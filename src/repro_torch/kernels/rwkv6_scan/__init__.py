from .ops import rwkv6_scan
from .ref import rwkv6_scan_ref

__all__ = ["rwkv6_scan", "rwkv6_scan_ref"]
