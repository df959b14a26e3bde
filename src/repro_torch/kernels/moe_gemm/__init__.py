from .ops import moe_expert_ffn
from .ref import moe_expert_ffn_ref

__all__ = ["moe_expert_ffn", "moe_expert_ffn_ref"]
