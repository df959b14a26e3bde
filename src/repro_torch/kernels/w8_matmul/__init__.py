from .ops import w8_matmul, w8_splits
from .ref import dequant_weight, w8_matmul_ref

__all__ = ["w8_matmul", "w8_matmul_ref", "dequant_weight", "w8_splits"]
