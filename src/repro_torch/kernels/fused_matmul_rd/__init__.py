from .ops import collective_matmul_rd
from .ref import collective_matmul_rd_ref

__all__ = ["collective_matmul_rd", "collective_matmul_rd_ref"]
