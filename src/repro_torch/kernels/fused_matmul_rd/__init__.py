from .ops import collective_matmul_rd, tile_shape, tiles_per_rank, vector_ok
from .ref import collective_matmul_rd_ref

__all__ = ["collective_matmul_rd", "collective_matmul_rd_ref", "tile_shape",
           "tiles_per_rank", "vector_ok"]
