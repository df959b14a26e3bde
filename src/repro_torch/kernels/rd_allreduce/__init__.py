from .ops import RDWorkspace, rd_all_reduce, rd_pieces
from .ref import rd_all_reduce_ref

__all__ = ["rd_all_reduce", "rd_all_reduce_ref", "RDWorkspace",
           "rd_pieces"]
