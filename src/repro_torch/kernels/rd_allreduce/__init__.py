from . import ops
from .ops import (LL_MAX_BYTES, RDWorkspace, ll_packets, ll_plan,
                  ll_recv_bytes, rd_all_reduce, rd_pieces, rd_protocol)
from .ref import rd_all_reduce_ref

__all__ = ["rd_all_reduce", "rd_all_reduce_ref", "RDWorkspace",
           "rd_pieces", "rd_protocol", "ll_packets", "ll_recv_bytes",
           "ll_plan", "LL_MAX_BYTES"]
