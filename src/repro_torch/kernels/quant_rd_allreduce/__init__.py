from .ops import (qrd_packets, qrd_plan, qrd_recv_bytes, qrd_tiles,
                  quant_rd_all_reduce)
from .ref import quant_rd_all_reduce_ref

__all__ = ["quant_rd_all_reduce", "quant_rd_all_reduce_ref", "qrd_tiles",
           "qrd_packets", "qrd_recv_bytes", "qrd_plan"]
