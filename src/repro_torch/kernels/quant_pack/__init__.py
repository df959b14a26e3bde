from .ops import quantize_pack, unpack_dequant
from .ref import (GROUP_CAP, QMAX, group_for, packed_width,
                  quantize_pack as quantize_pack_ref,
                  unpack_dequant as unpack_dequant_ref, wire_factor)

__all__ = ["quantize_pack", "unpack_dequant", "quantize_pack_ref",
           "unpack_dequant_ref", "QMAX", "GROUP_CAP", "group_for",
           "packed_width", "wire_factor"]
