from .ops import quantize_pack, unpack_dequant, unpack_geometry
from .ref import (GROUP_CAP, QMAX, group_for, packed_width,
                  quantize_pack as quantize_pack_ref,
                  quantize_pack_err as quantize_pack_err_ref,
                  unpack_dequant as unpack_dequant_ref,
                  unpack_dequant_sum as unpack_dequant_sum_ref, wire_factor)

__all__ = ["quantize_pack", "unpack_dequant", "quantize_pack_ref",
           "quantize_pack_err_ref", "unpack_dequant_ref",
           "unpack_dequant_sum_ref", "unpack_geometry", "QMAX", "GROUP_CAP",
           "group_for", "packed_width", "wire_factor"]
