from .ops import (decode_attention, decode_attention_int8,
                  paged_decode_attention)
from .ref import (decode_attention_int8_ref, decode_attention_ref,
                  paged_decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_int8",
           "paged_decode_attention", "decode_attention_ref",
           "decode_attention_int8_ref", "paged_decode_attention_ref"]
