from .autograd import FlashAttention, flash_attention_grad
from .ops import flash_attention, flash_attention_chunk
from .ref import flash_attention_chunk_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_chunk",
           "flash_attention_chunk_ref", "FlashAttention",
           "flash_attention_grad"]
