"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; hf]  32L d_model=4096 d_ff=14336 vocab=65536, 64 heads
of 64 channels, decay LoRA rank 64 (the port's copy of
``repro/configs/rwkv6_7b.py``)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    rwkv_head_dim=64, decay_lora=64, rope_theta=0.0,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=97, rwkv_head_dim=32, decay_lora=8,
    rope_theta=0.0,
)
