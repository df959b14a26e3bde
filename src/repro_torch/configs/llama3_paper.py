"""Llama 3.1 70B / 405B — the paper's own models (not registered as
--arch ids; chip_smoke.py runs them at cut depth).  [arXiv:2407.21783]"""
from ..models.common import ModelConfig

LLAMA31_70B = ModelConfig(
    name="llama3.1-70b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, rope_theta=5.0e5,
)

LLAMA31_405B = ModelConfig(
    name="llama3.1-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab_size=128256, rope_theta=5.0e5,
)
