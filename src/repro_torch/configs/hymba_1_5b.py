"""hymba-1.5b [hybrid] — parallel attention + mamba heads per block.
[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001 ssm_state=16, d_inner 3200, sliding-window attention (1024)
(the port's copy of ``repro/configs/hymba_1_5b.py``)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, d_inner=3200, d_conv=4, dt_rank=100,
    sliding_window=1024, rope_theta=1.0e4,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=5, head_dim=16,
    d_ff=128, vocab_size=97,
    ssm_state=8, d_inner=128, d_conv=4, dt_rank=8,
    sliding_window=8,
)
