"""llama3.2-1b [dense] — small llama3.
[hf:meta-llama/Llama-3.2-1B; unverified]  16L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=128256."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256,
    rope_theta=5.0e5,
)

SMOKE = ModelConfig(
    name="llama3.2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=97,
)
