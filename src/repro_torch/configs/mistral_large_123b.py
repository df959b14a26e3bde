"""mistral-large-123b [dense].
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]  88L d_model=12288
96H (GQA kv=8) d_ff=28672 vocab=32768."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=32768,
    rope_theta=1.0e6,
)

SMOKE = ModelConfig(
    name="mistral-large-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=97,
)
