"""qwen1.5-32b [dense] — MHA with QKV bias.
[hf:Qwen/Qwen1.5-0.5B; hf]  64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1.0e6,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=5, n_kv_heads=5, head_dim=16,
    d_ff=128, vocab_size=97, qkv_bias=True,
)
