"""codeqwen1.5-7b [dense] — qwen1.5 arch (QKV bias), MHA.
[hf:Qwen/CodeQwen1.5-7B; hf]  32L d_model=4096 32H (kv=32) d_ff=13440
vocab=92416."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
    qkv_bias=True, rope_theta=1.0e6,
)

SMOKE = ModelConfig(
    name="codeqwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=97, qkv_bias=True,
)
