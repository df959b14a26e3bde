"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained.
[hf:Qwen/Qwen3-30B-A3B; hf]  48L d_model=2048 32H (GQA kv=4) d_ff=768/expert
vocab=151936."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    n_experts=128, top_k=8, d_ff_expert=768,
    rope_theta=1.0e6,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=97, n_experts=16, top_k=4, d_ff_expert=32,
)
