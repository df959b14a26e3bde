"""pixtral-12b [vlm] — the pixtral-ViT front end is a stub: the patches
arrive as precomputed embeddings (B, n_patches, d_model) and overwrite the
first n_patches positions; a mistral-nemo decoder backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H (GQA
kv=8) d_ff=14336 vocab=131072."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    n_patches=1024, rope_theta=1.0e6,
)

SMOKE = ModelConfig(
    name="pixtral-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=97, n_patches=4,
)
