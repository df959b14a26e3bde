"""dbrx-132b [moe] — 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H (GQA kv=8)
d_ff=10752/expert vocab=100352.

Registered for the CPU smoke config: 132 B parameters do not fit one
card.  The grouped expert FFN kernel takes its widths (d_model 6144 in
its two-launch form, which tiles D; checked on the card at 4 experts)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4, d_ff_expert=10752,
    rope_theta=5.0e5,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=97, n_experts=8, top_k=2, d_ff_expert=96,
)
