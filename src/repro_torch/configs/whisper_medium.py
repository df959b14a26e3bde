"""whisper-medium [audio/encdec] — encoder-decoder; the conv front end is
a stub: the frames arrive as precomputed embeddings (B, enc_seq, d_model).
[arXiv:2212.04356; unverified]  24+24L d_model=1024 16H d_ff=4096
vocab=51865.  As in the reference, RoPE replaces Whisper's learned
absolute positions (a backbone-only reproduction)."""
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    enc_layers=24, enc_seq=1500,
    norm="layernorm", act="gelu", rope_theta=1.0e4,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=97, enc_layers=2, enc_seq=12,
    norm="layernorm", act="gelu",
)
