"""starcoder2-3b [dense] — arXiv:2402.19173.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152; GELU MLP
(non-gated), RoPE, attention+MLP bias in the public config (we model
the attention bias; MLP bias is negligible at this scale).
Note: 24 q-heads do not divide the 16-way model axis — the sharding
rules fall back to head_dim TP (see DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv=2,
    d_ff=12288, vocab=49152, act="gelu", qkv_bias=True,
    rope_theta=1e5,
)

SMOKE = ModelConfig(
    name="starcoder2-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=256, vocab=512, act="gelu", qkv_bias=True,
)
