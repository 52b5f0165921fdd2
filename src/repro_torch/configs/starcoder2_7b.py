"""starcoder2-7b [dense] — arXiv:2402.19173.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152; GELU MLP,
RoPE, QKV bias.  36 q-heads fall back to head_dim TP on the 16-way
model axis (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv=4,
    d_ff=18432, vocab=49152, act="gelu", qkv_bias=True,
    rope_theta=1e5,
)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke", family="dense",
    n_layers=2, d_model=72, n_heads=6, n_kv=2,
    d_ff=288, vocab=512, act="gelu", qkv_bias=True,
)
