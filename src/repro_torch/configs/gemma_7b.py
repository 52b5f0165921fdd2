"""gemma-7b [dense] — arXiv:2403.08295.

28L d_model=3072 16H (kv=16; the 2b sibling uses MQA) d_ff=24576
vocab=256000; GeGLU, head_dim=256 (> d_model/n_heads — explicit).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv=16,
    d_ff=24576, vocab=256000, act="gelu_glu", head_dim=256,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=256, vocab=512, act="gelu_glu", head_dim=32,
)
