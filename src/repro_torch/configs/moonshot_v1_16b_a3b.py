"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B.

48L d_model=2048 16H (GQA kv=16) vocab=163840; MoE: 64 routed experts
top-6, expert d_ff=1408 (per the assignment); DeepSeek-V3-style layout:
first layer dense (ff=11264) + 2 shared experts (public Moonlight
config).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16,
    d_ff=11264,             # the dense prefix layer's ff
    d_ff_expert=1408, n_experts=64, top_k=6, n_shared=2,
    first_dense_layers=1,
    vocab=163840, act="silu_glu", rope_theta=5e4,
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv=4,
    d_ff=192, d_ff_expert=32, n_experts=8, top_k=2, n_shared=1,
    first_dense_layers=1, vocab=512, act="silu_glu",
)
