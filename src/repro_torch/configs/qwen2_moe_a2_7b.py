"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (GQA kv=16) vocab=151936; MoE: 60 routed experts
top-4 + 4 shared experts, expert d_ff=1408 (shared = 4x1408 merged).
Qwen1.5 family uses QKV bias + SwiGLU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16,
    d_ff=5632,              # dense-equivalent ff (unused: all layers MoE)
    d_ff_expert=1408, n_experts=60, top_k=4, n_shared=4,
    vocab=151936, act="silu_glu", qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, d_ff_expert=32, n_experts=6, top_k=2, n_shared=2,
    vocab=512, act="silu_glu", qkv_bias=True,
)
