"""hymba-1.5b [hybrid] — arXiv:2411.13676.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Parallel attention + mamba heads per layer; sliding-window attention
(1024) everywhere except the first / middle / last layers (global).
Meta-token prompt tuning is out of backbone scope (DESIGN.md §8).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5,
    d_ff=5504, vocab=32001, act="silu_glu",
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=128, swa_window=1024, decode_cache_cap=32768,
)

SMOKE = ModelConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=4, n_kv=2,
    d_ff=128, vocab=512, act="silu_glu",
    ssm_state=8, ssm_conv=4, ssm_expand=2, ssm_head_dim=16,
    ssm_chunk=16, swa_window=16, decode_cache_cap=64,
)
