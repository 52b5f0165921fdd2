"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD / state-space duality).

48L d_model=2048, attention-free, vocab=50280, ssm_state=128,
expand=2 (d_inner=4096), head_dim=64 -> 64 SSD heads, conv k=4.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv=1, d_ff=0,
    head_dim=64,
    vocab=50280, ssm_state=128, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=64, ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv=1, d_ff=0, head_dim=16,
    vocab=512, ssm_state=16, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=16, ssm_chunk=16,
)
