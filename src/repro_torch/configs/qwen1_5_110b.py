"""qwen1.5-110b [dense] — hf:Qwen/Qwen1.5-110B (family config per
assignment; hf:Qwen/Qwen1.5-0.5B cited for the family).

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064; QKV bias,
SwiGLU.  The largest memory budget of the dry-run: ~110B params ->
~6 GB/chip of param+optimizer state on 256 chips at f32 master + f32
moments + bf16 compute.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8,
    d_ff=49152, vocab=152064, act="silu_glu", qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv=2,
    d_ff=256, vocab=512, act="silu_glu", qkv_bias=True,
)
