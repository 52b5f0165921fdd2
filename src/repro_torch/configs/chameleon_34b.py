"""chameleon-34b [vlm] — arXiv:2405.09818.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536; early-fusion:
VQ image tokens share the text vocabulary, so the backbone consumes a
single fused token stream — ``input_specs()`` provides token ids
directly (the VQ tokenizer is the stubbed modality frontend per the
assignment).  QK-norm per the Chameleon recipe.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv=8,
    d_ff=22016, vocab=65536, act="silu_glu", qk_norm=True,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="chameleon-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=128, vocab=512, act="silu_glu", qk_norm=True,
)
