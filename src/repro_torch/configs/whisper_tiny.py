"""whisper-tiny [audio] — arXiv:2212.04356.

Enc-dec, 4L+4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865; conv
frontend STUBBED per the assignment: ``input_specs()`` provides
precomputed frame embeddings (B, 1500, 384).  GELU MLPs; RMSNorm in
place of LayerNorm (DESIGN.md §8).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, enc_layers=4, d_model=384, n_heads=6, n_kv=6,
    d_ff=1536, vocab=51865, act="gelu", enc_seq=1500,
    frontend="frames",
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv=4,
    d_ff=128, vocab=512, act="gelu", enc_seq=32, frontend="frames",
)
