"""Model configuration dataclass shared by every assigned architecture."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "LM_SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "silu_glu"       # silu_glu | gelu_glu | gelu | relu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0     # leading dense layers (moonshot style)
    moe_dispatch: str = "flat"      # flat | grouped (GShard-style)
    pad_experts_to: int = 0         # pad expert dim for TP divisibility
                                    # (padded experts never routed to)
    # ssm (mamba2 / hybrid branch)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # hybrid (hymba)
    swa_window: int = 0             # sliding window for non-global layers
    global_every: int = 0           # 0 = none; else full attn on first/
                                    # every k-th/last layer
    decode_cache_cap: int = 32768   # rolling-cache cap for windowed decode
    kv_repeat: int = 1              # replicate KV heads for TP divisibility
                                    # (vLLM-style inference transform)
    # encdec (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500             # encoder frames (stub frontend)
    # numerics
    dtype: str = "bfloat16"
    remat: str = "full"             # none | full | dots (selective)
    # modality stub note ([audio]/[vlm] frontends per the assignment)
    frontend: str = "tokens"        # tokens | frames

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def num_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab
        n = v * d                                 # embedding
        n += v * d                                # lm head (untied)
        hd = self.hd
        per_layer = 0
        if self.family in ("dense", "moe", "hybrid", "encdec"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv) \
                + self.n_heads * hd * d
            per_layer += attn + 2 * d             # + norms
        if self.family in ("dense", "hybrid", "encdec"):
            glu = 3 if self.act.endswith("_glu") else 2
            per_layer += glu * d * self.d_ff
        if self.family == "moe":
            glu = 3
            expert = glu * d * self.d_ff_expert
            per_layer += self.n_experts * expert + d * self.n_experts
            per_layer += self.n_shared * glu * d * self.d_ff_expert
        if self.family in ("ssm", "hybrid"):
            di = self.ssm_expand * d if self.family == "ssm" else \
                self.ssm_expand * d
            nst = self.ssm_state
            h = di // self.ssm_head_dim
            per_layer += d * (2 * di + 2 * nst + h) + di * d + di
        n += self.n_layers * per_layer
        if self.family == "moe" and self.first_dense_layers:
            # replace moe ffn by dense ffn in the leading layers
            glu = 3
            n -= self.first_dense_layers * (
                self.n_experts * glu * d * self.d_ff_expert
                + d * self.n_experts
                + self.n_shared * glu * d * self.d_ff_expert)
            n += self.first_dense_layers * glu * d * self.d_ff
        if self.family == "encdec":
            n += self.enc_layers * per_layer      # encoder stack
            n += self.n_layers * (d * hd * (self.n_heads + 2 * self.n_kv)
                                  + self.n_heads * hd * d + d)  # cross attn
        return int(n)

    def num_active_params(self) -> int:
        """Active (per-token) parameters — the MoE 6·N_active·D count."""
        if self.family != "moe":
            return self.num_params()
        d = self.d_model
        glu = 3
        expert = glu * d * self.d_ff_expert
        total = self.num_params()
        inactive = (self.n_layers - self.first_dense_layers) * \
            (self.n_experts - self.top_k) * expert
        return int(total - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
