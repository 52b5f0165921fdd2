"""Model facade: one object per architecture config exposing init /
loss / prefill / decode_step / init_cache / input shapes / MODEL_FLOPS
accounting, independent of family."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import Sharder
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, ShapeSpec

__all__ = ["Model", "build_model", "batch_shapes"]


def batch_shapes(cfg: ModelConfig, shape: ShapeSpec
                 ) -> Dict[str, torch.Tensor]:
    """One input batch of the given shape spec as ``meta`` tensors (the
    shapes and dtypes; nothing allocated)."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        out = {"tokens": meta((b, s), torch.int32)}
        if cfg.frontend == "frames":
            out["frames"] = meta((b, cfg.enc_seq, cfg.d_model),
                                 getattr(torch, cfg.dtype))
        return out
    if shape.kind == "decode":
        return {"token": meta((b, 1), torch.int32)}
    raise ValueError(shape.kind)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- params ---------------------------------------------------------------
    def init(self, *, seed: int = 0, device=None,
             param_dtype: Optional[torch.dtype] = None) -> Dict:
        """Serving stores matrices in the compute type;
        ``param_dtype=torch.float32`` keeps training's f32 masters."""
        init = ed.init_encdec if self.cfg.family == "encdec" else tf.init_lm
        return init(self.cfg, seed=seed, device=device,
                    param_dtype=param_dtype)

    def abstract_params(self) -> Dict:
        """The parameter tree on ``meta``, f32 masters as the
        reference's."""
        return self.init(device="meta", param_dtype=torch.float32)

    # -- training -------------------------------------------------------------
    def loss(self, params: Dict, batch: Dict, shd: Sharder
             ) -> Tuple[torch.Tensor, Dict]:
        if self.cfg.family == "encdec":
            return ed.encdec_loss(params, batch, self.cfg, shd)
        return tf.lm_loss(params, batch, self.cfg, shd)

    # -- serving --------------------------------------------------------------
    def prefill(self, params: Dict, batch: Dict, shd: Sharder,
                max_len: int = 0):
        if self.cfg.family == "encdec":
            return ed.encdec_prefill(params, batch["frames"],
                                     batch["tokens"], self.cfg, shd,
                                     max_len=max_len)
        return tf.lm_prefill(params, batch["tokens"], self.cfg, shd,
                             max_len=max_len,
                             inputs_embeds=batch.get("frames"))

    def decode_step(self, params: Dict, cache: Dict, token: torch.Tensor,
                    shd: Sharder):
        if self.cfg.family == "encdec":
            return ed.encdec_decode_step(params, cache, token, self.cfg,
                                         shd)
        return tf.lm_decode_step(params, cache, token, self.cfg, shd)

    def init_cache(self, batch: int, seq_len: int, device=None) -> Dict:
        if self.cfg.family == "encdec":
            return ed.init_encdec_cache(self.cfg, batch, seq_len,
                                        device=device)
        return tf.init_lm_cache(self.cfg, batch, seq_len, device=device)

    def abstract_cache(self, batch: int, seq_len: int) -> Dict:
        return self.init_cache(batch, seq_len, device="meta")

    # -- accounting -----------------------------------------------------------
    def model_flops(self, shape: ShapeSpec) -> float:
        """MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE) for training;
        2·N·D per processed or generated token for inference shapes."""
        n_active = self.cfg.num_active_params()
        if shape.kind == "train":
            return 6.0 * n_active * shape.global_batch * shape.seq_len
        if shape.kind == "prefill":
            return 2.0 * n_active * shape.global_batch * shape.seq_len
        return 2.0 * n_active * shape.global_batch

    def supports_shape(self, shape: ShapeSpec) -> Tuple[bool, str]:
        """long_500k needs sub-quadratic sequence mixing."""
        if shape.name == "long_500k" and self.cfg.family not in (
                "ssm", "hybrid"):
            return False, ("skip: full-attention arch at 524k decode "
                           "(quadratic KV) — per assignment/DESIGN.md")
        return True, ""


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
