"""Model facade: one object per architecture config exposing init /
prefill / decode_step / init_cache (dense family)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.distributed.sharding import Sharder
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, *, seed: int = 0, device=None) -> Dict:
        return tf.init_lm(self.cfg, seed=seed, device=device)

    def prefill(self, params: Dict, batch: Dict, shd: Sharder,
                max_len: int = 0):
        return tf.lm_prefill(params, batch["tokens"], self.cfg, shd,
                             max_len=max_len)

    def decode_step(self, params: Dict, cache: Dict, token: torch.Tensor,
                    shd: Sharder):
        return tf.lm_decode_step(params, cache, token, self.cfg, shd)

    def init_cache(self, batch: int, seq_len: int, device=None) -> Dict:
        return tf.init_lm_cache(self.cfg, batch, seq_len, device=device)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg)
