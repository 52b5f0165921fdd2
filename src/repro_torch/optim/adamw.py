"""AdamW with a global-norm clip, the reference's from scratch.

State is a Param-shaped tree of f32 moments plus an int32 ``count``;
parameters are the f32 masters (the model casts to its compute type at
each use).  The norm and the clip run in f32, and leaves go in the
reference's flatten order (dict keys sorted), so the norm's sum runs in
the same order.  `adamw_update` updates parameters and moments in place
under ``torch.no_grad()`` — the counterpart of the reference donating
both to its jitted step — and returns them with the metrics.  Every
scalar stays a tensor on the state's device: a step never waits for
the card.  On a mesh parameters, gradients and moments are DTensors of
one layout per leaf, updated in place shard by shard; the norm is
reduced over the whole mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import settle
from repro_torch.models.params import Param, map_params, tree_leaves

__all__ = ["AdamWConfig", "init_adamw", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * peak (f32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * warm * frac


def _values(tree):
    return [leaf.value if isinstance(leaf, Param) else leaf
            for _, leaf in tree_leaves(tree)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's f32
    sum of squares.  A DTensor leaf's sum is reduced over its shards
    (`settle`), so a gradient sharded over the mesh is normed whole."""
    total = 0
    for v in _values(tree):
        total = total + settle(torch.sum(torch.square(v.float())))
    return torch.sqrt(torch.as_tensor(total))


def init_adamw(params) -> Dict:
    """Zero f32 moments shaped (and, on a mesh, laid out) as the
    parameters; ``count`` a plain int32 scalar."""
    zeros = lambda p: Param(torch.zeros_like(p.value, dtype=torch.float32),
                            p.dims)
    dev = next(iter(_values(params))).device
    return {"m": map_params(zeros, params), "v": map_params(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params, grads, state: Dict, cfg: AdamWConfig
                 ) -> Tuple[object, Dict, Dict]:
    """One AdamW step.  ``grads`` is a tree of tensors (or Params) in
    ``params``' structure; it is scaled by the clip in place.  Bias
    correction uses the incremented count."""
    count = state["count"] + 1
    lr = schedule(cfg, count)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    cf = count.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    for p, g, m, v in zip(_values(params), _values(grads),
                          _values(state["m"]), _values(state["v"])):
        g = g.float().mul_(clip)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        upd = lr * step.add_(pf, alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(upd)                 # pf is p: no copy of the master
        else:
            p.copy_(pf - upd)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
