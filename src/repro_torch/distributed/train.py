"""Training-step and serving-function factories (one device).

`make_train_step` builds ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` for any Model, as the reference's does:

* microbatched gradient accumulation: the batch dimension split into
  ``k`` equal parts, f32 gradients summed over them (into each master's
  ``.grad``) and divided by ``k``;
* f32 master parameters and f32 Adam moments with a global-norm clip
  (`optim.adamw`), updated in place — the counterpart of the
  reference's ``donate_argnums=(0, 1)``;
* the metrics dict the reference builds: ``{"loss": loss_sum / k,
  **last microbatch's metrics, **optimizer metrics}`` — so, as there,
  the last microbatch's own ``"loss"`` overrides the mean when ``k >
  1``.

Layers are rematerialised as ``cfg.remat`` says (`models.transformer.
remat`).  A mesh and int8 pod-gradient compression wait for the mesh
slice (ROADMAP A8b) and raise.  Tuned layers are refused: the port's
CUDA kernels, like the reference's Pallas kernels, have no backward.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (ACT_RULES, CACHE_RULES, Rules,
                                              Sharder, WEIGHT_RULES)
from repro_torch.models.layers import tuned_layers_enabled
from repro_torch.models.params import tree_leaves
from repro_torch.optim.adamw import AdamWConfig, adamw_update

if TYPE_CHECKING:
    from repro_torch.models.model import Model

__all__ = ["TrainStepConfig", "make_train_step", "make_serve_fns",
           "recommended_microbatches"]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    compress_pod_grads: bool = False
    # the reference's rule tables; only a Sharder on a mesh reads them
    # (ROADMAP A8b), so one device carries them unread
    act_rules: Rules = ACT_RULES
    cache_rules: Rules = CACHE_RULES
    weight_rules: Rules = WEIGHT_RULES


def recommended_microbatches(cfg, shape, mesh,
                             act_budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation depth that keeps the layer-boundary
    activations (L x B_loc x S x D bf16 — the dominant live set under
    full remat) inside ``act_budget_bytes`` per device.  ``mesh`` is
    anything with ``axis_names`` and ``devices.shape``."""
    if mesh is None or shape.kind != "train":
        return 1
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    data_shards = sizes.get("pod", 1) * sizes.get("data", 1)
    b_loc = max(shape.global_batch // max(data_shards, 1), 1)
    layers = cfg.n_layers + getattr(cfg, "enc_layers", 0)
    boundary = layers * b_loc * shape.seq_len * cfg.d_model * 2.0
    k = int(np.ceil(boundary / act_budget_bytes))
    if k <= 1:
        return 1
    for d in range(1, b_loc + 1):
        if b_loc % d == 0 and d >= k:
            return d
    return b_loc


def _refuse_tuned_layers() -> None:
    if tuned_layers_enabled():
        raise RuntimeError(
            "a training step cannot run under tuned layers: the CUDA "
            "kernels have no backward (their outputs carry no grad_fn, so "
            "every weight upstream of them would get a zero gradient), "
            "and the reference's Pallas kernels have none either — its "
            "step fails there too.  Train with tuned layers off.")


def _split_microbatches(batch: Dict, k: int) -> List[Dict]:
    """The batch dimension in ``k`` equal, contiguous parts."""
    for name, x in batch.items():
        if x.shape[0] % k:
            raise ValueError(f"batch {name} of {x.shape[0]} rows does not "
                             f"split into {k} microbatches")
    parts = {name: x.chunk(k) for name, x in batch.items()}
    return [{name: p[i] for name, p in parts.items()} for i in range(k)]


def make_train_step(model: "Model", opt_cfg: AdamWConfig, mesh=None,
                    step_cfg: TrainStepConfig = TrainStepConfig()
                    ) -> Callable:
    if mesh is not None or step_cfg.compress_pod_grads:
        raise NotImplementedError(
            "training on a mesh and int8 pod-gradient compression wait "
            "for the mesh slice (ROADMAP A8b)")
    _refuse_tuned_layers()
    shd = Sharder(None)
    n_micro = max(step_cfg.microbatches, 1)

    def train_step(params, opt_state, batch: Dict):
        _refuse_tuned_layers()
        mbs = _split_microbatches(batch, n_micro)
        masters = [leaf.value for _, leaf in tree_leaves(params)]
        for v in masters:
            v.requires_grad_(True)
            v.grad = None
        try:
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=masters[0].device)
            for mb in mbs:
                loss, metrics = model.loss(params, mb, shd)
                loss.backward()
                loss_sum = loss_sum + loss.detach()
        finally:
            for v in masters:
                v.requires_grad_(False)
        grads = []
        for v in masters:
            g = v.grad if v.grad is not None else torch.zeros_like(v)
            grads.append(g.float().div_(n_micro) if n_micro > 1
                         else g.float())
            v.grad = None
        params, opt_state, om = adamw_update(
            params, _rebuild(params, iter(grads)), opt_state, opt_cfg)
        metrics = {name: m.detach() for name, m in metrics.items()}
        return params, opt_state, {"loss": loss_sum / n_micro, **metrics,
                                   **om}

    return train_step


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in flatten
    (sorted-key) order."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], it) for key in sorted(tree)}
    return next(it)


def make_serve_fns(model: "Model", mesh=None) -> Tuple[Callable, Callable]:
    """(prefill, decode_step) closures with the Sharder bound."""
    shd = Sharder(mesh)

    def prefill(params, batch):
        return model.prefill(params, batch, shd)

    def decode_step(params, cache, token):
        return model.decode_step(params, cache, token, shd)

    return prefill, decode_step
