"""Training-step and serving-function factories, on one device or a
device mesh.

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
remat`).  Tuned layers are refused: the port's CUDA kernels, like the
reference's Pallas kernels, have no backward.

On a mesh (a ``DeviceMesh`` over one rank per device) the parameters
and moments are DTensors laid out by `param_shardings` (the caller
places them with `models.params.device_put`).  Each host batch — the
same global batch on every rank — is split into its microbatches as the
reference splits it, and each microbatch is laid out by the activation
rules (``batch -> ("pod", "data")``): every rank keeps its rows.  The
`Sharder` constrains the activations; plain tensors a layer makes
(positions, masks) join the mesh replicated.  After the backward each
gradient is redistributed to its parameter's placements — the data-
parallel all-reduce or reduce-scatter GSPMD inserts in the reference —
and, with ``compress_pod_grads`` on a mesh with a ``pod`` dim, passes
through the int8 error-feedback compression.  As in the reference, the
residual does not outlive the step: the reference's ``adamw_update``
returns a fresh state of ``m``, ``v`` and ``count``, so every step
compresses with a zero residual.  The metrics come back as plain
tensors, the same on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (ACT_RULES, CACHE_RULES, Rules,
                                              Sharder, WEIGHT_RULES,
                                              mesh_sizes)
from repro_torch.models.layers import tuned_layers_enabled
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw

if TYPE_CHECKING:
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig

__all__ = ["TrainStepConfig", "make_train_step", "make_serve_fns",
           "recommended_microbatches", "place_batch", "batch_dims"]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    compress_pod_grads: bool = False
    act_rules: Rules = ACT_RULES
    cache_rules: Rules = CACHE_RULES
    weight_rules: Rules = WEIGHT_RULES


def recommended_microbatches(cfg, shape, mesh,
                             act_budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation depth that keeps the layer-boundary
    activations (L x B_loc x S x D bf16 — the dominant live set under
    full remat) inside ``act_budget_bytes`` per device.  ``mesh`` is a
    ``DeviceMesh`` or anything with ``axis_names`` and
    ``devices.shape``."""
    if mesh is None or shape.kind != "train":
        return 1
    sizes = mesh_sizes(mesh)
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


_BATCH_DIMS = {"tokens": ("batch", "seq"), "token": ("batch", "seq"),
               "frames": ("batch", "seq", "embed")}


def batch_dims(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical dims of a batch entry (the reference's
    ``sharded_batch``): tokens and frames by name, anything else
    unnamed."""
    return _BATCH_DIMS.get(name, (None,) * ndim)


def place_batch(batch: Dict, shd: Sharder) -> Dict:
    """A host batch laid out on the Sharder's mesh by its activation
    rules; as is without a mesh."""
    if shd.mesh is None:
        return batch
    return {name: shd.act(x, batch_dims(name, x.dim()))
            for name, x in batch.items()}


def _full(x):
    """A DTensor's whole value (a plain tensor, the same on every
    rank); anything else as is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _on_mesh(mesh):
    """Plain tensors a layer makes join the mesh replicated."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_train_step(model: "Model", opt_cfg: AdamWConfig, mesh=None,
                    step_cfg: TrainStepConfig = TrainStepConfig()
                    ) -> Callable:
    _refuse_tuned_layers()
    shd = Sharder(mesh, act_rules=step_cfg.act_rules,
                  cache_rules=step_cfg.cache_rules,
                  weight_rules=step_cfg.weight_rules)
    n_micro = max(step_cfg.microbatches, 1)
    compress = (step_cfg.compress_pod_grads and mesh is not None
                and "pod" in (mesh.mesh_dim_names or ()))

    def train_step(params, opt_state, batch: Dict):
        _refuse_tuned_layers()
        mbs = [place_batch(mb, shd)
               for mb in _split_microbatches(batch, n_micro)]
        masters = [leaf.value for _, leaf in tree_leaves(params)]
        for v in masters:
            v.requires_grad_(True)
            v.grad = None
        try:
            with _on_mesh(mesh):
                loss_sum = torch.zeros((), dtype=torch.float32,
                                       device=masters[0].device)
                for mb in mbs:
                    loss, metrics = model.loss(params, mb, shd)
                    loss.backward()
                    loss_sum = loss_sum + _full(loss.detach())
        finally:
            for v in masters:
                v.requires_grad_(False)
        grads = []
        for v in masters:
            g = v.grad if v.grad is not None else torch.zeros_like(v)
            if mesh is not None and tuple(g.placements) != \
                    tuple(v.placements):
                # the data-parallel reduction: partial sums over the
                # batch shards reduced to the parameter's layout
                g = g.redistribute(v.device_mesh, v.placements)
            grads.append(g.float().div_(n_micro) if n_micro > 1
                         else g.float())
            v.grad = None
        grads = _rebuild(params, iter(grads))
        with _on_mesh(mesh):
            if compress:
                from repro_torch.distributed.compression import \
                    ef_compress_grads
                grads, opt_state = ef_compress_grads(grads, opt_state, mesh)
            params, opt_state, om = adamw.adamw_update(
                params, grads, opt_state, opt_cfg)
            # the reference's update drops the "ef" residual it was handed
            opt_state.pop("ef", None)
        metrics = {name: _full(m.detach()) for name, m in metrics.items()}
        return params, opt_state, {"loss": loss_sum / n_micro, **metrics,
                                   **{k: _full(v) for k, v in om.items()}}

    return train_step


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in flatten
    (sorted-key) order."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], it) for key in sorted(tree)}
    return next(it)


def make_serve_fns(model: "Model", mesh=None,
                   step_cfg: TrainStepConfig = TrainStepConfig()
                   ) -> Tuple[Callable, Callable]:
    """(prefill, decode_step) closures with the Sharder bound."""
    shd = Sharder(mesh, act_rules=step_cfg.act_rules,
                  cache_rules=step_cfg.cache_rules,
                  weight_rules=step_cfg.weight_rules)

    def prefill(params, batch):
        with _on_mesh(mesh):
            return model.prefill(params, place_batch(batch, shd), shd)

    def decode_step(params, cache, token):
        with _on_mesh(mesh):
            token = place_batch({"token": token}, shd)["token"]
            return model.decode_step(params, cache, token, shd)

    return prefill, decode_step
