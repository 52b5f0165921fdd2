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
places them with `models.params.device_put`), and the step runs as the
reference's compiled SPMD program: one local program per rank
(`sharding`'s local program).  At its start each rank takes its
parameters' local shards (tagged with their layouts) and its rows of
each microbatch — the host batch, the same on every rank, split into
microbatches as the reference splits it, then laid out by the
activation rules (``batch -> ("pod", "data")``).  The forward, remat
and backward run plain torch ops on local tensors; each mesh site is
the collective GSPMD inserts there, under autograd.  A weight moves in
the type its site computes in (`sharding.cast`): in a bf16 step its
float32 master's shard is cast, the cast gathered, and its bf16
gradient reduce-scattered in the backward and widened on the shard.
One whole along a mesh dim over which its site's work is split leaves
its gradient partial there, and after the backward the data-parallel
all-reduce sums it, in the type the site used it in.  The update
(`optim.adamw`) takes the gradients as local shards tagged with their
parameters' layouts and runs on the parameters' and moments' local
shards, the norm summed over the mesh dims that shard each leaf; with
``compress_pod_grads`` on a mesh with a ``pod`` dim the gradients join
the mesh as DTensors of their parameters' placements and pass through
the int8 error-feedback compression first.  As in the reference, the
residual does not outlive the step: the reference's ``adamw_update``
returns a fresh state of ``m``, ``v`` and ``count``, so every step
compresses with a zero residual.  The metrics come back as plain
tensors, the same on every rank.

`make_serve_fns` builds prefill and decode the same way: on a mesh each
runs as one local program per rank, the caches tagged local shards and
the logits whole at the step's edge.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (ACT_RULES, CACHE_RULES, Lay,
                                              Rules, Sharder, WEIGHT_RULES,
                                              _reduce, cast, mesh_sizes,
                                              pending_reductions, tag, whole)
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
    """A batch laid out on the Sharder's mesh by its activation rules
    (`Sharder.enter`: a host batch, the same on every rank, or one a
    caller laid out on the mesh); as is without a mesh."""
    if shd.mesh is None:
        return batch
    return {name: shd.enter(_local(x), batch_dims(name, x.dim()))
            for name, x in batch.items()}


def _local(v, key: Optional[int] = None):
    """A DTensor as its local shard, tagged with its layout (and
    ``key``, a parameter's index): a step's edge, where the parameter
    state, or a batch or cache a caller laid out on the mesh, enters the
    local program; anything else as is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(v, DTensor):
        return v
    return tag(v._local_tensor.detach(), Lay(v.device_mesh,
                                             tuple(v.placements),
                                             tuple(v.shape), key))


def _local_params(params):
    """A Param tree of DTensors as tagged local shards."""
    from repro_torch.models.params import Param, map_params
    return map_params(lambda p: Param(_local(p.value), p.dims), params)


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
        if mesh is None:
            grads, loss_sum, metrics = _backward(params, mbs)
        else:
            grads, loss_sum, metrics = _local_backward(params, mbs)
        grads = _rebuild(params, iter(grads))
        if compress:
            from repro_torch.distributed.compression import \
                ef_compress_grads
            grads, opt_state = ef_compress_grads(grads, opt_state, mesh)
        params, opt_state, om = adamw.adamw_update(
            params, grads, opt_state, opt_cfg)
        # the reference's update drops the "ef" residual it was handed
        opt_state.pop("ef", None)
        metrics = {name: m.detach() for name, m in metrics.items()}
        return params, opt_state, {"loss": loss_sum / n_micro, **metrics,
                                   **om}

    def _backward(params, mbs):
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
        return grads, loss_sum, metrics

    def _local_backward(params, mbs):
        """The step's body as one local program: every parameter's local
        shard a leaf (tagged with its layout and its index), the loss
        and its backward on local tensors, then the data-parallel
        reduction of each gradient over the mesh dims its sites left it
        partial on, in the type they used it in; the gradients come back
        as local shards tagged with their parameters' layouts, which the
        update takes as they are (DTensors of those layouts for the int8
        compression)."""
        from torch.distributed.tensor import DTensor
        from repro_torch.models.params import Param, map_params
        leaves = [leaf for _, leaf in tree_leaves(params)]
        locs = {id(leaf): _local(leaf.value, key).requires_grad_(True)
                for key, leaf in enumerate(leaves)}
        lparams = map_params(lambda p: Param(locs[id(p)], p.dims), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].value.device)
        with pending_reductions() as pend:
            for mb in mbs:
                loss, metrics = model.loss(lparams, mb, shd)
                loss.backward()
                loss_sum = loss_sum + loss.detach()
        grads = []
        for key, leaf in enumerate(leaves):
            v, loc = leaf.value, locs[id(leaf)]
            g = loc.grad if loc.grad is not None else torch.zeros_like(loc)
            for i, width in sorted(pend.get(key, {}).items()):
                g = _reduce(cast(g, width), (mesh, i))
            g = g.float().div_(n_micro) if n_micro > 1 else g.float()
            grads.append(DTensor.from_local(g, mesh, v.placements,
                                            shape=v.shape,
                                            stride=v.stride(),
                                            run_check=False) if compress
                         else tag(g, Lay(mesh, tuple(v.placements),
                                         tuple(v.shape))))
        return grads, loss_sum, metrics

    return train_step


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in flatten
    (sorted-key) order."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], it) for key in sorted(tree)}
    return next(it)


def make_serve_fns(model: "Model", mesh=None,
                   step_cfg: TrainStepConfig = TrainStepConfig(), *,
                   whole_logits: bool = True
                   ) -> Tuple[Callable, Callable]:
    """(prefill, decode_step) closures with the Sharder bound.  On a mesh
    each runs as one local program per rank, as the training step does:
    each parameter's local shard tagged with its layout, the tokens (and
    frames) this rank's rows by the activation rules (`place_batch`).
    The caches prefill returns are tagged local shards laid out by the
    cache rules; decode takes them (or a cache a caller laid out on the
    mesh as DTensors) and writes them in place.  The logits leave whole,
    the same on every rank — or, with ``whole_logits=False``, in their
    layout, as the reference's compiled program leaves them (the
    dry-run's per-device program)."""
    shd = Sharder(mesh, act_rules=step_cfg.act_rules,
                  cache_rules=step_cfg.cache_rules,
                  weight_rules=step_cfg.weight_rules)
    out = whole if whole_logits else (lambda x: x)

    def prefill(params, batch):
        logits, cache = model.prefill(_local_params(params),
                                      place_batch(batch, shd), shd)
        return out(logits), cache

    def decode_step(params, cache, token):
        token = place_batch({"token": token}, shd)["token"]
        logits, cache = model.decode_step(
            _local_params(params), {k: _local(v) for k, v in cache.items()},
            token, shd)
        return out(logits), cache

    return prefill, decode_step
