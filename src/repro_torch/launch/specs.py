"""Sharded shape stand-ins for the dry-run.

Every model input — parameters, optimizer state, decode caches, token
batches — as a `Sharded` leaf: a ``meta`` tensor (shape and dtype,
nothing allocated) beside the `NamedSharding` the logical-dim rule
tables resolve for it on the mesh.  The reference's
``ShapeDtypeStruct(shape, dtype, sharding=...)``, leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (ACT_RULES, CACHE_RULES,
                                              NamedSharding, Rules,
                                              WEIGHT_RULES, mesh_sizes,
                                              named_sharding)
from repro_torch.distributed.train import batch_dims
from repro_torch.models import batch_shapes
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.models.model import Model
from repro_torch.models.params import Param, map_params

__all__ = ["Sharded", "sharded_params", "sharded_opt_state",
           "sharded_batch", "sharded_cache", "cell_inputs",
           "tree_bytes_per_device", "to_dtensors"]


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A ``meta`` tensor and its sharding on a mesh."""

    value: torch.Tensor
    sharding: Optional[NamedSharding] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def sharded_params(model: Model, mesh, rules: Rules = WEIGHT_RULES):
    def attach(p: Param):
        s = named_sharding(p.dims, tuple(p.value.shape), rules, mesh)
        return Param(Sharded(p.value, s), p.dims)

    return map_params(attach, model.abstract_params())


def sharded_opt_state(params_sds, mesh):
    """Adam moments share the param shardings; count is replicated."""
    def moment(p: Param):
        return Param(Sharded(_meta(p.value.shape, torch.float32),
                             p.value.sharding), p.dims)
    return {
        "m": map_params(moment, params_sds),
        "v": map_params(moment, params_sds),
        "count": Sharded(_meta((), torch.int32), NamedSharding(mesh, ())),
    }


def sharded_batch(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  rules: Rules = ACT_RULES) -> Dict:
    return {name: Sharded(t, named_sharding(batch_dims(name, t.dim()),
                                            tuple(t.shape), rules, mesh))
            for name, t in batch_shapes(cfg, shape).items()}


_CACHE_DIMS = {
    "k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "k_pre": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "v_pre": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "ek": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "ev": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "ssm": ("layers", "batch", "ssm_inner", None, None),
    "conv": ("layers", "batch", None, "ssm_inner"),
    "pos": (),
}


def sharded_cache(model: Model, shape: ShapeSpec, mesh,
                  rules: Rules = CACHE_RULES) -> Dict:
    """The decode cache; its host-side ``pos`` stands as the int32
    scalar the reference's cache holds."""
    acache = model.abstract_cache(shape.global_batch, shape.seq_len)
    out = {}
    for name, t in acache.items():
        if not isinstance(t, torch.Tensor):
            t = _meta((), torch.int32)
        dims = _CACHE_DIMS.get(name, (None,) * t.dim())
        out[name] = Sharded(t, named_sharding(dims, tuple(t.shape), rules,
                                              mesh))
    return out


def cell_inputs(model: Model, shape: ShapeSpec, mesh,
                weight_rules: Rules = WEIGHT_RULES,
                act_rules: Rules = ACT_RULES,
                cache_rules: Rules = CACHE_RULES) -> Tuple:
    """Args tuple for the cell's step function:
    train  -> (params, opt_state, batch)
    prefill-> (params, batch)
    decode -> (params, cache, token_batch)"""
    params = sharded_params(model, mesh, weight_rules)
    if shape.kind == "train":
        opt = sharded_opt_state(params, mesh)
        batch = sharded_batch(model.cfg, shape, mesh, act_rules)
        return (params, opt, batch)
    if shape.kind == "prefill":
        batch = sharded_batch(model.cfg, shape, mesh, act_rules)
        return (params, batch)
    if shape.kind == "decode":
        cache = sharded_cache(model, shape, mesh, cache_rules)
        batch = sharded_batch(model.cfg, shape, mesh, act_rules)
        return (params, cache, batch["token"])
    raise ValueError(shape.kind)


def _leaves(tree):
    if isinstance(tree, Sharded):
        yield tree
    elif isinstance(tree, Param):
        yield from _leaves(tree.value)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)


def tree_bytes_per_device(tree, mesh) -> int:
    """Analytic per-device bytes of a `Sharded` tree: each leaf's bytes
    over the product of the mesh dims its spec names (the reference's
    arithmetic, integer division per leaf)."""
    sizes = mesh_sizes(mesh)
    n = 0
    for leaf in _leaves(tree):
        total = math.prod(leaf.shape) * leaf.value.element_size()
        shards = 1
        if leaf.sharding is not None:
            for entry in leaf.sharding.spec:
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                for a in axes:
                    shards *= sizes.get(a, 1)
        n += total // max(shards, 1)
    return n


def to_dtensors(tree):
    """The `Sharded` tree as ``meta`` DTensors on its mesh, each rank's
    shard only (for the dry-run's step on a fake process group); Params
    keep their dims."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, Sharded):
        return distribute_tensor(tree.value, tree.sharding.mesh,
                                 tree.sharding.placements,
                                 src_data_rank=None)
    if isinstance(tree, Param):
        return Param(to_dtensors(tree.value), tree.dims)
    if isinstance(tree, dict):
        return {k: to_dtensors(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_dtensors(v) for v in tree)
    return tree
