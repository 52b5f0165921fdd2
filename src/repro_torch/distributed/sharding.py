"""Logical-axis sharding rules with divisibility fallback.

Every parameter and constrained activation carries a tuple of
*logical* dimension names (``("embed", "heads", "head_dim")``).  A rule
table maps logical names to mesh-axis candidates; `logical_spec`
assigns, per tensor, the first candidate whose mesh-axis product
divides the dimension, never reusing a mesh axis within one tensor,
and falls back to replication otherwise — the reference's tables and
resolver, value for value.  Its mesh is a torch ``DeviceMesh`` (read
through ``mesh_dim_names`` and ``shape``) or anything with
``axis_names`` and ``devices.shape``; it returns the tuple of per-dim
assignments the reference's ``PartitionSpec`` holds.

A `NamedSharding` is that tuple on a mesh; its ``placements`` give one
``Shard(dim)`` or ``Replicate()`` per mesh dim, the DTensor layout of
the same assignment.  A multi-axis candidate such as ``("pod",
"data")`` shards one tensor dim over both mesh dims, the first axis
major, as JAX splits it; DTensor orders the shards of one tensor dim by
mesh dim, so the axes must appear in mesh order (the rule tables' do).

`Sharder` keeps the reference's call sites — every layer names the
logical layout of what it produces.  Without a mesh it passes each
tensor through unchanged; on a mesh ``act`` and ``cache`` redistribute
a DTensor to the rule's placements, the counterpart of the reference's
``with_sharding_constraint``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["Rules", "WEIGHT_RULES", "ACT_RULES", "ACT_RULES_SP",
           "CACHE_RULES", "CACHE_RULES_SEQSHARD", "logical_spec",
           "NamedSharding", "named_sharding", "Sharder", "tree_shardings",
           "mesh_sizes", "place", "local", "settle", "per_shard"]

AxisCand = Union[str, Tuple[str, ...]]
Rule = Tuple[str, Tuple[AxisCand, ...]]
Rules = Tuple[Rule, ...]

WEIGHT_RULES: Rules = (
    ("vocab", ("model",)),
    ("embed", ("data",)),          # FSDP / ZeRO-3 weight sharding
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("head_dim", ("model",)),      # TP fallback when heads indivisible
    ("mlp", ("model",)),
    ("experts", ("model",)),       # expert parallelism
    ("expert_mlp", ("model",)),    # within-expert TP fallback
    ("ssm_inner", ("model",)),
    ("state", ()),
    ("conv", ()),
)

ACT_RULES: Rules = (
    ("batch", (("pod", "data"), "data")),
    ("seq", ()),
    ("embed", ()),
    ("heads", ("model",)),
    # kv activations stay replicated over model: they broadcast up to the
    # TP-sharded q-head axis locally (Megatron GQA recipe)
    ("kv_heads", ()),
    ("head_dim", ()),
    ("mlp", ("model",)),
    ("experts", ("model",)),
    ("expert_mlp", ("model",)),
    ("moe_capacity", (("pod", "data"), "data")),
    ("vocab", ("model",)),
    ("ssm_inner", ("model",)),
    ("state", ()),
    ("residual_seq", ()),          # block-boundary residual stream
)

# Megatron-style sequence parallelism: the residual stream between blocks
# sharded over the model axis
ACT_RULES_SP: Rules = tuple(
    (("residual_seq", ("model",)) if name == "residual_seq"
     else (name, cands))
    for name, cands in ACT_RULES)

# decode caches: kv-heads sharded (head_dim fallback); the seq-sharded
# variant is the split-KV / flash-decoding layout
CACHE_RULES: Rules = (
    ("batch", (("pod", "data"), "data")),
    ("kv_heads", ("model",)),
    ("head_dim", ("model",)),
    ("cache_seq", ()),
    ("state", ()),
    ("ssm_inner", ("model",)),
    ("layers", ()),
)

CACHE_RULES_SEQSHARD: Rules = (
    ("batch", (("pod", "data"), "data")),
    ("cache_seq", ("model",)),
    ("kv_heads", ()),
    ("head_dim", ()),
    ("state", ()),
    ("ssm_inner", ("model",)),
    ("layers", ()),
)


def _axes_of(c: AxisCand) -> Tuple[str, ...]:
    return c if isinstance(c, tuple) else (c,)


def logical_spec(dims: Sequence[Optional[str]], shape: Sequence[int],
                 rules: Rules, mesh) -> Tuple[Optional[AxisCand], ...]:
    """Resolve logical dims -> the per-dim mesh-axis assignments of a
    concrete shape (trailing unassigned dims dropped, as in a
    ``PartitionSpec``)."""
    if len(dims) != len(shape):
        raise ValueError(f"dims {dims} do not match shape {shape}")
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for dname, size in zip(dims, shape):
        assigned = None
        if dname is not None:
            for ld, cands in rules:
                if ld != dname:
                    continue
                for cand in cands:
                    axs = _axes_of(cand)
                    if any(a in used or a not in sizes for a in axs):
                        continue
                    n = math.prod(sizes[a] for a in axs)
                    if n > 1 and size % n == 0:
                        assigned = cand
                        used.update(axs)
                        break
                break  # first matching rule only
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a torch ``DeviceMesh`` or of anything with
    ``axis_names`` and ``devices.shape`` (the reference's mesh)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A `logical_spec` tuple on a mesh (the reference's
    ``NamedSharding(mesh, PartitionSpec(*spec))``)."""

    mesh: Any
    spec: Tuple[Optional[AxisCand], ...]

    @property
    def placements(self) -> tuple:
        """One ``Shard(tensor dim)`` or ``Replicate()`` per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        sizes = mesh_sizes(self.mesh)
        names = list(sizes)
        out: list = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            idx = [names.index(a) for a in _axes_of(entry)]
            if idx != sorted(idx):
                raise ValueError(
                    f"spec entry {entry} is not in mesh order {names}: "
                    f"DTensor shards one tensor dim over mesh dims in "
                    f"mesh order")
            for i in idx:
                # a shard over a mesh dim of size 1 is the whole tensor:
                # written Replicate, the layout DTensor's ops produce
                if sizes[names[i]] > 1:
                    out[i] = Shard(dim)
        return tuple(out)


def named_sharding(dims: Sequence[Optional[str]], shape: Sequence[int],
                   rules: Rules, mesh) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(dims, shape, rules, mesh))


def tree_shardings(mesh, tree_shapes, tree_dims, rules: Rules):
    """A nested dict of shapes (tensors or anything with ``.shape``) and
    a matching dict of dim tuples -> a dict of `NamedSharding`."""
    if isinstance(tree_shapes, dict):
        return {k: tree_shardings(mesh, v, tree_dims[k], rules)
                for k, v in tree_shapes.items()}
    return named_sharding(tree_dims, tree_shapes.shape, rules, mesh)


def place(x, sharding: NamedSharding):
    """``x`` laid out by ``sharding``: a DTensor is redistributed (the
    collective the layout change needs); a plain tensor — the same
    global value on every rank, as a host batch or a parameter tree
    loaded on every rank is — is distributed without communication,
    each rank keeping its own shard."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = sharding.placements
    if isinstance(x, DTensor):
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(sharding.mesh, pl)
    return distribute_tensor(x, sharding.mesh, pl, src_data_rank=None)


def settle(x):
    """A DTensor with every pending (``Partial``) placement reduced to
    ``Replicate()``, its shards kept; anything else as is.  For a result
    DTensor cannot carry through the next op in its pending form (a
    gather along a sharded dim leaves a masked partial that no view
    keeps)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def per_shard(fn, placements, *xs, whole: Sequence[int] = ()):
    """``fn`` run on each rank's shards, for an ``fn`` whose every output
    element depends only on the inputs at the same index of the tensor
    dims ``placements`` shards (batch, heads): each DTensor among ``xs``
    is laid out by ``placements``, except those at the indices in
    ``whole``, which go whole (``Replicate()``) and take back a gradient
    partial over the mesh dims ``placements`` shards, each rank adding
    its shards' part.  ``fn`` runs on the local tensors and each tensor
    it returns is a DTensor of ``placements``.  Plain ``xs`` (a mask
    bias, the same on every rank) pass as they are; without DTensors it
    is ``fn(*xs)``.

    The attention core, the SSD block, the embedding lookup and the
    projections of heads the rules leave whole run so; each call site
    says which DTensor rule it works around."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = next((x.device_mesh for x in xs if isinstance(x, DTensor)),
                None)
    if mesh is None:
        return fn(*xs)
    pl = tuple(placements)
    rep = (Replicate(),) * mesh.ndim
    grad_pl = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    args = []
    for i, x in enumerate(xs):
        if not isinstance(x, DTensor):
            args.append(x)
        elif i in whole:
            args.append(x.redistribute(mesh, rep).to_local(
                grad_placements=grad_pl))
        else:
            args.append(x.redistribute(mesh, pl).to_local())

    def back(y):
        if isinstance(y, (tuple, list)):
            return type(y)(back(t) for t in y)
        if isinstance(y, torch.Tensor):
            return DTensor.from_local(y, mesh, pl, run_check=False)
        return y
    return back(fn(*args))


def local(fn, *xs):
    """``fn`` on whole operands: every DTensor among ``xs`` is gathered
    to ``Replicate()`` (the all-gather GSPMD inserts around an op it
    cannot partition), ``fn`` runs on the local copies, and each tensor
    it returns goes back on the mesh replicated.  For ops DTensor has no
    sharding rule for; autograd flows through.  Without DTensors it is
    ``fn(*xs)``."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next((x.device_mesh for x in xs if isinstance(x, DTensor)),
                None)
    if mesh is None:
        return fn(*xs)
    return per_shard(fn, (Replicate(),) * mesh.ndim, *xs)


class Sharder:
    """Threaded through model code; a pass-through without a mesh."""

    def __init__(self, mesh=None, act_rules: Rules = ACT_RULES,
                 cache_rules: Rules = CACHE_RULES,
                 weight_rules: Rules = WEIGHT_RULES):
        self.mesh = mesh
        self.act_rules = act_rules
        self.cache_rules = cache_rules
        self.weight_rules = weight_rules

    def act(self, x, dims: Sequence[Optional[str]]):
        if self.mesh is None:
            return x
        return place(x, named_sharding(dims, x.shape, self.act_rules,
                                       self.mesh))

    def cache(self, x, dims: Sequence[Optional[str]]):
        if self.mesh is None:
            return x
        return place(x, named_sharding(dims, x.shape, self.cache_rules,
                                       self.mesh))

    def batch_placements(self, x) -> Optional[tuple]:
        """The placements of ``x`` sharded over its leading (batch) dim
        by the activation rules, every other dim whole; None without a
        mesh."""
        if self.mesh is None:
            return None
        return named_sharding(("batch",) + (None,) * (x.dim() - 1),
                              x.shape, self.act_rules,
                              self.mesh).placements

    def weight_sharding(self, dims, shape) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return named_sharding(dims, shape, self.weight_rules, self.mesh)
