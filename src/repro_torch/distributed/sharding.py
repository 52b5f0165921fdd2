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
tensor through unchanged; on a mesh ``act`` and ``cache`` lay a local
shard out by the rule's placements, the counterpart of the reference's
``with_sharding_constraint``.

The meshed steps — training, prefill and decode — run as the reference's
compiled SPMD program runs: one local program per rank
(`make_train_step`, `make_serve_fns`).  Its tensors are
the ranks' plain local shards; each one a mesh site takes or makes
carries its place on the mesh as a `Lay` (`tag`, `layout`: the mesh,
one placement per mesh dim, the global shape, and for a parameter its
index in the tree).  Between two sites the model runs plain torch ops
on them, and `like` hands an op's result its input's `Lay`.  At a site
(`Sharder.act`, `settle`, `shard_map` and what is built on it) a layout
change is one explicit collective on the mesh dim it crosses —
all-gather, reduce-scatter, all-reduce or all-to-all (`relayout`) —
written as an autograd function whose backward runs the transposed
one.  A site whose work is split along a mesh dim over which an input
is whole hands that input a gradient partial there, and reduces it: an
activation's at once, a parameter's once after the backward (the
data-parallel reduction; `pending_reductions`).  A weight moves in
the type its site computes in: `cast` first, then the collective, as
the reference's program gathers the cast shard and reduces the narrow
gradient.  DTensors stay at the steps' edges (the parameter state,
checkpoints, the int8 gradient compression).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from contextvars import ContextVar
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["Rules", "WEIGHT_RULES", "ACT_RULES", "ACT_RULES_SP",
           "CACHE_RULES", "CACHE_RULES_SEQSHARD", "logical_spec",
           "NamedSharding", "named_sharding", "Sharder", "tree_shardings",
           "mesh_sizes", "place", "local", "settle", "per_shard",
           "shard_map", "shard_einsum", "shard_range", "batch_only",
           "Lay", "tag", "layout", "like", "gshape", "relayout", "cast",
           "weight_like", "shard_mean", "pending_reductions", "layer_of",
           "stack_layers", "whole"]

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
        got = self.__dict__.get("_placements")
        if got is None:
            got = self._resolve()
            object.__setattr__(self, "_placements", got)
        return got

    def _resolve(self) -> tuple:
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


# resolved shardings by (dims, shape, id(rules), id(mesh)): a step
# resolves the same few hundred at every site, every step
_RESOLVED: Dict[tuple, tuple] = {}


def named_sharding(dims: Sequence[Optional[str]], shape: Sequence[int],
                   rules: Rules, mesh) -> NamedSharding:
    key = (tuple(dims), tuple(shape), id(rules), id(mesh))
    hit = _RESOLVED.get(key)
    if hit is not None and hit[0] is rules and hit[1] is mesh:
        return hit[2]
    out = NamedSharding(mesh, logical_spec(dims, shape, rules, mesh))
    if len(_RESOLVED) > 4096:
        _RESOLVED.clear()
    _RESOLVED[key] = (rules, mesh, out)
    return out


def tree_shardings(mesh, tree_shapes, tree_dims, rules: Rules):
    """A nested dict of shapes (tensors or anything with ``.shape``) and
    a matching dict of dim tuples -> a dict of `NamedSharding`."""
    if isinstance(tree_shapes, dict):
        return {k: tree_shardings(mesh, v, tree_dims[k], rules)
                for k, v in tree_shapes.items()}
    return named_sharding(tree_dims, tree_shapes.shape, rules, mesh)


# ---------------------------------------------------------------------------
# the local program: tagged local shards and explicit collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Lay:
    """A local tensor's place on a mesh: one placement per mesh dim
    (``Shard(d)``, ``Replicate()`` or ``Partial()``, DTensor's types),
    the global shape, and for a parameter's shard its index in the
    parameter tree (``key``: its gradient's pending reductions)."""

    mesh: Any
    placements: tuple
    shape: tuple
    key: Optional[int] = None


_TAG = "_repro_lay"


def tag(x, lay: Lay):
    """``x`` (a plain tensor) with ``lay`` attached; returns ``x``."""
    setattr(x, _TAG, lay)
    return x


def layout(x) -> Optional[Lay]:
    """A tagged local tensor's `Lay`; None for anything else (a plain
    tensor off the mesh, or the same on every rank)."""
    return getattr(x, _TAG, None)


def gshape(x) -> tuple:
    """The global shape of ``x``: a tagged local tensor's `Lay` shape,
    else ``x.shape``."""
    lay = getattr(x, _TAG, None)
    return tuple(lay.shape) if lay is not None else tuple(x.shape)


def _global_of(local_shape, placements, mesh) -> tuple:
    out = list(local_shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] *= mesh.shape[i]
    return tuple(out)


def _tag_out(y, mesh, placements):
    return tag(y, Lay(mesh, tuple(placements),
                      _global_of(y.shape, placements, mesh)))


def like(y, x):
    """``y`` tagged with ``x``'s placements (its global shape by them):
    for a plain op's result that keeps its input's layout.  ``y`` as is
    when ``x`` is no tagged local."""
    lay = getattr(x, _TAG, None)
    if lay is None:
        return y
    if any(p.is_partial() for p in lay.placements):
        raise ValueError("an op on a pending sum: settle it first")
    return _tag_out(y, lay.mesh, lay.placements)


def cast(x, dtype):
    """``x`` in ``dtype``, a tagged local's `Lay` kept whole — a
    parameter's cast keeps its key, so its gradient's pending reductions
    are still recorded; ``x`` itself when it is of ``dtype`` already (a
    float32 run casts nothing).  Under autograd the cast's backward
    widens the gradient on the shard, after the collectives that moved
    it in ``dtype``."""
    if x.dtype == dtype:
        return x
    lay = getattr(x, _TAG, None)
    y = x.to(dtype)
    return y if lay is None else tag(y, lay)


# a step's pending reductions of parameter gradients: {key: {mesh dim:
# the type the gradient is reduced in}}
_PENDING: "ContextVar[Optional[Dict[int, Dict[int, torch.dtype]]]]" = \
    ContextVar("repro_torch_pending_reductions", default=None)


@contextlib.contextmanager
def pending_reductions():
    """Within it a parameter shard (a tagged local with a ``key``) that a
    site uses whole along a mesh dim over which the site's work is
    split leaves its gradient partial there, and the dims are recorded
    in the dict it yields ({key: {mesh dim: type}}) for the step to
    reduce once after the backward — the data-parallel reduction — in
    the type the site used the parameter in (float32 where any site
    used it so).  Outside it the site reduces the gradient at once."""
    pend: Dict[int, Dict[int, torch.dtype]] = {}
    tok = _PENDING.set(pend)
    try:
        yield pend
    finally:
        _PENDING.reset(tok)


def _wait(t):
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _gather(x, d: int, group):
    import torch.distributed._functional_collectives as funcol
    return _wait(funcol.all_gather_tensor(x.contiguous(), d, group))


def _reduce(x, group):
    import torch.distributed._functional_collectives as funcol
    return _wait(funcol.all_reduce(x.contiguous(), "sum", group))


def _scatter(x, d: int, group):
    import torch.distributed._functional_collectives as funcol
    return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", d,
                                              group))


def _all_to_all(x, src: int, dst: int, group, n: int):
    """Move a shard from tensor dim ``src`` to ``dst``: every rank sends
    piece j of its ``dst`` dim to rank j and joins what it gets along
    ``src``."""
    import torch.distributed._functional_collectives as funcol
    parts = torch.stack(x.chunk(n, dim=dst)).contiguous()
    got = _wait(funcol.all_to_all_single(parts, None, None, group))
    return torch.cat(got.unbind(0), dim=src)


def _relayout(x, mesh, src: tuple, dst: tuple):
    """``x`` (a local shard laid out by ``src``) laid out by ``dst``,
    one collective on each mesh dim whose placement changes: Partial ->
    Shard a reduce-scatter, Partial -> Replicate an all-reduce, Shard ->
    Replicate an all-gather, Shard -> Shard an all-to-all, Replicate ->
    Shard a local slice; Partial -> Partial and Replicate -> Partial
    keep the summand.  The reductions run first and the gathers last,
    so each collective moves the smallest piece; a tensor dim split
    over several mesh dims is gathered whole before it is split again,
    the innermost mesh dim first."""
    from torch.distributed.tensor import Replicate
    if tuple(src) == tuple(dst):
        return x
    coord = mesh.get_coordinate()
    rep = Replicate()
    dst = list(dst)

    def dims_of(pl, d):
        return [i for i, p in enumerate(pl) if p.is_shard() and p.dim == d]

    # tensor dims whose shards move across several mesh dims: whole first
    tangled = {p.dim for pl in (src, dst) for p in pl if p.is_shard()
               and (len(dims_of(src, p.dim)) > 1
                    or len(dims_of(dst, p.dim)) > 1)
               and dims_of(src, p.dim) != dims_of(dst, p.dim)}
    cur = list(src)
    # the pending sums: reduce-scattered where one mesh dim alone shards
    # the target dim, else all-reduced
    for i in range(mesh.ndim):
        s, t = cur[i], dst[i]
        if not s.is_partial() or t.is_partial():
            continue
        if t.is_shard() and t.dim not in tangled and \
                len(dims_of(dst, t.dim)) == 1 and not dims_of(cur, t.dim):
            x = _scatter(x, t.dim, (mesh, i))
            cur[i] = t
        else:
            x = _reduce(x, (mesh, i))
            cur[i] = rep
    for i in reversed(range(mesh.ndim)):
        s, t = cur[i], dst[i]
        if s == t or not s.is_shard():
            continue
        group, n = (mesh, i), mesh.shape[i]
        if t.is_shard() and s.dim not in tangled and t.dim not in tangled:
            x = _all_to_all(x, s.dim, t.dim, group, n)
            cur[i] = t
        else:
            x = _gather(x, s.dim, group)
            cur[i] = rep
    for i in range(mesh.ndim):
        s, t = cur[i], dst[i]
        if s == t or t.is_partial():
            continue
        if s.is_replicate() and t.is_shard():
            x = x.chunk(mesh.shape[i], dim=t.dim)[coord[i]]
        else:
            raise ValueError(f"no relayout from {src} to {dst}")
    return x


class _Relayout(torch.autograd.Function):
    """`_relayout` under autograd.  The backward takes the gradient,
    which is whole on the mesh dims ``pgrad`` does not name and partial
    on those it does, back to ``src``: the transposed collectives.  A
    partial gradient of a source whole along a mesh dim is summed there,
    unless that dim is in ``keep``, where it stays partial (a
    parameter's, reduced after the backward)."""

    @staticmethod
    def forward(ctx, x, mesh, src, dst, pgrad, keep):
        ctx.args = (mesh, src, dst, pgrad, keep)
        return _relayout(x, mesh, src, dst)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate
        mesh, src, dst, pgrad, keep = ctx.args
        have = tuple(Partial() if i in pgrad else p
                     for i, p in enumerate(dst))
        want = tuple(Partial() if i in keep else
                     (Replicate() if p.is_partial() else p)
                     for i, p in enumerate(src))
        return (_relayout(g, mesh, have, want), None, None, None, None,
                None)


def relayout(x, placements, pgrad: Sequence[int] = ()):
    """A tagged local ``x`` laid out by ``placements`` (tagged), under
    autograd; ``pgrad`` names the mesh dims along which the consumer's
    gradient comes back partial (its work split there, ``x`` whole).
    A parameter's shard keeps such a gradient partial on the dims it is
    whole over, for the step's data-parallel reduction, when a
    `pending_reductions` is open."""
    lay = getattr(x, _TAG)
    if not pgrad and lay.placements == tuple(placements):
        return x                    # no collective either way
    src, dst = tuple(lay.placements), tuple(placements)
    pgrad = tuple(sorted(set(pgrad)))
    keep: tuple = ()
    pend = _PENDING.get()
    if lay.key is not None and pend is not None:
        keep = tuple(i for i in pgrad if src[i].is_replicate())
        got = pend.setdefault(lay.key, {}) if keep else None
        for i in keep:
            # a float32 use widens the reduction of every use
            got[i] = torch.promote_types(got.get(i, x.dtype), x.dtype)
    if src == dst and not (set(pgrad) - set(keep)):
        return x
    y = _Relayout.apply(x, lay.mesh, src, dst, pgrad, keep)
    return tag(y, Lay(lay.mesh, dst, lay.shape))


def layer_of(v, stacked):
    """``v``, one layer of a stacked parameter or cache (``stacked[i]``),
    a tagged local again when ``stacked`` is: its placements' tensor dims
    shifted past the layers dim (never sharded), its key kept."""
    lay = getattr(stacked, _TAG, None)
    if lay is None:
        return v
    from torch.distributed.tensor import Shard
    if any(p.is_shard() and p.dim == 0 for p in lay.placements):
        raise ValueError("a stacked parameter sharded over its layers")
    pl = tuple(Shard(p.dim - 1) if p.is_shard() else p
               for p in lay.placements)
    return tag(v, Lay(lay.mesh, pl, tuple(lay.shape[1:]), lay.key))


def stack_layers(vs):
    """``torch.stack(vs)`` of one tensor a layer (a stacked cache), a
    tagged local again when they are: the layers dim whole, each
    placement's tensor dim shifted past it (`layer_of` takes a layer
    back out)."""
    out = torch.stack(vs)
    lay = getattr(vs[0], _TAG, None)
    if lay is None:
        return out
    if any(getattr(v, _TAG, None) != lay for v in vs) or \
            any(p.is_partial() for p in lay.placements):
        raise ValueError("layers stacked from different layouts or "
                         "pending sums")
    from torch.distributed.tensor import Shard
    pl = tuple(Shard(p.dim + 1) if p.is_shard() else p
               for p in lay.placements)
    return tag(out, Lay(lay.mesh, pl, (len(vs),) + tuple(lay.shape)))


def weight_like(w, x):
    """A parameter ``w`` laid out to meet ``x`` in an elementwise op
    (its dims aligned with ``x``'s trailing ones): sharded where ``x``
    is sharded on the aligned dim, whole elsewhere — a gain of an FSDP
    weight is gathered — its gradient reduced over the mesh dims along
    which ``x`` is split and ``w`` whole.  Off the mesh (``x`` no tagged
    local) ``w`` as is."""
    xl = getattr(x, _TAG, None)
    if xl is None:
        return w
    from torch.distributed.tensor import Replicate, Shard
    off = len(xl.shape) - len(getattr(w, _TAG).shape)
    pl, pgrad = [], []
    for i, p in enumerate(xl.placements):
        if p.is_shard() and p.dim >= off:
            pl.append(Shard(p.dim - off))
        else:
            pl.append(Replicate())
            if not p.is_replicate():
                pgrad.append(i)
    return relayout(w, tuple(pl), pgrad)


def shard_mean(x):
    """The mean of every element of ``x``.  A tagged local's: its
    elements' sum over the global count, summed over the mesh dims that
    shard it (an all-reduce; each rank's gradient is its own rows'),
    whole on every rank; anything else ``x.mean()``."""
    lay = getattr(x, _TAG, None)
    if lay is None:
        return x.mean()
    from torch.distributed.tensor import Partial, Replicate
    if any(p.is_partial() for p in lay.placements):
        raise ValueError("the mean of a pending sum: settle it first")
    part = x.sum() / math.prod(lay.shape)
    pl = tuple(Partial() if p.is_shard() else Replicate()
               for p in lay.placements)
    return whole(tag(part, Lay(lay.mesh, pl, ())))


def whole(x):
    """A tagged local's whole value as a plain tensor, the same on every
    rank (its shards gathered, its pending sums reduced); anything else
    as is."""
    lay = getattr(x, _TAG, None)
    if lay is None:
        return x
    from torch.distributed.tensor import Replicate
    out = relayout(x, (Replicate(),) * len(lay.placements))
    return out.view_as(out)          # a new tensor: no tag


def place(x, sharding: NamedSharding):
    """A tagged local ``x`` laid out by ``sharding`` (`relayout`)."""
    if layout(x) is None:
        raise ValueError(f"a local tensor {tuple(x.shape)} without a "
                         f"layout reached a mesh site")
    return relayout(x, sharding.placements)


def settle(x, split=None):
    """A tagged local with every pending (``Partial``) placement reduced
    to ``Replicate()``, its shards kept; anything else as is — for a
    result the next plain op cannot take in its pending form.  ``split``
    names a tensor the result meets in elementwise ops: along the mesh
    dims where that one is sharded and the result whole, the result's
    gradient comes back partial and is summed there."""
    from torch.distributed.tensor import Replicate
    lay = layout(x)
    if lay is None or not any(p.is_partial() for p in lay.placements):
        return x
    pl = [Replicate() if p.is_partial() else p for p in lay.placements]
    other = layout(split) if split is not None else None
    pgrad = [] if other is None else [
        i for i, (p, q) in enumerate(zip(pl, other.placements))
        if p.is_replicate() and not q.is_replicate()]
    return relayout(x, pl, pgrad)


# `shard_map`'s layout plans by (in, out and grad placements, inputs,
# id(mesh)): a step lays out the same few dozen sites at every step
_MAP_PLANS: Dict[tuple, tuple] = {}


def _map_plan(in_placements, out_placements, grad_placements, n: int,
              mesh):
    """(the outputs' placements, one per output; per input None, or
    (its placements, the mesh dims where its gradient is partial))."""
    ins = tuple(None if pl is None else tuple(pl) for pl in in_placements)
    single = not isinstance(out_placements[0], (tuple, list))
    outs = tuple(out_placements) if single else tuple(
        tuple(p) for p in out_placements)
    grads = (tuple(None if g is None else tuple(g) for g in grad_placements)
             if grad_placements is not None else None)
    key = (ins, outs, single, grads, n, id(mesh))
    hit = _MAP_PLANS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1], hit[2]
    outs = [outs] if single else list(outs)
    busy = [any(not o[i].is_replicate() for o in outs)
            for i in range(mesh.ndim)]
    if any(busy[i] and any(o[i].is_replicate() for o in outs)
           for i in range(mesh.ndim)):
        raise ValueError(f"outputs {outs} mix replicated and partitioned "
                         f"layouts along one mesh dim")
    plan = []
    for pl, grad in zip(ins, grads or [None] * n):
        if pl is None:
            plan.append(None)
        elif grad is not None:
            plan.append((pl, [i for i, g in enumerate(grad)
                              if g.is_partial()]))
        else:
            plan.append((pl, [i for i, p in enumerate(pl)
                              if not p.is_shard() and busy[i]]))
    if len(_MAP_PLANS) > 4096:
        _MAP_PLANS.clear()
    _MAP_PLANS[key] = (mesh, outs, tuple(plan))
    return outs, tuple(plan)


def shard_map(fn, in_placements, out_placements, *xs, mesh=None,
              grad_placements=None):
    """``fn`` on each rank's local shards, every layout given, as JAX's
    ``shard_map``: each tagged local among ``xs`` is laid out by its
    entry of ``in_placements`` (`relayout`; a plain tensor there, the
    same on every rank, is whole; an entry of None passes its argument
    as it is), ``fn`` runs on the local tensors, and each tensor it
    returns is tagged with ``out_placements`` (one tuple for every
    output, or a list with one tuple per output; ``Partial()`` where the
    outputs of the ranks along a mesh dim are summands).

    Gradients: an input sharded along a mesh dim takes its gradient
    sharded there; one replicated along a mesh dim along which the
    outputs are sharded or partial takes a partial gradient (each rank
    adds its own part), and one replicated where the outputs are too
    takes a replicated one — so along a mesh dim the outputs must be
    all replicated or none.  ``grad_placements`` (one entry per input,
    None for the rule) overrides that, for an ``fn`` whose backward
    splits work the forward repeats.  Without a mesh it is
    ``fn(*xs)``."""
    from torch.distributed.tensor import Replicate
    if mesh is None:
        mesh = next((layout(x).mesh for x in xs if layout(x) is not None),
                    None)
    if mesh is None:
        return fn(*xs)
    outs, plan = _map_plan(in_placements, out_placements, grad_placements,
                           len(xs), mesh)
    args = []
    for x, entry in zip(xs, plan):
        if entry is None or not isinstance(x, torch.Tensor):
            args.append(x)
            continue
        pl, pgrad = entry
        if layout(x) is None:           # the same on every rank
            x = tag(x.view_as(x), Lay(mesh, (Replicate(),) * mesh.ndim,
                                      tuple(x.shape)))
        args.append(relayout(x, pl, pgrad))
    n_out = [0]

    def back(y):
        if isinstance(y, (tuple, list)):
            return type(y)(back(t) for t in y)
        if isinstance(y, torch.Tensor):
            pl = outs[min(n_out[0], len(outs) - 1)]
            n_out[0] += 1
            return _tag_out(y, mesh, pl)
        return y
    return back(fn(*args))


def per_shard(fn, placements, *xs, whole: Sequence[int] = ()):
    """``fn`` run on each rank's shards, for an ``fn`` whose every output
    element depends only on the inputs at the same index of the tensor
    dims ``placements`` shards (batch, heads): each tagged local among
    ``xs`` is laid out by ``placements``, except those at the indices in
    ``whole``, which go whole (``Replicate()``) and take back a gradient
    partial over the mesh dims ``placements`` shards.  ``fn`` runs on
    the local tensors and each tensor it returns is tagged with
    ``placements``.  Plain ``xs`` (a mask bias, the same on every rank)
    pass as they are; off the mesh it is ``fn(*xs)`` (`shard_map` with
    one layout)."""
    from torch.distributed.tensor import Replicate
    mesh = next((layout(x).mesh for x in xs if layout(x) is not None),
                None)
    if mesh is None:
        return fn(*xs)
    pl = tuple(placements)
    ins = [None if layout(x) is None
           else (Replicate(),) * mesh.ndim if i in whole else pl
           for i, x in enumerate(xs)]
    return shard_map(fn, ins, pl, *xs, mesh=mesh)


def local(fn, *xs):
    """``fn`` on whole operands: every tagged local among ``xs`` is
    gathered to ``Replicate()`` (the all-gather GSPMD inserts around an
    op it cannot partition), ``fn`` runs on the whole copies, and each
    tensor it returns is tagged replicated.  Only the tuned ops' call
    sites use it (a kernel takes whole operands, as the reference's
    Pallas calls do under GSPMD).  Off the mesh it is ``fn(*xs)``."""
    from torch.distributed.tensor import Replicate
    mesh = next((layout(x).mesh for x in xs if layout(x) is not None),
                None)
    if mesh is None:
        return fn(*xs)
    return per_shard(fn, (Replicate(),) * mesh.ndim, *xs)


def shard_einsum(eq: str, x, w, whole: Sequence[int] = ()):
    """``einsum(eq, x, w)`` with ``w`` cast to ``x``'s type.  On a
    mesh, the layout along each mesh dim is read off the operands,
    as the reference's FSDP x tensor-parallel program runs: where ``x``
    is sharded along a dim the weight is not (a batch shard against the
    weight's FSDP ``embed`` shard) the weight is gathered (``x`` is,
    where its shard is of a contracted dim); a dim sharded
    on either side stays sharded in the result, or, contracted, leaves
    it partial over that mesh dim (the other operand then takes the
    matching shard, a local slice when it was whole).  The product runs
    on local tensors (`shard_map`), in the backward too: each rank does
    its shard's share of the work, never a whole weight's.  The weight
    is cast to ``x``'s type before it moves (`cast`), as the reference's
    program gathers the cast: a float32 master moves in bf16, and its
    gradient is reduced in bf16 and widened on the shard.

    Along the mesh dims ``whole`` (one at most), where both operands are
    whole, the result is whole on every rank, the product repeated; the
    backward stays split there, each rank forming the weight's gradient
    on its part of the weight's first dim only (partial over the dim),
    which ``x`` contracts.  The reference's compiled program runs so
    where a layout leaves the lm head's result whole (a vocab the model
    dim does not divide)."""
    if layout(x) is None and layout(w) is None:
        return torch.einsum(eq, x, w.to(x.dtype))
    mesh = (layout(x) or layout(w)).mesh
    x, w = settle(x), cast(settle(w), x.dtype)
    lx, lw = layout(x), layout(w)
    px, pw, po, xgrad, grad, cut_dim = _einsum_plan(
        eq, lx.placements if lx is not None else None,
        lw.placements if lw is not None else None, tuple(whole), mesh)
    if cut_dim is None:
        return shard_map(lambda xx, ww: torch.einsum(eq, xx, ww),
                         (px, pw), po, x, w, mesh=mesh)
    # torch.chunk's split of the weight's first dim
    size, k = gshape(w)[0], mesh.shape[cut_dim]
    lo = min(mesh.get_coordinate()[cut_dim] * -(-size // k), size)
    cut = (lo, min(-(-size // k), size - lo))
    return shard_map(lambda xx, ww: _SlicedWeightGrad.apply(
        eq, xx, ww, *cut), (px, pw), po, x, w, mesh=mesh,
        grad_placements=[xgrad, grad])


# `shard_einsum`'s layout plans by (equation, operand placements, whole,
# id(mesh))
_EINSUM_PLANS: Dict[tuple, tuple] = {}


def _einsum_plan(eq: str, xpl, wpl, whole: tuple, mesh):
    """`shard_einsum`'s layouts along each mesh dim, read off the
    operands' placements: (x's, w's, the result's, x's gradient's, w's
    gradient's, the mesh dim along which the weight's gradient is cut,
    or None)."""
    key = (eq, xpl, wpl, whole, id(mesh))
    hit = _EINSUM_PLANS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    from torch.distributed.tensor import Partial, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    if len(whole) > 1:
        raise ValueError(f"a weight gathered along {len(whole)} mesh dims "
                         f"(one at most)")
    px, pw, po, grad, xgrad, cut_dim = [], [], [], [], [], None
    for i in range(mesh.ndim):
        lx = (a[xpl[i].dim] if xpl is not None and xpl[i].is_shard()
              else None)
        lw = (b[wpl[i].dim] if wpl is not None and wpl[i].is_shard()
              else None)
        if i in whole:
            if lx is not None or lw is not None or b[0] not in a:
                raise ValueError(f"whole along mesh dim {i} takes whole "
                                 f"operands and a contracted weight dim 0")
            cut_dim = i
            px.append(Replicate()), pw.append(Replicate())
            po.append(Replicate()), grad.append(Partial())
            xgrad.append(Replicate())
            continue
        if lx is not None and lw is not None and lx != lw and lx not in out:
            lx = None        # x's contracted shard against the weight's own
        letter = lx or lw    # x's batch shard wins: the weight gathers
        if letter is None:
            px.append(Replicate()); pw.append(Replicate())
            po.append(Replicate()), grad.append(Replicate())
            xgrad.append(Replicate())
            continue
        px.append(Shard(a.index(letter)) if letter in a else Replicate())
        pw.append(Shard(b.index(letter)) if letter in b else Replicate())
        po.append(Shard(out.index(letter)) if letter in out else Partial())
        grad.append(pw[-1] if pw[-1].is_shard() else Partial())
        xgrad.append(px[-1] if px[-1].is_shard() else Partial())
    plan = (tuple(px), tuple(pw), tuple(po), tuple(xgrad), tuple(grad),
            cut_dim)
    if len(_EINSUM_PLANS) > 4096:
        _EINSUM_PLANS.clear()
    _EINSUM_PLANS[key] = (mesh, plan)
    return plan


class _SlicedWeightGrad(torch.autograd.Function):
    """``einsum(eq, x, w)`` whose backward forms the weight's gradient
    on rows ``[lo, lo + n)`` of its first dim only (zero elsewhere:
    another rank forms the rest); ``x`` contracts that dim, and ``eq``
    has no index that only one operand sums over."""

    @staticmethod
    def forward(ctx, eq, x, w, lo, n):
        ctx.save_for_backward(x, w)
        ctx.args = (eq, lo, n)
        return torch.einsum(eq, x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        eq, lo, n = ctx.args
        ins, out = eq.replace(" ", "").split("->")
        a, b = ins.split(",")
        xs = x.narrow(a.index(b[0]), lo, n)
        dx = torch.einsum(f"{out},{b}->{a}", g, w)
        dw = torch.zeros_like(w)
        dw.narrow(0, lo, n).copy_(torch.einsum(f"{a},{out}->{b}", xs, g))
        return None, dx, dw, None, None


def batch_only(x):
    """A tagged local laid out over its batch (dim 0) shards alone, every
    other shard or pending sum gathered; anything else as is."""
    from torch.distributed.tensor import Replicate
    lay = layout(x)
    if lay is None:
        return x
    return relayout(x, tuple(p if p.is_shard() and p.dim == 0
                             else Replicate() for p in lay.placements))


def shard_range(mesh, placements, dim: int, size: int) -> Tuple[int, int]:
    """(start, length) of this rank's part of tensor dim ``dim`` (of
    ``size``) under ``placements``: the dim is split over every mesh dim
    that shards it, in mesh order, the first major; (0, size) without a
    mesh or a shard of ``dim``."""
    if mesh is None:
        return 0, size
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, p in enumerate(placements):
        if p.is_shard() and p.dim == dim:
            idx, n = idx * mesh.shape[i] + coord[i], n * mesh.shape[i]
    if size % n:
        raise ValueError(f"dim of {size} does not split over {n} ranks")
    return idx * (size // n), size // n


class Sharder:
    """Threaded through model code; a pass-through without a mesh.  On a
    mesh every tensor at a site is a tagged local shard: a plain tensor
    joins the local program only through `enter`."""

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
        return place(x, named_sharding(dims, gshape(x), self.act_rules,
                                       self.mesh))

    def cache(self, x, dims: Sequence[Optional[str]]):
        if self.mesh is None:
            return x
        return place(x, named_sharding(dims, gshape(x), self.cache_rules,
                                       self.mesh))

    def enter(self, x, dims: Sequence[Optional[str]]):
        """A global value laid out by the activation rules: a plain
        tensor (a host batch, the same on every rank) becomes this rank's
        tagged shard (a slice: no communication); a tagged local is laid
        out by the rules."""
        if self.mesh is None:
            return x
        pl = named_sharding(dims, gshape(x), self.act_rules,
                            self.mesh).placements
        if layout(x) is not None:
            return relayout(x, pl)
        from torch.distributed.tensor import Replicate
        part = _relayout(x, self.mesh, (Replicate(),) * self.mesh.ndim, pl)
        return tag(part if part is not x else x.view_as(x),
                   Lay(self.mesh, pl, tuple(x.shape)))

    def rows(self, t, x, dims: Sequence[Optional[str]]):
        """``t``, made by this rank for the rows of ``x`` (its dim 0
        ``x``'s batch rows, the rest whole), laid out as ``dims`` say:
        in the local program tagged with ``x``'s batch layout, else
        `act` (a whole plain tensor joins the mesh)."""
        lay = getattr(x, _TAG, None)
        if lay is None:
            return self.act(t, dims)
        from torch.distributed.tensor import Replicate
        pl = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                   for p in lay.placements)
        return self.act(tag(t, Lay(lay.mesh, pl, _global_of(
            t.shape, pl, lay.mesh))), dims)

    def batch_placements(self, x) -> Optional[tuple]:
        """The placements of ``x`` sharded over its leading (batch) dim
        by the activation rules, every other dim whole; None without a
        mesh."""
        if self.mesh is None:
            return None
        return named_sharding(("batch",) + (None,) * (x.dim() - 1),
                              gshape(x), self.act_rules,
                              self.mesh).placements

    def weight_sharding(self, dims, shape) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return named_sharding(dims, shape, self.weight_rules, self.mesh)
