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
           "mesh_sizes", "place", "local", "settle", "per_shard",
           "shard_map", "shard_einsum", "shard_range", "batch_only"]

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


def shard_map(fn, in_placements, out_placements, *xs, mesh=None,
              grad_placements=None):
    """``fn`` on each rank's local shards, every layout given, as JAX's
    ``shard_map``: each DTensor among ``xs`` is redistributed to its
    entry of ``in_placements`` (a plain tensor there joins the mesh
    replicated first; an entry of None passes its argument as it is),
    ``fn`` runs on the local tensors, and each tensor it returns becomes
    a DTensor of ``out_placements`` (one tuple for every output, or a
    list with one tuple per output; ``Partial()`` where the outputs of
    the ranks along a mesh dim are summands).

    Gradients: an input sharded along a mesh dim takes its gradient
    sharded there; one replicated along a mesh dim along which the
    outputs are sharded or partial takes a partial gradient (each rank
    adds its own part), and one replicated where the outputs are too
    takes a replicated one — so along a mesh dim the outputs must be
    all replicated or none.  ``grad_placements`` (one entry per input,
    None for the rule) overrides that, for an ``fn`` whose backward
    splits work the forward repeats.  Without a mesh it is
    ``fn(*xs)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if mesh is None:
        mesh = next((x.device_mesh for x in xs if isinstance(x, DTensor)),
                    None)
    if mesh is None:
        return fn(*xs)
    from torch.distributed.tensor import Placement
    outs = ([tuple(out_placements)] if isinstance(out_placements[0],
                                                  Placement)
            else [tuple(p) for p in out_placements])
    busy = [any(not o[i].is_replicate() for o in outs)
            for i in range(mesh.ndim)]
    if any(busy[i] and any(o[i].is_replicate() for o in outs)
           for i in range(mesh.ndim)):
        raise ValueError(f"outputs {outs} mix replicated and partitioned "
                         f"layouts along one mesh dim")
    rep = (Replicate(),) * mesh.ndim
    args = []
    grads = grad_placements or [None] * len(xs)
    for x, pl, grad in zip(xs, in_placements, grads):
        if pl is None or not isinstance(x, torch.Tensor):
            args.append(x)
            continue
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, rep, run_check=False)
        pl = tuple(pl)
        grad = tuple(grad) if grad is not None else tuple(
            p if p.is_shard() else Partial() if busy[i] else Replicate()
            for i, p in enumerate(pl))
        if tuple(x.placements) != pl:
            x = x.redistribute(mesh, pl)
        args.append(x.to_local(grad_placements=grad))
    n_out = [0]

    def back(y):
        if isinstance(y, (tuple, list)):
            return type(y)(back(t) for t in y)
        if isinstance(y, torch.Tensor):
            pl = outs[min(n_out[0], len(outs) - 1)]
            n_out[0] += 1
            return DTensor.from_local(y, mesh, pl, run_check=False)
        return y
    return back(fn(*args))


def per_shard(fn, placements, *xs, whole: Sequence[int] = ()):
    """``fn`` run on each rank's shards, for an ``fn`` whose every output
    element depends only on the inputs at the same index of the tensor
    dims ``placements`` shards (batch, heads): each DTensor among ``xs``
    is laid out by ``placements``, except those at the indices in
    ``whole``, which go whole (``Replicate()``) and take back a gradient
    partial over the mesh dims ``placements`` shards.  ``fn`` runs on
    the local tensors and each tensor it returns is a DTensor of
    ``placements``.  Plain ``xs`` (a mask bias, the same on every rank)
    pass as they are; without DTensors it is ``fn(*xs)`` (`shard_map`
    with one layout)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next((x.device_mesh for x in xs if isinstance(x, DTensor)),
                None)
    if mesh is None:
        return fn(*xs)
    pl = tuple(placements)
    ins = [None if not isinstance(x, DTensor)
           else (Replicate(),) * mesh.ndim if i in whole else pl
           for i, x in enumerate(xs)]
    return shard_map(fn, ins, pl, *xs, mesh=mesh)


def local(fn, *xs):
    """``fn`` on whole operands: every DTensor among ``xs`` is gathered
    to ``Replicate()`` (the all-gather GSPMD inserts around an op it
    cannot partition), ``fn`` runs on the local copies, and each tensor
    it returns goes back on the mesh replicated.  Only the tuned ops'
    call sites use it (a kernel takes whole operands, as the
    reference's Pallas calls do under GSPMD).  Without DTensors it is
    ``fn(*xs)``."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next((x.device_mesh for x in xs if isinstance(x, DTensor)),
                None)
    if mesh is None:
        return fn(*xs)
    return per_shard(fn, (Replicate(),) * mesh.ndim, *xs)


def shard_einsum(eq: str, x, w, whole: Sequence[int] = ()):
    """``einsum(eq, x, w)`` with ``w`` cast to ``x``'s type.  On
    DTensors, the layout along each mesh dim is read off the operands,
    as the reference's FSDP x tensor-parallel program runs: where ``x``
    is sharded along a dim the weight is not (a batch shard against the
    weight's FSDP ``embed`` shard) the weight is gathered (``x`` is,
    where its shard is of a contracted dim); a dim sharded
    on either side stays sharded in the result, or, contracted, leaves
    it partial over that mesh dim (the other operand then takes the
    matching shard, a local slice when it was whole).  The product runs
    on local tensors (`shard_map`), so no DTensor strategy re-plans it,
    in the backward either: each rank does its shard's share of the
    work, never a whole weight's.  Without grad (serving) the weight is
    cast to ``x``'s type before it moves, as the reference's program
    gathers the cast; with grad the float32 master is gathered, so its
    gradient is reduced in float32.

    Along the mesh dims ``whole`` (one at most), where both operands are
    whole, the result is whole on every rank, the product repeated; the
    backward stays split there, each rank forming the weight's gradient
    on its part of the weight's first dim only (partial over the dim),
    which ``x`` contracts.  The reference's compiled program runs so
    where a layout leaves the lm head's result whole (a vocab the model
    dim does not divide)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return torch.einsum(eq, x, w.to(x.dtype))
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    ins, out = eq.replace(" ", "").split("->")
    a, b = ins.split(",")
    x, w = settle(x), settle(w)
    if not torch.is_grad_enabled():
        w = w.to(x.dtype)     # serving: a gathered weight moves cast
    if len(whole) > 1:
        raise ValueError(f"a weight gathered along {len(whole)} mesh dims "
                         f"(one at most)")
    xpl = x.placements if isinstance(x, DTensor) else None
    wpl = w.placements if isinstance(w, DTensor) else None
    px, pw, po, grad, xgrad, cut = [], [], [], [], [], None
    for i in range(mesh.ndim):
        lx = (a[xpl[i].dim] if xpl is not None and xpl[i].is_shard()
              else None)
        lw = (b[wpl[i].dim] if wpl is not None and wpl[i].is_shard()
              else None)
        if i in whole:
            if lx is not None or lw is not None or b[0] not in a:
                raise ValueError(f"whole along mesh dim {i} takes whole "
                                 f"operands and a contracted weight dim 0")
            # torch.chunk's split of the weight's first dim
            size, k = w.shape[0], mesh.shape[i]
            lo = min(mesh.get_coordinate()[i] * -(-size // k), size)
            cut = (lo, min(-(-size // k), size - lo))
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
    if cut is None:
        return shard_map(lambda xx, ww: torch.einsum(
            eq, xx, ww.to(xx.dtype)), (tuple(px), tuple(pw)), tuple(po),
            x, w, mesh=mesh)
    return shard_map(lambda xx, ww: _SlicedWeightGrad.apply(
        eq, xx, ww.to(xx.dtype), *cut), (tuple(px), tuple(pw)), tuple(po),
        x, w, mesh=mesh, grad_placements=[tuple(xgrad), tuple(grad)])


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
    """A DTensor laid out over its batch (dim 0) shards alone, every
    other shard or pending sum gathered; anything else as is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    pl = tuple(p if p.is_shard() and p.dim == 0 else Replicate()
               for p in x.placements)
    return x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


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
