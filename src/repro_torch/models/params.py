"""Parameters with logical-dimension metadata.

A :class:`Param` wraps one tensor plus the tuple of logical dim names
(``("embed", "heads", "head_dim")``) the reference's sharding resolver
consumes; the port keeps the names so a tree carried over from the
reference keeps its meaning.  Layouts are the reference's: ``wq`` is
(d, h, hd), ``wo`` (h, hd, d), ``w_gate`` (d, f), and per-layer weights
are stacked along a leading ``layers`` dim.

The reference keeps f32 masters and casts matrices to the compute type
at each use.  The port casts once when parameters are made or loaded —
matrices to the compute type, norm gains (vectors per layer) kept in
f32 — which gives the same values the reference computes with, and
halves the resident weights of a bf16 model.  The MoE router (its last
dim is ``experts``) stays f32 too: the reference routes in f32.
Training keeps the reference's f32 masters instead (``param_dtype=
torch.float32`` through `Model.init`): every layer casts at each use,
so the compute type is unchanged and AdamW updates the masters.

On a mesh, `param_shardings` resolves every Param's `NamedSharding` by
the weight rules and `device_put` places a tree by them: each value
becomes a DTensor with the rule's placements.

Trees are nested dicts; `tree_leaves` walks them in the reference's
flatten order (dict keys sorted), which the optimizer's norm and the
checkpoint's names follow.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

__all__ = ["Param", "param", "map_params", "stack_dims",
           "param_shardings", "device_put", "distribute", "from_numpy_tree",
           "resolve_device", "tree_leaves", "tree_param_count",
           "tree_param_bytes"]


class Param:
    """One parameter tensor + its logical dims."""

    __slots__ = ("value", "dims")

    def __init__(self, value: torch.Tensor, dims: Tuple[Optional[str], ...]):
        self.value = value
        self.dims = tuple(dims)

    @property
    def shape(self):
        return self.value.shape

    @property
    def dtype(self):
        return self.value.dtype

    def __repr__(self):
        return f"Param({tuple(self.value.shape)}, dims={self.dims})"


def _store_dtype(shape: Sequence[int], dims: Sequence[Optional[str]],
                 dtype: torch.dtype) -> torch.dtype:
    """Matrices in the compute type, gains and the router in f32 —
    judged per layer: a stacked (layers, d) gain is a vector."""
    if dims and dims[-1] == "experts":
        return torch.float32
    rank = len(shape) - (1 if dims and dims[0] == "layers" else 0)
    return dtype if rank >= 2 else torch.float32


def param(shape: Sequence[int], dims: Sequence[Optional[str]], *,
          init: str = "normal", scale: Optional[float] = None,
          fan_in: Optional[int] = None, dtype: torch.dtype,
          device: torch.device,
          generator: Optional[torch.Generator] = None) -> Param:
    """Make one Param in its storage type (`_store_dtype`).  ``normal``
    defaults to 1/sqrt(fan_in) with fan_in = the first per-layer dim
    (``fan_in``, for stacked weights) — the reference's convention for
    (in, out)-ordered weights; ``embed`` to 0.02."""
    shape = tuple(int(s) for s in shape)
    dt = _store_dtype(shape, dims, dtype)
    if device.type == "meta" or init in ("zeros", "ones"):
        fill = {"zeros": torch.zeros, "ones": torch.ones}.get(init,
                                                              torch.empty)
        return Param(fill(shape, dtype=dt, device=device), dims)
    if init == "normal":
        if scale is None:
            scale = 1.0 / max(fan_in or shape[0], 1) ** 0.5
    elif init == "embed":
        scale = scale or 0.02
    else:
        raise ValueError(init)
    v = torch.empty(shape, dtype=dt, device=device)
    v.normal_(0.0, scale, generator=generator)
    return Param(v, dims)


def map_params(fn: Callable[[Param], Any], tree):
    """Map over Param nodes of a nested dict."""
    if isinstance(tree, Param):
        return fn(tree)
    return {k: map_params(fn, v) for k, v in tree.items()}


def stack_dims(tree, axis_name: str = "layers"):
    """Prepend the stacking dim name to every Param of a per-layer tree
    whose values were stacked along a new leading dim."""
    return map_params(lambda p: Param(p.value, (axis_name,) + p.dims), tree)


def param_shardings(tree, mesh, rules=None):
    """Param tree -> `NamedSharding` tree (``rules`` default: the weight
    rules)."""
    from repro_torch.distributed.sharding import WEIGHT_RULES, \
        named_sharding
    rules = WEIGHT_RULES if rules is None else rules
    return map_params(
        lambda p: named_sharding(p.dims, tuple(p.value.shape), rules, mesh),
        tree)


def device_put(tree, shardings):
    """A Param tree on the mesh, leaf by leaf by its `NamedSharding`
    (the counterpart of ``jax.device_put(params, param_shardings(...))``).
    A host leaf holds the whole value on every rank, and each rank keeps
    its shard of it; a DTensor leaf is redistributed."""
    if isinstance(tree, Param):
        return Param(distribute(tree.value, shardings), tree.dims)
    return {k: device_put(v, shardings[k]) for k, v in tree.items()}


def distribute(x, sharding):
    """``x`` as a DTensor laid out by ``sharding`` (a `NamedSharding`): a
    DTensor is redistributed (the collective the layout change needs); a
    plain tensor — the same value on every rank, as a parameter tree
    loaded on every rank is — is distributed without communication,
    each rank keeping its own shard.  The parameter state's edge: a
    step's body takes the local shards."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = sharding.placements
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == pl else x.redistribute(
            sharding.mesh, pl)
    return distribute_tensor(x, sharding.mesh, pl, src_data_rank=None)


def tree_leaves(tree, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of a nested dict, keys sorted at every level —
    the reference's ``jax.tree.leaves`` order.  A leaf is a `Param` or
    anything that is not a dict (a tensor, an int)."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for k in sorted(tree):
        yield from tree_leaves(tree[k], path + (k,))


def _leaf_tensors(tree):
    for _, leaf in tree_leaves(tree):
        v = leaf.value if isinstance(leaf, Param) else leaf
        if hasattr(v, "shape"):
            yield v


def tree_param_count(tree) -> int:
    return int(sum(v.numel() for v in _leaf_tensors(tree)))


def tree_param_bytes(tree) -> int:
    return int(sum(v.numel() * v.element_size()
                   for v in _leaf_tensors(tree)))


def from_numpy_tree(tree, *, dtype: torch.dtype = torch.float32,
                    device=None):
    """The reference's parameter (or optimizer-state) tree -> the port's.

    ``tree`` is a nested dict whose leaves carry a numpy array and its
    dims: an object with ``.value`` and ``.dims`` (the reference's
    ``Param`` after ``np.asarray`` on its value) or a ``(array, dims)``
    pair.  Matrices are cast once to ``dtype`` (the model's compute
    type; float32, the default, keeps the reference's f32 masters), 1-D
    gains and the MoE router stay f32, everything lands on ``device``
    (default: the CUDA card).  A bare numpy array or number (the
    optimizer's ``count``) crosses as a tensor of its own type, so
    AdamW's state — ``m`` and ``v`` as Param-shaped f32 trees, plus
    ``count`` — crosses with the default ``dtype``.  Every family's
    tree crosses as is: stacked layers, a dense prefix stack, MoE
    experts, SSD blocks, encoder and decoder stacks."""
    dev = resolve_device(device)

    def conv(leaf):
        if isinstance(leaf, (np.ndarray, np.generic, int, float)):
            return torch.from_numpy(np.array(leaf)).to(dev)
        arr, dims = ((leaf.value, leaf.dims) if hasattr(leaf, "dims")
                     else leaf)
        t = torch.from_numpy(np.array(arr))
        return Param(t.to(device=dev,
                          dtype=_store_dtype(t.shape, dims, dtype)), dims)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return conv(node)

    return walk(tree)
