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
halves the resident weights of a bf16 model.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

__all__ = ["Param", "param", "map_params", "from_numpy_tree",
           "resolve_device"]


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


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raise when there is none (entry
    points never drop to the CPU unless asked)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' (or "
                "--device cpu) to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def _store_dtype(shape: Sequence[int], dims: Sequence[Optional[str]],
                 dtype: torch.dtype) -> torch.dtype:
    """Matrices in the compute type, gains in f32 — judged per layer: a
    stacked (layers, d) gain is a vector."""
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


def from_numpy_tree(tree, *, dtype: torch.dtype = torch.float32,
                    device=None):
    """The reference's parameter tree -> the port's.

    ``tree`` is a nested dict whose leaves carry a numpy array and its
    dims: an object with ``.value`` and ``.dims`` (the reference's
    ``Param`` after ``np.asarray`` on its value) or a ``(array, dims)``
    pair.  Matrices are cast once to ``dtype`` (the model's compute
    type), 1-D gains stay f32, everything lands on ``device`` (default:
    the CUDA card)."""
    dev = resolve_device(device)

    def conv(leaf):
        arr, dims = ((leaf.value, leaf.dims) if hasattr(leaf, "dims")
                     else leaf)
        t = torch.from_numpy(arr.copy())
        return Param(t.to(device=dev,
                          dtype=_store_dtype(t.shape, dims, dtype)), dims)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return conv(node)

    return walk(tree)
