"""The benchmark's weights, made from the seed on the run's device.

One normal draw per storage type fills one flat buffer; every weight is
a view into it, scaled in place.  The same tensors go to the program
(wrapped in its parameter tree by the harness) and to the reference.

Scales: a product's weight N(0, 1 / fan_in), so each layer's outputs
keep unit size; the embedding N(0, 0.02); the QKV biases N(0, 0.1); the
norm gains 1 + N(0, 0.1), so that a gain applied wrongly shows.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference.model import weight_layout

__all__ = ["served_dtype", "make_weights"]

_ALIGN = 64           # elements: every view starts on a 128-byte boundary
_GAINS = ("final_norm", "blocks.ln1", "blocks.ln2")
_FAN_IN_DIMS = {"attn.wo": 2}       # a weight's input dims, where not one


def served_dtype(path: str, m: Dict) -> torch.dtype:
    """The type a weight is served in: norm gains and the router in
    float32, every other weight in the model's type."""
    if path in _GAINS or path.endswith("router"):
        return torch.float32
    return getattr(torch, m["dtype"])


def _scale(path: str, shape) -> float:
    if path == "embed":
        return 0.02
    if path in _GAINS:
        return 0.1
    if path.split(".")[-1] in ("bq", "bk", "bv"):
        return 0.1
    per_layer = shape[1:] if path.startswith("blocks.") else shape
    key = path.split(".", 1)[-1]
    k = _FAN_IN_DIMS.get(key, 1)
    skip = 1 if key.startswith("moe.w_") else 0      # the expert dim
    # fan-in: the product of the input dims
    return 1.0 / math.sqrt(math.prod(per_layer[skip:skip + k]))


def make_weights(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of `weight_layout(m)` from ``seed``, on ``device``."""
    layout = weight_layout(m)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    groups: Dict[torch.dtype, list] = {}
    for path, shape in layout.items():
        groups.setdefault(served_dtype(path, m), []).append((path, shape))
    out: Dict[str, torch.Tensor] = {}
    for dt, items in groups.items():
        offs, n = [], 0
        for _, shape in items:
            offs.append(n)
            n += -(-math.prod(shape) // _ALIGN) * _ALIGN
        buf = torch.empty(n, dtype=dt, device=device)
        buf.normal_(generator=gen)
        for (path, shape), off in zip(items, offs):
            w = buf[off:off + math.prod(shape)].view(shape)
            w.mul_(_scale(path, shape))
            if path in _GAINS:
                w.add_(1.0)
            out[path] = w
    return out
