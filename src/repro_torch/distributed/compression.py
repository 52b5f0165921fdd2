"""Gradient compression for the slow cross-pod tier.

int8 quantized all-reduce with error feedback (EF-SGD style): each pod
quantizes (grad + residual) to int8 with a per-tensor f32 scale, sums
the int8 payload across the ``pod`` mesh dim, dequantizes, and keeps the
quantization error as the next step's residual (Karimireddy et al.,
2019) — the reference's, step for step.

The gradients arriving here are DTensors already reduced over the data
and model dims and laid out as their parameters (replicated over
``pod``), as the reference's arrive replicated.  The scale is the
tensor's whole max (a max over its shards); the payload is widened to
int32 and all-reduced over the ``pod`` sub-group (``mesh["pod"]``), the
scale summed there too, and ``g_hat = q_sum * (scale_sum / n) / n`` is
computed in that order, as the reference computes it — with the
rounding of the reference's compiled step (`_compress_one`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import settle

_RECIP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_grads",
           "init_ef_state"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    # a DTensor's max is pending over its shards until settled
    amax = settle(torch.max(torch.abs(xf)))
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_ef_state(params) -> Dict:
    """Zero f32 residuals shaped (and, on a mesh, laid out) as
    ``params`` (a tree of tensors or Params)."""
    val = lambda p: getattr(p, "value", p)
    return {"residual": _map(
        lambda p: torch.zeros_like(val(p), dtype=torch.float32), params)}


def _compress_one(g, r, group, n: int):
    from torch.distributed.tensor import DTensor
    import torch.distributed as dist

    target = g.float() + r
    # the reference's compiled arithmetic, which is not its eager one:
    # inside its jitted step XLA folds the division by 127 into a
    # multiply by the f32 reciprocal, and fuses the residual's multiply-
    # subtract into one rounding (emulated in float64, where q * scale
    # is exact)
    amax = settle(torch.max(torch.abs(target)))
    scale = torch.clamp(amax, min=1e-30) * _RECIP_127.to(amax.device)
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    local = lambda t: t.to_local() if isinstance(t, DTensor) else t
    # the int8 payload summed over the pods, widened so the sum is exact
    q_sum = local(q).to(torch.int32)
    dist.all_reduce(q_sum, group=group)
    scale_sum = local(scale).clone()
    dist.all_reduce(scale_sum, group=group)
    g_hat = q_sum.float() * (scale_sum / n) / n
    if isinstance(g, DTensor):
        g_hat = DTensor.from_local(g_hat, g.device_mesh, g.placements,
                                   run_check=False)
    new_r = (target.double() - q.double() * scale.double()).float()
    return g_hat.to(g.dtype), new_r


def ef_compress_grads(grads, opt_state: Dict, mesh):
    """EF-int8 cross-pod compression of a gradient tree (nested dicts of
    tensors, DTensors on ``mesh``); the residual lives in
    ``opt_state["ef"]``.  Returns (grads, opt_state)."""
    if "ef" not in opt_state:
        opt_state = dict(opt_state)
        opt_state["ef"] = init_ef_state(grads)
    group = mesh["pod"].get_group()
    n = mesh["pod"].size()
    out = _map(lambda g, r: _compress_one(g, r, group, n), grads,
               opt_state["ef"]["residual"])
    is_pair = lambda t: isinstance(t, tuple)
    pick = lambda tree, i: ({k: pick(v, i) for k, v in tree.items()}
                            if not is_pair(tree) else tree[i])
    opt_state = dict(opt_state)
    opt_state["ef"] = {"residual": pick(out, 1)}
    return pick(out, 0), opt_state
