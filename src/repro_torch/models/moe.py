"""Mixture-of-experts layer: top-k routing, capacity-bounded sort-based
dispatch, batched expert GEMMs, shared experts.

The reference's scatter/gather formulation: tokens are replicated k
ways, ranked within their expert by a stable sort, dropped beyond
``capacity = cf * T * k / E`` (a multiple of 32, at least 32), written
into an (E, C, D) buffer, pushed through the batched products
``ecd,edf->ecf``, and gathered back weighted by the router's
probabilities.  Capacity comes from shapes only, and no step reads a
value back to the host (no ``.item()``, no boolean-mask indexing), so
the layer runs unchanged on ``meta`` tensors (graph enumeration).

Every step is deterministic on the card:

* top-k is a stable descending sort, so ties go to the lower expert
  index, as ``lax.top_k`` breaks them;
* the buffer is written with ``index_copy_`` (each kept row has its own
  slot; dropped rows all land in one sink row that is cut off);
* the k routed rows of a token are summed in the reference's order of
  k, never by ``index_add_`` (atomics on CUDA);
* the router runs in float32 (the caller keeps TF32 off on the card).

The decode step routes B tokens into a capacity of at least 32 slots
per expert, so every step reads every expert's weights: the reference's
semantics, kept.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import Sharder, local
from repro_torch.models.layers import _ACTS, init_mlp, mlp
from repro_torch.models.params import param

__all__ = ["init_moe", "moe_layer", "moe_capacity"]


def moe_capacity(tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = int(math.ceil(capacity_factor * tokens * top_k / n_experts))
    # a multiple of 32, at least 32 (the reference's sublane alignment)
    return max(32, ((c + 31) // 32) * 32)


def init_moe(d_model: int, d_ff: int, n_experts: int, n_shared: int = 0,
             act: str = "silu_glu", pad_to: int = 0, *, n_layers: int,
             dtype, device, generator) -> Dict:
    """Stacked (n_layers, ...) MoE weights, reference layouts and init
    scales.  ``pad_to``: allocate max(n_experts, pad_to) experts; the
    router only ever routes to the first n_experts."""
    e = max(n_experts, pad_to) if pad_to else n_experts
    d, f = d_model, d_ff
    mk = lambda shape, dims, **kw: param(
        (n_layers,) + shape, ("layers",) + dims, dtype=dtype, device=device,
        generator=generator, fan_in=shape[0], **kw)
    p = {
        "router": mk((d, n_experts), ("embed", "experts"), scale=0.02),
        "w_gate": mk((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": mk((e, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": mk((e, f, d), ("experts", "expert_mlp", "embed")),
    }
    if n_shared > 0:
        p["shared"] = init_mlp(d_model, n_shared * d_ff, act,
                               n_layers=n_layers, dtype=dtype, device=device,
                               generator=generator)
    return p


def _rank_in_expert(flat_e: torch.Tensor, n: int, e: int) -> torch.Tensor:
    """Position of each routed token within its expert (stable order)."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(e, dtype=torch.long, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=flat_e.device) - starts[sorted_e]
    return torch.zeros_like(pos_sorted).index_copy_(0, order, pos_sorted)


def _scatter(xt, flat_e, e: int, e_pad: int, cap: int):
    """Rows of ``xt`` (T, D), replicated k ways (``flat_e`` (T*k,)),
    into the (E_pad, C, D) buffer.  Returns (buffer, slot, keep)."""
    t, d = xt.shape
    k = flat_e.shape[0] // t
    pos = _rank_in_expert(flat_e, t * k, e)
    keep = pos < cap
    sink = e_pad * cap
    slot = torch.where(keep, flat_e * cap + pos, torch.full_like(pos, sink))
    xin = xt.repeat_interleave(k, dim=0)                     # (T*k, D)
    xin = torch.where(keep[:, None], xin, torch.zeros_like(xin))
    buf = torch.zeros((sink + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_copy_(0, slot, xin)
    return buf[:-1].reshape(e_pad, cap, d), slot, keep


def _combine(flat_out, slot, keep, top_p, cap_rows: int):
    """Gather each routed row back and sum a token's k rows, weighted by
    its router probabilities, in the order of k."""
    t, k = top_p.shape
    safe = torch.clamp(slot, max=cap_rows - 1)
    y_rep = flat_out[safe]
    y_rep = torch.where(keep[:, None], y_rep, torch.zeros_like(y_rep))
    w = top_p.reshape(-1)[:, None].to(flat_out.dtype)
    r = (y_rep * w).reshape(t, k, -1)
    y = torch.zeros_like(r[:, 0])
    for j in range(k):
        y = y + r[:, j]
    return y


def _experts(buf, wg, wu, wd, act: str, lead: str):
    """The experts' gated MLPs over the dispatch buffer: ``lead`` names
    its leading dims (``e``, or ``ge`` with a group per sequence)."""
    a = _ACTS[act.replace("_glu", "")]
    hid = a(torch.einsum(f"{lead}cd,edf->{lead}cf", buf, wg)) \
        * torch.einsum(f"{lead}cd,edf->{lead}cf", buf, wu)
    return torch.einsum(f"{lead}cf,efd->{lead}cd", hid, wd)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x, router, wg, wu, wd, *, n_experts: int, top_k: int,
           capacity_factor: float, act: str, router_dtype, pad_to: int,
           dispatch: str):
    """Routing, dispatch, the experts and the combine: (y, aux)."""
    b, s, d = x.shape
    t = b * s
    e = n_experts
    e_pad = max(e, pad_to) if pad_to else e

    logits = torch.einsum("bsd,de->bse", x.to(router_dtype),
                          router.to(router_dtype))
    probs = torch.softmax(logits, dim=-1)                     # (B, S, E)
    top_p, top_i = _top_k(probs, top_k)                       # (B, S, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.reshape(t, e).mean(dim=0)
    ce = torch.zeros(e, dtype=router_dtype, device=x.device)
    ce.scatter_add_(0, top_i.reshape(-1), torch.full(
        (t * top_k,), 1.0 / (t * top_k), dtype=router_dtype,
        device=x.device))
    aux = e * torch.sum(me * ce)

    wg, wu, wd = wg.to(x.dtype), wu.to(x.dtype), wd.to(x.dtype)

    if dispatch == "grouped":
        cap = moe_capacity(s, e, top_k, capacity_factor)
        groups = [_scatter(x[g], top_i[g].reshape(-1), e, e_pad, cap)
                  for g in range(b)]
        buf = torch.stack([g[0] for g in groups])            # (B,E,C,D)
        out_buf = _experts(buf, wg, wu, wd, act, "ge")
        y = torch.stack([
            _combine(out_buf[g].reshape(e_pad * cap, d), slot, keep,
                     top_p[g], e_pad * cap)
            for g, (_, slot, keep) in enumerate(groups)])
    else:
        cap = moe_capacity(t, e, top_k, capacity_factor)
        buf, slot, keep = _scatter(x.reshape(t, d), top_i.reshape(-1), e,
                                   e_pad, cap)
        out_buf = _experts(buf, wg, wu, wd, act, "e")
        y = _combine(out_buf.reshape(e_pad * cap, d), slot, keep,
                     top_p.reshape(t, top_k), e_pad * cap).reshape(b, s, d)

    return y, aux


def moe_layer(p: Dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, act: str, shd: Sharder,
              router_dtype=torch.float32, pad_to: int = 0,
              dispatch: str = "flat") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    ``dispatch='flat'``: one capacity over all B*S tokens.
    ``dispatch='grouped'``: a capacity per sequence, each sequence
    scattered into its own (E, C, D) buffer."""
    # on a mesh the routing runs on whole operands on every rank
    # (`local`: an all-gather of the tokens and the experts): the flat
    # capacity counts over every token of the batch, and DTensor has no
    # rule for the dispatch's scatter_add_ and index_copy_
    y, aux = local(
        functools.partial(_route, n_experts=n_experts, top_k=top_k,
                          capacity_factor=capacity_factor, act=act,
                          router_dtype=router_dtype, pad_to=pad_to,
                          dispatch=dispatch),
        x, p["router"].value, p["w_gate"].value, p["w_up"].value,
        p["w_down"].value)
    if "shared" in p:
        y = y + mlp(p["shared"], x, act, shd)

    return shd.act(y, ("batch", "residual_seq", "embed")), aux.float()
