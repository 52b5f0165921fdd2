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

from repro_torch.distributed.sharding import (Sharder, cast, gshape, like,
                                              named_sharding, settle,
                                              shard_map, shard_range)
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


def _scatter(xt, flat_e, e: int, cap: int, er, cr=None):
    """Rows of ``xt`` (T, D), replicated k ways (``flat_e`` (T*k,)),
    into this rank's part of the (E_pad, C, D) buffer: experts
    ``er = (first, count)`` and capacity slots ``cr`` (the whole buffer
    when None).  Positions count over every row of ``flat_e``.  Returns
    (buffer, slot, mine): each row's slot in the flat part (a sink past
    its end where the row is dropped or lies in another rank's part)."""
    t, d = xt.shape
    k = flat_e.shape[0] // t
    pos = _rank_in_expert(flat_e, t * k, e)
    (e0, el), (c0, cl) = er, cr or (0, cap)
    mine = pos < cap
    if (c0, cl) != (0, cap):
        mine = mine & (pos >= c0) & (pos < c0 + cl)
    if e0 or el < e:
        mine = mine & (flat_e >= e0) & (flat_e < e0 + el)
    sink = el * cl
    slot = torch.where(mine, (flat_e - e0) * cl + pos - c0,
                       torch.full_like(pos, sink))
    buf = _Scatter.apply(xt, slot, sink)
    return buf.reshape(el, cl, d), slot, mine


class _Scatter(torch.autograd.Function):
    """The dispatch buffer's ``rows`` rows: row ``s`` is the token of the
    routed row (of T*k, token = row // k) whose ``slot`` is ``s``, zero
    where none is.  Each routed row is looked up from its slot, so the
    k-fold copy of the tokens is never made; the backward sums each
    token's k rows of the buffer's gradient in the order of k (no
    atomics)."""

    @staticmethod
    def forward(ctx, xt, slot, rows: int):
        t, k = xt.shape[0], slot.shape[0] // xt.shape[0]
        src = torch.full((rows + 1,), t * k, dtype=torch.long,
                         device=xt.device)
        # every kept row has its own slot; the dropped ones share the
        # sink, cut off
        src.index_copy_(0, slot, torch.arange(t * k, device=xt.device))
        src = src[:rows]
        ctx.save_for_backward(slot)
        ctx.t = t
        return torch.where((src < t * k)[:, None],
                           xt[torch.clamp(src // k, max=t - 1)],
                           torch.zeros((), dtype=xt.dtype, device=xt.device))

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        rows = g.shape[0]
        slot = slot.reshape(ctx.t, -1)
        keep = slot < rows
        safe = torch.clamp(slot, max=max(rows - 1, 0))
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        dx = torch.zeros((ctx.t, g.shape[1]), dtype=g.dtype, device=g.device)
        for j in range(slot.shape[1]):
            dx = dx + torch.where(keep[:, j, None], g[safe[:, j]], zero)
        return dx, None, None


def _combine(flat_out, slot, keep, top_p, cap_rows: int):
    """Gather each routed row back and sum a token's k rows, weighted by
    its router probabilities, in the order of k (`_Combine`)."""
    t, k = top_p.shape
    return _Combine.apply(flat_out, torch.clamp(slot, max=cap_rows - 1)
                          .reshape(t, k), keep.reshape(t, k),
                          top_p.to(flat_out.dtype))


class _Combine(torch.autograd.Function):
    """``y[t] = sum_j w[t, j] * out[slot[t, j]]`` over the kept rows, in
    the order of j.  One routed row's contribution at a time, and none
    saved: the backward looks each up again (the weights' gradient) or
    goes from each slot to its routed row (the buffer's), so no (T*k, D)
    tensor is made in either pass."""

    @staticmethod
    def forward(ctx, out, safe, keep, w):
        t, k = w.shape
        zero = torch.zeros((), dtype=out.dtype, device=out.device)
        y = torch.zeros((t, out.shape[1]), dtype=out.dtype,
                        device=out.device)
        for j in range(k):
            y = y + torch.where(keep[:, j, None], out[safe[:, j]],
                                zero) * w[:, j, None]
        ctx.save_for_backward(out, safe, keep, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        out, safe, keep, w = ctx.saved_tensors
        (t, k), rows = w.shape, out.shape[0]
        zero = torch.zeros((), dtype=out.dtype, device=out.device)
        dw = torch.stack([
            (dy * torch.where(keep[:, j, None], out[safe[:, j]], zero))
            .sum(dim=-1) for j in range(k)], dim=1)
        # the routed row in each slot (each kept row has its own)
        src = torch.full((rows + 1,), t * k, dtype=torch.long,
                         device=out.device)
        src.index_copy_(0, torch.where(keep, safe, rows).reshape(-1),
                        torch.arange(t * k, device=out.device))
        src = src[:rows]
        hit = torch.clamp(src, max=t * k - 1)
        dout = torch.where((src < t * k)[:, None],
                           dy[hit // k] * w.reshape(-1)[hit][:, None], zero)
        return dout, None, None, dw


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


def _router(x, router, *, top_k: int, router_dtype, tokens: int):
    """Routing of the local tokens: (top_p, top_i, the sum of their
    probabilities per expert, their share of the ``tokens * top_k``
    routed rows per expert) — the last two summands of the Switch aux
    loss's terms."""
    e = router.shape[-1]
    logits = torch.einsum("bsd,de->bse", x.to(router_dtype),
                          router.to(router_dtype))
    probs = torch.softmax(logits, dim=-1)                     # (B, S, E)
    top_p, top_i = _top_k(probs, top_k)                       # (B, S, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    me = probs.reshape(-1, e).sum(dim=0)
    n = top_i.numel()
    ce = torch.zeros(e, dtype=router_dtype, device=x.device)
    ce.scatter_add_(0, top_i.reshape(-1), torch.full(
        (n,), 1.0 / (tokens * top_k), dtype=router_dtype, device=x.device))
    return top_p, top_i, me, ce


def _dispatch(x, top_p, top_i, wg, wu, wd, *, n_experts: int, cap: int,
              act: str, grouped: bool, er, cr):
    """Dispatch, this rank's experts over its capacity slots, and the
    combine of its slots' rows into every token (zero where a token's
    rows lie elsewhere).  ``x``: every token of the flat capacity (its
    batch shard when grouped)."""
    b, s, d = x.shape
    wg, wu, wd = wg.to(x.dtype), wu.to(x.dtype), wd.to(x.dtype)
    if grouped:
        groups = [_scatter(x[g], top_i[g].reshape(-1), n_experts, cap, er)
                  for g in range(b)]
        out = _experts(torch.stack([g[0] for g in groups]), wg, wu, wd,
                       act, "ge")
        rows = out.shape[1] * cap
        return torch.stack([
            _combine(out[g].reshape(rows, d), slot, mine, top_p[g], rows)
            for g, (_, slot, mine) in enumerate(groups)])
    t = b * s
    buf, slot, mine = _scatter(x.reshape(t, d), top_i.reshape(-1),
                               n_experts, cap, er, cr)
    out = _experts(buf, wg, wu, wd, act, "e")
    rows = buf.shape[0] * buf.shape[1]
    return _combine(out.reshape(rows, d), slot, mine,
                    top_p.reshape(t, -1), rows).reshape(b, s, d)


def _layouts(shd: Sharder, x, e_pad: int, cap: int, f: int,
             grouped: bool):
    """The dispatch's layouts on a mesh, from the activation rules of
    the expert buffers (the reference's ``(experts, moe_capacity, .)``,
    or ``(batch, experts, ., .)`` grouped) and of the hidden rows
    (``expert_mlp``): (input layouts of x, top_p, top_i and the three
    weights; the output's; this rank's experts (first, count); its
    capacity slots, or None)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    b, s, d = gshape(x)
    mesh, rules = shd.mesh, shd.act_rules
    if grouped:
        buf = named_sharding(("batch", "experts", None, None),
                             (b, e_pad, cap, d), rules, mesh).placements
        hid = named_sharding(("batch", "experts", None, "expert_mlp"),
                             (b, e_pad, cap, f), rules, mesh).placements
        ed, cd, fd = 1, None, 3
    else:
        buf = named_sharding(("experts", "moe_capacity", None),
                             (e_pad, cap, d), rules, mesh).placements
        hid = named_sharding(("experts", "moe_capacity", "expert_mlp"),
                             (e_pad, cap, f), rules, mesh).placements
        ed, cd, fd = 0, 1, 2
    rep = Replicate()
    tokens, w_in, w_out, y = [], [], [], []
    for pb, ph in zip(buf, hid):
        on = lambda p, dim: p.is_shard() and p.dim == dim
        if on(pb, ed):                        # expert parallel
            w_in.append(Shard(0)), w_out.append(Shard(0)), y.append(Partial())
        elif on(ph, fd):                      # within-expert TP
            w_in.append(Shard(2)), w_out.append(Shard(1)), y.append(Partial())
        elif cd is not None and on(pb, cd):   # capacity slots
            w_in.append(rep), w_out.append(rep), y.append(Partial())
        else:
            w_in.append(rep), w_out.append(rep)
            y.append(Shard(0) if grouped and on(pb, 0) else rep)
        tokens.append(y[-1] if y[-1].is_shard() else rep)
    tok = tuple(tokens)
    return ((tok, tok, tok, tuple(w_in), tuple(w_in), tuple(w_out)),
            tuple(y), shard_range(mesh, buf, ed, e_pad),
            None if grouped else shard_range(mesh, buf, cd, cap))


def moe_layer(p: Dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, act: str, shd: Sharder,
              router_dtype=torch.float32, pad_to: int = 0,
              dispatch: str = "flat") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    ``dispatch='flat'``: one capacity over all B*S tokens.
    ``dispatch='grouped'``: a capacity per sequence, each sequence
    scattered into its own (E, C, D) buffer.

    On a mesh the work is partitioned as the reference's rules lay out
    its buffers: each rank routes its batch shard; the flat dispatch
    gathers the top-k routing and the tokens (its capacity counts over
    every token of the batch), and each rank fills only its own part of
    the (experts, capacity) buffer — experts over the model dim where
    their count divides it, else the expert MLP's width (``expert_mlp``),
    capacity over the batch dims — runs the expert products on its
    expert or width shard, and adds its slots' rows into a result
    partial over those dims, reduced back to the activations' layout
    (`shard_map`: the dispatch's ``index_copy_`` and ``scatter_add_`` on
    local tensors)."""
    b, s, d = gshape(x)
    t = b * s
    e = n_experts
    e_pad = max(e, pad_to) if pad_to else e
    grouped = dispatch == "grouped"
    cap = moe_capacity(s if grouped else t, e, top_k, capacity_factor)
    route = functools.partial(_router, top_k=top_k,
                              router_dtype=router_dtype, tokens=t)
    run = functools.partial(_dispatch, n_experts=e, cap=cap, act=act,
                            grouped=grouped)
    # the experts' weights in the compute type before they move, as the
    # reference's program gathers them
    wts = tuple(cast(p[k].value, x.dtype)
                for k in ("w_gate", "w_up", "w_down"))
    if shd.mesh is None:
        top_p, top_i, me, ce = route(x, p["router"].value)
        y = run(x, top_p, top_i, *wts, er=(0, e_pad), cr=None)
    else:
        from torch.distributed.tensor import Partial, Replicate
        bp = shd.batch_placements(x)
        rep = (Replicate(),) * len(bp)
        part = tuple(Partial() if q.is_shard() else q for q in bp)
        top_p, top_i, me, ce = shard_map(
            route, (bp, rep), [bp, bp, part, part], x, p["router"].value)
        me, ce = settle(me), settle(ce)
        ins, out, er, cr = _layouts(shd, x, e_pad, cap,
                                    gshape(wts[0])[-1], grouped)
        y = shard_map(functools.partial(run, er=er, cr=cr), ins, out, x,
                      top_p, top_i, *wts)
        y = shd.act(y, ("batch", "residual_seq", "embed"))
    aux = e * torch.sum((me / t) * ce)
    if "shared" in p:
        y = like(y + mlp(p["shared"], x, act, shd), y)

    return shd.act(y, ("batch", "residual_seq", "embed")), aux.float()
