"""Mamba-2 SSD (state-space duality) block.

Chunked block decomposition (Dao & Gu, arXiv:2405.21060 §6): the
sequence is split into chunks of length L; within a chunk the output is
the quadratic "attention-like" term, across chunks the (H, N, P) state
is carried with exponential decay.  Decode is the O(1) recurrence
``S <- exp(dt·A)·S + dt·B⊗x``.

The reference carries the chunk states with an associative scan; the
port runs the same recurrence as a loop over chunks, left to right — a
different association of the same products, so the two agree to float
rounding (float32: 1e-4; the tests state each tolerance).

Layout: d_inner = expand * d_model, heads H = d_inner / head_dim P,
single B/C group, state size N = cfg.ssm_state, short causal conv
(k = cfg.ssm_conv) over the x/B/C channels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (Sharder, batch_only, cast,
                                              gshape, layout, like,
                                              named_sharding,
                                              per_shard, settle,
                                              shard_einsum, shard_map,
                                              shard_range, weight_like)
from repro_torch.models.params import param

__all__ = ["SsdConfig", "init_ssd", "ssd_block", "ssd_decode",
           "init_ssd_state", "xc_skip"]


@dataclasses.dataclass(frozen=True)
class SsdConfig:
    d_model: int
    ssm_state: int = 128       # N
    ssm_conv: int = 4
    expand: int = 2
    head_dim: int = 64         # P
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_state


def init_ssd(cfg: SsdConfig, *, n_layers: int, dtype, device,
             generator) -> Dict:
    """Stacked (n_layers, ...) SSD weights, reference layouts and init
    scales; ``w_in`` packs [z, x, B, C, dt]."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_heads
    mk = lambda shape, dims, **kw: param(
        (n_layers,) + shape, ("layers",) + dims, dtype=dtype, device=device,
        generator=generator, fan_in=shape[0], **kw)
    return {
        "w_in": mk((d, 2 * di + 2 * n + h), ("embed", "ssm_inner")),
        "conv_w": mk((cfg.ssm_conv, cfg.conv_dim), ("conv", "ssm_inner"),
                     scale=0.5),
        "conv_b": mk((cfg.conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": mk((h,), (None,), init="zeros"),
        "dt_bias": mk((h,), (None,), init="zeros"),
        "d_skip": mk((h,), (None,), init="ones"),
        "norm_w": mk((di,), ("ssm_inner",), init="ones"),
        "w_out": mk((di, d), ("ssm_inner", "embed"),
                    scale=1.0 / math.sqrt(di)),
    }


def _causal_conv(xbc, w, b, k):
    """Depthwise causal conv via k shifted adds.  xbc: (B, S, C)."""
    out = torch.zeros_like(xbc)
    for i in range(k):
        shifted = xbc if i == 0 else F.pad(xbc[:, :-i, :], (0, 0, i, 0))
        out = out + shifted * w[k - 1 - i]
    return F.silu(out + b)


def _ssd_chunked(xh, dt, a, b_in, c_in, cfg: SsdConfig):
    """xh: (B,T,H,P); dt: (B,T,H); b_in/c_in: (B,T,N).  Returns
    ((B,T,H,P), (decay products, states)) — the states (B,NC,H,N,P)
    after each chunk."""
    bsz, t, h, pdim = xh.shape
    n = b_in.shape[-1]
    l = min(cfg.chunk, t)
    t_orig = t
    pad = (-t) % l
    if pad:
        # zero-pad the tail; dt=0 on pads makes them state-neutral
        # (decay exp(0)=1, update dt·B⊗x = 0) so the state is exact
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
        t = t + pad
    nc = t // l

    xc = xh.reshape(bsz, nc, l, h, pdim).float()
    dtc = dt.reshape(bsz, nc, l, h).float()
    bc = b_in.reshape(bsz, nc, l, n).float()
    cc = c_in.reshape(bsz, nc, l, n).float()

    da = dtc * a                                     # (B,NC,L,H) decays
    cum = torch.cumsum(da, dim=2)                    # inclusive cumsum
    seg_total = cum[:, :, -1:, :]                    # (B,NC,1,H)

    # ---- intra-chunk (quadratic within chunk) -----------------------------
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,NC,L,L,H)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=xh.device))
    lam = torch.where(tri[None, None, :, :, None], torch.exp(diff),
                      torch.zeros((), device=xh.device))
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)       # (B,NC,L,L)
    w = scores[..., None] * lam * dtc[:, :, None, :, :]    # (B,NC,L,L,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # ---- chunk states ------------------------------------------------------
    decay_to_end = torch.exp(seg_total - cum)              # (B,NC,L,H)
    wgt = decay_to_end * dtc
    s_chunk = torch.einsum("bcln,bclh,bclhp->bchnp", bc, wgt, xc)

    # ---- inter-chunk recurrence, chunk by chunk ----------------------------
    a_c = torch.exp(seg_total[:, :, 0, :])                 # (B,NC,H)
    states = [s_chunk[:, 0]]
    for c in range(1, nc):
        states.append(states[-1] * a_c[:, c, :, None, None] + s_chunk[:, c])
    s_scan = torch.stack(states, dim=1)                    # (B,NC,H,N,P)
    a_scan = torch.cumprod(a_c, dim=1)
    # state entering chunk c = state after chunk c-1 (zero for c=0)
    s_prev = F.pad(s_scan[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))

    decay_in = torch.exp(cum)                              # (B,NC,L,H)
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", cc, decay_in, s_prev)

    y = (y_intra + y_inter).reshape(bsz, t, h, pdim)
    if pad:
        y = y[:, :t_orig]
    return y, (a_scan, s_scan)


def xc_skip(p, xh):
    return xh.float() * p["d_skip"].value.float()[None, None, :, None]


def _inner_layout(shd: Sharder, shape, cfg: SsdConfig):
    """(placements of the (B, S, H, P) heads activations by the rules,
    this rank's first head, its head count); (None, 0, H) without a
    mesh."""
    if shd.mesh is None:
        return None, 0, cfg.n_heads
    pl = named_sharding(("batch", "seq", "ssm_inner", None),
                        (shape[0], shape[1], cfg.n_heads, cfg.head_dim),
                        shd.act_rules, shd.mesh).placements
    h0, hl = shard_range(shd.mesh, pl, 2, cfg.n_heads)
    return pl, h0, hl


def _layouts(pl, bp):
    """The core's output layouts from the heads layout ``pl`` and the
    batch layout ``bp``: the gated channels (B, S, H_loc * P), the
    partial sum of their squares (B, S, 1) and the state (B, H_loc, N,
    P)."""
    from torch.distributed.tensor import Partial, Shard
    heads = [p.is_shard() and p.dim == 2 for p in pl]
    return ([tuple(Shard(2) if hs else b for hs, b in zip(heads, bp)),
             tuple(Partial() if hs else b for hs, b in zip(heads, bp)),
             tuple(Shard(1) if hs else b for hs, b in zip(heads, bp))])


def _my_channels(t, cfg: SsdConfig, h0: int, hl: int):
    """The conv channels of heads [h0, h0 + hl) (their x columns) and B,
    C, along the last dim of ``t``; ``t`` itself when that is every
    head."""
    if hl == cfg.n_heads:
        return t
    p, di = cfg.head_dim, cfg.d_inner
    return torch.cat([t[..., h0 * p:(h0 + hl) * p], t[..., di:]], dim=-1)


_CORE = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip")


def _core_weights(p, dtype):
    """The ``_CORE`` weights, the conv's cast to ``dtype`` (the
    reference's casts), the rest as stored (the core computes with them
    in float32)."""
    return tuple(cast(p[k].value, dtype) if k.startswith("conv")
                 else p[k].value for k in _CORE)


def _project_in(x, w):
    """The packed projection ``x @ w_in`` (B, S, E).  Where the rules
    leave w_in's columns whole on a mesh dim along which ``x`` is whole
    too (the model dim does not divide them: hymba's 6482), each rank
    still projects one chunk of them, the columns zero-padded to a
    multiple of the dim as the reference's compiler pads them to split
    them, and the result is sharded there over the padded width (the
    core gathers it; the pad columns are never read).  Each rank cuts
    its chunk from its own rows of the weight and only the chunk is
    gathered over the dims that shard the rows, cast to ``x``'s type
    first (`cast`), as the reference's program moves it."""
    from torch.distributed.tensor import Replicate, Shard
    if layout(x) is None:
        return shard_einsum("bsd,de->bse", x, w)
    x, mesh = batch_only(x), layout(x).mesh
    xpl, wpl = layout(x).placements, layout(w).placements
    spare = [i for i, (a, b) in enumerate(zip(xpl, wpl))
             if a.is_replicate() and b.is_replicate() and mesh.shape[i] > 1]
    if not spare:
        return shard_einsum("bsd,de->bse", x, w)
    op = tuple(Shard(2) if i in spare else p for i, p in enumerate(xpl))
    e = gshape(w)[1]
    pad = (-e) % math.prod(mesh.shape[i] for i in spare)
    lo, n = shard_range(mesh, op, 2, e + pad)
    w = cast(w, x.dtype)
    rows = tuple(p if p.is_shard(0) else Replicate() for p in wpl)
    cols = tuple(Shard(1) if i in spare else Replicate()
                 for i in range(mesh.ndim))
    wc = shard_map(lambda ww: F.pad(ww, (0, pad))[:, lo:lo + n], (rows,),
                   tuple(Shard(1) if i in spare else p
                         for i, p in enumerate(rows)), w, mesh=mesh)
    return shard_map(lambda xx, ww: torch.einsum("bsd,de->bse", xx, ww),
                     (xpl, cols), op, x, wc, mesh=mesh)


def _core_layouts(shd: Sharder, zx, pl, n_state: int):
    """The core's input layouts (``zx`` and ``n_state`` state tensors on
    the batch layout — the core's `shard_map` gathers ``zx`` over every
    other mesh dim, its gradient reduce-scattered in one collective —
    and the ``_CORE`` weights whole) and its output layouts (None, None
    without a mesh)."""
    if pl is None:
        return None, None
    from torch.distributed.tensor import Replicate
    bp = shd.batch_placements(zx)
    ins = [bp] * n_state + [(Replicate(),) * len(bp)] * len(_CORE)
    return ins, _layouts(pl, bp)


def ssd_block(p: Dict, x: torch.Tensor, cfg: SsdConfig, shd: Sharder,
              return_state: bool = False):
    """Full-sequence SSD block.  x: (B, S, D) -> (B, S, D).

    ``return_state=True`` additionally returns the decode handoff state
    {"ssm": (B,H,N,P), "conv": (B,k-1,C)} after the last position.

    On a mesh the block is partitioned as the rules say (``ssm_inner ->
    model``): ``w_in`` projects each rank's column shard, the packed
    [z, x, B, C, dt] rows are gathered over the model dim (its column
    shards cut across the five parts), each rank runs the conv and the
    scan of its own heads (every head where they do not divide the model
    dim, as the reference's are replicated then), and ``w_out`` sums
    its row shard's part, partial over the model dim; the gated norm's
    sum of squares is reduced once."""
    bsz, t, _ = x.shape
    zx = _project_in(x, p["w_in"].value)
    pl, h0, hl = _inner_layout(shd, gshape(x), cfg)
    ins, outs = _core_layouts(shd, zx, pl, 1)
    core = lambda zz, *w: _ssd_core(zz, *w, cfg=cfg, h0=h0, hl=hl,
                                    return_state=return_state)
    res = shard_map(core, ins, outs and outs[:3 if return_state else 2],
                    zx, *_core_weights(p, zx.dtype))
    out = _ssd_out(p, res[0], res[1], cfg, shd)
    if not return_state:
        return out
    k = cfg.ssm_conv

    def tail_of(zz):
        pad = max(0, (k - 1) - t)
        tail = zz[:, max(0, t - (k - 1)):, cfg.d_inner:
                  cfg.d_inner + cfg.conv_dim]
        return F.pad(tail, (0, 0, pad, 0)) if pad else tail
    return out, {"ssm": res[2],
                 "conv": per_shard(tail_of, shd.batch_placements(zx), zx)}


def _ssd_core(zx, conv_w, conv_b, a_log, dt_bias, d_skip, *,
              cfg: SsdConfig, h0: int, hl: int, return_state: bool):
    """The conv and the scan of heads [h0, h0 + hl) on local tensors:
    (gated channels, their sum of squares[, the state after the last
    position])."""
    bsz, t, _ = zx.shape
    di, n, pdim = cfg.d_inner, cfg.ssm_state, cfg.head_dim
    hs = slice(h0, h0 + hl)
    z = zx[..., h0 * pdim:(h0 + hl) * pdim]
    xbc_raw = _my_channels(zx[..., di:di + cfg.conv_dim], cfg, h0, hl)
    dt = zx[..., di + cfg.conv_dim:][..., hs]
    xbc = _causal_conv(xbc_raw,
                       _my_channels(conv_w, cfg, h0, hl).to(zx.dtype),
                       _my_channels(conv_b, cfg, h0, hl).to(zx.dtype),
                       cfg.ssm_conv)
    xh = xbc[..., :hl * pdim].reshape(bsz, t, hl, pdim)
    b_in = xbc[..., hl * pdim:hl * pdim + n]
    c_in = xbc[..., hl * pdim + n:]
    a = -torch.exp(a_log[hs].float())                       # (H_loc,)
    dtp = F.softplus(dt.float() + dt_bias[hs].float())
    y, (_a_scan, s_scan) = _ssd_chunked(xh, dtp, a, b_in, c_in, cfg)
    y = y + xh.float() * d_skip[hs].float()[None, None, :, None]
    g = y.reshape(bsz, t, hl * pdim).to(zx.dtype) * F.silu(z)
    ssq = torch.sum(g.float() * g.float(), dim=-1, keepdim=True)
    return (g, ssq, s_scan[:, -1]) if return_state else (g, ssq)


def _ssd_out(p: Dict, g, ssq, cfg: SsdConfig, shd: Sharder, eps=1e-6):
    """The gated RMS norm over d_inner (its sum of squares reduced over
    the ranks' heads) and the output projection."""
    var = settle(ssq, split=g) / cfg.d_inner
    y = like((g.float() * torch.rsqrt(var + eps)
              * weight_like(p["norm_w"].value, g).float()).to(g.dtype), g)
    out = shard_einsum("bse,ed->bsd", y, p["w_out"].value)
    return shd.act(out, ("batch", "residual_seq", "embed"))


def init_ssd_state(bsz: int, cfg: SsdConfig, dtype=torch.float32,
                   device=None):
    """The decode state: the SSM state in float32, the conv window in
    ``dtype`` (the reference's types)."""
    return {
        "ssm": torch.zeros((bsz, cfg.n_heads, cfg.ssm_state, cfg.head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((bsz, cfg.ssm_conv - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
    }


def ssd_decode(p: Dict, x: torch.Tensor, state: Dict, cfg: SsdConfig,
               shd: Sharder) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, D).  On a mesh, partitioned as
    `ssd_block`: each rank steps the state of its own heads (the cache
    rules shard it so), with the conv window gathered over the model
    dim; the new window and state come back in the cache's layout."""
    zx = _project_in(x, p["w_in"].value)
    pl, h0, hl = _inner_layout(shd, gshape(x), cfg)
    ins, outs = _core_layouts(shd, zx, pl, 3)
    if ins is not None:
        # the state on the heads' layout
        ins[1] = outs[2]
    step = lambda zz, ssm, conv, *w: _ssd_step(zz, ssm, conv, *w, cfg=cfg,
                                               h0=h0, hl=hl)
    g, ssq, ssm = shard_map(step, ins, outs, zx, state["ssm"],
                            state["conv"], *_core_weights(p, zx.dtype))
    di = cfg.d_inner
    window = per_shard(
        lambda zz, conv: torch.cat([conv.to(zz.dtype),
                                    zz[..., di:di + cfg.conv_dim]], 1)[:, 1:],
        shd.batch_placements(zx), zx, state["conv"])
    return _ssd_out(p, g, ssq, cfg, shd), {
        "ssm": shd.cache(ssm, ("batch", "ssm_inner", None, None)),
        "conv": shd.cache(window, ("batch", None, "ssm_inner"))}


def _ssd_step(zx, ssm, conv, conv_w, conv_b, a_log, dt_bias, d_skip, *,
              cfg: SsdConfig, h0: int, hl: int):
    """One step of heads [h0, h0 + hl) on local tensors: (gated channels,
    their sum of squares, the new state)."""
    bsz = zx.shape[0]
    di, n, pdim = cfg.d_inner, cfg.ssm_state, cfg.head_dim
    hs = slice(h0, h0 + hl)
    z = zx[..., h0 * pdim:(h0 + hl) * pdim]
    xbc = zx[..., di:di + cfg.conv_dim]                     # (B,1,C)
    dt = zx[..., di + cfg.conv_dim:][..., hs]
    window = _my_channels(torch.cat([conv.to(xbc.dtype), xbc], dim=1), cfg,
                          h0, hl)
    conv_out = torch.einsum("bkc,kc->bc", window, _my_channels(
        conv_w, cfg, h0, hl).to(zx.dtype)) \
        + _my_channels(conv_b, cfg, h0, hl).to(zx.dtype)
    conv_out = F.silu(conv_out)[:, None, :]                 # (B,1,C_loc)
    xin = conv_out[..., :hl * pdim].reshape(bsz, hl, pdim)
    b_in = conv_out[..., hl * pdim:hl * pdim + n].reshape(bsz, n)
    c_in = conv_out[..., hl * pdim + n:].reshape(bsz, n)
    a = -torch.exp(a_log[hs].float())
    dtp = F.softplus(dt[:, 0].float() + dt_bias[hs].float())  # (B,H_loc)
    decay = torch.exp(dtp * a)                              # (B,H_loc)
    upd = torch.einsum("bn,bh,bhp->bhnp", b_in.float(), dtp, xin.float())
    s_new = ssm * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c_in.float(), s_new)
    y = y + xin.float() * d_skip[hs].float()[None, :, None]
    g = y.reshape(bsz, 1, hl * pdim).to(zx.dtype) * F.silu(z)
    ssq = torch.sum(g.float() * g.float(), dim=-1, keepdim=True)
    return g, ssq, s_new
