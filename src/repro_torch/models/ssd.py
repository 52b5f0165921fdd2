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

from repro_torch.distributed.sharding import Sharder, per_shard
from repro_torch.models.params import Param, param

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


def _split_in(p, x, cfg: SsdConfig):
    di = cfg.d_inner
    zxbcdt = torch.einsum("bsd,de->bse", x, p["w_in"].value.to(x.dtype))
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + cfg.conv_dim]
    dt = zxbcdt[..., di + cfg.conv_dim:]
    return z, xbc, dt


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


def ssd_block(p: Dict, x: torch.Tensor, cfg: SsdConfig, shd: Sharder,
              return_state: bool = False):
    """Full-sequence SSD block.  x: (B, S, D) -> (B, S, D).

    ``return_state=True`` additionally returns the decode handoff state
    {"ssm": (B,H,N,P), "conv": (B,k-1,C)} after the last position.

    On a mesh the block runs on each rank's batch shard with its weights
    whole (`per_shard`): ``w_in`` packs [z, x, B, C, dt] along the dim
    the rules shard, so its slices would cut across shards, and DTensor
    merges the sharded batch with the sequence into strided shards whose
    redistribution planner does not finish.  The weights' gradients
    come back partial over the batch shards and are reduced to the
    weights' layout."""
    names = sorted(p)

    def body(xx, *vals):
        q = {k: Param(v, p[k].dims) for k, v in zip(names, vals)}
        out, state = _ssd_block(q, xx, cfg, return_state)
        return (out,) if state is None else (out, state["ssm"],
                                             state["conv"])

    res = per_shard(body, shd.batch_placements(x), x,
                    *(p[k].value for k in names),
                    whole=range(1, len(names) + 1))
    out = shd.act(res[0], ("batch", "residual_seq", "embed"))
    if return_state:
        return out, {"ssm": res[1], "conv": res[2]}
    return out


def _ssd_block(p: Dict, x: torch.Tensor, cfg: SsdConfig,
               return_state: bool):
    """The block on local tensors: (out, state or None)."""
    from repro_torch.models.layers import _rms
    bsz, t, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_heads
    z, xbc_raw, dt = _split_in(p, x, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"].value.to(x.dtype),
                       p["conv_b"].value.to(x.dtype), cfg.ssm_conv)
    xin = xbc[..., :di]
    b_in = xbc[..., di:di + n]
    c_in = xbc[..., di + n:]
    xh = xin.reshape(bsz, t, h, cfg.head_dim)
    a = -torch.exp(p["a_log"].value.float())               # (H,)
    dtp = F.softplus(dt.float() + p["dt_bias"].value.float())
    y, (_a_scan, s_scan) = _ssd_chunked(xh, dtp, a, b_in, c_in, cfg)
    y = y + xc_skip(p, xh)
    y = y.reshape(bsz, t, di).to(x.dtype)
    y = _rms(y * F.silu(z), p["norm_w"].value)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"].value.to(x.dtype))
    if not return_state:
        return out, None
    k = cfg.ssm_conv
    pad = max(0, (k - 1) - t)
    tail = xbc_raw[:, max(0, t - (k - 1)):, :]
    if pad:
        tail = F.pad(tail, (0, 0, pad, 0))
    return out, {"ssm": s_scan[:, -1], "conv": tail}


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
    """One-token decode.  x: (B, 1, D).  On a mesh, as `ssd_block`, on
    each rank's batch shard with the weights whole."""
    names = sorted(p)

    def body(xx, ssm, conv, *vals):
        q = {k: Param(v, p[k].dims) for k, v in zip(names, vals)}
        out, st = _ssd_decode(q, xx, {"ssm": ssm, "conv": conv}, cfg)
        return out, st["ssm"], st["conv"]

    out, ssm, conv = per_shard(body, shd.batch_placements(x), x,
                               state["ssm"], state["conv"],
                               *(p[k].value for k in names),
                               whole=range(3, len(names) + 3))
    return out, {"ssm": ssm, "conv": conv}


def _ssd_decode(p: Dict, x: torch.Tensor, state: Dict, cfg: SsdConfig
                ) -> Tuple[torch.Tensor, Dict]:
    from repro_torch.models.layers import _rms
    bsz = x.shape[0]
    di, n = cfg.d_inner, cfg.ssm_state
    z, xbc, dt = _split_in(p, x, cfg)                       # (B,1,*)
    window = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
    w = p["conv_w"].value.to(x.dtype)
    conv_out = torch.einsum("bkc,kc->bc", window, w) \
        + p["conv_b"].value.to(x.dtype)
    conv_out = F.silu(conv_out)[:, None, :]                 # (B,1,C)
    new_conv = window[:, 1:, :]

    xin = conv_out[..., :di].reshape(bsz, cfg.n_heads, cfg.head_dim)
    b_in = conv_out[..., di:di + n].reshape(bsz, n)
    c_in = conv_out[..., di + n:].reshape(bsz, n)
    a = -torch.exp(p["a_log"].value.float())
    dtp = F.softplus(dt[:, 0].float() + p["dt_bias"].value.float())  # (B,H)
    decay = torch.exp(dtp * a)                              # (B,H)
    upd = torch.einsum("bn,bh,bhp->bhnp", b_in.float(), dtp, xin.float())
    s_new = state["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c_in.float(), s_new)
    y = y + xin.float() * p["d_skip"].value.float()[None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = _rms(y * F.silu(z), p["norm_w"].value)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"].value.to(x.dtype))
    return out, {"ssm": s_new, "conv": new_conv}
