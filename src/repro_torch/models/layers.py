"""Shared neural layers (functions over Param trees).

Everything computes in the model's compute type (bf16 by default) with
f32 norms, rope and softmax, as the reference does.

Tuned-op routing (DESIGN.md §15): when tuned layers are enabled —
``use_tuned_layers()`` / ``set_tuned_layers(True)`` / env
``REPRO_TUNED_LAYERS=1`` — ``rms_norm``, the gated ``mlp`` (front half
and down-projection) and unwindowed prefill ``attention`` (causal, or
bidirectional in an encoder) dispatch through `repro_torch.kernels.ops`,
i.e. through the statically ranked CUDA kernels on the card.  Disabled
(the default), every layer runs its plain PyTorch path.  Decode attention and the QKV / output / lm-head
projections are plain PyTorch either way, as the reference leaves them
to XLA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
from contextvars import ContextVar
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (Sharder, local, per_shard,
                                              settle, shard_einsum,
                                              shard_map)
from repro_torch.models.params import Param, param

__all__ = ["rms_norm", "make_rope", "apply_rope", "init_attention",
           "attention", "attention_decode", "init_mlp", "mlp",
           "causal_mask_bias", "AttnConfig", "set_tuned_layers",
           "use_tuned_layers", "tuned_layers_enabled"]


# ---------------------------------------------------------------------------
# tuned-op routing flag
# ---------------------------------------------------------------------------

_TUNED_LAYERS: "ContextVar[Optional[bool]]" = ContextVar(
    "repro_torch_tuned_layers", default=None)


def tuned_layers_enabled() -> bool:
    """True when layers should dispatch through `repro_torch.kernels.ops`.

    Explicit `set_tuned_layers` / `use_tuned_layers` state wins; with
    neither set, the env var ``REPRO_TUNED_LAYERS`` decides (off by
    default)."""
    v = _TUNED_LAYERS.get()
    if v is not None:
        return v
    return os.environ.get("REPRO_TUNED_LAYERS", "0").lower() \
        not in ("", "0", "false", "no")


def set_tuned_layers(on: bool) -> None:
    """Context-wide switch; `use_tuned_layers` is the scoped variant."""
    _TUNED_LAYERS.set(bool(on))


@contextlib.contextmanager
def use_tuned_layers(on: bool = True):
    """Scope in which layers route through the tuned kernel registry."""
    tok = _TUNED_LAYERS.set(bool(on))
    try:
        yield
    finally:
        _TUNED_LAYERS.reset(tok)


def _ops():
    # deferred: repro_torch.kernels registers every kernel on first use
    from repro_torch.kernels import ops
    return ops


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: Param, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with gamma stored directly (init ones); f32 math.  Tuned
    route: (tokens, D) rows through the ``rms_norm`` registry op."""
    if tuned_layers_enabled():
        # on a mesh a tuned op sees whole operands (`local`), as the
        # reference's Pallas calls do under GSPMD
        return local(lambda xx, ww: _ops().rms_norm(
            xx.reshape(-1, xx.shape[-1]), ww, eps=eps).reshape(xx.shape),
            x, w.value)
    return _rms(x, w.value, eps)


def _rms(x, w, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def make_rope(head_dim: int, theta: float = 1e4, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (..., S, head_dim); positions: (..., S) (broadcastable)."""
    ang = positions[..., None].float() * inv_freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: int = 0              # 0 = full attention
    causal: bool = True          # False: bidirectional (encoder)
    chunk_q: int = 1024          # chunked path q-block for long seqs
    dense_below: int = 4096      # use dense logits for S < this
    kv_repeat: int = 1           # replicate KV heads in the decode cache


def init_attention(cfg: AttnConfig, *, n_layers: int, dtype, device,
                   generator) -> Dict:
    """Stacked (n_layers, ...) attention weights, reference layouts."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    mk = lambda shape, dims, **kw: param(
        (n_layers,) + shape, ("layers",) + dims, dtype=dtype, device=device,
        generator=generator, fan_in=shape[0], **kw)
    p = {
        "wq": mk((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": mk((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": mk((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": mk((h, hd, d), ("heads", "head_dim", "embed"),
                 scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = mk((h, hd), ("heads", "head_dim"), init="zeros")
        p["bk"] = mk((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = mk((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = mk((hd,), ("head_dim",), init="ones")
        p["k_norm"] = mk((hd,), ("head_dim",), init="ones")
    return p


def head_proj(eq: str, x: torch.Tensor, w: Param) -> torch.Tensor:
    """``einsum(eq, x, w)`` for a (d, heads, head_dim) or (heads,
    head_dim, d) projection ``w``, cast to ``x``'s type.  On a mesh it is
    `shard_einsum`: each rank projects onto its heads, or, where the
    rules shard head_dim because the heads do not divide the model dim,
    onto its head_dim shard (the output projection then sums its
    head_dim shard's part, partial over the model dim) — the reference's
    ``head_dim`` fallback."""
    return shard_einsum(eq, x, w.value)


def _project_qkv(p: Dict, x: torch.Tensor, cfg: AttnConfig, positions):
    q = head_proj("bsd,dhk->bshk", x, p["wq"])
    k = head_proj("bsd,dhk->bshk", x, p["wk"])
    v = head_proj("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].value.to(x.dtype)
        k = k + p["bk"].value.to(x.dtype)
        v = v + p["bv"].value.to(x.dtype)
    if cfg.qk_norm:
        q = _rms(q, p["q_norm"].value)
        k = _rms(k, p["k_norm"].value)
    inv = make_rope(cfg.head_dim, cfg.rope_theta, device=x.device)
    q = apply_rope(q, positions[:, :, None], inv)
    k = apply_rope(k, positions[:, :, None], inv)
    return q, k, v


def causal_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Additive bias (0 / -1e30), (Sq, Sk); ``window`` 0 = full causal."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(ok, 0.0, -1e30).float()


def _repeat_kv(k, h):
    """Broadcast GQA KV heads (B, S, KV, hd) up to H heads."""
    b, s, kvh, hd = k.shape
    if kvh == h:
        return k
    return k[:, :, :, None, :].expand(b, s, kvh, h // kvh, hd) \
        .reshape(b, s, h, hd)


def _sdpa(q, k, v, bias, scale, split: Tuple[int, ...] = ()):
    """q: (B,S,H,hd), k/v: (B,Sk,KV,hd) — dense attention, softmax in
    f32, P.V in the value type.  On a mesh the core runs on each rank's
    (batch, heads) shards (`per_shard`): on a mesh of three dims
    DTensor's rules for its batched products merge the two sharded dims
    into a strided shard whose redistribution planner did not finish.
    Along the mesh dims ``split`` (where the output projection shards
    head_dim, the heads being whole) each rank forms P.V on its own
    head_dim shard only, as the reference's program does, and the
    output comes back sharded there."""
    h = q.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    q = settle(q)           # a decode step's q may be a pending sum
    core = functools.partial(_sdpa_core, scale=scale)
    qp = getattr(q, "placements", None)
    if qp is None or not split:
        return per_shard(core, qp, q, k, v, bias)
    from torch.distributed.tensor import Shard
    op = tuple(Shard(3) if i in split else p for i, p in enumerate(qp))
    return shard_map(core, (qp, qp, op, None), op, q, k, v, bias)


def _head_dim_split(w: Param) -> Tuple[int, ...]:
    """The mesh dims over which an output projection ``w`` (heads,
    head_dim, d) shards head_dim, its heads being whole."""
    pl = getattr(w.value, "placements", None)
    if pl is None or any(p.is_shard() and p.dim == 0 for p in pl):
        return ()
    return tuple(i for i, p in enumerate(pl) if p.is_shard() and p.dim == 1)


def _sdpa_core(q, k, v, bias, scale):
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v)
    return out.to(q.dtype)


def _sdpa_chunked(q, k, v, q_positions, k_positions, window, scale,
                  chunk: int, split: Tuple[int, ...] = ()):
    """Query chunks of ``chunk`` rows: O(S * chunk) logits memory."""
    outs = []
    for c0 in range(0, q.shape[1], chunk):
        bias = causal_mask_bias(q_positions[0, c0:c0 + chunk],
                                k_positions[0], window)
        outs.append(_sdpa(q[:, c0:c0 + chunk], k, v, bias, scale, split))
    return torch.cat(outs, dim=1)


def _attention_tuned(q, k, v, causal: bool):
    """Full attention through the ``flash_attention`` registry op: GQA
    KV heads broadcast up to H, (B,S,H,hd) -> (B,H,S,hd) for the kernel
    layout (contiguous, as the kernels take), and back."""
    h = q.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    t = lambda a: a.transpose(1, 2).contiguous()
    return local(lambda qq, kk, vv: _ops().flash_attention(
        t(qq), t(kk), t(vv), causal).transpose(1, 2), q, k, v)


def attention(p: Dict, x: torch.Tensor, cfg: AttnConfig, shd: Sharder,
              positions: Optional[torch.Tensor] = None,
              return_kv: bool = False,
              window_override: Optional[int] = None):
    """Full-sequence (prefill) attention.  x: (B, S, D).

    ``window_override`` replaces ``cfg.window`` for this call (the
    hybrid family's per-layer windows, where "full" is the sequence
    length, never 0 — so those layers keep the plain masked path, as
    the reference's traced windows do)."""
    b, s, d = x.shape
    window = cfg.window if window_override is None else window_override
    # the tuned kernel implements exactly the standard prefill mask:
    # positions = arange, full causal (or fully bidirectional)
    tuned = tuned_layers_enabled() and positions is None and window == 0
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    # on a mesh the positions (and the rope angles made from them) take
    # the batch's layout: a plain table would join the mesh whole
    q, k, v = _project_qkv(p, x, cfg, shd.act(positions, ("batch", "seq")))
    q = shd.act(q, ("batch", "seq", "heads", "head_dim"))
    k = shd.act(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = shd.act(v, ("batch", "seq", "kv_heads", "head_dim"))
    scale = 1.0 / math.sqrt(cfg.head_dim)
    split = _head_dim_split(p["wo"])
    if tuned:
        out = _attention_tuned(q, k, v, cfg.causal)
    elif not cfg.causal:
        out = _sdpa(q, k, v, torch.zeros((), device=x.device), scale,
                    split)
    elif s < cfg.dense_below:
        bias = causal_mask_bias(positions[0], positions[0], window)
        out = _sdpa(q, k, v, bias, scale, split)
    else:
        out = _sdpa_chunked(q, k, v, positions, positions, window,
                            scale, cfg.chunk_q, split)
    out = out.to(x.dtype)
    y = head_proj("bshk,hkd->bsd", out, p["wo"])
    y = shd.act(y, ("batch", "residual_seq", "embed"))
    if return_kv:
        if cfg.kv_repeat > 1:
            k = torch.repeat_interleave(k, cfg.kv_repeat, dim=2)
            v = torch.repeat_interleave(v, cfg.kv_repeat, dim=2)
        kc = shd.cache(k, ("batch", "cache_seq", "kv_heads", "head_dim"))
        vc = shd.cache(v, ("batch", "cache_seq", "kv_heads", "head_dim"))
        return y, (kc, vc)
    return y


def attention_decode(p: Dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg: AttnConfig,
                     shd: Sharder, window_override: Optional[int] = None,
                     rolling: bool = False):
    """One-token decode.  x: (B, 1, D); cache_k/v: (B, S_cache, KV, hd)
    views of the layer's cache, written in place at this step's slot
    (the reference returns new caches; in place saves a cache copy per
    layer and step); ``pos``: the current position; ``window_override``
    a per-call attention window (None: the config's; 0: none).

    ``rolling=True`` treats the cache as a mod-S_cache ring buffer
    (windowed layers / capped long-context decode); the effective
    attention span is ``min(window, S_cache)``."""
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    window = cfg.window if window_override is None else window_override
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    if cfg.kv_repeat > 1:
        k_new = torch.repeat_interleave(k_new, cfg.kv_repeat, dim=2)
        v_new = torch.repeat_interleave(v_new, cfg.kv_repeat, dim=2)
    # The reference writes with jax.lax.dynamic_update_slice, which
    # clamps a start index past the end to the last slot: a cache sized
    # to the prompt (what serving's prefill builds) keeps overwriting
    # its last entry.  Reproduce the clamp so greedy tokens agree; a
    # plain slice assignment would go out of range instead.
    slot = pos % s_cache if rolling else min(pos, s_cache - 1)
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    idx = torch.arange(s_cache, device=x.device)
    if rolling:
        # ring buffer: entry i holds absolute position p = i (mod S_c),
        # valid if it was written (p <= pos) and inside the window
        age = (pos - idx) % s_cache
        span = min(window if window > 0 else s_cache, s_cache)
        ok = (age < span) & (age <= pos)
    else:
        ok = idx <= pos
        if window > 0:
            ok &= (pos - idx) < window
    bias = torch.where(ok, 0.0, -1e30).float()[None, :]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    out = _decode_core(q, cache_k, cache_v, bias, scale).to(x.dtype)
    y = head_proj("bshk,hkd->bsd", out, p["wo"])
    return y, (cache_k, cache_v)


def _decode_core(q, k, v, bias, scale):
    """The decode step's attention over the cache.  Where the cache
    rules split head_dim over a mesh dim (the heads do not divide it),
    the core runs on each rank's head_dim shard as the reference's does:
    the logits are partial sums over the shards, reduced once (one
    value per cached position), and P.V is each shard's; otherwise
    `_sdpa` on the cache's (batch, heads) shards."""
    kp = getattr(k, "placements", None)
    if kp is None or not any(p.is_shard() and p.dim == 3 for p in kp):
        if kp is not None:
            # q on the cache's layout, not the whole batch DTensor's
            # projection may leave it in
            q = q.redistribute(q.device_mesh, kp)
        return _sdpa(q, k, v, bias, scale)
    from torch.distributed.tensor import Partial, Replicate
    h = q.shape[2]
    kp = tuple(kp)
    split = lambda part: tuple(part if p.is_shard() and p.dim == 3 else p
                               for p in kp)
    logits = shard_map(
        lambda qq, kk: torch.einsum("bqhd,bshd->bhqs", qq.float(),
                                    _repeat_kv(kk, h).float()) * scale,
        (kp, kp), split(Partial()), q, k)
    probs = torch.softmax(settle(logits) + bias, dim=-1).to(v.dtype)
    out = shard_map(
        lambda pp, vv: torch.einsum("bhqs,bshd->bqhd", pp,
                                    _repeat_kv(vv, h)),
        (split(Replicate()), kp), kp, probs, v)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# mlp
# ---------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def init_mlp(d_model: int, d_ff: int, act: str = "silu_glu", *,
             n_layers: int, dtype, device, generator) -> Dict:
    mk = lambda shape, dims: param(
        (n_layers,) + shape, ("layers",) + dims, dtype=dtype, device=device,
        generator=generator, fan_in=shape[0])
    p = {"w_up": mk((d_model, d_ff), ("embed", "mlp")),
         "w_down": mk((d_ff, d_model), ("mlp", "embed"))}
    if act.endswith("_glu"):
        p["w_gate"] = mk((d_model, d_ff), ("embed", "mlp"))
    return p


def mlp(p: Dict, x: torch.Tensor, act: str, shd: Sharder) -> torch.Tensor:
    a = _ACTS[act.replace("_glu", "")]
    b, s, d = x.shape
    if tuned_layers_enabled() and "w_gate" in p:
        # gated front half act(x@w_gate) * (x@w_up) as one registry op
        # (variant-arbitrated fused/stream/split), then the
        # down-projection through the tuned matmul.
        # (on a mesh each op sees whole operands: `local`)
        h = local(lambda xx, wg, wu: _ops().mlp_matmul(
            xx.reshape(b * s, d), wg, wu, act.replace("_glu", "")),
            x, p["w_gate"].value.to(x.dtype), p["w_up"].value.to(x.dtype))
        h = shd.act(h.reshape(b, s, -1), ("batch", "seq", "mlp"))
        f = h.shape[-1]
        y = local(lambda hh, wd: _ops().matmul(hh.reshape(b * s, f), wd),
                  h, p["w_down"].value.to(x.dtype))
        return shd.act(y.reshape(b, s, d), ("batch", "residual_seq",
                                            "embed"))
    up = shard_einsum("bsd,df->bsf", x, p["w_up"].value)
    if "w_gate" in p:
        h = a(shard_einsum("bsd,df->bsf", x, p["w_gate"].value)) * up
    else:
        h = a(up)
    h = shd.act(h, ("batch", "seq", "mlp"))
    y = shard_einsum("bsf,fd->bsd", h, p["w_down"].value)
    return shd.act(y, ("batch", "residual_seq", "embed"))
