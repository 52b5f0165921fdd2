"""Shared neural layers of the dense LM (functions over Param trees).

Everything computes in the model's compute type (bf16 by default) with
f32 norms, rope and softmax, as the reference does.

Tuned-op routing (DESIGN.md §15): when tuned layers are enabled —
``use_tuned_layers()`` / ``set_tuned_layers(True)`` / env
``REPRO_TUNED_LAYERS=1`` — ``rms_norm``, the gated ``mlp`` (front half
and down-projection) and full-causal prefill ``attention`` dispatch
through `repro_torch.kernels.ops`, i.e. through the statically ranked
CUDA kernels on the card.  Disabled (the default), every layer runs its
plain PyTorch path.  Decode attention and the QKV / output / lm-head
projections are plain PyTorch either way, as the reference leaves them
to XLA.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from contextvars import ContextVar
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import Sharder
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
        d = x.shape[-1]
        out = _ops().rms_norm(x.reshape(-1, d), w.value, eps=eps)
        return out.reshape(x.shape)
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


def _project_qkv(p: Dict, x: torch.Tensor, cfg: AttnConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].value.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].value.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].value.to(x.dtype))
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


def _sdpa(q, k, v, bias, scale):
    """q: (B,S,H,hd), k/v: (B,Sk,KV,hd) — dense attention, softmax in
    f32, P.V in the value type."""
    h = q.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v)
    return out.to(q.dtype)


def _sdpa_chunked(q, k, v, q_positions, k_positions, window, scale,
                  chunk: int):
    """Query chunks of ``chunk`` rows: O(S * chunk) logits memory."""
    outs = []
    for c0 in range(0, q.shape[1], chunk):
        bias = causal_mask_bias(q_positions[0, c0:c0 + chunk],
                                k_positions[0], window)
        outs.append(_sdpa(q[:, c0:c0 + chunk], k, v, bias, scale))
    return torch.cat(outs, dim=1)


def _attention_tuned(q, k, v, causal: bool):
    """Full attention through the ``flash_attention`` registry op: GQA
    KV heads broadcast up to H, (B,S,H,hd) -> (B,H,S,hd) for the kernel
    layout (contiguous, as the kernels take), and back."""
    h = q.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    t = lambda a: a.transpose(1, 2).contiguous()
    out = _ops().flash_attention(t(q), t(k), t(v), causal)
    return out.transpose(1, 2)


def attention(p: Dict, x: torch.Tensor, cfg: AttnConfig, shd: Sharder,
              positions: Optional[torch.Tensor] = None,
              return_kv: bool = False):
    """Full-sequence (prefill) attention.  x: (B, S, D)."""
    b, s, d = x.shape
    window = cfg.window
    # the tuned kernel implements exactly the standard prefill mask:
    # positions = arange, full causal (or fully bidirectional)
    tuned = tuned_layers_enabled() and positions is None and window == 0
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    q = shd.act(q, ("batch", "seq", "heads", "head_dim"))
    k = shd.act(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = shd.act(v, ("batch", "seq", "kv_heads", "head_dim"))
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if tuned:
        out = _attention_tuned(q, k, v, cfg.causal)
    elif not cfg.causal:
        out = _sdpa(q, k, v, torch.zeros((), device=x.device), scale)
    elif s < cfg.dense_below:
        bias = causal_mask_bias(positions[0], positions[0], window)
        out = _sdpa(q, k, v, bias, scale)
    else:
        out = _sdpa_chunked(q, k, v, positions, positions, window,
                            scale, cfg.chunk_q)
    out = out.to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].value.to(x.dtype))
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
                     shd: Sharder, window_override: Optional[int] = None):
    """One-token decode.  x: (B, 1, D); cache_k/v: (B, S_cache, KV, hd)
    views of the layer's cache, written in place at this step's slot
    (the reference returns new caches; in place saves a cache copy per
    layer and step); ``pos``: the current position; ``window_override``
    a per-call attention window (0 or None: the config's)."""
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    window = window_override or cfg.window
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
    slot = min(pos, s_cache - 1)
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    idx = torch.arange(s_cache, device=x.device)
    ok = idx <= pos
    if window > 0:
        ok &= (pos - idx) < window
    bias = torch.where(ok, 0.0, -1e30).float()[None, :]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    out = _sdpa(q, cache_k, cache_v, bias, scale).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].value.to(x.dtype))
    return y, (cache_k, cache_v)


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
        x2 = x.reshape(b * s, d)
        h = _ops().mlp_matmul(x2, p["w_gate"].value.to(x.dtype),
                              p["w_up"].value.to(x.dtype),
                              act.replace("_glu", ""))
        h = shd.act(h.reshape(b, s, -1), ("batch", "seq", "mlp"))
        f = h.shape[-1]
        y = _ops().matmul(h.reshape(b * s, f),
                          p["w_down"].value.to(x.dtype))
        return shd.act(y.reshape(b, s, d), ("batch", "residual_seq",
                                            "embed"))
    up = torch.einsum("bsd,df->bsf", x, p["w_up"].value.to(x.dtype))
    if "w_gate" in p:
        gate = torch.einsum("bsd,df->bsf", x,
                            p["w_gate"].value.to(x.dtype))
        h = a(gate) * up
    else:
        h = a(up)
    h = shd.act(h, ("batch", "seq", "mlp"))
    y = torch.einsum("bsf,fd->bsd", h, p["w_down"].value.to(x.dtype))
    return shd.act(y, ("batch", "residual_seq", "embed"))
