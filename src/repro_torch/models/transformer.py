"""Decoder-only LM, dense family, serving path (prefill + decode).

The reference scans one stacked layer body with ``lax.scan``; the port
keeps the stacked (n_layers, ...) parameters and loops over layers in
Python, slicing layer ``i``'s weights as views.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.distributed.sharding import Sharder
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnConfig, attention,
                                       attention_decode, init_attention,
                                       init_mlp, mlp, rms_norm)
from repro_torch.models.params import Param, param, resolve_device

__all__ = ["attn_config", "init_lm", "lm_logits", "lm_prefill",
           "lm_decode_step", "init_lm_cache"]


def attn_config(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, kv_repeat=cfg.kv_repeat, window=0)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch serves the dense family only; {cfg.name} is "
            f"{cfg.family!r}")


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None) -> Dict:
    """Random parameters (a ``torch.Generator`` seeded with ``seed``),
    reference layouts and init scales, matrices in ``cfg.dtype``.  On
    the ``meta`` device nothing is allocated (graph enumeration)."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    kw = dict(dtype=dtype, device=dev, generator=gen)
    n, d = cfg.n_layers, cfg.d_model
    blocks = {
        "ln1": param((n, d), ("layers", "embed"), init="ones", **kw),
        "attn": init_attention(attn_config(cfg), n_layers=n, **kw),
        "ln2": param((n, d), ("layers", "embed"), init="ones", **kw),
        "mlp": init_mlp(d, cfg.d_ff, cfg.act, n_layers=n, **kw),
    }
    return {
        "embed": param((cfg.vocab, d), ("vocab", "embed"), init="embed",
                       **kw),
        "final_norm": param((d,), ("embed",), init="ones", **kw),
        "lm_head": param((d, cfg.vocab), ("embed", "vocab"),
                         scale=1.0 / math.sqrt(d), **kw),
        "blocks": blocks,
    }


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked block tree (views)."""
    if isinstance(tree, Param):
        return Param(tree.value[i], tree.dims[1:])
    return {k: _layer(v, i) for k, v in tree.items()}


def _block_apply(blk: Dict, h: torch.Tensor, cfg: ModelConfig,
                 shd: Sharder, collect_kv: bool = False):
    """One layer; returns (h, kv) — kv is None unless ``collect_kv``."""
    acfg = attn_config(cfg)
    x = rms_norm(h, blk["ln1"])
    kv = None
    if collect_kv:
        a, kv = attention(blk["attn"], x, acfg, shd, return_kv=True)
    else:
        a = attention(blk["attn"], x, acfg, shd)
    h = h + a
    x2 = rms_norm(h, blk["ln2"])
    return h + mlp(blk["mlp"], x2, cfg.act, shd), kv


def _embed(params, tokens, shd: Sharder, dtype) -> torch.Tensor:
    h = params["embed"].value.to(dtype)[tokens]
    return shd.act(h, ("batch", "residual_seq", "embed"))


def _head(params, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"])
    return torch.einsum("bsd,dv->bsv", h,
                        params["lm_head"].value.to(h.dtype))


def lm_logits(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
              shd: Sharder, collect_kv: bool = False):
    """Forward pass.  tokens: (B, S) -> logits (B, S, V) [, (K, V)
    stacked (L, B, S, KV, hd) when ``collect_kv``]."""
    _check_dense(cfg)
    h = _embed(params, tokens, shd, getattr(torch, cfg.dtype))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, kv = _block_apply(_layer(params["blocks"], i), h, cfg, shd,
                             collect_kv)
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    logits = shd.act(_head(params, h), ("batch", "seq", "vocab"))
    if collect_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def init_lm_cache(cfg: ModelConfig, batch: int, seq_len: int,
                  dtype=None, device=None) -> Dict:
    """Linear KV cache per layer; ``pos`` is a host-side int."""
    dtype = dtype or getattr(torch, cfg.dtype)
    kv, hd = cfg.n_kv * max(cfg.kv_repeat, 1), cfg.hd
    shape = (cfg.n_layers, batch, seq_len, kv, hd)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def lm_decode_step(params: Dict, cache: Dict, token: torch.Tensor,
                   cfg: ModelConfig, shd: Sharder):
    """One decode step.  token: (B, 1) -> (logits (B, 1, V), cache).
    The cache's K/V tensors are updated in place; the returned dict
    carries the advanced position."""
    _check_dense(cfg)
    acfg = attn_config(cfg)
    pos = cache["pos"]
    # The reference's decode scan hands every dense layer the window
    # "full = S_cache" as a traced value, which attention_decode applies
    # as a sliding window ((pos - slot) < S_cache): once pos reaches the
    # cache length the oldest slots drop out.  Keep it for parity.
    window = cache["k"].shape[2]
    h = _embed(params, token, shd, getattr(torch, cfg.dtype))
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        x = rms_norm(h, blk["ln1"])
        a, _ = attention_decode(blk["attn"], x, cache["k"][i],
                                cache["v"][i], pos, acfg, shd,
                                window_override=window)
        h = h + a
        x2 = rms_norm(h, blk["ln2"])
        h = h + mlp(blk["mlp"], x2, cfg.act, shd)
    return _head(params, h), {**cache, "pos": pos + 1}


def lm_prefill(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
               shd: Sharder, max_len: Optional[int] = None):
    """Prefill: full forward collecting per-layer KV -> (logits, cache)
    ready for ``lm_decode_step`` at position s.  ``max_len`` sizes the
    cache (default: exactly the prompt length, as serving uses it)."""
    b, s = tokens.shape
    logits, (k, v) = lm_logits(params, tokens, cfg, shd, collect_kv=True)
    sc = max(s, max_len or 0)
    dtype = getattr(torch, cfg.dtype)
    if sc == s:
        cache = {"pos": s, "k": k.to(dtype), "v": v.to(dtype)}
    else:
        cache = init_lm_cache(cfg, b, sc, dtype, device=tokens.device)
        cache["k"][:, :, :s] = k
        cache["v"][:, :, :s] = v
        cache["pos"] = s
    return logits, cache
