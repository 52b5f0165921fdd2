"""Encoder-decoder LM (whisper-tiny backbone): the training loss
(`encdec_loss`) and the serving path.

The audio frontend is a stub, as in the reference: callers give
precomputed frame embeddings (B, enc_seq, d_model); the conv stem
(`conv_frontend`) exists for completeness.  The backbone is real:
bidirectional encoder (its attention through the tuned kernel,
non-causal), causal decoder with cross-attention (plain, as the
reference leaves it to XLA), a Python loop over each stack's layers,
each layer rematerialised under autograd as ``cfg.remat`` says
(`transformer.remat`).  RMSNorm replaces Whisper's LayerNorm, as in
the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (Sharder, cast, gshape, like,
                                              layer_of, settle,
                                              stack_layers, weight_like)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnConfig, _decode_core, attention,
                                       attention_decode, head_proj,
                                       init_attention, init_mlp, mlp,
                                       rms_norm)
from repro_torch.models.params import param, resolve_device
from repro_torch.models.transformer import (_unstack, embed_lookup,
                                            lm_head_product, next_token_nll,
                                            remat)

__all__ = ["init_encdec", "encdec_prefill", "encdec_decode_step",
           "init_encdec_cache", "conv_frontend", "encode", "encdec_logits",
           "encdec_loss"]


def _acfg(cfg: ModelConfig, causal: bool) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv=cfg.n_kv, head_dim=cfg.hd,
                      rope_theta=cfg.rope_theta, causal=causal)


# ---------------------------------------------------------------------------
# optional conv stem (completeness only; the serving path takes frames)
# ---------------------------------------------------------------------------


def _same_pad(t: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    total = max((-(-t // stride) - 1) * stride + k - t, 0)
    return total // 2, total - total // 2


def conv_frontend(params: Dict, mel: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) -> (B, T//2, d_model): two 1-D convs ("SAME"
    padding, weights (k, cin, cout)), GELU, the second with stride 2."""
    x = mel
    for i, name in enumerate(("conv1", "conv2")):
        w = params[name].value.to(x.dtype)               # (k, cin, cout)
        stride = 1 if i == 0 else 2
        lo, hi = _same_pad(x.shape[1], w.shape[0], stride)
        xc = F.pad(x.transpose(1, 2), (lo, hi))
        x = F.conv1d(xc, w.permute(2, 1, 0), stride=stride).transpose(1, 2)
        x = F.gelu(x, approximate="tanh")
    return x


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_encdec(cfg: ModelConfig, *, seed: int = 0, device=None,
                param_dtype: Optional[torch.dtype] = None) -> Dict:
    """Random parameters, reference layouts and init scales; each stack
    (n_layers, ...) per weight; ``param_dtype`` as `init_lm`'s."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    kw = dict(dtype=param_dtype or getattr(torch, cfg.dtype), device=dev,
              generator=gen)
    d = cfg.d_model

    def gain(n):
        return param((n, d), ("layers", "embed"), init="ones", **kw)

    ne, nd = cfg.enc_layers, cfg.n_layers
    return {
        "enc_pos": param((cfg.enc_seq, d), (None, "embed"), scale=0.02,
                         **kw),
        "enc_blocks": {
            "ln1": gain(ne),
            "attn": init_attention(_acfg(cfg, False), n_layers=ne, **kw),
            "ln2": gain(ne),
            "mlp": init_mlp(d, cfg.d_ff, cfg.act, n_layers=ne, **kw),
        },
        "enc_norm": param((d,), ("embed",), init="ones", **kw),
        "embed": param((cfg.vocab, d), ("vocab", "embed"), init="embed",
                       **kw),
        "dec_blocks": {
            "ln1": gain(nd),
            "attn": init_attention(_acfg(cfg, True), n_layers=nd, **kw),
            "ln_x": gain(nd),
            "xattn": init_attention(_acfg(cfg, False), n_layers=nd, **kw),
            "ln2": gain(nd),
            "mlp": init_mlp(d, cfg.d_ff, cfg.act, n_layers=nd, **kw),
        },
        "final_norm": param((d,), ("embed",), init="ones", **kw),
        "lm_head": param((d, cfg.vocab), ("embed", "vocab"),
                         scale=1.0 / math.sqrt(d), **kw),
    }


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------


def _cross_kv(p: Dict, ctx: torch.Tensor):
    k = head_proj("bsd,dhk->bshk", ctx, p["wk"])
    v = head_proj("bsd,dhk->bshk", ctx, p["wv"])
    return k, v


def _cross_attention(p: Dict, x: torch.Tensor, ek: torch.Tensor,
                     ev: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    q = head_proj("bsd,dhk->bshk", x, p["wq"])
    # on a mesh the core follows the context's layout (`_decode_core`):
    # on each rank's head_dim shard where the rules split head_dim
    out = _decode_core(q, ek, ev, torch.zeros((), device=x.device),
                       1.0 / math.sqrt(cfg.hd))
    # its partial sums over the head shards reduced before the residual
    return settle(head_proj("bshk,hkd->bsd", like(out.to(x.dtype), out),
                            p["wo"]))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def encode(params: Dict, frames: torch.Tensor, cfg: ModelConfig,
           shd: Sharder) -> torch.Tensor:
    """frames: (B, T_enc, d_model) stub embeddings -> encoder output."""
    h = cast(frames, getattr(torch, cfg.dtype))
    pos = weight_like(cast(params["enc_pos"].value, h.dtype), h)
    h = like(h + pos[None, :gshape(h)[1]], h)
    h = shd.act(h, ("batch", "residual_seq", "embed"))
    acfg = _acfg(cfg, causal=False)
    for blk in _unstack(params["enc_blocks"], cfg.enc_layers):
        def layer(hh, blk=blk):
            hh = like(hh + attention(blk["attn"], rms_norm(hh, blk["ln1"]),
                                     acfg, shd), hh)
            return like(hh + mlp(blk["mlp"], rms_norm(hh, blk["ln2"]),
                                 cfg.act, shd), hh)
        h = remat(layer, cfg)(h)
    return rms_norm(h, params["enc_norm"])


def _decode_stack(params, h, enc_out, cfg: ModelConfig, shd: Sharder,
                  collect_kv: bool = False):
    """The decoder over a prompt; with ``collect_kv`` also returns the
    self-attention K/V and the cross K/V, each stacked (L, ...).
    Under autograd each layer is rematerialised (`remat`)."""
    acfg = _acfg(cfg, causal=True)

    def layer(hh, blk):
        a_in = rms_norm(hh, blk["ln1"])
        if collect_kv:
            a, kv = attention(blk["attn"], a_in, acfg, shd, return_kv=True)
        else:
            a, kv = attention(blk["attn"], a_in, acfg, shd), None
        hh = like(hh + a, hh)
        ek, ev = _cross_kv(blk["xattn"], enc_out)
        hh = like(hh + _cross_attention(blk["xattn"],
                                        rms_norm(hh, blk["ln_x"]), ek, ev,
                                        cfg), hh)
        hh = like(hh + mlp(blk["mlp"], rms_norm(hh, blk["ln2"]), cfg.act,
                           shd), hh)
        return hh, kv, (ek, ev)

    ys = []
    for blk in _unstack(params["dec_blocks"], cfg.n_layers):
        h, kv, ekv = remat(lambda hh, blk=blk: layer(hh, blk), cfg)(h)
        if collect_kv:
            ys.append(kv + ekv)
    if not collect_kv:
        return h, None
    k, v, ek, ev = (stack_layers(t) for t in zip(*ys))
    return h, ((k, v), (ek, ev))


def _head(params, h: torch.Tensor, shd: Sharder) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"])
    logits = lm_head_product(h, params["lm_head"].value)
    return shd.act(logits, ("batch", "seq", "vocab"))


def encdec_logits(params: Dict, frames: torch.Tensor, tokens: torch.Tensor,
                  cfg: ModelConfig, shd: Sharder, collect_kv: bool = False):
    enc_out = encode(params, frames, cfg, shd)
    h = embed_lookup(params["embed"].value, tokens, shd,
                     getattr(torch, cfg.dtype))
    h = shd.act(h, ("batch", "residual_seq", "embed"))
    h, ys = _decode_stack(params, h, enc_out, cfg, shd, collect_kv)
    logits = _head(params, h, shd)
    return (logits, ys) if collect_kv else logits


def encdec_loss(params: Dict, batch: Dict, cfg: ModelConfig, shd: Sharder
                ) -> Tuple[torch.Tensor, Dict]:
    """The decoder's next-token cross entropy (f32 logsumexp) given the
    batch's ``frames``; no aux loss."""
    tokens = batch["tokens"]
    logits = encdec_logits(params, batch["frames"], tokens, cfg, shd)
    nll = next_token_nll(logits, tokens)
    return nll, {"nll": nll, "loss": nll,
                 "aux": torch.zeros((), dtype=torch.float32,
                                    device=nll.device)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_encdec_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype=None, device=None) -> Dict:
    dtype = dtype or getattr(torch, cfg.dtype)
    kv, hd = cfg.n_kv, cfg.hd
    zeros = lambda s: torch.zeros((cfg.n_layers, batch, s, kv, hd),
                                  dtype=dtype, device=device)
    return {"pos": 0, "k": zeros(seq_len), "v": zeros(seq_len),
            "ek": zeros(cfg.enc_seq), "ev": zeros(cfg.enc_seq)}


def encdec_prefill(params: Dict, frames: torch.Tensor, tokens: torch.Tensor,
                   cfg: ModelConfig, shd: Sharder, max_len: int = 0):
    """(logits, cache): `init_encdec_cache`'s entries made from what the
    prompt left (on a mesh each rank's shards, laid out by the cache
    rules), the self-attention K/V zero past the prompt up to
    ``max_len``."""
    s = gshape(tokens)[1]
    logits, ((k, v), (ek, ev)) = encdec_logits(params, frames, tokens, cfg,
                                               shd, collect_kv=True)
    dtype = getattr(torch, cfg.dtype)
    pad = max(s, max_len or 0) - s
    grow = (lambda t: like(F.pad(
        t, (0, 0, 0, 0, 0, pad)), t)) if pad else (lambda t: t)
    return logits, {"k": grow(cast(k, dtype)), "v": grow(cast(v, dtype)),
                    "ek": cast(ek, dtype), "ev": cast(ev, dtype), "pos": s}


def encdec_decode_step(params: Dict, cache: Dict, token: torch.Tensor,
                       cfg: ModelConfig, shd: Sharder):
    """One decode step; the self-attention K/V are written in place."""
    dtype = getattr(torch, cfg.dtype)
    pos = cache["pos"]
    h = embed_lookup(params["embed"].value, token, shd, dtype)
    acfg = _acfg(cfg, causal=True)
    for i, blk in enumerate(_unstack(params["dec_blocks"], cfg.n_layers)):
        layer = lambda name: layer_of(cache[name][i], cache[name])
        a, _ = attention_decode(blk["attn"], rms_norm(h, blk["ln1"]),
                                layer("k"), layer("v"), pos, acfg, shd)
        h = like(h + settle(a), h)
        x_in = rms_norm(h, blk["ln_x"])
        h = like(h + _cross_attention(blk["xattn"], x_in,
                                      cast(layer("ek"), h.dtype),
                                      cast(layer("ev"), h.dtype), cfg), h)
        h = like(h + mlp(blk["mlp"], rms_norm(h, blk["ln2"]), cfg.act, shd),
                 h)
    return _head(params, h, shd), {**cache, "pos": pos + 1}
