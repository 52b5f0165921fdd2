"""Decoder-only LM covering the dense / moe / ssm / hybrid families:
the training loss (`lm_loss`) and the serving path (prefill + decode).

The reference scans one stacked layer body with ``lax.scan``; the port
keeps the stacked (n_layers, ...) parameters and loops over layers in
Python, slicing layer ``i``'s weights as views.  Per-layer
heterogeneity is the reference's: hymba's sliding-vs-global windows
are per-layer ints (`hybrid_windows`), moonshot's leading dense layers
a small ``prefix_blocks`` stack with its own ``k_pre``/``v_pre`` cache.

Under autograd each layer is rematerialised as ``cfg.remat`` says
(`remat`), as the reference wraps its scan body in ``jax.checkpoint``:
``full`` keeps only the layer's input, ``dots`` also the matrix
products' outputs.  Serving runs without grad and takes none of it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (Sharder, batch_only, cast,
                                              gshape, layer_of, layout,
                                              like, per_shard, relayout,
                                              settle, shard_einsum,
                                              shard_map, shard_mean,
                                              shard_range, stack_layers, tag,
                                              weight_like)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnConfig, _rms, attention,
                                       attention_decode, init_attention,
                                       init_mlp, mlp, rms_norm)
from repro_torch.models.moe import init_moe, moe_layer
from repro_torch.models.params import Param, param, resolve_device
from repro_torch.models.ssd import (SsdConfig, init_ssd, ssd_block,
                                    ssd_decode)

__all__ = ["attn_config", "ssd_config", "init_lm", "lm_logits", "lm_loss",
           "lm_prefill", "lm_decode_step", "init_lm_cache", "hybrid_windows",
           "remat"]


def attn_config(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, kv_repeat=cfg.kv_repeat,
        window=0)  # per-layer windows flow through window_override


def ssd_config(cfg: ModelConfig) -> SsdConfig:
    return SsdConfig(d_model=cfg.d_model, ssm_state=cfg.ssm_state,
                     ssm_conv=cfg.ssm_conv, expand=cfg.ssm_expand,
                     head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk)


def hybrid_windows(cfg: ModelConfig, seq_len: int,
                   n_layers: int) -> List[int]:
    """Per-layer attention windows.  A window >= seq_len acts as full
    causal attention: full is encoded as seq_len, never as 0, as the
    reference's traced windows are — so a windowed family's attention
    keeps the plain masked path on every layer, global ones included."""
    full = max(int(seq_len), 1)
    if cfg.family != "hybrid" or cfg.swa_window <= 0:
        return [full] * n_layers
    glb = {0, n_layers // 2, n_layers - 1}
    return [full if i in glb else min(cfg.swa_window, full)
            for i in range(n_layers)]


def _n_main(cfg: ModelConfig) -> int:
    """Layers of the main stack (a MoE config's dense prefix apart)."""
    return (cfg.n_layers - cfg.first_dense_layers if cfg.family == "moe"
            else cfg.n_layers)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_blocks(cfg: ModelConfig, n: int, moe: bool, kw: Dict) -> Dict:
    """One stack of ``n`` layers, (n, ...) per weight."""
    d = cfg.d_model
    gain = lambda: param((n, d), ("layers", "embed"), init="ones", **kw)
    blk: Dict = {"ln1": gain()}
    fam = cfg.family
    if fam in ("dense", "moe", "hybrid"):
        blk["attn"] = init_attention(attn_config(cfg), n_layers=n, **kw)
        blk["ln2"] = gain()
        if moe:
            blk["moe"] = init_moe(d, cfg.d_ff_expert, cfg.n_experts,
                                  cfg.n_shared, cfg.act,
                                  pad_to=cfg.pad_experts_to, n_layers=n,
                                  **kw)
        else:
            blk["mlp"] = init_mlp(d, cfg.d_ff, cfg.act, n_layers=n, **kw)
    if fam in ("ssm", "hybrid"):
        blk["ssd"] = init_ssd(ssd_config(cfg), n_layers=n, **kw)
    if fam == "hybrid":
        for name in ("norm_a", "norm_m", "beta_a", "beta_m"):
            blk[name] = gain()
    return blk


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None,
            param_dtype: Optional[torch.dtype] = None) -> Dict:
    """Random parameters (a ``torch.Generator`` seeded with ``seed``),
    reference layouts and init scales, matrices in ``cfg.dtype`` — or
    in ``param_dtype`` (training's f32 masters: every leaf f32).  On
    the ``meta`` device nothing is allocated (graph enumeration)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                         f"decoder-only LM")
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    kw = dict(dtype=param_dtype or getattr(torch, cfg.dtype), device=dev,
              generator=gen)
    d = cfg.d_model
    p = {
        "embed": param((cfg.vocab, d), ("vocab", "embed"), init="embed",
                       **kw),
        "final_norm": param((d,), ("embed",), init="ones", **kw),
        "lm_head": param((d, cfg.vocab), ("embed", "vocab"),
                         scale=1.0 / math.sqrt(d), **kw),
    }
    if cfg.family == "moe" and cfg.first_dense_layers:
        p["prefix_blocks"] = _init_blocks(cfg, cfg.first_dense_layers,
                                          False, kw)
    p["blocks"] = _init_blocks(cfg, _n_main(cfg), cfg.family == "moe", kw)
    return p


def _unstack(tree, n: int) -> List[Dict]:
    """Every layer's slice of a stacked block tree, by one ``unbind``
    per weight: its backward stacks the layers' gradients once, where
    ``n`` indexings would each add a full-stack buffer."""
    if isinstance(tree, Param):
        return [Param(layer_of(v, tree.value), tree.dims[1:])
                for v in tree.value.unbind(0)]
    per = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: per[k][i] for k in per} for i in range(n)]


# ---------------------------------------------------------------------------
# blocks (prefill path)
# ---------------------------------------------------------------------------


def _full_attention(cfg: ModelConfig) -> bool:
    """True when every layer runs full (unwindowed) attention: the
    per-layer window is then dropped, so the static ``window == 0``
    gate routes attention through the tuned kernel."""
    return cfg.family != "hybrid" or cfg.swa_window <= 0


def _hybrid_mix(blk: Dict, a: torch.Tensor, m: torch.Tensor, dtype):
    """Hymba's parallel heads: the normed attention and SSD outputs,
    each with its gain, averaged."""
    g = lambda name, x: weight_like(blk[name].value, x)
    beta = lambda name, x: weight_like(cast(blk[name].value, dtype), x)
    return like(0.5 * (_rms(a, g("norm_a", a)) * beta("beta_a", a)
                       + _rms(m, g("norm_m", m)) * beta("beta_m", m)), a)


def _moe(blk: Dict, x: torch.Tensor, cfg: ModelConfig, shd: Sharder):
    return moe_layer(blk["moe"], x, n_experts=cfg.n_experts,
                     top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                     act=cfg.act, shd=shd, pad_to=cfg.pad_experts_to,
                     dispatch=cfg.moe_dispatch)


def _block_apply(blk: Dict, h: torch.Tensor, cfg: ModelConfig,
                 shd: Sharder, collect_kv: bool = False, *,
                 window: Optional[int] = None, moe: bool = False):
    """One layer; returns (h, aux_loss, (kv, ssm_state)) — aux is None
    unless ``moe``, the last two None unless ``collect_kv`` (prefill
    handoff)."""
    acfg = attn_config(cfg)
    if _full_attention(cfg):
        window = None               # static full attention (cfg.window=0)
    aux = kv = sstate = None
    fam = cfg.family
    x = rms_norm(h, blk["ln1"])
    if fam == "ssm":
        if collect_kv:
            y, sstate = ssd_block(blk["ssd"], x, ssd_config(cfg), shd,
                                  return_state=True)
        else:
            y = ssd_block(blk["ssd"], x, ssd_config(cfg), shd)
        return like(h + y, h), aux, (kv, sstate)
    if collect_kv:
        a, kv = attention(blk["attn"], x, acfg, shd, return_kv=True,
                          window_override=window)
    else:
        a = attention(blk["attn"], x, acfg, shd, window_override=window)
    if fam == "hybrid":
        if collect_kv:
            m, sstate = ssd_block(blk["ssd"], x, ssd_config(cfg), shd,
                                  return_state=True)
        else:
            m = ssd_block(blk["ssd"], x, ssd_config(cfg), shd)
        h = like(h + _hybrid_mix(blk, a, m, h.dtype), h)
    else:
        h = like(h + a, h)
    x2 = rms_norm(h, blk["ln2"])
    if moe:
        y, aux = _moe(blk, x2, cfg, shd)
    else:
        y = mlp(blk["mlp"], x2, cfg.act, shd)
    return like(h + y, h), aux, (kv, sstate)


# the matrix products a ``dots`` layer keeps for its backward (einsum
# lowers to these), as the reference's ``dots_saveable`` keeps its dots
_MATMULS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default))


def _save_matmuls(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` (one layer) rematerialised in its backward per
    ``cfg.remat``: ``none`` keeps every activation, ``full`` only the
    inputs, ``dots`` also the matrix products' outputs.  Without grad
    (serving) ``fn`` runs as is."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: none | full | dots")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _run_blocks(blocks: Dict, h: torch.Tensor, windows: List[int],
                cfg: ModelConfig, shd: Sharder, moe: bool, aux_total,
                collect_kv: bool = False):
    """Every layer of one stack.  Returns (h, aux_total, (kvs, states)):
    with ``collect_kv``, K/V stacked (L, B, S, KV, hd) and the SSM
    states stacked (L, ...), each None where the family has none.
    Under autograd each layer is rematerialised (`remat`)."""
    ks, vs, ssm, conv = [], [], [], []
    for blk, win in zip(_unstack(blocks, len(windows)), windows):
        def layer(hh, blk=blk, win=win):
            return _block_apply(blk, hh, cfg, shd, collect_kv, window=win,
                                moe=moe)
        h, aux, (kv, st) = remat(layer, cfg)(h)
        if aux is not None:
            aux_total = aux_total + aux
        if kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
        if st is not None:
            ssm.append(st["ssm"])
            conv.append(st["conv"])
    kvs = (stack_layers(ks), stack_layers(vs)) if ks else None
    states = ({"ssm": stack_layers(ssm), "conv": stack_layers(conv)}
              if ssm else None)
    return h, aux_total, (kvs, states)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, shd: Sharder,
                 dtype) -> torch.Tensor:
    """``table[tokens]`` in ``dtype``.  On a mesh the lookup runs on each
    rank's part of the table, as the reference's compiled program runs
    it, and the table is never gathered: along a mesh dim that shards
    the embed dim every token is looked up in the rank's columns (the
    tokens gathered, the rows left split over the embed dim for the
    batch to move them onto: an all-to-all); along
    one that shards the vocab each rank picks the tokens in its own
    rows, zero elsewhere, a partial sum; elsewhere the rank's batch
    shard.  The result is laid out over its batch shards, every other
    dim whole.  The lookup indexes local tensors (`shard_map`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    lay = layout(table)
    if lay is None:
        return per_shard(lambda t, w: w.to(dtype)[t],
                         shd.batch_placements(tokens), tokens, table)
    mesh, wp = lay.mesh, tuple(lay.placements)
    bp = shd.batch_placements(tokens) or (Replicate(),) * mesh.ndim
    tp, op = [], []
    for w, b in zip(wp, bp):
        if w.is_shard(1):                 # the rank's columns, every token
            tp.append(Replicate()), op.append(Shard(2))
        elif w.is_shard(0):               # the rank's rows: a partial sum
            tp.append(Replicate()), op.append(Partial())
        else:
            tp.append(b), op.append(b)
    vocab = gshape(table)[0]
    lo, n = shard_range(mesh, wp, 0, vocab)

    def look(t, w):
        w = w.to(dtype)
        if n == vocab:
            return w[t]
        idx = t - lo
        ok = (idx >= 0) & (idx < n)
        return torch.where(ok[..., None], w[idx.clamp(0, n - 1)],
                           torch.zeros((), dtype=dtype, device=w.device))
    h = shard_map(look, (tuple(tp), wp), tuple(op), tokens, table,
                  mesh=mesh)
    return relayout(h, bp)


def _embed(params, tokens, shd: Sharder, dtype) -> torch.Tensor:
    h = embed_lookup(params["embed"].value, tokens, shd, dtype)
    return shd.act(h, ("batch", "residual_seq", "embed"))


def _head(params, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"])
    return lm_head_product(h, params["lm_head"].value)


def lm_head_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The logits ``h @ w`` (``w`` (embed, vocab), cast to ``h``'s type).
    Where the rules shard the vocab, `shard_einsum`.  Where they leave
    it whole on some mesh dims (a vocab the model dim does not divide),
    the work along those dims follows the reference's compiled program:
    serving contracts each rank's own part of the weight and sums the
    logits once;
    training keeps the logits whole on every rank there and splits only
    the weight's gradient, each rank forming its own embed rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if layout(h) is None:
        return shard_einsum("bsd,dv->bsv", h, w)
    h, mesh = batch_only(h), layout(h).mesh
    spare = [i for i, (a, b) in enumerate(zip(layout(h).placements,
                                              layout(w).placements))
             if a.is_replicate() and b.is_replicate() and mesh.shape[i] > 1]
    if not spare:
        return shard_einsum("bsd,dv->bsv", h, w)
    rep = Replicate()
    if not torch.is_grad_enabled():
        # serving: the weight cast first.  When the batch's tokens are
        # fewer than the embed dim (a decode step) they are gathered
        # where the weight's embed rows are sharded, each rank contracts
        # its own rows against its vocab chunk over the spare dims, and
        # the logits' partial sums go back onto the batch shards: the
        # weight never moves.  Else the weight is gathered along the
        # batch's dims and each rank contracts its embed rows over the
        # spare dims.
        few = gshape(h)[0] * gshape(h)[1] < gshape(w)[0]
        rows = {i for i, p in enumerate(layout(w).placements)
                if few and p.is_shard() and p.dim == 0}
        hp, wp, op = [], [], []
        for i, p in enumerate(layout(h).placements):
            if i in rows:
                hp.append(Shard(2)), wp.append(Shard(0)), op.append(Partial())
            elif i in spare:
                hp.append(rep if few else Shard(2))
                wp.append(rep if few else Shard(0))
                op.append(Shard(2) if few else Partial())
            else:
                hp.append(p), wp.append(rep), op.append(p)
        # the vocab chunks: zero-padded to a multiple of the spare dims
        v = gshape(w)[1]
        pad = (-v) % math.prod(mesh.shape[i] for i in spare) if few else 0
        lo, n = shard_range(mesh, op, 2, v + pad)

        def head(hh, ww):
            if few:
                ww = torch.nn.functional.pad(ww, (0, pad))[:, lo:lo + n]
            return torch.einsum("bsd,dv->bsv", hh, ww)
        out = relayout(shard_map(head, (tuple(hp), tuple(wp)), tuple(op),
                                 h, cast(w, h.dtype), mesh=mesh),
                       layout(h).placements)
        return like(out[..., :v], out) if pad else out
    return shard_einsum("bsd,dv->bsv", h, w, whole=spare)


def lm_logits(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
              shd: Sharder, collect_kv: bool = False,
              inputs_embeds: Optional[torch.Tensor] = None):
    """Forward pass.  tokens: (B, S) -> (logits (B, S, V), aux loss)
    [, (prefix (kvs, states), main (kvs, states)) when ``collect_kv``]."""
    dtype = getattr(torch, cfg.dtype)
    h = (like(inputs_embeds.to(dtype), inputs_embeds)
         if inputs_embeds is not None else _embed(params, tokens, shd, dtype))
    s = gshape(h)[1]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    pre = None
    if "prefix_blocks" in params:
        h, aux, pre = _run_blocks(params["prefix_blocks"], h,
                                  [s] * cfg.first_dense_layers, cfg, shd,
                                  False, aux, collect_kv)
    h, aux, main = _run_blocks(params["blocks"], h,
                               hybrid_windows(cfg, s, _n_main(cfg)), cfg,
                               shd, cfg.family == "moe", aux, collect_kv)
    logits = shd.act(_head(params, h), ("batch", "seq", "vocab"))
    if collect_kv:
        return logits, aux, (pre, main)
    return logits, aux


# rows a chunk of the loss takes: its float32 rows stay about this many
# bytes, whatever the vocab (a few chunks a step: each adds host ops)
NLL_CHUNK_BYTES = 1 << 28


def _row_chunks(n: int, v: int):
    """(first row, rows) of the chunks that cover ``n`` rows of ``v``
    logits, each about `NLL_CHUNK_BYTES` in float32."""
    c = max(1, NLL_CHUNK_BYTES // max(4 * v, 1))
    return [(r, min(c, n - r)) for r in range(0, n, c)]


class _TokenNLL(torch.autograd.Function):
    """Per row of ``x`` (N, V), its float32 logsumexp (``own_lse``: on
    this rank of the vocab's shards only) minus the logit of its target
    where the target lies in these rows' vocab ``[0, V)`` (``t`` already
    offset; out of range, as -1, it counts 0): summed over the vocab's
    shards, the cross entropy.  The logsumexp's max and sum are reduced
    over the vocab's other shards (the mesh ``groups``).  Both passes go
    chunk by chunk, in float32 within a chunk; the backward writes the
    gradient, ``(softmax - one-hot) x g``, straight into one tensor of
    the logits' type: no whole float32 copy of the logits is made."""

    @staticmethod
    def forward(ctx, x, t, groups, own_lse: bool):
        import torch.distributed._functional_collectives as funcol
        n, v = x.shape
        ok = (t >= 0) & (t < v)
        idx = t.clamp(0, v - 1)
        m, z, gold = (torch.empty(n, dtype=torch.float32, device=x.device)
                      for _ in range(3))
        for r, c in _row_chunks(n, v):
            lf = x[r:r + c].float()
            mc = lf.amax(dim=-1)
            m[r:r + c] = mc
            z[r:r + c] = torch.exp(lf - mc[:, None]).sum(dim=-1)
            gold[r:r + c] = lf.gather(-1, idx[r:r + c, None])[:, 0]
        for g in groups:
            top = funcol.all_reduce(m, "max", g)
            z = funcol.all_reduce(z * torch.exp(m - top), "sum", g)
            m = top
        lse = m + torch.log(z)
        ctx.save_for_backward(x, idx, ok, lse)
        return (lse if own_lse else torch.zeros_like(lse)) \
            - torch.where(ok, gold, torch.zeros_like(gold))

    @staticmethod
    def backward(ctx, g):
        x, idx, ok, lse = ctx.saved_tensors
        grad = torch.empty_like(x)
        hit = -ok.to(torch.float32)
        for r, c in _row_chunks(*x.shape):
            p = torch.exp(x[r:r + c].float() - lse[r:r + c, None])
            p.scatter_add_(-1, idx[r:r + c, None], hit[r:r + c, None])
            grad[r:r + c] = p * g[r:r + c, None]
        return grad, None, None, None


def _nll_positions(logits, target, groups=(), lo: int = 0,
                   own_lse: bool = True) -> torch.Tensor:
    """Per position of ``logits[:, :-1]`` (local tensors), the cross
    entropy against ``target`` (a vocab shard's rows start at ``lo``).
    The rows go flat, the last position's included and cut off after
    (its target -1): no copy of the sliced logits is made."""
    b, s, v = logits.shape
    t = torch.nn.functional.pad(target - lo, (0, 1), value=-1)
    out = _TokenNLL.apply(logits.reshape(b * s, v), t.reshape(-1),
                          tuple(groups), own_lse)
    return out.reshape(b, s)[:, :-1]


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """Mean next-token cross entropy: f32 logsumexp over
    ``logits[:, :-1]`` against ``tokens[:, 1:]``, chunk by chunk over the
    rows (`_TokenNLL`): the value and the gradient are the plain
    f32 form's, without its float32 copies of the whole batch's logits.
    On a mesh it runs on each rank's shards (`shard_map`); where the
    vocab is sharded, the logsumexp's max and sum are reduced over the
    vocab's mesh dims and each rank picks the targets in its own vocab
    range, the per-position losses a partial sum over those dims."""
    from torch.distributed.tensor import Partial, Replicate
    target = tokens[:, 1:].long()
    if layout(logits) is None:
        return _nll_positions(logits, target).mean()
    if layout(tokens) is not None and layout(target) is None:
        b, s = gshape(tokens)
        target = tag(target, dataclasses.replace(layout(tokens),
                                                 shape=(b, s - 1)))
    mesh, pl = layout(logits).mesh, tuple(layout(logits).placements)
    split = [i for i, p in enumerate(pl) if p.is_shard() and p.dim == 2]
    lo, _ = shard_range(mesh, pl, 2, gshape(logits)[-1])
    coord = mesh.get_coordinate()
    tp = tuple(Replicate() if i in split else p for i, p in enumerate(pl))
    op = tuple(Partial() if i in split else p for i, p in enumerate(pl))
    nll = shard_map(
        functools.partial(_nll_positions, groups=[(mesh, i) for i in split],
                          lo=lo, own_lse=all(coord[i] == 0 for i in split)),
        (pl, tp), op, logits, target, mesh=mesh)
    return shard_mean(settle(nll))


def lm_loss(params: Dict, batch: Dict, cfg: ModelConfig, shd: Sharder
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (f32 logsumexp), plus 0.01 x the MoE aux
    loss.  The full sequence is forwarded; the last position has no
    target and is sliced off the logits."""
    tokens = batch["tokens"]
    logits, aux = lm_logits(params, tokens, cfg, shd,
                            inputs_embeds=batch.get("frames"))
    nll = next_token_nll(logits, tokens)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux, "loss": loss}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def _cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.family == "hybrid":
        return min(seq_len, cfg.decode_cache_cap)
    return seq_len


def init_lm_cache(cfg: ModelConfig, batch: int, seq_len: int,
                  dtype=None, device=None) -> Dict:
    """Decode cache: ring/linear KV per attention layer + SSM states
    (the state in float32, the conv window in ``dtype``); ``pos`` is a
    host-side int."""
    dtype = dtype or getattr(torch, cfg.dtype)
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                device=device)
    cache: Dict = {"pos": 0}
    sc = _cache_len(cfg, seq_len)
    kv, hd = cfg.n_kv * max(cfg.kv_repeat, 1), cfg.hd
    if cfg.family in ("dense", "moe", "hybrid"):
        cache["k"] = zeros((_n_main(cfg), batch, sc, kv, hd))
        cache["v"] = zeros((_n_main(cfg), batch, sc, kv, hd))
        if cfg.first_dense_layers:
            pre = (cfg.first_dense_layers, batch, sc, kv, hd)
            cache["k_pre"], cache["v_pre"] = zeros(pre), zeros(pre)
    if cfg.family in ("ssm", "hybrid"):
        sc_ = ssd_config(cfg)
        cache["ssm"] = zeros((cfg.n_layers, batch, sc_.n_heads,
                              sc_.ssm_state, sc_.head_dim), torch.float32)
        cache["conv"] = zeros((cfg.n_layers, batch, sc_.ssm_conv - 1,
                               sc_.conv_dim))
    return cache


def _block_decode(blk: Dict, h: torch.Tensor, win: int, ck, cv, sstate,
                  pos: int, cfg: ModelConfig, shd: Sharder, moe: bool):
    """One layer of one decode step; K/V are written in place.  Returns
    (h, ssm_state).  On a mesh the attention's output, a pending sum
    where its projection contracts a sharded dim, is reduced before the
    residual."""
    fam = cfg.family
    x = rms_norm(h, blk["ln1"])
    if fam == "ssm":
        y, sstate = ssd_decode(blk["ssd"], x, sstate, ssd_config(cfg), shd)
        return like(h + y, h), sstate
    a, _ = attention_decode(blk["attn"], x, ck, cv, pos, attn_config(cfg),
                            shd, window_override=win,
                            rolling=(fam == "hybrid"))
    a = settle(a)
    if fam == "hybrid":
        m, sstate = ssd_decode(blk["ssd"], x, sstate, ssd_config(cfg), shd)
        h = like(h + _hybrid_mix(blk, a, m, h.dtype), h)
    else:
        h = like(h + a, h)
    x2 = rms_norm(h, blk["ln2"])
    y = _moe(blk, x2, cfg, shd)[0] if moe else mlp(blk["mlp"], x2,
                                                     cfg.act, shd)
    return like(h + y, h), sstate


def _decode_stack(blocks: Dict, h: torch.Tensor, windows: List[int],
                  cache: Dict, kname: str, vname: str, pos: int,
                  cfg: ModelConfig, shd: Sharder, moe: bool,
                  states: bool = False):
    k, v = cache.get(kname), cache.get(vname)
    layer = lambda t, i: None if t is None else layer_of(t[i], t)
    for i, (blk, win) in enumerate(zip(_unstack(blocks, len(windows)),
                                       windows)):
        sstate = ({"ssm": layer(cache["ssm"], i),
                   "conv": layer(cache["conv"], i)} if states else None)
        h, sstate = _block_decode(blk, h, win, layer(k, i), layer(v, i),
                                  sstate, pos, cfg, shd, moe)
        if states:
            for name in ("ssm", "conv"):
                t = cache[name]
                if layout(t) is not None:    # into the stored layout
                    sstate[name] = relayout(sstate[name],
                                            layout(layer(t, i)).placements)
                t[i] = sstate[name]
    return h


def lm_decode_step(params: Dict, cache: Dict, token: torch.Tensor,
                   cfg: ModelConfig, shd: Sharder):
    """One decode step.  token: (B, 1) -> (logits (B, 1, V), cache).
    The cache's K/V and SSM tensors are updated in place; the returned
    dict carries the advanced position."""
    pos = cache["pos"]
    h = _embed(params, token, shd, getattr(torch, cfg.dtype))
    # The reference's decode scan hands every attention layer the window
    # "full = S_cache" as a traced value, which attention_decode applies
    # as a sliding window ((pos - slot) < S_cache): once pos reaches the
    # cache length the oldest slots drop out.  Kept for parity.
    sc = max(gshape(cache["k"])[2] if "k" in cache else 0, 1)
    if "prefix_blocks" in params:
        h = _decode_stack(params["prefix_blocks"], h,
                          [sc] * cfg.first_dense_layers, cache, "k_pre",
                          "v_pre", pos, cfg, shd, moe=False)
    h = _decode_stack(params["blocks"], h,
                      hybrid_windows(cfg, sc, _n_main(cfg)), cache, "k",
                      "v", pos, cfg, shd, moe=(cfg.family == "moe"),
                      states="ssm" in cache)
    return _head(params, h), {**cache, "pos": pos + 1}


def lm_prefill(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
               shd: Sharder, max_len: Optional[int] = None,
               inputs_embeds: Optional[torch.Tensor] = None):
    """Prefill: full forward collecting per-layer KV + SSM states ->
    (logits, cache) ready for ``lm_decode_step`` at position s.
    ``max_len`` sizes the cache (default: exactly the prompt length, as
    serving uses it)."""
    s = gshape(tokens if inputs_embeds is None else inputs_embeds)[1]
    logits, _aux, (pre, main) = lm_logits(params, tokens, cfg, shd,
                                          collect_kv=True,
                                          inputs_embeds=inputs_embeds)
    dtype = getattr(torch, cfg.dtype)
    # `init_lm_cache`'s entries, made from what the prompt left (on a
    # mesh each rank's shards, laid out by the cache rules)
    cache: Dict = {"pos": s}
    sc = _cache_len(cfg, max(s, max_len or 0))

    def fill_kv(kvs, kname, vname):
        for name, x in ((kname, kvs[0]), (vname, kvs[1])):
            x = cast(x, dtype)
            if sc > s:
                # zeros past the prompt (the cache's sequence is whole)
                x = like(torch.nn.functional.pad(
                    x, (0, 0, 0, 0, 0, sc - s)), x)
            elif sc < s:
                # capped ring cache: position p lives at slot p % sc; the
                # last sc positions land at roll(linear tail, s % sc)
                x = like(torch.roll(x[:, :, -sc:], s % sc, dims=2), x)
            cache[name] = x

    kvs, states = main
    if kvs is not None:
        fill_kv(kvs, "k", "v")
    if states is not None:
        cache["ssm"] = cast(states["ssm"], torch.float32)
        cache["conv"] = cast(states["conv"], dtype)
    if pre is not None and pre[0] is not None:
        # the prefix cache is filled like the main one; the reference
        # stores it prompt-long whatever ``max_len`` is, so past a
        # prompt-long cache its decode overwrites the prefix's last slot
        fill_kv(pre[0], "k_pre", "v_pre")
    return logits, cache
