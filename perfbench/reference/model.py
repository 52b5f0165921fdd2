"""The plain reference of the served decoder-only models, in float32.

Plain PyTorch only: no kernel, cache or batching of the program under
test, and nothing imported from it.  It reads the benchmark's own
weights (a dict of tensors keyed by path, see `weight_layout`), widens
each layer's weights to float32 when it uses them, and recomputes what
the program derives from them (rope tables, routing, capacity).

Where the repository's model departs from the published one, this file
holds a frozen copy of the repository's semantics (the configuration
file lists each departure):

* the MoE router runs in float32; the top-k probabilities are divided
  by their sum; each expert keeps at most ``capacity`` routed rows of a
  batch, ranked in token order (`capacity`), the rest dropped; the
  shared experts are one ungated MLP of width ``n_shared * d_ff_expert``;
* decode writes past a prompt-long cache into its last slot, and takes
  the cache's length as a sliding window over slot indices: a token
  decoded at position p attends to the prompt positions j <= S - 2 with
  p - j < S, and to itself while p < 2S - 1 (`decode_hidden`).

``quant="fp8"`` is the control: every matrix product's weight rounded
to float8 e4m3 with one scale per output channel, all else as above.
``quant="bf16"`` is a witness of bfloat16 rounding alone: the residual
stream and each norm's output rounded to bfloat16, as the program keeps
them, all else in float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

__all__ = ["weight_layout", "capacity", "gap_summary", "Reference"]

# weights of a product: the dims its input contracts (the rest are
# output channels), by path under the layer stack
_IN_DIMS = {"attn.wq": (0,), "attn.wk": (0,), "attn.wv": (0,),
            "attn.wo": (0, 1), "mlp.w_gate": (0,), "mlp.w_up": (0,),
            "mlp.w_down": (0,), "moe.w_gate": (1,), "moe.w_up": (1,),
            "moe.w_down": (1,), "moe.shared.w_gate": (0,),
            "moe.shared.w_up": (0,), "moe.shared.w_down": (0,)}


def weight_layout(m: Dict) -> Dict[str, Tuple[int, ...]]:
    """Every weight's path and shape for the model sizes ``m`` (the
    configuration file's ``model`` group): per-layer weights stacked
    along a leading layer dim."""
    d, h, kv, L, v = m["d_model"], m["n_heads"], m["n_kv"], m["n_layers"], \
        m["vocab"]
    hd = m.get("head_dim") or d // h
    out = {"embed": (v, d), "final_norm": (d,), "lm_head": (d, v),
           "blocks.ln1": (L, d), "blocks.ln2": (L, d),
           "blocks.attn.wq": (L, d, h, hd), "blocks.attn.wk": (L, d, kv, hd),
           "blocks.attn.wv": (L, d, kv, hd), "blocks.attn.wo": (L, h, hd, d)}
    if m.get("qkv_bias"):
        out.update({"blocks.attn.bq": (L, h, hd), "blocks.attn.bk": (L, kv, hd),
                    "blocks.attn.bv": (L, kv, hd)})
    if m["family"] == "moe":
        e, f = m["n_experts"], m["d_ff_expert"]
        out.update({"blocks.moe.router": (L, d, e),
                    "blocks.moe.w_gate": (L, e, d, f),
                    "blocks.moe.w_up": (L, e, d, f),
                    "blocks.moe.w_down": (L, e, f, d)})
        if m.get("n_shared"):
            fs = m["n_shared"] * f
            out.update({"blocks.moe.shared.w_gate": (L, d, fs),
                        "blocks.moe.shared.w_up": (L, d, fs),
                        "blocks.moe.shared.w_down": (L, fs, d)})
    elif m["family"] == "dense":
        f = m["d_ff"]
        out.update({"blocks.mlp.w_gate": (L, d, f),
                    "blocks.mlp.w_up": (L, d, f),
                    "blocks.mlp.w_down": (L, f, d)})
    else:
        raise ValueError(f"family {m['family']!r}: no reference")
    return out


def capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    """Rows an expert keeps of a batch: ``factor * tokens * top_k /
    n_experts`` rounded up to a multiple of 32, at least 32."""
    c = int(math.ceil(factor * tokens * top_k / n_experts))
    return max(32, (c + 31) // 32 * 32)


def _fp8(w: torch.Tensor, in_dims: Tuple[int, ...]) -> torch.Tensor:
    """``w`` rounded to float8 e4m3, one scale per output channel."""
    amax = w.abs().amax(dim=in_dims, keepdim=True).clamp(min=1e-30)
    s = amax / 448.0
    return (w / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def gap_summary(gaps: torch.Tensor) -> Dict[str, float]:
    """The numbers a judgement can compare, over every position's gap
    (how far the chosen token's logit lies below the reference's best):
    the widest, the mean, the 99.9th percentile, and the share of
    positions whose chosen token is not the reference's best."""
    g = gaps.double().flatten()
    return {"gap_max": float(g.max()), "gap_mean": float(g.mean()),
            "gap_p999": float(torch.quantile(g, 0.999)),
            "miss_share": float((g > 0).double().mean()),
            "positions": int(g.numel())}


class Reference:
    """The model's forward pass in float32 over the benchmark's weights.

    ``weights`` maps `weight_layout`'s paths to tensors (any type, any
    device); the products run on ``weights``' device."""

    def __init__(self, m: Dict, weights: Dict[str, torch.Tensor],
                 quant: Optional[str] = None):
        if quant not in (None, "fp8", "bf16"):
            raise ValueError(f"quant {quant!r}: None | fp8 | bf16")
        self.m, self.w, self.quant = m, weights, quant
        self.routed = self.dropped = 0     # MoE rows routed, and past capacity
        self.hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
        self.eps = float(m.get("norm_eps", 1e-6))

    # -- weights --------------------------------------------------------------
    def _get(self, name: str, layer: Optional[int] = None) -> torch.Tensor:
        t = self.w[name if layer is None else f"blocks.{name}"]
        t = (t if layer is None else t[layer]).to(torch.float32)
        if self.quant == "fp8" and (name in _IN_DIMS or name == "lm_head"):
            t = _fp8(t, _IN_DIMS.get(name, (0,)))
        return t

    # -- pieces ---------------------------------------------------------------
    def _rms(self, x, g):
        return self._round(
            x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * g)

    def _round(self, x):
        if self.quant == "bf16":
            return x.to(torch.bfloat16).to(torch.float32)
        return x

    def _rope(self, x, pos):
        """x (..., S, H, hd); pos (..., S): the halves of head_dim rotated."""
        hd = self.hd
        inv = 1.0 / (float(self.m["rope_theta"]) ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
        ang = pos[..., None].to(torch.float32) * inv
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _qkv(self, x, layer, pos):
        q, k, v = (torch.einsum("...d,dhk->...hk", x, self._get(f"attn.w{n}",
                                                               layer))
                   for n in "qkv")
        if self.m.get("qkv_bias"):
            q = q + self._get("attn.bq", layer)
            k = k + self._get("attn.bk", layer)
            v = v + self._get("attn.bv", layer)
        return self._rope(q, pos), self._rope(k, pos), v

    def _mlp(self, x, pre: str, layer):
        g = torch.einsum("...d,df->...f", x, self._get(f"{pre}.w_gate", layer))
        u = torch.einsum("...d,df->...f", x, self._get(f"{pre}.w_up", layer))
        return torch.einsum("...f,fd->...d", torch.nn.functional.silu(g) * u,
                            self._get(f"{pre}.w_down", layer))

    def _moe(self, x, layer):
        """x (T, D): every token of one batch (capacity counts them all)."""
        m = self.m
        t, e, k = x.shape[0], m["n_experts"], m["top_k"]
        probs = torch.softmax(x @ self._get("moe.router", layer), dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_i = top_p[:, :k], top_i[:, :k]
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
        cap = capacity(t, e, k, float(m.get("capacity_factor", 1.25)))
        flat = top_i.reshape(-1)                   # routed rows, token-major
        wg, wu, wd = (self._get(f"moe.{n}", layer)
                      for n in ("w_gate", "w_up", "w_down"))
        y = torch.zeros_like(x)
        self.routed += flat.numel()
        for ex in range(e):
            rows = torch.nonzero(flat == ex).flatten()
            self.dropped += max(rows.numel() - cap, 0)
            rows = rows[:cap]
            if rows.numel() == 0:
                continue
            tok = rows // k
            xe = x[tok]
            out = (torch.nn.functional.silu(xe @ wg[ex]) * (xe @ wu[ex])) @ wd[ex]
            y.index_add_(0, tok, out * top_p.reshape(-1)[rows, None])
        if m.get("n_shared"):
            y = y + self._mlp(x, "moe.shared", layer)
        return y

    def _ffn(self, x, layer):
        if self.m["family"] == "moe":
            return self._moe(x.reshape(-1, x.shape[-1]), layer).reshape(x.shape)
        return self._mlp(x, "mlp", layer)

    @staticmethod
    def _attend(q, k, v, allow):
        """q (Q, H, hd), k/v (K, KV, hd), ``allow`` (Q, K) bool -> (Q, H, hd);
        a KV head serves H / KV query heads."""
        h, kvh = q.shape[1], k.shape[1]
        g = h // kvh
        qg = q.reshape(q.shape[0], kvh, g, q.shape[2])
        logits = torch.einsum("qcgd,kcd->cgqk", qg, k) / math.sqrt(q.shape[2])
        logits = logits.masked_fill(~allow, float("-inf"))
        out = torch.einsum("cgqk,kcd->qcgd", torch.softmax(logits, dim=-1), v)
        return out.reshape(q.shape)

    def _embed(self, tokens):
        return self.w["embed"][tokens].to(torch.float32)

    def _layers(self, x, pos, attend: Callable, keep_kv: bool = False):
        """Every layer over x (..., S, D); ``attend(layer, q, k, v)``
        runs the attention core.  With ``keep_kv`` also returns each
        layer's (k, v)."""
        kvs = []
        for layer in range(self.m["n_layers"]):
            h = self._rms(x, self._get("ln1", layer))
            q, k, v = self._qkv(h, layer, pos)
            if keep_kv:
                kvs.append((k, v))
            a = attend(layer, q, k, v)
            x = self._round(x + torch.einsum("...hk,hkd->...d", a,
                                             self._get("attn.wo", layer)))
            x = self._round(
                x + self._ffn(self._rms(x, self._get("ln2", layer)), layer))
        return (x, kvs) if keep_kv else x

    def _final(self, x):
        return self._rms(x, self._get("final_norm"))

    # -- entry points ---------------------------------------------------------
    def prefill_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> the final normed hidden state (B, S, D) of a
        causal forward over each row (MoE capacity over all B * S)."""
        b, s = tokens.shape
        pos = torch.arange(s, device=tokens.device).expand(b, s)
        return self._final(self._layers(self._embed(tokens), pos,
                                        self._causal(b, s, tokens.device)))

    def _causal(self, b: int, s: int, device) -> Callable:
        """The attention core of ``b`` causal rows of ``s`` positions."""
        causal = torch.ones(s, s, dtype=torch.bool, device=device).tril()

        def attend(layer, q, k, v):
            return torch.stack([self._attend(q[i], k[i], v[i], causal)
                                for i in range(b)])
        return attend

    def decode_hidden(self, prompt: torch.Tensor, inputs: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """One sequence's decode steps past its prompt-long cache.
        ``prompt`` (S,); ``inputs`` (N,) the token fed at each step and
        ``positions`` (N,) its position (>= S).  The cache's last slot
        holds the newest token; the prompt's positions 0 .. S - 2 stay
        in the others.  -> hidden (N, D)."""
        s = prompt.shape[0]
        _, kvs = self._layers(self._embed(prompt[None]),
                              torch.arange(s, device=prompt.device)[None],
                              self._causal(1, s, prompt.device), keep_kv=True)
        # slot j < S - 1 holds prompt position j, slot S - 1 the newest
        # token; a step at position p keeps the slots j with p - j < S
        # (the cache's length as a sliding window), and where it keeps
        # none its weights are uniform over every slot
        slot = torch.arange(s, device=prompt.device)
        keep = (positions[:, None] - slot[None]) < s              # (N, S)
        none = ~keep.any(1)
        keep[none] = True

        def attend(layer, q, k, v):
            pk, pv = kvs[layer][0][0, :s - 1], kvs[layer][1][0, :s - 1]
            n, h, hd = q.shape
            kvh = k.shape[1]
            out = torch.empty_like(q)
            for c in range(0, n, 256):
                qg = q[c:c + 256].reshape(-1, kvh, h // kvh, hd)
                kc, vc = k[c:c + 256], v[c:c + 256]
                lp = torch.einsum("ncgd,kcd->ncgk", qg, pk)
                ls = torch.einsum("ncgd,ncd->ncg", qg, kc)[..., None]
                lg = torch.cat([lp, ls], -1) / math.sqrt(hd)
                lg = lg.masked_fill(~keep[c:c + 256, None, None], float("-inf"))
                lg[none[c:c + 256]] = 0.0
                p = torch.softmax(lg, -1)
                o = torch.einsum("ncgk,kcd->ncgd", p[..., :-1], pv) \
                    + p[..., -1:] * vc[:, :, None, :]
                out[c:c + 256] = o.reshape(-1, h, hd)
            return out
        return self._final(self._layers(self._embed(inputs), positions, attend))

    def head_rows(self, hidden: torch.Tensor, rows: int = 2048
                  ) -> Iterator[Tuple[int, torch.Tensor]]:
        """The logits (n, V) of hidden (N, D), ``rows`` at a time:
        (first row, logits)."""
        w = self._get("lm_head")
        for r in range(0, hidden.shape[0], rows):
            yield r, hidden[r:r + rows] @ w

    def gaps(self, hidden: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
        """Per row of hidden (N, D): how far the logit of ``chosen`` (N,)
        lies below the row's best."""
        out = torch.empty(hidden.shape[0], dtype=torch.float32,
                          device=hidden.device)
        for r, lg in self.head_rows(hidden):
            c = chosen[r:r + lg.shape[0]].to(lg.device)
            out[r:r + lg.shape[0]] = lg.amax(-1) - lg.gather(1, c[:, None])[:, 0]
        return out

    def argmax(self, hidden: torch.Tensor) -> torch.Tensor:
        """The token each row of hidden (N, D) puts first."""
        return torch.cat([lg.argmax(-1) for _, lg in self.head_rows(hidden)])
