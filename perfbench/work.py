"""The benchmark's yardstick: the chip's peaks and the operations and
bytes of each piece of work, counted from shapes.

Bytes count each input read once and each output written once; the
least time of a piece of work is the larger of its operations at the
type's peak and its bytes at the memory's rate (the rule of
``chip_smoke.bound``, copied).  Counts follow the model's equations, not
what an implementation happens to do.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "least_s", "prefill_flops",
           "decode_flops", "decode_bytes", "op_work"]

# NVIDIA H100 SXM, dense rates without sparsity (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    """Least time of the work: operations at the type's peak against
    bytes at the memory's rate, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def _dims(m: Dict) -> Tuple[int, int, int, int]:
    d, h = m["d_model"], m["n_heads"]
    return d, h, m["n_kv"], m.get("head_dim") or d // h


def _token_flops(m: Dict) -> float:
    """Matrix-product operations of one token through every layer (the
    projections, the MLP or the routed and shared experts and the
    router), attention's core apart."""
    d, h, kv, hd = _dims(m)
    per = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d
    if m["family"] == "moe":
        f = m["d_ff_expert"]
        per += 2 * d * m["n_experts"]
        per += m["top_k"] * 3 * 2 * d * f
        per += 3 * 2 * d * m.get("n_shared", 0) * f
    else:
        per += 3 * 2 * d * m["d_ff"]
    return float(m["n_layers"] * per)


def prefill_flops(m: Dict, batch: int, length: int) -> float:
    """A causal prefill of ``batch`` prompts of ``length`` tokens that
    returns each prompt's next token: every layer at every position,
    attention over each position's predecessors and itself, and the
    output head at the last position only."""
    d, h, _, hd = _dims(m)
    core = 4.0 * h * hd * length * (length + 1) / 2 * m["n_layers"]
    return batch * (length * _token_flops(m) + core
                    + 2.0 * d * m["vocab"])


def decode_flops(m: Dict, batch: int, slots: int) -> float:
    """One decode step of ``batch`` sequences, each attending over
    ``slots`` cached positions."""
    d, h, _, hd = _dims(m)
    core = 4.0 * h * hd * slots * m["n_layers"]
    return batch * (_token_flops(m) + core + 2.0 * d * m["vocab"])


def decode_bytes(m: Dict, batch: int, slots: int) -> float:
    """Bytes one decode step has to move: every layer's weights and the
    output head once, and each sequence's cached keys and values once."""
    d, h, kv, hd = _dims(m)
    eb = _BYTES[m["dtype"]]
    per = d * (h + 2 * kv) * hd + h * hd * d
    if m.get("qkv_bias"):
        per += (h + 2 * kv) * hd
    if m["family"] == "moe":
        f = m["d_ff_expert"]
        per += 3 * d * f * (m["n_experts"] + m.get("n_shared", 0))
        router = 4 * d * m["n_experts"]
    else:
        per += 3 * d * m["d_ff"]
        router = 0
    weights = m["n_layers"] * (per * eb + router + 2 * 4 * d) \
        + d * m["vocab"] * eb
    cache = m["n_layers"] * batch * slots * 2 * kv * hd * eb
    return float(weights + cache)


def _shape(t) -> Tuple[int, ...]:
    return tuple(int(s) for s in t.shape)


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def op_work(name: str, args, kwargs) -> Optional[Tuple[float, float, str]]:
    """(operations, bytes, type) of one call of a registry op, from its
    operands' shapes; None for an op this file does not count."""
    if name == "matmul":
        a, b = args[0], args[1]
        (m_, k), (_, n) = _shape(a), _shape(b)
        eb = _BYTES[_dtype(a)]
        return 2.0 * m_ * k * n, float(eb * (m_ * k + k * n + m_ * n)), \
            _dtype(a)
    if name == "mlp_matmul":
        x, wg = args[0], args[1]
        (m_, d), (_, f) = _shape(x), _shape(wg)
        eb = _BYTES[_dtype(x)]
        return 4.0 * m_ * d * f, float(eb * (m_ * d + 2 * d * f + m_ * f)), \
            _dtype(x)
    if name == "rms_norm":
        x, w = args[0], args[1]
        n, d = _shape(x)
        eb = _BYTES[_dtype(x)]
        wb = _BYTES[_dtype(w)]
        return 4.0 * n * d, float(2 * eb * n * d + wb * d), _dtype(x)
    if name == "flash_attention":
        q, k = args[0], args[1]
        b, h, s, hd = _shape(q)
        skv = _shape(k)[2]
        causal = args[3] if len(args) > 3 else kwargs.get("causal", True)
        pairs = s * (s + 1) / 2 if causal and s == skv else s * skv
        eb = _BYTES[_dtype(q)]
        return 4.0 * b * h * hd * pairs, \
            float(eb * b * h * hd * (2 * s + 2 * skv)), _dtype(q)
    return None
