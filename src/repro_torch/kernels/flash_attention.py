"""Attention as a logical op with two implementations.

Ports of the two Pallas variants of
`src/repro/kernels/flash_attention.py` as the CUDA kernels of
``csrc/attention.cu`` (design, bound and what is left on the table are
noted there):

* ``flash`` (primary) — online softmax over KV tiles
  (`_flash_kernel`): per-row running max, denominator and f32
  accumulator, KV tiles past the causal diagonal skipped.
* ``blocked`` — the whole KV of a head resident in shared memory, one
  stable softmax pass (`_blocked_kernel`); it fits only while K, V and
  the logits block fit the 227 KB a block may opt in to, so long
  sequences leave ``flash`` the only feasible implementation.

Both hold to the Pallas kernels' semantics, not to the oracle's: the
causal mask is top-left aligned (``row >= col``), masked logits are
-1e30, the denominator is clamped at 1e-30, and the scale is 1/sqrt(d).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, KernelVariant, TILE_AXIS,
                                     cuda_profile, divisors, tuned_kernel)
from repro_torch.core.hw import dtype_bytes
from repro_torch.kernels.common import cdiv, dtype_name, require_shape

__all__ = ["flash_attention", "blocked_attention", "attention_plain",
           "flash_cuda", "blocked_cuda", "FLASH_TILES", "BLOCKED_TILES",
           "LAUNCHES"]

# Launches of each CUDA kernel by its wrapper (one per call).
LAUNCHES = {"flash": 0, "blocked": 0}

_NEG_INF = -1e30

# name -> (BQ, BKV, threads); order = csrc/attention.cu FLASH_TILES.
FLASH_TILES: Dict[str, Tuple[int, ...]] = {
    "q16k32": (16, 32, 128),
    "q16k64": (16, 64, 128),
    "q32k32": (32, 32, 256),
    "q32k64": (32, 64, 256),
    "q64k64": (64, 64, 256),
}

# name -> (BQ, threads); order = csrc/attention.cu BLOCKED_TILES.
BLOCKED_TILES: Dict[str, Tuple[int, ...]] = {
    "q8": (8, 128),
    "q16": (16, 128),
    "q32": (32, 256),
    "q64": (64, 256),
}

# declared registers per thread (loop indices, one dot accumulator,
# pointers); the smoke prints the compiled count beside it
_ATTN_REGS = 40


def _kpad(eb: int) -> int:
    return 4 // eb


def flash_smem_bytes(bq, bkv, d: int, eb: int):
    """Shared bytes of `flash_kernel` (csrc layout: f32 Q, acc, logits,
    m/l/alpha; K rows padded by one word; V)."""
    return 4 * (2 * bq * d + bq * bkv + 3 * bq) \
        + eb * (bkv * (d + _kpad(eb)) + bkv * d)


def blocked_smem_bytes(bq, skv: int, d: int, eb: int):
    """Shared bytes of `blocked_kernel` (f32 Q, logits, denominators;
    the whole padded K and V of one head)."""
    return 4 * (bq * d + bq * skv + bq) \
        + eb * (skv * (d + _kpad(eb)) + skv * d)


def _visited_tiles(bq: int, bkv: int, sq: int, skv: int,
                   causal: bool) -> int:
    """KV tiles the flash kernel visits per head, summed over q-tiles
    (causal: tiles wholly above the diagonal are skipped)."""
    n_kv = cdiv(skv, bkv)
    if not causal:
        return cdiv(sq, bq) * n_kv
    return sum(min(n_kv, (min(q0 + bq, sq) - 1) // bkv + 1)
               for q0 in range(0, sq, bq))


def _flash_hopper(cols, *, b: int, h: int, sq: int, skv: int, d: int,
                  causal: bool = True, dtype: str = "float32"):
    t = np.array([FLASH_TILES[str(x)] for x in cols[TILE_AXIS]],
                 dtype=np.int64).reshape(-1, 3)
    bq, bkv, nt = t[:, 0], t[:, 1], t[:, 2]
    eb = dtype_bytes(dtype)
    bh = b * h
    vis = np.array([_visited_tiles(int(q), int(k), sq, skv, causal)
                    for q, k in zip(bq, bkv)], dtype=np.float64)
    logits = vis * bq * bkv * bh                    # padded (row, col) pairs
    return dict(
        blocks=bh * cdiv(sq, bq), threads=nt, regs=_ATTN_REGS,
        smem=flash_smem_bytes(bq, bkv, d, eb),
        flops=4.0 * logits * d, trans=logits + vis * bq * bh,
        hbm_bytes=bh * (2.0 * sq * d * eb + vis * bkv * 2.0 * d * eb),
        # per logit: d words of q and d of k; per (row, feature): bkv
        # words of p and bkv of v — 4 * d words per logit in all
        smem_bytes=logits * 4.0 * d * 4.0)


def _blocked_hopper(cols, *, b: int, h: int, sq: int, skv: int, d: int,
                    causal: bool = True, dtype: str = "float32"):
    t = np.array([BLOCKED_TILES[str(x)] for x in cols[TILE_AXIS]],
                 dtype=np.int64).reshape(-1, 2)
    bq, nt = t[:, 0], t[:, 1]
    eb = dtype_bytes(dtype)
    bh = b * h
    qt = cdiv(sq, bq)
    logits = (bh * qt * bq * skv).astype(np.float64)  # no causal skip
    return dict(
        blocks=bh * qt, threads=nt, regs=_ATTN_REGS,
        smem=blocked_smem_bytes(bq, skv, d, eb),
        flops=4.0 * logits * d, trans=logits + bh * qt * bq,
        hbm_bytes=bh * (2.0 * sq * d * eb + qt * 2.0 * skv * d * eb),
        smem_bytes=logits * 4.0 * d * 4.0)


def _flash_analysis(p, *, b: int, h: int, sq: int, skv: int, d: int,
                    causal: bool = True, dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols)."""
    bq = np.minimum(np.asarray(p["bq"], dtype=np.int64), sq)
    bkv = np.minimum(np.asarray(p["bkv"], dtype=np.int64), skv)
    steps = (b * h) * cdiv(sq, bq) * cdiv(skv, bkv)
    # causal masking skips ~half the logits -> effective FLOP discount.
    eff = 0.5 if causal and sq == skv else 1.0
    return dict(
        in_blocks=[(bq, d), (bkv, d), (bkv, d)],
        out_blocks=[(bq, d)],
        in_dtypes=[dtype] * 3,
        out_dtypes=[dtype],
        flops_per_step=4.0 * bq * bkv * d * eff,   # QK^T + PV
        vpu_per_step=6.0 * bq * bkv * eff,         # mask/max/sum/scale
        trans_per_step=(bq * bkv + bq) * eff,      # exp
        grid_steps=steps,
        scratch_bytes=(bq * 2 + bq * d) * 4,
    )


def _blocked_analysis(p, *, b: int, h: int, sq: int, skv: int, d: int,
                      causal: bool = True, dtype: str = "float32"):
    """Static analysis of the dense variant (the reference's): one
    softmax pass, no causal FLOP discount, and the full (bq, skv) f32
    logits block counted as scratch."""
    bq = np.minimum(np.asarray(p["bq"], dtype=np.int64), sq)
    return dict(
        in_blocks=[(bq, d), (skv, d), (skv, d)],
        out_blocks=[(bq, d)],
        in_dtypes=[dtype] * 3,
        out_dtypes=[dtype],
        flops_per_step=4.0 * bq * skv * d,         # QK^T + PV, no discount
        vpu_per_step=5.0 * bq * skv,               # mask/max/sum/div
        trans_per_step=bq * skv + bq,              # exp
        grid_steps=(b * h) * cdiv(sq, bq),
        scratch_bytes=bq * skv * 4,                # f32 logits block
    )


def attention_plain(q, k, v, causal: bool = True):
    """The plain PyTorch version of both kernels: f32 logits scaled by
    1/sqrt(d), top-left causal mask filled with -1e30, stable softmax
    with the denominator clamped at 1e-30, f32 P.V, cast back."""
    import torch
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / denom
            ).to(q.dtype)


def _check_qkv(kernel: str, q, k, v) -> Tuple[int, int, int, int, int]:
    _cuda.require_operands(kernel, q, k, v)
    if q.dim() != 4:
        raise ValueError(f"{kernel}: q must be (B, H, S, D), got "
                         f"{tuple(q.shape)}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    require_shape(kernel, "k", tuple(k.shape), (b, h, skv, d))
    require_shape(kernel, "v", tuple(v.shape), (b, h, skv, d))
    return b, h, sq, skv, d


def _attn_launch(kernel: str, fn_name: str, tiles, q, k, v, causal: bool,
                 tile: str):
    import torch
    b, h, sq, skv, d = _check_qkv(kernel, q, k, v)
    if tile not in tiles:
        raise ValueError(f"{kernel}: unknown tile {tile!r}")
    out = torch.empty_like(q)
    rc = getattr(_cuda.library(), fn_name)(
        list(tiles).index(tile), _cuda.dtype_code(q), int(bool(causal)),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, sq, skv, d, 1.0 / math.sqrt(d), _cuda.stream_of(q))
    _cuda.check(rc, kernel)
    return out


def flash_cuda(q, k, v, causal: bool = True, *, tile: str):
    """Launch the online-softmax CUDA kernel ``tile`` on CUDA tensors."""
    out = _attn_launch("flash_attention", "repro_flash", FLASH_TILES,
                       q, k, v, causal, tile)
    LAUNCHES["flash"] += 1
    return out


def blocked_cuda(q, k, v, causal: bool = True, *, tile: str):
    """Launch the whole-KV-resident CUDA kernel ``tile``."""
    out = _attn_launch("blocked_attention", "repro_blocked", BLOCKED_TILES,
                       q, k, v, causal, tile)
    LAUNCHES["blocked"] += 1
    return out


def blocked_attention(q, k, v, causal: bool = True, *,
                      tile: str | None = None):
    """q, k, v (B, H, S, D) -> (B, H, S, D), full KV resident per block."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal)
    return blocked_cuda(q, k, v, causal, tile=tile)


@tuned_kernel(
    "flash_attention",
    space={"bq": divisors("sq", (8, 16, 32, 64, 128, 256, 512)),
           "bkv": divisors("skv", (8, 16, 32, 64, 128, 256, 512))},
    # causal is positional-or-keyword so the dispatch wrapper keeps the
    # public signature flash_attention(q, k, v, causal=True, ...)
    signature=lambda q, k, v, causal=True, **_: dict(
        b=q.shape[0], h=q.shape[1], sq=q.shape[2], skv=k.shape[2],
        d=q.shape[3], causal=causal, dtype=dtype_name(q)),
    static_info=_flash_analysis,
    hopper={"flash": HopperSpace(tiles=tuple(FLASH_TILES),
                                 analysis=_flash_hopper),
            "blocked": HopperSpace(tiles=tuple(BLOCKED_TILES),
                                   analysis=_blocked_hopper)},
    out=lambda q, k, v, causal=True, **_: (tuple(q.shape), q.dtype),
    pretune=tuple(dict(b=b, h=h, sq=s, skv=s, d=128, causal=causal,
                       dtype=dt)
                  for (b, h, s) in [(2, 8, 128), (4, 8, 256),
                                    (2, 4, 1024), (4, 8, 2048),
                                    (1, 8, 4096)]
                  for causal in (True, False)
                  for dt in ("float32", "bfloat16")),
    variants=(KernelVariant(
        variant_id="blocked",
        fn=blocked_attention,
        space={"bq": divisors("sq", (8, 16, 32, 64, 128, 256, 512))},
        analysis=_blocked_analysis),),
    primary_variant="flash",
    # The reference's profile: register-heavy (online-softmax
    # accumulators per row), one K/V stage pair in shared memory.
    cuda=cuda_profile(
        regs=64, shmem_per_block=16384,
        workload=lambda b, h, sq, skv, d, causal=True, **_: dict(
            o_fl=(2.0 if causal else 4.0) * b * h * sq * skv * d,
            o_mem=2.0 * b * h * (sq + skv) * d,
            o_ctrl=1.0 * b * h * sq,
            o_reg=(2.0 if causal else 4.0) * b * h * sq * skv * d)),
)
def flash_attention(q, k, v, causal: bool = True, *,
                    tile: str | None = None):
    """q, k, v (B, H, S, D) -> (B, H, S, D): the online-softmax CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  GQA
    callers broadcast KV heads up to H first."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal)
    return flash_cuda(q, k, v, causal, tile=tile)
