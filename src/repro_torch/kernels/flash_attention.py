"""Attention as a logical op with two implementations.

Ports of the two Pallas variants of
`src/repro/kernels/flash_attention.py` as the CUDA kernels of
``csrc/attention.cu`` (design, bound and what is left on the table are
noted there):

* ``flash`` (primary) — online softmax over KV tiles
  (`_flash_kernel`): per-row running max, denominator and f32
  accumulator, KV tiles past the causal diagonal skipped.  Its tile
  table (`FLASH_TILES`) holds three families priced together by
  `flash_tiles_cost`: SIMT rows (f32 and bf16, any head width),
  tensor-core rows (``mma_*``: bf16 only, d a multiple of 16 up to 256)
  and 3xTF32 tensor-core rows (``tf32_*``: float32 only, d a multiple
  of 8 up to 256); a tensor-core row is infeasible elsewhere and
  refuses such a launch with ValueError.
* ``blocked`` — the whole KV of a head resident in shared memory, one
  stable softmax pass (`_blocked_kernel`); it fits only while K, V and
  the logits block fit the 227 KB a block may opt in to, so long
  sequences leave ``flash`` the only feasible implementation.  Its
  table (`BLOCKED_TILES`) holds SIMT rows and tensor-core rows
  (``tc_*``: bf16 as the ``mma_*`` rows take it, float32 as the
  ``tf32_*`` rows), priced by `blocked_tiles_cost`.

Both hold to the Pallas kernels' semantics, not to the oracle's: the
causal mask is top-left aligned (``row >= col``), masked logits are
-1e30, the denominator is clamped at 1e-30, and the scale is 1/sqrt(d).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.autotuner import KernelStaticInfo, TunableKernel
from repro_torch.core.search import SearchSpace
from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, KernelVariant, TILE_AXIS,
                                     cuda_profile, divisors, get_spec,
                                     tuned_kernel)
from repro_torch.core.hw import H100_SXM, dtype_bytes
from repro_torch.core.sass import template_symbol
from repro_torch.kernels.common import (block_info, cdiv, dtype_name,
                                        dtype_str,
                                        family_costs,
                                        pick_divisor_candidates,
                                        require_shape)

__all__ = ["flash_attention", "blocked_attention", "attention_plain",
           "flash_cuda", "blocked_cuda", "make_tunable_flash",
           "FLASH_TILES", "BLOCKED_TILES", "SIMT", "MMA", "TF32", "TC",
           "mma_takes", "tf32_takes", "tc_takes", "flash_tiles_cost",
           "blocked_tiles_cost", "flash_static_info", "LAUNCHES"]

# Launches of each CUDA kernel by its wrapper (one per call): "flash"
# and "blocked" count calls of `flash_cuda` / `blocked_cuda` whatever
# the tile, the others the kernel of each family that it launched.
LAUNCHES = {"flash": 0, "blocked": 0, "flash_simt": 0, "flash_mma": 0,
            "flash_tf32": 0, "blocked_simt": 0, "blocked_tc": 0}
_FAMILY_COUNTER = {"repro_flash": ("flash_simt", "flash_mma", "flash_tf32"),
                   "repro_blocked": ("blocked_simt", "blocked_tc")}

_NEG_INF = -1e30

# tile families of the flash table (csrc/attention.cu FlashFamily) and
# of the blocked table (BlockedFamily); the widest head the tensor-core
# rows take
SIMT, MMA, TF32 = 0, 1, 2
TC = 1
MMA_DMAX = 256

# name -> (BQ, BKV, threads, family); order = csrc/attention.cu
# FLASH_TILES, FLASH_MMA_TILES, FLASH_TF32_TILES.  Tensor-core rows run
# DS = threads / (2 BQ) warps per 16 query rows, each on 1/DS of the
# features (``w``: one warp per 16 rows, kept only in 64-row blocks, for
# long sequences; ``d2``, ``d4``: two, four).
FLASH_TILES: Dict[str, Tuple[int, ...]] = {
    "q16k32": (16, 32, 128, SIMT),
    "q16k64": (16, 64, 128, SIMT),
    "q32k32": (32, 32, 256, SIMT),
    "q32k64": (32, 64, 256, SIMT),
    "q64k64": (64, 64, 256, SIMT),
    "mma_q64k32w4": (64, 32, 128, MMA),
    "mma_q64k64w4": (64, 64, 128, MMA),
    "mma_q16k32d2": (16, 32, 64, MMA),
    "mma_q16k64d2": (16, 64, 64, MMA),
    "mma_q32k64d2": (32, 64, 128, MMA),
    "mma_q64k64d2": (64, 64, 256, MMA),
    "mma_q16k64d4": (16, 64, 128, MMA),
    "mma_q32k64d4": (32, 64, 256, MMA),
    "tf32_q64k32w4": (64, 32, 128, TF32),
    "tf32_q16k32d2": (16, 32, 64, TF32),
    "tf32_q16k64d2": (16, 64, 64, TF32),
    "tf32_q32k32d2": (32, 32, 128, TF32),
    "tf32_q16k32d4": (16, 32, 128, TF32),
    "tf32_q16k64d4": (16, 64, 128, TF32),
    "tf32_q32k32d4": (32, 32, 256, TF32),
    "tf32_q32k64d4": (32, 64, 256, TF32),
}

# name -> (BQ, threads, family); order = csrc/attention.cu BLOCKED_TILES,
# then BLOCKED_TC_TILES (``tc_q<BQ>w<warps>``, DS = warps x 16 / BQ).
BLOCKED_TILES: Dict[str, Tuple[int, ...]] = {
    "q8": (8, 128, SIMT),
    "q16": (16, 128, SIMT),
    "q32": (32, 256, SIMT),
    "q64": (64, 256, SIMT),
    "tc_q16w2": (16, 64, TC),
    "tc_q16w4": (16, 128, TC),
    "tc_q32w4": (32, 128, TC),
    "tc_q32w8": (32, 256, TC),
    "tc_q64w4": (64, 128, TC),
    "tc_q64w8": (64, 256, TC),
}
# KV rows of one cp.async group of the blocked tensor-core rows
# (csrc BLOCKED_KT)
BLOCKED_KT = 64

# a tile's index in its C table (the launch's ``tile`` argument)
_TILE_INDEX = {"repro_flash": {t: i for i, t in enumerate(FLASH_TILES)},
               "repro_blocked": {t: i for i, t in enumerate(BLOCKED_TILES)}}

# declared registers per thread (loop indices, one dot accumulator,
# pointers) of the SIMT kernels; the tensor-core kernels' are their
# compiled counts for sm_90a (the largest where rows share a key), by
# (BKV, DS) for the flash rows (O's 128 / DS f32 registers at d <= 256,
# S's BKV / 2, fragments) and by (element bytes, BQ, threads) for the
# blocked rows; the smoke prints the compiled counts beside them
_ATTN_REGS = 40
_MMA_REGS = {(32, 1): 221, (64, 1): 247, (32, 2): 153, (64, 2): 187,
             (64, 4): 153}
_TF32_REGS = {(32, 1): 221, (32, 2): 167, (64, 2): 207, (32, 4): 110,
              (64, 4): 142}
_BLOCKED_TC_REGS = {(2, 16, 64): 121, (2, 16, 128): 85, (2, 32, 128): 121,
                    (2, 32, 256): 87, (2, 64, 128): 177, (2, 64, 256): 126,
                    (4, 16, 64): 118, (4, 16, 128): 72, (4, 32, 128): 104,
                    (4, 32, 256): 71, (4, 64, 128): 163, (4, 64, 256): 104}

# Per tensor-core family: element bytes, regs table, the priced
# tensor-core FLOPs a logit and feature of Q.K^T and of P.V, the
# CUDA-core operations an operand element costs to split, and whether a
# flash group's DS warps share S (csrc TcStep::SHARE_S: each computes
# 1/DS of its columns) or each computes all of it.  bf16 (MMA): one
# m16n8k16 a product, two for P = hi + lo, no operand split, S in each
# warp.  3xTF32: three m16n8k8 a product for both, each TF32 FLOP priced
# as two bf16 ones (495 against 989 TFLOP/s dense, NVIDIA's datasheet),
# every operand split (cvt, subtract, cvt), S shared.
_TC_UNITS = {MMA: (2, _MMA_REGS, 2.0, 4.0, 0.0, False),
             TF32: (4, _TF32_REGS, 12.0, 12.0, 3.0, True)}
# features of one P.V step, by element bytes (TcStep<T>::FS)
_TC_FS = {2: 16, 4: 8}


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


def mma_takes(dtype: str, d: int) -> bool:
    """Whether the bf16 tensor-core rows take a head width: bf16 only,
    d a multiple of 16 (whole MMA steps) up to MMA_DMAX (O's
    registers)."""
    return dtype == "bfloat16" and d % 16 == 0 and d <= MMA_DMAX


def tf32_takes(dtype: str, d: int) -> bool:
    """Whether the 3xTF32 tensor-core rows take a head width: float32
    only, d a multiple of 8 (whole m16n8k8 steps) up to MMA_DMAX."""
    return dtype == "float32" and d % 8 == 0 and d <= MMA_DMAX


def tc_takes(dtype: str, d: int) -> bool:
    """Whether the blocked tensor-core rows take a head width: bf16 as
    `mma_takes`, float32 as `tf32_takes` (shared memory aside)."""
    return mma_takes(dtype, d) or tf32_takes(dtype, d)


def mma_smem_bytes(bq, bkv, skv: int, d: int, eb: int = 2):
    """Shared bytes of the flash tensor-core kernels: the Q tile and one
    stage of K and V tiles, or two when skv needs more than one tile;
    rows padded by 16 bytes, ``eb`` bytes an element; in f32 (the 3xTF32
    rows, whose groups share S) the f32 S tile [bq][bkv + 8]."""
    stages = np.where(skv > np.asarray(bkv), 2, 1)
    share = 4 * np.asarray(bq) * (np.asarray(bkv) + 8) if eb == 4 else 0
    return eb * (d + 16 // eb) * (bq + stages * 2 * bkv) + share


def blocked_tc_smem_bytes(bq, skv: int, d: int, eb: int):
    """Shared bytes of `blocked_tc_kernel`: Q, the whole K and V (skv
    rounded up to 16 rows), rows padded by 16 bytes; the f32 logits
    block [bq][skv16 + 8] and the denominators."""
    skvp = cdiv(skv, 16) * 16
    return eb * (d + 16 // eb) * (bq + 2 * skvp) + 4 * (bq * (skvp + 8) + bq)


def _group_tiles(bq: int, bkv: int, sq: int, skv: int,
                 causal: bool) -> Tuple[int, float]:
    """KV tiles the tensor-core kernel's 16-row groups run per head:
    each group of a block with rows below sq walks the block's tiles,
    skipping (causal) those wholly above its own last row.  Returns the
    (group, tile) pairs, and the tiles of the longest group (the last
    block's last, under the causal skip): the kernel's critical path
    when its blocks run in one wave."""
    n_kv = cdiv(skv, bkv)
    pairs, longest = 0, []
    for q0 in range(0, sq, bq):
        tiles = n_kv if not causal else min(
            n_kv, (min(q0 + bq, sq) - 1) // bkv + 1)
        runs = [tiles if not causal else sum(
            1 for t in range(tiles) if w0 + 15 >= t * bkv)
            for w0 in range(q0, min(q0 + bq, sq), 16)]
        pairs += sum(runs)
        longest.append(runs[-1])
    return pairs, float(max(longest))


def _simt_cost(t, *, bh: int, sq: int, skv: int, d: int, causal: bool,
               eb: int):
    bq, bkv, nt = t[:, 0], t[:, 1], t[:, 2]
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


def _tc_cost(t, *, bh: int, sq: int, skv: int, d: int, causal: bool,
             eb: int, fam: int):
    """Tensor-core rows of family ``fam`` (`_TC_UNITS`) on the (16-row
    group, tile) pairs that run.  On the tensor cores: QK^T, in each of
    the DS warps of a group or, where they share S, once (its 16-column
    pairs dealt to them), and P.V (split over the DS warps).  On the
    CUDA cores: the softmax in each warp (scale, mask, max, subtract,
    sum, the hi/lo split of P: 8 a logit) with one exp a logit and one a
    row and tile, O's rescale (d a row and tile) and, for 3xTF32, the
    split of every Q element each warp loads and of K's and V's.  Device
    memory as the SIMT rows; shared memory: each visited K/V tile stored
    once per block, and per group and tile the reads of Q (by every
    warp), K and V, and a shared S tile's stores and reads.  The block
    keeps one K/V stage in flight.  A warp's own MMA chain per tile is
    its QK^T (all of it, or its pairs of the shared S) and its 1/DS of
    P.V, over the tiles of the longest group."""
    teb, regs, qk, pv, split, share = _TC_UNITS[fam]
    bq, bkv, nt = t[:, 0], t[:, 1], t[:, 2]
    ds = nt // (2 * bq)
    vis = np.array([_visited_tiles(int(q), int(k), sq, skv, causal)
                    for q, k in zip(bq, bkv)], dtype=np.float64)
    wt, chain = np.array([_group_tiles(int(q), int(k), sq, skv, causal)
                          for q, k in zip(bq, bkv)], dtype=np.float64).T
    logits = wt * 16 * bkv * bh                     # padded, per group
    rows = wt * 16 * bh
    flops = ds * (8.0 * logits) + rows * d
    if share:
        qk_warps = 1.0                  # S computed once per group
        k_reads = ds * 16.0 + bkv       # every warp's Q, K once
        qk_chain = 16.0 * np.ceil(bkv / 16.0 / ds) / bkv
        s_tile = wt * bh * 16.0 * bkv * 4.0 * (1.0 + ds)
    else:
        qk_warps, k_reads, qk_chain, s_tile = ds, ds * (16.0 + bkv), 1.0, 0.0
    if split:
        flops = flops + split * wt * bh * d * (k_reads + bkv)
    return dict(
        blocks=bh * cdiv(sq, bq), threads=nt,
        regs=np.array([regs[(int(k), int(s))] for k, s in zip(bkv, ds)]),
        smem=mma_smem_bytes(bq, bkv, skv, d, teb),
        flops=flops,
        tc_flops=(qk * qk_warps + pv) * logits * d,
        trans=ds * (logits + rows),
        hbm_bytes=bh * (2.0 * sq * d * eb + vis * bkv * 2.0 * d * eb),
        smem_bytes=bh * vis * 2.0 * bkv * d * teb
        + wt * bh * (k_reads + bkv) * d * teb + s_tile,
        inflight_bytes=2.0 * bkv * d * teb,
        warp_tc_flops=chain * (qk * qk_chain + pv / ds) * 16 * bkv * d)


def flash_tiles_cost(t, *, b: int, h: int, sq: int, skv: int, d: int,
                     causal: bool = True,
                     dtype: str = "float32") -> Dict[str, np.ndarray]:
    """`hopper_info_batch` arguments of FLASH_TILES rows ``t`` (an (N, 4)
    array of the table's fields), each row priced by its family; the
    bf16 tensor-core rows are infeasible unless `mma_takes` the shape,
    the 3xTF32 rows unless `tf32_takes` it.  SIMT rows state no
    tensor-core flops, bytes in flight or MMA chain: they are priced on
    the CUDA cores with their latency hiding in warps."""
    kw = dict(bh=b * h, sq=sq, skv=skv, d=d, causal=causal,
              eb=dtype_bytes(dtype))
    fam = t[:, 3]
    out = family_costs(fam, {SIMT: lambda sel: _simt_cost(t[sel], **kw),
                             MMA: lambda sel: _tc_cost(t[sel], fam=MMA, **kw),
                             TF32: lambda sel: _tc_cost(t[sel], fam=TF32,
                                                        **kw)},
                       keys=("blocks", "threads", "regs", "smem", "flops",
                             "tc_flops", "trans", "hbm_bytes", "smem_bytes",
                             "inflight_bytes", "warp_tc_flops"))
    out["feasible"] &= ((fam != MMA) | mma_takes(dtype, d)) \
        & ((fam != TF32) | tf32_takes(dtype, d))
    return out


def _flash_hopper(cols, *, b: int, h: int, sq: int, skv: int, d: int,
                  causal: bool = True, dtype: str = "float32"):
    t = np.array([FLASH_TILES[str(x)] for x in cols[TILE_AXIS]],
                 dtype=np.int64).reshape(-1, 4)
    return flash_tiles_cost(t, b=b, h=h, sq=sq, skv=skv, d=d, causal=causal,
                            dtype=dtype)


def _blocked_simt_cost(t, *, bh: int, sq: int, skv: int, d: int,
                       causal: bool, eb: int):
    bq, nt = t[:, 0], t[:, 1]
    qt = cdiv(sq, bq)
    logits = (bh * qt * bq * skv).astype(np.float64)  # no causal skip
    return dict(
        blocks=bh * qt, threads=nt, regs=_ATTN_REGS,
        smem=blocked_smem_bytes(bq, skv, d, eb),
        flops=4.0 * logits * d, trans=logits + bh * qt * bq,
        hbm_bytes=bh * (2.0 * sq * d * eb + qt * 2.0 * skv * d * eb),
        smem_bytes=logits * 4.0 * d * 4.0)


def _blocked_groups(bq: int, sq: int, skv: int,
                    causal: bool) -> Tuple[int, int, int]:
    """What the blocked tensor-core kernel's blocks and 16-row groups
    cover per head: the KV rows the blocks load (causal: up to each
    block's last row, in whole 16-row pairs), the KV columns of S the
    groups with rows below sq compute (causal: up to each group's last
    row), and the longest group's columns."""
    skvp = cdiv(skv, 16) * 16
    loaded = cols = longest = 0
    for q0 in range(0, sq, bq):
        loaded += min(skvp, cdiv(min(q0 + bq, sq), 16) * 16) if causal \
            else skvp
        for w0 in range(q0, min(q0 + bq, sq), 16):
            c = min(skvp, w0 + 16) if causal else skvp
            cols += c
            longest = max(longest, c)
    return loaded, cols, longest


def _blocked_tc_cost(t, *, bh: int, sq: int, skv: int, d: int,
                     causal: bool, eb: int):
    """Tensor-core blocked rows in the input's own type (bf16, or f32
    as 3xTF32: `_TC_UNITS`): Q.K^T once per group (its 16-column pairs
    dealt to the DS warps) and P.V (features split over the DS warps)
    on the tensor cores, over the columns each group computes; on the
    CUDA cores the row pass (max, exp, sum, the store of P: 4 a logit),
    every warp's hi/lo split of P (4 a logit) and, for 3xTF32, the split
    of the Q, K and V elements loaded.  Device memory: q and o once, and
    each block's K and V; shared memory: K/V stored once per block, the
    operand reads, the logits block's stores and the row pass.  Every
    load is issued at once, so a block keeps its whole K and V in
    flight.  A warp's chain: its share of the longest group's pairs and
    of its P.V."""
    fam = MMA if eb == 2 else TF32
    _, _, qk, pv, split, _ = _TC_UNITS[fam]
    fs = _TC_FS[eb]
    bq, nt = t[:, 0], t[:, 1]
    ds = nt // (2 * bq)
    loaded, cols, longest = np.array(
        [_blocked_groups(int(q), sq, skv, causal) for q in bq],
        dtype=np.float64).T
    logits = cols * 16 * bh
    blocks = bh * cdiv(sq, bq)
    pairs_w = np.ceil(longest / 16 / ds)
    return dict(
        blocks=blocks, threads=nt,
        regs=np.array([_BLOCKED_TC_REGS[(eb, int(q), int(n))]
                       for q, n in zip(bq, nt)]),
        smem=blocked_tc_smem_bytes(bq, skv, d, eb),
        flops=(4.0 + 4.0 * ds) * logits
        + split * bh * d * cols * (ds / 4.0 + 2.0),
        tc_flops=(qk + pv) * logits * d,
        trans=logits,
        hbm_bytes=bh * (2.0 * sq * d * eb + 2.0 * loaded * d * eb),
        smem_bytes=bh * d * eb * (2.0 * loaded + cols * (ds / 4.0 + 2.0))
        + (16.0 + 4.0 * ds) * logits,
        inflight_bytes=2.0 * loaded * bh / blocks * d * eb,
        warp_tc_flops=qk * 16 * 16 * pairs_w * d
        + pv * 16 * longest * fs * np.ceil(d // fs / ds))


def blocked_tiles_cost(t, *, b: int, h: int, sq: int, skv: int, d: int,
                       causal: bool = True,
                       dtype: str = "float32") -> Dict[str, np.ndarray]:
    """`hopper_info_batch` arguments of BLOCKED_TILES rows ``t`` (an
    (N, 3) array of the table's fields), each row priced by its family;
    the tensor-core rows are infeasible unless `tc_takes` the shape (and,
    as every row, unless their shared memory fits)."""
    kw = dict(bh=b * h, sq=sq, skv=skv, d=d, causal=causal,
              eb=dtype_bytes(dtype))
    fam = t[:, 2]
    out = family_costs(fam, {SIMT: lambda sel: _blocked_simt_cost(t[sel],
                                                                  **kw),
                             TC: lambda sel: _blocked_tc_cost(t[sel], **kw)},
                       keys=("blocks", "threads", "regs", "smem", "flops",
                             "tc_flops", "trans", "hbm_bytes", "smem_bytes",
                             "inflight_bytes", "warp_tc_flops"))
    out["feasible"] &= (fam != TC) | tc_takes(dtype, d)
    return out


def _blocked_hopper(cols, *, b: int, h: int, sq: int, skv: int, d: int,
                    causal: bool = True, dtype: str = "float32"):
    t = np.array([BLOCKED_TILES[str(x)] for x in cols[TILE_AXIS]],
                 dtype=np.int64).reshape(-1, 3)
    return blocked_tiles_cost(t, b=b, h=h, sq=sq, skv=skv, d=d,
                              causal=causal, dtype=dtype)


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


def _refuse(kernel: str, fn_name: str, tile: str, q, k, v, skv: int,
            d: int) -> None:
    """ValueError, before any launch, for what a tensor-core row does not
    take: another dtype or head width, shared memory past the 227 KB a
    block may opt in to, or an operand off a 16-byte boundary."""
    dtype, eb = dtype_name(q), q.element_size()
    if fn_name == "repro_flash":
        bq, bkv, _, fam = FLASH_TILES[tile]
        if fam == SIMT:
            return
        if fam == MMA and not mma_takes(dtype, d):
            raise ValueError(
                f"{kernel}: tile {tile} takes bfloat16 with d a multiple "
                f"of 16 up to {MMA_DMAX}, got {dtype} d={d}")
        if fam == TF32 and not tf32_takes(dtype, d):
            raise ValueError(
                f"{kernel}: tile {tile} takes float32 with d a multiple "
                f"of 8 up to {MMA_DMAX}, got {dtype} d={d}")
        smem = int(mma_smem_bytes(bq, bkv, skv, d, eb))
    else:
        bq, _, fam = BLOCKED_TILES[tile]
        if fam == SIMT:
            return
        if not tc_takes(dtype, d):
            raise ValueError(
                f"{kernel}: tile {tile} takes bfloat16 with d a multiple "
                f"of 16 or float32 with d a multiple of 8, up to "
                f"{MMA_DMAX}, got {dtype} d={d}")
        smem = blocked_tc_smem_bytes(bq, skv, d, eb)
    if smem > H100_SXM.shmem_per_block:
        raise ValueError(
            f"{kernel}: tile {tile} at skv={skv} d={d} {dtype} needs "
            f"{smem} bytes of shared memory, over the "
            f"{H100_SXM.shmem_per_block} a block may use")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{kernel}: tile {tile} needs 16-byte-aligned "
                         f"operands")


def _attn_launch(kernel: str, fn_name: str, q, k, v, causal: bool,
                 tile: str):
    import torch
    b, h, sq, skv, d = _check_qkv(kernel, q, k, v)
    idx = _TILE_INDEX[fn_name].get(tile)
    if idx is None:
        raise ValueError(f"{kernel}: unknown tile {tile!r}")
    _refuse(kernel, fn_name, tile, q, k, v, skv, d)
    out = torch.empty_like(q)
    rc = getattr(_cuda.library(), fn_name)(
        idx, _cuda.dtype_code(q), int(bool(causal)),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, sq, skv, d, 1.0 / math.sqrt(d), _cuda.stream_of(q))
    _cuda.check(rc, kernel)
    table = FLASH_TILES if fn_name == "repro_flash" else BLOCKED_TILES
    LAUNCHES[_FAMILY_COUNTER[fn_name][table[tile][-1]]] += 1
    return out


def flash_cuda(q, k, v, causal: bool = True, *, tile: str):
    """Launch the online-softmax CUDA kernel ``tile`` on CUDA tensors (a
    tensor-core row refuses with ValueError what `mma_takes` or
    `tf32_takes` refuses, shared memory it cannot have, or an operand
    off a 16-byte boundary)."""
    out = _attn_launch("flash_attention", "repro_flash", q, k, v, causal,
                       tile)
    LAUNCHES["flash"] += 1
    return out


def blocked_cuda(q, k, v, causal: bool = True, *, tile: str):
    """Launch the whole-KV-resident CUDA kernel ``tile`` (a tensor-core
    row refuses with ValueError what `tc_takes` refuses, a K and V too
    long for shared memory, or an operand off a 16-byte boundary)."""
    out = _attn_launch("blocked_attention", "repro_blocked", q, k, v,
                       causal, tile)
    LAUNCHES["blocked"] += 1
    return out


def blocked_attention(q, k, v, causal: bool = True, *,
                      tile: str | None = None):
    """q, k, v (B, H, S, D) -> (B, H, S, D), full KV resident per block."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal)
    return blocked_cuda(q, k, v, causal, tile=tile)


def _flash_symbols(tile: str, *, dtype: str = "float32", **_):
    bq, bkv, threads, fam = FLASH_TILES[tile]
    if fam == SIMT:
        return (template_symbol("flash_kernel", dtype, bq, bkv, threads),)
    nw = threads // 32
    kernel = "flash_mma_kernel" if fam == MMA else "flash_tf32_kernel"
    return (template_symbol(kernel, bq, bkv, nw, nw * 16 // bq),)


def _blocked_symbols(tile: str, *, dtype: str = "float32", **_):
    bq, threads, fam = BLOCKED_TILES[tile]
    if fam == SIMT:
        return (template_symbol("blocked_kernel", dtype, bq, threads),)
    return (template_symbol("blocked_tc_kernel", dtype, bq, threads // 32),)


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
                                 analysis=_flash_hopper,
                                 symbols=_flash_symbols),
            "blocked": HopperSpace(tiles=tuple(BLOCKED_TILES),
                                   analysis=_blocked_hopper,
                                   symbols=_blocked_symbols)},
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


def flash_static_info(b: int, h: int, sq: int, skv: int, d: int, dtype,
                      params: Dict, causal: bool = True) -> KernelStaticInfo:
    """Scalar static info for one configuration (wrapper over the
    declared analysis; kept as a stable public helper)."""
    return block_info(**_flash_analysis(params, b=b, h=h, sq=sq, skv=skv,
                                        d=d, causal=causal,
                                        dtype=dtype_str(dtype)))


def make_tunable_flash(b: int = 2, h: int = 4, s: int = 1024, d: int = 128,
                       causal: bool = True, dtype="float32", seed: int = 0,
                       device=None) -> TunableKernel:
    """flash_attention at (b, h, s, d) for `repro_torch.core.KernelTuner`:
    the reference's narrowed (bq, bkv) space under a TPU target, the
    joint (variant, tile) table under the H100 — the active target (see
    `KernelSpec.tunable`).  The op declares no ``make_inputs=``, so it
    tunes statically only."""
    space = SearchSpace({
        "bq": pick_divisor_candidates(s, (128, 256, 512)),
        "bkv": pick_divisor_candidates(s, (128, 256, 512)),
    })
    return get_spec("flash_attention").tunable(
        b=b, h=h, sq=s, skv=s, d=d, causal=causal, dtype=dtype_str(dtype),
        seed=seed, space=space, name=f"flash_{b}x{h}x{s}x{d}",
        device=device)
