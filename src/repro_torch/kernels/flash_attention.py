"""Attention as a logical op with two implementations.

Ports of the two Pallas variants of
`src/repro/kernels/flash_attention.py` as the CUDA kernels of
``csrc/attention.cu`` (design, bound and what is left on the table are
noted there):

* ``flash`` (primary) — online softmax over KV tiles
  (`_flash_kernel`): per-row running max, denominator and f32
  accumulator, KV tiles past the causal diagonal skipped.  Its tile
  table (`FLASH_TILES`) holds two families priced together by
  `flash_tiles_cost`: SIMT rows (f32 and bf16, any head width) and
  tensor-core rows (``mma_*``: bf16 only, d a multiple of 16 up to 256,
  else infeasible and refused with ValueError).
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

from repro_torch.core.autotuner import TunableKernel
from repro_torch.core.search import SearchSpace
from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, KernelVariant, TILE_AXIS,
                                     cuda_profile, divisors, get_spec,
                                     tuned_kernel)
from repro_torch.core.hw import dtype_bytes
from repro_torch.kernels.common import (cdiv, dtype_name, dtype_str,
                                        family_costs,
                                        pick_divisor_candidates,
                                        require_shape)

__all__ = ["flash_attention", "blocked_attention", "attention_plain",
           "flash_cuda", "blocked_cuda", "make_tunable_flash",
           "FLASH_TILES", "BLOCKED_TILES", "SIMT", "MMA", "mma_takes",
           "flash_tiles_cost", "LAUNCHES"]

# Launches of each CUDA kernel by its wrapper (one per call): "flash"
# counts calls of `flash_cuda` whatever the tile, "flash_simt" /
# "flash_mma" the kernel of each family that it launched.
LAUNCHES = {"flash": 0, "blocked": 0, "flash_simt": 0, "flash_mma": 0}
_FAMILY_COUNTER = ("flash_simt", "flash_mma")

_NEG_INF = -1e30

# tile families of the flash table (csrc/attention.cu FlashFamily); the
# widest head the tensor-core rows take
SIMT, MMA = 0, 1
MMA_DMAX = 256

# name -> (BQ, BKV, threads, family); order = csrc/attention.cu
# FLASH_TILES, then FLASH_MMA_TILES.  Tensor-core rows run DS = threads
# / (2 BQ) warps per 16 query rows, each on 1/DS of the features
# (``w``: one warp per 16 rows, kept only in 64-row blocks, for long
# sequences; ``d2``, ``d4``: two, four).
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
}

# name -> (BQ, threads); order = csrc/attention.cu BLOCKED_TILES.
BLOCKED_TILES: Dict[str, Tuple[int, ...]] = {
    "q8": (8, 128),
    "q16": (16, 128),
    "q32": (32, 256),
    "q64": (64, 256),
}

# a tile's index in its C table (the launch's ``tile`` argument)
_TILE_INDEX = {"repro_flash": {t: i for i, t in enumerate(FLASH_TILES)},
               "repro_blocked": {t: i for i, t in enumerate(BLOCKED_TILES)}}

# declared registers per thread (loop indices, one dot accumulator,
# pointers) of the SIMT and blocked kernels; the tensor-core kernel's by
# (BKV, DS) are its compiled counts for sm_90a (O's 128 / DS f32
# registers at d <= 256, S's BKV / 2, fragments); the smoke prints the
# compiled counts beside them
_ATTN_REGS = 40
_MMA_REGS = {(32, 1): 221, (64, 1): 247, (32, 2): 153, (64, 2): 187,
             (64, 4): 153}


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
    """Whether the tensor-core rows take a head width: bf16 only (f32
    stays full f32 on the SIMT rows), d a multiple of 16 (whole MMA
    steps) up to MMA_DMAX (O's registers)."""
    return dtype == "bfloat16" and d % 16 == 0 and d <= MMA_DMAX


def mma_smem_bytes(bq, bkv, skv: int, d: int):
    """Shared bytes of `flash_mma_kernel`: the bf16 Q tile and one stage
    of K and V tiles, or two when skv needs more than one tile; rows
    padded by 16 bytes."""
    stages = np.where(skv > np.asarray(bkv), 2, 1)
    return 2 * (d + 8) * (bq + stages * 2 * bkv)


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


def _mma_cost(t, *, bh: int, sq: int, skv: int, d: int, causal: bool,
              eb: int):
    """Tensor-core rows: QK^T (2 d FLOPs a logit, in each of the DS
    warps of a 16-row group) and the two P.V MMAs of P's hi and lo
    halves (4 d, split over the DS warps) on the tensor cores, over the
    (16-row group, tile) pairs that run; the softmax on the CUDA cores
    (scale, mask, max, subtract, sum, the hi/lo split: 8 a logit, in
    each warp) with one exp a logit and one a row and tile, and O's
    rescale (d a row and tile).  Device memory as the SIMT rows; shared
    memory: each visited K/V tile stored once per block, and per group
    and tile the ldmatrix reads of Q and K (by every warp) and V.  The
    block keeps one K/V stage in flight.  A warp's own MMA chain per
    tile is its QK^T and its 1/DS of P.V ((2 + 4 / DS) x 16 x BKV x d
    FLOPs), over the tiles of the longest group."""
    bq, bkv, nt = t[:, 0], t[:, 1], t[:, 2]
    ds = nt // (2 * bq)
    vis = np.array([_visited_tiles(int(q), int(k), sq, skv, causal)
                    for q, k in zip(bq, bkv)], dtype=np.float64)
    wt, chain = np.array([_group_tiles(int(q), int(k), sq, skv, causal)
                          for q, k in zip(bq, bkv)], dtype=np.float64).T
    logits = wt * 16 * bkv * bh                     # padded, per group
    rows = wt * 16 * bh
    return dict(
        blocks=bh * cdiv(sq, bq), threads=nt,
        regs=np.array([_MMA_REGS[(int(k), int(s))]
                       for k, s in zip(bkv, ds)]),
        smem=mma_smem_bytes(bq, bkv, skv, d),
        flops=ds * (8.0 * logits) + rows * d,
        tc_flops=(2.0 * ds + 4.0) * logits * d,
        trans=ds * (logits + rows),
        hbm_bytes=bh * (2.0 * sq * d * eb + vis * bkv * 2.0 * d * eb),
        smem_bytes=bh * vis * 2.0 * bkv * d * 2
        + wt * bh * (ds * (16.0 + bkv) + bkv) * d * 2,
        inflight_bytes=2.0 * bkv * d * 2,
        warp_tc_flops=chain * (2.0 + 4.0 / ds) * 16 * bkv * d)


def flash_tiles_cost(t, *, b: int, h: int, sq: int, skv: int, d: int,
                     causal: bool = True,
                     dtype: str = "float32") -> Dict[str, np.ndarray]:
    """`hopper_info_batch` arguments of FLASH_TILES rows ``t`` (an (N, 4)
    array of the table's fields), each row priced by its family; the
    tensor-core rows are infeasible unless `mma_takes` the shape.  SIMT
    rows state no tensor-core flops, bytes in flight or MMA chain: they
    are priced on the CUDA cores with their latency hiding in warps."""
    kw = dict(bh=b * h, sq=sq, skv=skv, d=d, causal=causal,
              eb=dtype_bytes(dtype))
    fam = t[:, 3]
    out = family_costs(fam, {SIMT: lambda sel: _simt_cost(t[sel], **kw),
                             MMA: lambda sel: _mma_cost(t[sel], **kw)},
                       keys=("blocks", "threads", "regs", "smem", "flops",
                             "tc_flops", "trans", "hbm_bytes", "smem_bytes",
                             "inflight_bytes", "warp_tc_flops"))
    out["feasible"] &= (fam != MMA) | mma_takes(dtype, d)
    return out


def _flash_hopper(cols, *, b: int, h: int, sq: int, skv: int, d: int,
                  causal: bool = True, dtype: str = "float32"):
    t = np.array([FLASH_TILES[str(x)] for x in cols[TILE_AXIS]],
                 dtype=np.int64).reshape(-1, 4)
    return flash_tiles_cost(t, b=b, h=h, sq=sq, skv=skv, d=d, causal=causal,
                            dtype=dtype)


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


def _attn_launch(kernel: str, fn_name: str, q, k, v, causal: bool,
                 tile: str):
    import torch
    b, h, sq, skv, d = _check_qkv(kernel, q, k, v)
    idx = _TILE_INDEX[fn_name].get(tile)
    if idx is None:
        raise ValueError(f"{kernel}: unknown tile {tile!r}")
    if fn_name == "repro_flash" and FLASH_TILES[tile][3] == MMA:
        if not mma_takes(dtype_name(q), d):
            raise ValueError(
                f"{kernel}: tile {tile} takes bfloat16 with d a multiple "
                f"of 16 up to {MMA_DMAX}, got {dtype_name(q)} d={d}")
        if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError(f"{kernel}: tile {tile} needs 16-byte-aligned "
                             f"operands")
    out = torch.empty_like(q)
    rc = getattr(_cuda.library(), fn_name)(
        idx, _cuda.dtype_code(q), int(bool(causal)),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b * h, sq, skv, d, 1.0 / math.sqrt(d), _cuda.stream_of(q))
    _cuda.check(rc, kernel)
    return out


def flash_cuda(q, k, v, causal: bool = True, *, tile: str):
    """Launch the online-softmax CUDA kernel ``tile`` on CUDA tensors (a
    tensor-core row refuses with ValueError what `mma_takes` refuses, or
    an operand off a 16-byte boundary)."""
    out = _attn_launch("flash_attention", "repro_flash", q, k, v, causal,
                       tile)
    LAUNCHES["flash"] += 1
    LAUNCHES[_FAMILY_COUNTER[FLASH_TILES[tile][3]]] += 1
    return out


def blocked_cuda(q, k, v, causal: bool = True, *, tile: str):
    """Launch the whole-KV-resident CUDA kernel ``tile``."""
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
