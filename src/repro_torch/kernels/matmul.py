"""Blocked matmul: C = A.B with f32 accumulation, cast to the input type.

Port of the reference's MXU-workhorse Pallas kernel
(`src/repro/kernels/matmul.py:_mm_kernel`) as the CUDA GEMMs of
``csrc/gemm.cu`` (see the note at its top for the designs, their bounds
and what they leave on the table).  The serving path uses it for the
MLP's down-projection.

The `@tuned_kernel` declaration keeps the reference's TPU block space,
analysis, ``cuda=`` profile and pretune grid unchanged, and adds the
H100 launch space: the GEMM tile instantiations compiled into the
library (`GEMM_TILES`), in three families — SIMT tiles, split-K GEMV
tiles for small M, TMA + wgmma tiles for bf16 — priced together by
`gemm_tiles_cost`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.autotuner import KernelStaticInfo, TunableKernel
from repro_torch.core.hw import dtype_bytes
from repro_torch.core.search import SearchSpace
from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, TILE_AXIS, cuda_profile,
                                     divisors, get_spec, tuned_kernel)
from repro_torch.kernels.common import (block_info, cdiv, dtype_name,
                                        dtype_str,
                                        family_costs,
                                        pick_divisor_candidates)
from repro_torch.kernels.ref import matmul_ref

__all__ = ["matmul", "matmul_static_info", "matmul_cuda", "matmul_plain",
           "make_tunable_matmul",
           "GEMM_TILES", "SIMT", "GEMV", "WGMMA", "gemm_hopper_cost",
           "gemm_tiles_cost", "wgmma_takes", "tile_fields",
           "splitk_reduce", "splitk_reduce_cuda", "splitk_reduce_plain",
           "LAUNCHES"]

# Launches by kernel: "matmul" counts calls of `matmul_cuda` (one per
# call, whatever the tile); "gemm_simt" / "gemm_gemv" / "gemm_wgmma"
# count the GEMM kernel of each family that `gemm_launch` launches (for
# matmul and for the split MLP's passes), "splitk_reduce" the split-K
# reductions (a split tile's second launch, or `splitk_reduce_cuda`).
LAUNCHES = {"matmul": 0, "gemm_simt": 0, "gemm_gemv": 0, "gemm_wgmma": 0,
            "splitk_reduce": 0}
_FAMILY_COUNTER = ("gemm_simt", "gemm_gemv", "gemm_wgmma")

# tile families of the GEMM table (csrc/gemm.cu GemmFamily)
SIMT, GEMV, WGMMA = 0, 1, 2
# split-K GEMV: warps per block; K rows of a chunk (a lane's 16-byte
# loads in flight) in bf16 and in f32
GEMV_WARPS, GEMV_ROWS, GEMV_ROWS_F32 = 8, 16, 8

# name -> (BM, BN, BK, TM, TN, FAMILY, STAGES, SPLIT); order =
# csrc/gemm.cu GEMM_TILES, GEMV_TILES, WGMMA_TILES.  GEMV rows give BN
# and TN in bf16 columns (a lane's 16 bytes; f32 blocks span half) and
# BK = the K rows a block reads per step; wgmma rows are 128 x BN x 64
# tiles of two 64-row warpgroups.
GEMM_TILES: Dict[str, Tuple[int, ...]] = {
    "m16n64k32": (16, 64, 32, 1, 4, SIMT, 1, 1),
    "m32n64k32": (32, 64, 32, 2, 4, SIMT, 1, 1),
    "m64n64k16": (64, 64, 16, 4, 4, SIMT, 1, 1),
    "m128n64k16": (128, 64, 16, 8, 4, SIMT, 1, 1),
    "m64n128k16": (64, 128, 16, 4, 8, SIMT, 1, 1),
    "m128n128k16": (128, 128, 16, 8, 8, SIMT, 1, 1),
    "m16n32k64": (16, 32, 64, 1, 2, SIMT, 1, 1),
    "m16n16k64": (16, 16, 64, 1, 1, SIMT, 1, 1),
    "gemv_m4s1": (4, 256, 128, 4, 8, GEMV, GEMV_ROWS, 1),
    "gemv_m4s8": (4, 256, 128, 4, 8, GEMV, GEMV_ROWS, 8),
    "gemv_m4s16": (4, 256, 128, 4, 8, GEMV, GEMV_ROWS, 16),
    "gemv_m4s32": (4, 256, 128, 4, 8, GEMV, GEMV_ROWS, 32),
    "wgmma_n128s1": (128, 128, 64, 64, 128, WGMMA, 4, 1),
    "wgmma_n128s2": (128, 128, 64, 64, 128, WGMMA, 4, 2),
    "wgmma_n128s4": (128, 128, 64, 64, 128, WGMMA, 4, 4),
    "wgmma_n256s1": (128, 256, 64, 64, 256, WGMMA, 4, 1),
    "wgmma_n256s2": (128, 256, 64, 64, 256, WGMMA, 4, 2),
    "wgmma_n256s5": (128, 256, 64, 64, 256, WGMMA, 4, 5),
}

# a tile's index in the C table (the launch's ``tile`` argument)
_TILE_INDEX = {t: i for i, t in enumerate(GEMM_TILES)}

# CUDA's limit on a grid's y and z dimensions (GEMV rows put M/BM on z,
# wgmma rows M/128 on y)
_GRID_YZ = 65535


def tile_fields(table: Dict[str, Tuple[int, ...]], tiles) -> np.ndarray:
    """(N, F) int64 array of the table rows named by ``tiles``."""
    width = len(next(iter(table.values())))
    return np.array([table[str(t)] for t in np.asarray(tiles).ravel()],
                    dtype=np.int64).reshape(-1, width)


def gemm_hopper_cost(*, m: int, n: int, k: int, bm, bn, bk, tm, tn,
                     in_bytes: int, out_bytes: int, operands: int = 1):
    """Work, traffic and resources of one tiled-GEMM launch per tile row.

    ``operands`` is the number of B-side matrices sharing the A tile (2
    for the gated product: W_gate and W_up).  FLOPs count the padded
    tiles the kernel actually computes (masked rows and columns still
    run their FMAs); device traffic counts A re-read once per column of
    blocks and B once per row of blocks; shared-memory traffic counts
    the per-thread fragment reads (TM + operands*TN words per K step)
    and the tile staging stores.  ``bk=None`` is the whole-K panel of
    the stream kernel (no K loop)."""
    gm, gn = cdiv(m, bm), cdiv(n, bn)
    blocks = gm * gn
    kk = k if bk is None else bk
    steps = 1 if bk is None else cdiv(k, bk)
    fma = (gm * bm) * (gn * bn) * float(k)
    stage = blocks * steps * (bm * kk + operands * kk * bn) * in_bytes
    return dict(
        blocks=blocks,
        threads=(bm // tm) * (bn // tn),
        regs=operands * tm * tn + tm + operands * tn
        + (24 if operands == 1 else 28),
        smem=(bm * kk + operands * kk * bn) * in_bytes,
        flops=2.0 * operands * fma,
        hbm_bytes=(float(m) * k * in_bytes * gn
                   + operands * float(k) * n * in_bytes * gm
                   + float(m) * n * out_bytes),
        smem_bytes=fma / (tm * tn) * (tm + operands * tn) * 4.0
        + np.asarray(stage, dtype=np.float64))


def wgmma_takes(dtype: str, n: int, k: int) -> bool:
    """Whether the TMA + wgmma tiles take a (., K) . (K, N) product: bf16
    only (the tensor-core route; f32 stays full f32 on the SIMT tiles),
    and 16-byte row pitches for the tensor maps (K % 8 == N % 8 == 0)."""
    return dtype == "bfloat16" and k % 8 == 0 and n % 8 == 0


def _unique_bytes(m, n, k, in_bytes, out_bytes, rows):
    """Device-memory bytes of a GEMV or wgmma launch with each operand
    read once and the output written once: the blocks that re-read a
    tile of A (along a row of output tiles) are launched next to one
    another, as are a wgmma launch's blocks down a column of B, and run
    in the same wave at the shapes these families serve, so those
    re-reads come from the 50 MB L2."""
    return np.full(rows, (float(m) * k + float(k) * n) * in_bytes
                   + float(m) * n * out_bytes)


def _gemv_cost(t, *, m, n, k, in_bytes, out_bytes):
    """Split-K GEMV rows: a lane's 16-byte slice of a B row, 8 warps on
    interleaved chunks of K rows, every row of a chunk in flight at
    once; the kernel is bounded to 128 registers (2 blocks per SM)."""
    bm, split = t[:, 0], t[:, 7]
    v = 16 // in_bytes
    bn = 32 * v
    rows = GEMV_ROWS if in_bytes == 2 else GEMV_ROWS_F32
    gm, gn = cdiv(m, bm), cdiv(n, bn)
    return dict(
        blocks=gn * split * gm,
        threads=np.full(len(t), 32 * GEMV_WARPS),
        regs=np.full(len(t), 128),
        smem=bm * bn * 4,
        flops=2.0 * m * (gn * bn) * float(k),
        tc_flops=np.zeros(len(t)),
        # row blocks are the grid's slowest axis: each re-reads B from HBM
        hbm_bytes=(_unique_bytes(m, n, k, in_bytes, out_bytes, len(t))
                   + (gm - 1) * float(k) * n * in_bytes),
        smem_bytes=(gn * split * gm) * 2.0 * GEMV_WARPS * bm * bn * 4,
        inflight_bytes=np.full(len(t), 32.0 * GEMV_WARPS * rows * 16),
        feasible=gm <= _GRID_YZ)


def _wgmma_cost(t, *, m, n, k, in_bytes, out_bytes):
    """TMA + wgmma rows: 128 x BN tiles, 64-row warpgroups (a warpgroup
    whose rows all lie past M skips its MMAs), K padded to 64 by the
    tensor map's zero fill; STAGES stages of TMA loads in flight, of
    which the A box's rows past M read nothing."""
    bn, stages = t[:, 1], t[:, 6]
    gm, gn = cdiv(m, 128), cdiv(n, bn)
    stage = 128 * 64 * 2 + 64 * bn * 2
    return dict(
        blocks=gn * t[:, 7] * gm,
        threads=np.full(len(t), 384),
        regs=bn // 2 + 26,
        smem=stages * stage + 16 * stages + 1024,
        flops=np.zeros(len(t)),
        tc_flops=2.0 * (cdiv(m, 64) * 64) * (gn * bn) * (cdiv(k, 64) * 64.0),
        hbm_bytes=_unique_bytes(m, n, k, in_bytes, out_bytes, len(t)),
        smem_bytes=(gm * gn) * cdiv(k, 64) * stage * 1.0,
        inflight_bytes=stages * (min(m, 128) * 64 * 2 + 64 * bn * 2) * 1.0,
        feasible=gm <= _GRID_YZ)


def gemm_tiles_cost(t, *, m: int, n: int, k: int, dtype: str,
                    out_bytes: int) -> Dict[str, np.ndarray]:
    """`hopper_info_batch` arguments of GEMM_TILES rows ``t`` (the (N, 8)
    `tile_fields` array) for one (m, k) . (k, n) product in ``dtype``,
    each row priced by its family: the SIMT rows by `gemm_hopper_cost`
    (their latency hiding counted in warps), the GEMV and wgmma rows with
    their bytes in flight and bf16 tensor-core flops stated.  A split-K
    row (SPLIT > 1) adds its f32 partials' write and read and the
    reduction's launch; wgmma rows are infeasible unless `wgmma_takes`
    the shape."""
    eb = dtype_bytes(dtype)
    fam, split = t[:, 5], t[:, 7]
    kw = dict(m=m, n=n, k=k, in_bytes=eb, out_bytes=out_bytes)
    out = family_costs(fam, {
        SIMT: lambda sel: gemm_hopper_cost(
            bm=t[sel, 0], bn=t[sel, 1], bk=t[sel, 2], tm=t[sel, 3],
            tn=t[sel, 4], **kw),
        GEMV: lambda sel: _gemv_cost(t[sel], **kw),
        WGMMA: lambda sel: _wgmma_cost(t[sel], **kw)},
        keys=("blocks", "threads", "regs", "smem", "flops", "tc_flops",
              "hbm_bytes", "smem_bytes", "inflight_bytes"))
    partials = 2.0 * split * float(m) * n * 4
    out["hbm_bytes"] = out["hbm_bytes"] + np.where(split > 1, partials, 0.0)
    out["launches"] = np.where(split > 1, 2, 1)
    out["feasible"] &= (fam != WGMMA) | wgmma_takes(dtype, n, k)
    return out


def _matmul_hopper(cols, *, m: int, n: int, k: int, dtype: str = "float32"):
    t = tile_fields(GEMM_TILES, cols[TILE_AXIS])
    return gemm_tiles_cost(t, m=m, n=n, k=k, dtype=dtype,
                           out_bytes=dtype_bytes(dtype))


def _matmul_analysis(p, *, m: int, n: int, k: int, dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols)."""
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    bn = np.minimum(np.asarray(p["bn"], dtype=np.int64), n)
    bk = np.minimum(np.asarray(p["bk"], dtype=np.int64), k)
    steps = cdiv(m, bm) * cdiv(n, bn) * cdiv(k, bk)
    return dict(
        in_blocks=[(bm, bk), (bk, bn)],
        out_blocks=[(bm, bn)],
        in_dtypes=[dtype, dtype],
        out_dtypes=[dtype],
        flops_per_step=2.0 * bm * bn * bk,
        grid_steps=steps,
        scratch_bytes=bm * bn * 4,
    )


def _matmul_schedule(p, *, m: int, n: int, k: int, dtype: str = "float32"):
    """Per-K-step instruction stream for the pipeline tier under a TPU
    target, as the reference declares it: stage both operand tiles,
    MXU-contract into the VMEM accumulator, amortized result flush.  Row
    format: ``(class, units[, dep])`` with ``dep`` an index into the
    stream."""
    bm = min(int(p["bm"]), m)
    bn = min(int(p["bn"]), n)
    bk = min(int(p["bk"]), k)
    eb = dtype_bytes(dtype)
    return [
        ("hbm", float((bm * bk + bk * bn) * eb)),          # 0: tile DMA in
        ("vmem", float((bm * bk + bk * bn + bm * bn) * eb), 0),  # 1: staging
        ("mxu", 2.0 * bm * bn * bk, 1),                    # 2: contraction
        # result tile leaves once per (i, j) cell, i.e. every K/bk steps
        ("hbm", float(bm * bn * eb) / max(cdiv(k, bk), 1)),
        ("ctrl", 1.0),                                     # grid bookkeeping
    ]


def _matmul_inputs(gen, *, m: int, n: int, k: int, dtype: str = "float32"):
    import torch
    dt = getattr(torch, dtype)
    return (torch.randn((m, k), generator=gen, device=gen.device).to(dt),
            torch.randn((k, n), generator=gen, device=gen.device).to(dt))


def matmul_plain(a, b):
    """The plain PyTorch version: f32 product, cast to ``a``'s type."""
    return (a.float() @ b.float()).to(a.dtype)


def _refuse(kernel: str, tile: str, a, b) -> None:
    """ValueError for a product the tile's kernel cannot take."""
    if GEMM_TILES[tile][5] != WGMMA:
        return
    m, k = a.shape
    n = b.shape[1]
    if not wgmma_takes(dtype_name(a), n, k):
        raise ValueError(
            f"{kernel}: tile {tile} takes bfloat16 with K and N multiples "
            f"of 8, got {dtype_name(a)} (M={m}, K={k}, N={n})")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{kernel}: tile {tile} needs 16-byte-aligned "
                         f"operands for its tensor maps")


def gemm_launch(kernel: str, a, b, out, tile: str) -> None:
    """One call of the GEMM tile ``tile`` (``out`` float32 for the split
    MLP's passes, else the input type); a split-K tile gets its f32
    workspace here."""
    import torch
    _refuse(kernel, tile, a, b)
    m, k = a.shape
    n = b.shape[1]
    split = GEMM_TILES[tile][7]
    ws = (torch.empty((split, m, n), dtype=torch.float32, device=a.device)
          if split > 1 else None)
    lib = _cuda.library()
    rc = lib.repro_gemm(_TILE_INDEX[tile], _cuda.dtype_code(a),
                        int(out.dtype != a.dtype), a.data_ptr(),
                        b.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(), m, n, k,
                        _cuda.stream_of(a))
    _cuda.check(rc, kernel)
    LAUNCHES[_FAMILY_COUNTER[GEMM_TILES[tile][5]]] += 1
    if split > 1:
        LAUNCHES["splitk_reduce"] += 1


def splitk_reduce_plain(ws, dtype):
    """The plain version of the split-K reduction: the f32 slices of
    ``ws`` [split, M, N] summed in slice order, cast to ``dtype``."""
    out = ws[0].clone()
    for p in range(1, ws.shape[0]):
        out += ws[p]
    return out.to(dtype)


def splitk_reduce_cuda(ws, dtype):
    """Launch the split-K reduction kernel on a CUDA f32 workspace."""
    import torch
    _cuda.require_operands("splitk_reduce", ws)
    if ws.dim() != 3 or ws.dtype != torch.float32:
        raise ValueError(f"splitk_reduce: ws must be float32 [split, M, N], "
                         f"got {ws.dtype} {tuple(ws.shape)}")
    split, m, n = ws.shape
    out = torch.empty((m, n), dtype=dtype, device=ws.device)
    rc = _cuda.library().repro_splitk_reduce(
        _cuda.dtype_code(out), ws.data_ptr(), out.data_ptr(), m, n, split,
        _cuda.stream_of(ws))
    _cuda.check(rc, "splitk_reduce")
    LAUNCHES["splitk_reduce"] += 1
    return out


def splitk_reduce(ws, dtype):
    """Sum the split-K slices: the kernel for a CUDA workspace, the plain
    version for a CPU one."""
    if ws.device.type == "cpu":
        return splitk_reduce_plain(ws, dtype)
    return splitk_reduce_cuda(ws, dtype)


def matmul_cuda(a, b, *, tile: str):
    """Launch the CUDA GEMM instantiation ``tile`` on CUDA tensors."""
    import torch
    _cuda.require_operands("matmul", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: inner dimensions disagree: "
                         f"a.shape={tuple(a.shape)}, b.shape={tuple(b.shape)}")
    if tile not in GEMM_TILES:
        raise ValueError(f"matmul: unknown tile {tile!r}")
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype,
                      device=a.device)
    gemm_launch("matmul", a, b, out, tile)
    LAUNCHES["matmul"] += 1
    return out


@tuned_kernel(
    "matmul",
    space={"bm": divisors("m", (8, 16, 32, 64, 128, 256, 512)),
           "bn": divisors("n", (8, 16, 32, 64, 128, 256, 512)),
           "bk": divisors("k", (8, 16, 32, 64, 128, 256, 512))},
    signature=lambda a, b, **_: dict(m=a.shape[0], n=b.shape[1],
                                     k=a.shape[1], dtype=dtype_name(a)),
    static_info=_matmul_analysis,
    schedule=_matmul_schedule,
    hopper=HopperSpace(tiles=tuple(GEMM_TILES), analysis=_matmul_hopper),
    out=lambda a, b, **_: ((a.shape[0], b.shape[1]), a.dtype),
    make_inputs=_matmul_inputs,
    reference=matmul_ref,
    pretune=tuple(dict(m=m, n=n, k=k, dtype=dt)
                  for (m, n, k) in [(256,) * 3, (512,) * 3, (1024,) * 3,
                                    (2048,) * 3, (1024, 1024, 4096),
                                    (4096, 1024, 1024)]
                  for dt in ("float32", "bfloat16")),
    # Not a paper kernel; classic shared-memory-tiled SGEMM numbers:
    # two 16x16 f32 operand tiles staged per block, moderate register
    # pressure (accumulator + tile indices).
    cuda=cuda_profile(
        regs=32, shmem_per_block=2 * 16 * 16 * 4,
        workload=lambda m, n, k, **_: dict(
            o_fl=2.0 * m * n * k, o_mem=1.0 * (m * k + k * n + m * n),
            o_ctrl=1.0 * m * n, o_reg=2.0 * m * n * k)),
)
def matmul(a, b, *, tile: str | None = None):
    """a (M, K) . b (K, N) -> (M, N) in ``a``'s type: the CUDA GEMM for
    CUDA tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    return matmul_cuda(a, b, tile=tile)


def matmul_static_info(m: int, n: int, k: int, dtype,
                       params: Dict) -> KernelStaticInfo:
    """Scalar static info for one configuration (wrapper over the
    declared analysis; kept as a stable public helper)."""
    return block_info(**_matmul_analysis(params, m=m, n=n, k=k,
                                       dtype=dtype_str(dtype)))


def make_tunable_matmul(m: int = 1024, n: int = 1024, k: int = 1024,
                        dtype="float32", seed: int = 0,
                        device=None) -> TunableKernel:
    """matmul at (m, n, k) for `repro_torch.core.KernelTuner`: the
    reference's narrowed block space under a TPU target, the GEMM tile
    table under the H100 — the active target (see `KernelSpec.tunable`)."""
    sizes = (128, 256, 512)
    space = SearchSpace({
        "bm": pick_divisor_candidates(m, sizes),
        "bn": pick_divisor_candidates(n, sizes),
        "bk": pick_divisor_candidates(k, sizes),
    })
    return get_spec("matmul").tunable(
        m=m, n=n, k=k, dtype=dtype_str(dtype), seed=seed, space=space,
        name=f"matmul_{m}x{n}x{k}", device=device)
