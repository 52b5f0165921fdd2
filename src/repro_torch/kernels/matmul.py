"""Blocked matmul: C = A.B with f32 accumulation, cast to the input type.

Port of the reference's MXU-workhorse Pallas kernel
(`src/repro/kernels/matmul.py:_mm_kernel`) as the tiled CUDA GEMM of
``csrc/gemm.cu`` (see the note at its top for the design, the bound and
what the simple design leaves on the table).  The serving path uses it
for the MLP's down-projection.

The `@tuned_kernel` declaration keeps the reference's TPU block space,
analysis, ``cuda=`` profile and pretune grid unchanged, and adds the
H100 launch space: the GEMM tile instantiations compiled into the
library (`GEMM_TILES`), priced by `gemm_hopper_cost`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, TILE_AXIS, cuda_profile,
                                     divisors, tuned_kernel)
from repro_torch.core.hw import dtype_bytes
from repro_torch.kernels.common import cdiv, dtype_name

__all__ = ["matmul", "matmul_cuda", "matmul_plain", "GEMM_TILES",
           "gemm_hopper_cost", "tile_fields", "LAUNCHES"]

# Launches of the CUDA kernel by `matmul_cuda` (one per call).
LAUNCHES = {"matmul": 0}

# name -> (BM, BN, BK, TM, TN); order = csrc/gemm.cu GEMM_TILES.
GEMM_TILES: Dict[str, Tuple[int, ...]] = {
    "m16n64k32": (16, 64, 32, 1, 4),
    "m32n64k32": (32, 64, 32, 2, 4),
    "m64n64k16": (64, 64, 16, 4, 4),
    "m128n64k16": (128, 64, 16, 8, 4),
    "m64n128k16": (64, 128, 16, 4, 8),
    "m128n128k16": (128, 128, 16, 8, 8),
    "m16n32k64": (16, 32, 64, 1, 2),
    "m16n16k64": (16, 16, 64, 1, 1),
}


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


def _matmul_hopper(cols, *, m: int, n: int, k: int, dtype: str = "float32"):
    t = tile_fields(GEMM_TILES, cols[TILE_AXIS])
    eb = dtype_bytes(dtype)
    return gemm_hopper_cost(m=m, n=n, k=k, bm=t[:, 0], bn=t[:, 1],
                            bk=t[:, 2], tm=t[:, 3], tn=t[:, 4],
                            in_bytes=eb, out_bytes=eb)


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


def matmul_plain(a, b):
    """The plain PyTorch version: f32 product, cast to ``a``'s type."""
    return (a.float() @ b.float()).to(a.dtype)


def gemm_launch(kernel: str, a, b, out, tile: str) -> None:
    """One launch of the tiled GEMM (``out`` float32 for the split MLP's
    passes, else the input type)."""
    m, k = a.shape
    n = b.shape[1]
    lib = _cuda.library()
    rc = lib.repro_gemm(list(GEMM_TILES).index(tile), _cuda.dtype_code(a),
                        int(out.dtype != a.dtype), a.data_ptr(),
                        b.data_ptr(), out.data_ptr(), m, n, k,
                        _cuda.stream_of(a))
    _cuda.check(rc, kernel)


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
    hopper=HopperSpace(tiles=tuple(GEMM_TILES), analysis=_matmul_hopper),
    out=lambda a, b, **_: ((a.shape[0], b.shape[1]), a.dtype),
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
