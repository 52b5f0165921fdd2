"""MatVec2D (paper Table IV): y = A x, f32 accumulation, cast to A's type.

Port of the reference's Pallas kernel
(`src/repro/kernels/matvec.py:_mv_kernel`) as ``matvec_kernel`` of
``csrc/blas2.cu`` (design and bound in the note at its top): a block
owns whole rows, ``WPR`` warps per row, 16-byte loads and a shuffle
reduction.

The `@tuned_kernel` declaration keeps the reference's TPU block space,
analysis, ``cuda=`` profile (Table VII's R^u) and pretune grid, and
adds the H100 launch space: the (rows per block, warps per row)
instantiations compiled into the library (`MATVEC_TILES`), spanning
32 to 1024 threads per block.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.autotuner import KernelStaticInfo, TunableKernel
from repro_torch.core.hw import dtype_bytes
from repro_torch.core.sass import template_symbol
from repro_torch.core.search import SearchSpace
from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, TILE_AXIS, cuda_profile,
                                     divisors, get_spec, tuned_kernel)
from repro_torch.kernels.common import (block_info, cdiv, dtype_name,
                                        dtype_str,
                                        pick_divisor_candidates,
                                        require_shape)
from repro_torch.kernels.matmul import tile_fields
from repro_torch.kernels.ref import matvec_ref

__all__ = ["matvec", "matvec_static_info", "matvec_cuda", "matvec_plain",
           "make_tunable_matvec",
           "MATVEC_TILES", "KIND", "LAUNCHES"]

# Launches of the CUDA kernel by `matvec_cuda` (one per call).
LAUNCHES = {"matvec": 0}

# The C library's kernel kind (csrc/common.cuh ReproKind).
KIND = 6

# name -> (rows per block, warps per row); threads = 32 * rows * wpr;
# order = csrc/blas2.cu MATVEC_TILES.
MATVEC_TILES: Dict[str, Tuple[int, ...]] = {
    "r1w1": (1, 1), "r2w1": (2, 1), "r4w1": (4, 1), "r8w1": (8, 1),
    "r16w1": (16, 1), "r32w1": (32, 1), "r1w4": (1, 4), "r1w8": (1, 8),
    "r2w8": (2, 8), "r4w8": (4, 8),
}


def _matvec_analysis(p, *, m: int, n: int, dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols)."""
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    bk = np.minimum(np.asarray(p["bk"], dtype=np.int64), n)
    steps = cdiv(m, bm) * cdiv(n, bk)
    return dict(
        in_blocks=[(bm, bk), (bk, 1)],
        out_blocks=[(bm, 1)],
        in_dtypes=[dtype, dtype],
        out_dtypes=[dtype],
        flops_per_step=2.0 * bm * bk,
        grid_steps=steps,
        scratch_bytes=bm * 4,
    )


def _matvec_hopper(cols, *, m: int, n: int, dtype: str = "float32"):
    """A read once from device memory, x from L1/L2 after its first
    read, y written once.  A row of n/V 16-byte vectors keeps at most
    that many of its 32 * WPR lanes busy."""
    t = tile_fields(MATVEC_TILES, cols[TILE_AXIS])
    rows, wpr = t[:, 0], t[:, 1]
    eb = dtype_bytes(dtype)
    vec = 16 // eb
    busy_lanes = np.minimum(32 * wpr, max(1, cdiv(n, vec)))
    return dict(blocks=cdiv(m, rows), threads=32 * rows * wpr,
                busy_threads=np.minimum(rows, m) * busy_lanes,
                regs=24 + 2 * vec, smem=4 * rows * wpr,
                flops=2.0 * m * n,
                hbm_bytes=float(m) * n * eb + (n + m) * eb)


def _matvec_inputs(gen, *, m: int, n: int, dtype: str = "float32"):
    import torch
    dt = getattr(torch, dtype)
    return (torch.randn((m, n), generator=gen, device=gen.device).to(dt),
            torch.randn((n, 1), generator=gen, device=gen.device).to(dt))


def matvec_plain(a, x):
    """The plain PyTorch version: f32 product, cast to ``a``'s type."""
    return matvec_ref(a, x)


def matvec_cuda(a, x, *, tile: str):
    """Launch the CUDA matvec instantiation ``tile`` on CUDA tensors
    (a (M, N), x (N, 1) -> (M, 1))."""
    import torch
    _cuda.require_operands("matvec", a, x)
    if a.dim() != 2 or a.numel() == 0:
        raise ValueError(f"matvec: a must be a non-empty (M, N) matrix, "
                         f"got {tuple(a.shape)}")
    m, n = a.shape
    require_shape("matvec", "x", tuple(x.shape), (n, 1))
    if tile not in MATVEC_TILES:
        raise ValueError(f"matvec: unknown tile {tile!r}")
    y = torch.empty((m, 1), dtype=a.dtype, device=a.device)
    rc = _cuda.library().repro_matvec(
        list(MATVEC_TILES).index(tile), _cuda.dtype_code(a), a.data_ptr(),
        x.data_ptr(), y.data_ptr(), m, n, _cuda.stream_of(a))
    _cuda.check(rc, "matvec")
    LAUNCHES["matvec"] += 1
    return y


def _matvec_symbols(tile: str, *, m: int, n: int, dtype: str = "float32"):
    rows, wpr = MATVEC_TILES[tile]
    return (template_symbol("matvec_kernel", dtype, rows, wpr),)


@tuned_kernel(
    "matvec",
    space={"bm": divisors("m", (32, 64, 128, 256, 512, 1024)),
           "bk": divisors("n", (32, 64, 128, 256, 512, 1024))},
    signature=lambda a, x, **_: dict(m=a.shape[0], n=a.shape[1],
                                     dtype=dtype_name(a)),
    static_info=_matvec_analysis,
    hopper=HopperSpace(tiles=tuple(MATVEC_TILES), analysis=_matvec_hopper,
                       symbols=_matvec_symbols),
    out=lambda a, x, **_: ((a.shape[0], 1), a.dtype),
    make_inputs=_matvec_inputs,
    reference=matvec_ref,
    pretune=tuple(dict(m=s, n=s, dtype=dt)
                  for s in (512, 1024, 2048, 4096)
                  for dt in ("float32", "bfloat16")),
    # Paper Table VII row (matVec2D): R^u per compute capability, no
    # shared memory; one multiply-add per matrix element.
    cuda=cuda_profile(
        regs={"Fermi": 20, "Kepler": 20, "Maxwell": 13},
        workload=lambda m, n, **_: dict(
            o_fl=2.0 * m * n, o_mem=1.0 * m * n + m + n,
            o_ctrl=1.0 * m, o_reg=2.0 * m * n)),
)
def matvec(a, x, *, tile: str | None = None):
    """a (M, N) . x (N, 1) -> (M, 1) in ``a``'s type: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return matvec_plain(a, x)
    return matvec_cuda(a, x, tile=tile)


def matvec_static_info(m: int, n: int, dtype,
                       params: Dict) -> KernelStaticInfo:
    """Scalar static info for one configuration (wrapper over the
    declared analysis; kept as a stable public helper)."""
    return block_info(**_matvec_analysis(params, m=m, n=n,
                                       dtype=dtype_str(dtype)))


def make_tunable_matvec(m: int = 2048, n: int = 2048, dtype="float32",
                        seed: int = 0,
                        device=None) -> TunableKernel:
    """matvec at (m, n) for `repro_torch.core.KernelTuner`: the
    reference's narrowed block space under a TPU target, the tile table
    under the H100 — the active target (see `KernelSpec.tunable`)."""
    space = SearchSpace({
        "bm": pick_divisor_candidates(m, (64, 128, 256, 512, 1024)),
        "bk": pick_divisor_candidates(n, (128, 256, 512, 1024)),
    })
    return get_spec("matvec").tunable(
        m=m, n=n, dtype=dtype_str(dtype), seed=seed, space=space,
        name=f"matvec_{m}x{n}", device=device)
