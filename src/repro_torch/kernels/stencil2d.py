"""stencil2d: 5-point 2-D Jacobi sweep — the openness proof for
`@tuned_kernel` (B9).

out = c0·u + c1·(the 4 edge neighbours) in f32 on the interior of the
(Y, X) grid; every cell on the grid's edge passes through (Dirichlet);
the result is in u's type.

This module is the **only** Python file that knows stencil2d exists,
yet the kernel gets cold full-space ranking, warm memoized dispatch
(``repro_torch.kernels.ops.stencil2d``) and `KernelTuner` packaging —
all derived from the single declaration below, because
``repro_torch.kernels`` imports every module it finds.  Nothing in
``ops.py``, ``api.py``, the tuning cache or the kernel library names it:
its CUDA source, ``csrc/stencil2d.cu`` (design and bound in the note at
its top), builds on its own through `_cuda.load_extension`.

Port of the reference's Pallas kernel
(`src/repro/kernels/stencil2d.py:_stencil_kernel`).  The declaration
keeps the reference's TPU block space (``by`` rows per grid step),
analysis, ``cuda=`` profile and pretune grid; its H100 space is the
(x tile, row groups, rows per run) instantiations of `STENCIL_TILES`,
spanning 32 to 1024 threads.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.autotuner import TunableKernel
from repro_torch.core.hw import dtype_bytes
from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, TILE_AXIS, cuda_profile,
                                     divisors, get_spec, tuned_kernel)
from repro_torch.kernels.common import cdiv, dtype_name, dtype_str
from repro_torch.kernels.matmul import tile_fields

__all__ = ["stencil2d", "stencil2d_cuda", "stencil2d_plain",
           "make_tunable_stencil2d", "extension", "STENCIL_TILES",
           "LAUNCHES"]

C0_DEFAULT = 0.5
C1_DEFAULT = 0.125

# Launches of the CUDA kernel by `stencil2d_cuda` (one per call).
LAUNCHES = {"stencil2d": 0}

# name -> (x tile BX, row groups BY, rows per run R); threads = BX * BY;
# order = csrc/stencil2d.cu STENCIL_TILES.
STENCIL_TILES: Dict[str, Tuple[int, ...]] = {
    "x32y1r16": (32, 1, 16), "x32y4r16": (32, 4, 16),
    "x64y2r32": (64, 2, 32), "x128y1r64": (128, 1, 64),
    "x128y2r16": (128, 2, 16), "x256y1r32": (256, 1, 32),
    "x128y4r16": (128, 4, 16), "x256y2r16": (256, 2, 16),
    "x512y1r8": (512, 1, 8), "x128y8r8": (128, 8, 8),
    "x32y32r4": (32, 32, 4),
}

_SOURCE = _cuda.CSRC / "stencil2d.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "stencil2d_launch": [_I, _I, _P, _P, _I, _I, _F, _F, _P],
    "stencil2d_attrs": [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                        ctypes.POINTER(_I)],
    "stencil2d_tile_info": [_I, ctypes.POINTER(_I)],
}


def extension() -> ctypes.CDLL:
    """The compiled ``csrc/stencil2d.cu`` (built at first use)."""
    return _cuda.load_extension("stencil2d", _SOURCE, _SIGNATURES)


def _stencil2d_analysis(p, *, y: int, x: int, dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols).

    5-point stencil: ~6 vector FLOPs/output; 3 block reads + 1 write.
    """
    by = np.minimum(np.asarray(p["by"], dtype=np.int64), y)
    steps = cdiv(y, by)
    return dict(
        in_blocks=[(by, x)] * 3,
        out_blocks=[(by, x)],
        in_dtypes=[dtype] * 3,
        out_dtypes=[dtype],
        flops_per_step=0.0,
        vpu_per_step=6.0 * by * x,
        grid_steps=steps,
    )


def _stencil2d_hopper(cols, *, y: int, x: int, dtype: str = "float32"):
    """u read once and out written once from device memory, plus the
    halo rows of each run (one above, two below its R rows); the
    lane-edge cells come from L1/L2.  No shared memory."""
    t = tile_fields(STENCIL_TILES, cols[TILE_AXIS])
    bx, by, r = t[:, 0], t[:, 1], t[:, 2]
    eb = dtype_bytes(dtype)
    runs = cdiv(y, r)
    pts = float(y) * x
    return dict(blocks=cdiv(x, bx) * cdiv(runs, by), threads=bx * by,
                busy_threads=np.minimum(bx, x) * np.minimum(by, runs),
                regs=32, smem=0, flops=6.0 * pts,
                hbm_bytes=(pts + 3.0 * (runs - 1) * x) * eb + pts * eb)


def _stencil2d_inputs(gen, *, y: int, x: int, dtype: str = "float32"):
    import torch
    return (torch.randn((y, x), generator=gen, device=gen.device)
            .to(getattr(torch, dtype)),)


def stencil2d_plain(u, c0: float = C0_DEFAULT, c1: float = C1_DEFAULT):
    """The plain PyTorch version (the reference's oracle): the sweep in
    f32 on the interior, boundary passed through, cast to u's type."""
    f = u.float()
    out = f.clone()
    out[1:-1, 1:-1] = (c0 * f[1:-1, 1:-1]
                       + c1 * (f[:-2, 1:-1] + f[2:, 1:-1]
                               + f[1:-1, :-2] + f[1:-1, 2:]))
    return out.to(u.dtype)


def stencil2d_cuda(u, c0: float = C0_DEFAULT, c1: float = C1_DEFAULT, *,
                   tile: str):
    """Launch the CUDA stencil instantiation ``tile`` on a CUDA tensor
    u (Y, X) -> (Y, X)."""
    import torch
    _cuda.require_operands("stencil2d", u)
    if u.dim() != 2 or u.numel() == 0:
        raise ValueError(f"stencil2d: u must be a non-empty (Y, X) grid, "
                         f"got {tuple(u.shape)}")
    if tile not in STENCIL_TILES:
        raise ValueError(f"stencil2d: unknown tile {tile!r}")
    y, x = u.shape
    _, by, r = STENCIL_TILES[tile]
    if cdiv(y, by * r) > 65535:
        raise ValueError(f"stencil2d: {y} rows exceed tile {tile}'s grid "
                         f"(65535 row blocks of {by * r} rows)")
    lib = extension()
    out = torch.empty_like(u)
    rc = lib.stencil2d_launch(
        list(STENCIL_TILES).index(tile), _cuda.dtype_code(u), u.data_ptr(),
        out.data_ptr(), y, x, float(c0), float(c1), _cuda.stream_of(u))
    _cuda.check(rc, "stencil2d", lib)
    LAUNCHES["stencil2d"] += 1
    return out


@tuned_kernel(
    "stencil2d",
    space={"by": divisors("y", (8, 16, 32, 64, 128, 256))},
    signature=lambda u, **_: dict(y=u.shape[0], x=u.shape[1],
                                  dtype=dtype_name(u)),
    static_info=_stencil2d_analysis,
    hopper=HopperSpace(tiles=tuple(STENCIL_TILES),
                       analysis=_stencil2d_hopper),
    out=lambda u, **_: (tuple(u.shape), u.dtype),
    make_inputs=_stencil2d_inputs,
    reference=stencil2d_plain,
    pretune=(dict(y=512, x=512, dtype="float32"),
             dict(y=1024, x=1024, dtype="float32"),
             dict(y=2048, x=2048, dtype="float32"),
             dict(y=1024, x=1024, dtype="bfloat16")),
    # 5-point Jacobi: 6 flops/point, read + write per point, light
    # register pressure (no staging).
    cuda=cuda_profile(
        regs=24,
        workload=lambda y, x, **_: dict(
            o_fl=6.0 * y * x, o_mem=2.0 * y * x,
            o_ctrl=1.0 * y, o_reg=6.0 * y * x)),
)
def stencil2d(u, c0: float = C0_DEFAULT, c1: float = C1_DEFAULT, *,
              tile: str | None = None):
    """One 5-point sweep of u (Y, X): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if u.device.type == "cpu":
        return stencil2d_plain(u, c0, c1)
    return stencil2d_cuda(u, c0, c1, tile=tile)


def make_tunable_stencil2d(y: int = 512, x: int = 512, dtype="float32",
                           seed: int = 0, device=None) -> TunableKernel:
    """stencil2d at (y, x) for `repro_torch.core.KernelTuner` over the
    *full* dispatch space: the declared block space under a TPU target,
    the tile table under the H100 — the active target (see
    `KernelSpec.tunable`)."""
    return get_spec("stencil2d").tunable(
        y=y, x=x, dtype=dtype_str(dtype), seed=seed, device=device)
