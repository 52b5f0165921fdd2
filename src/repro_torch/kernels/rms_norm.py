"""RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w over rows, in f32.

Port of `src/repro/kernels/rms_norm.py:_rms_kernel` as the warp-per-row
CUDA kernel of ``csrc/rms_norm.cu`` (design, bound and what it leaves
on the table are noted there).  The serving path normalizes every
layer's input rows through it.

The declaration keeps the reference's TPU space (``bm`` rows per grid
step), analysis and pretune grid; its H100 space is the rows-per-block
instantiations of the kernel (`RMS_TILES`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, TILE_AXIS, divisors,
                                     tuned_kernel)
from repro_torch.core.hw import dtype_bytes
from repro_torch.kernels.common import cdiv, dtype_name, require_shape

__all__ = ["rms_norm", "rms_norm_cuda", "rms_norm_plain", "RMS_TILES",
           "LAUNCHES"]

# Launches of the CUDA kernel by `rms_norm_cuda` (one per call).
LAUNCHES = {"rms_norm": 0}

# name -> (rows per block,), threads = 32 * rows; order = csrc RMS_TILES.
RMS_TILES: Dict[str, Tuple[int, ...]] = {
    "r1": (1,), "r2": (2,), "r4": (4,), "r8": (8,), "r16": (16,),
}


def _rms_analysis(p, *, m: int, d: int, dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols).
    Pure VPU workload: square, mean, rsqrt-scale, weight multiply."""
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    return dict(
        in_blocks=[(bm, d), (1, d)],
        out_blocks=[(bm, d)],
        in_dtypes=[dtype, dtype],
        out_dtypes=[dtype],
        flops_per_step=0.0,
        vpu_per_step=6.0 * bm * d,        # sq, sum, scale, mul, casts
        trans_per_step=1.0 * bm,          # rsqrt per row
        grid_steps=cdiv(m, bm),
    )


def _rms_hopper(cols, *, m: int, d: int, dtype: str = "float32"):
    """One warp per row: no shared memory, x read and y written once
    from device memory (the second pass over a row hits L1/L2), the f32
    weight read once per block."""
    rows = np.array([RMS_TILES[str(t)][0] for t in cols[TILE_AXIS]],
                    dtype=np.int64)
    eb = dtype_bytes(dtype)
    blocks = cdiv(m, rows)
    return dict(blocks=blocks, threads=32 * rows,
                busy_threads=32 * np.minimum(rows, m), regs=24, smem=0,
                flops=4.0 * m * d, trans=float(m),
                hbm_bytes=2.0 * m * d * eb + blocks * d * 4.0)


def rms_norm_plain(x, w, eps: float = 1e-6):
    """The plain PyTorch version: f32 mean/rsqrt/scale, cast back."""
    import torch
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rms_norm_cuda(x, w, eps: float = 1e-6, *, tile: str):
    """Launch the CUDA RMSNorm instantiation ``tile`` on CUDA tensors
    (x (M, D) float32/bfloat16, w (D,) any float type, widened)."""
    import torch
    _cuda.require_operands("rms_norm", x)
    if x.dim() != 2:
        raise ValueError(f"rms_norm: x must be (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    require_shape("rms_norm", "w", tuple(w.shape), (d,))
    if tile not in RMS_TILES:
        raise ValueError(f"rms_norm: unknown tile {tile!r}")
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    rc = _cuda.library().repro_rms_norm(
        list(RMS_TILES).index(tile), _cuda.dtype_code(x), x.data_ptr(),
        wf.data_ptr(), out.data_ptr(), m, d, float(eps), _cuda.stream_of(x))
    _cuda.check(rc, "rms_norm")
    LAUNCHES["rms_norm"] += 1
    return out


@tuned_kernel(
    "rms_norm",
    space={"bm": divisors("m", (8, 16, 32, 64, 128, 256, 512, 1024))},
    signature=lambda x, w, **_: dict(m=x.shape[0], d=x.shape[1],
                                     dtype=dtype_name(x)),
    static_info=_rms_analysis,
    hopper=HopperSpace(tiles=tuple(RMS_TILES), analysis=_rms_hopper),
    out=lambda x, w, **_: (tuple(x.shape), x.dtype),
    pretune=tuple(dict(m=m, d=d, dtype=dt)
                  for (m, d) in [(1024, 1024), (4096, 4096), (8192, 2048)]
                  for dt in ("float32", "bfloat16")),
)
def rms_norm(x, w, eps: float = 1e-6, *, tile: str | None = None):
    """x (M, D), w (D,) -> (M, D) RMS-normalized rows: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps)
    return rms_norm_cuda(x, w, eps, tile=tile)
