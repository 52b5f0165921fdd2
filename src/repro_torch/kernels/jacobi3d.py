"""ex14FJ analogue (paper Table IV): one 7-point 3-D Jacobi sweep.

out = c0·u + c1·(the 6 face neighbours) in f32 on the interior of the
(Z, Y, X) volume; every cell on a face passes through (Dirichlet); the
result is in u's type.

Port of the reference's Pallas kernel
(`src/repro/kernels/jacobi3d.py:_jacobi_kernel`) as ``jacobi_kernel``
of ``csrc/jacobi3d.cu`` (design and bound in the note at its top): a
2-D thread tile over (y, x) marching along z, the z-neighbours in
registers, the in-plane ones from a shared-memory tile with a halo.

The declaration keeps the reference's TPU block space (``bz`` planes
per grid step), analysis, ``cuda=`` profile (Table VII's R^u) and
pretune grid; its H100 space is the (x tile, y tile, planes per block)
instantiations of `JACOBI_TILES`, spanning 32 to 1024 threads.
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
                                        pick_divisor_candidates)
from repro_torch.kernels.matmul import tile_fields
from repro_torch.kernels.ref import jacobi3d_ref

__all__ = ["jacobi3d", "jacobi3d_static_info", "jacobi3d_cuda",
           "jacobi3d_plain",
           "make_tunable_jacobi3d", "JACOBI_TILES", "KIND", "LAUNCHES"]

C0_DEFAULT = 0.5
C1_DEFAULT = 1.0 / 12.0

# Launches of the CUDA kernel by `jacobi3d_cuda` (one per call).
LAUNCHES = {"jacobi3d": 0}

# The C library's kernel kind (csrc/common.cuh ReproKind).
KIND = 9

# name -> (x tile, y tile, z planes per block); threads = x * y;
# order = csrc/jacobi3d.cu JACOBI_TILES.
JACOBI_TILES: Dict[str, Tuple[int, ...]] = {
    "x32y1z32": (32, 1, 32), "x32y2z32": (32, 2, 32),
    "x32y4z16": (32, 4, 16), "x32y8z16": (32, 8, 16),
    "x64y4z16": (64, 4, 16), "x32y16z16": (32, 16, 16),
    "x64y8z16": (64, 8, 16), "x32y32z16": (32, 32, 16),
    "x64y16z16": (64, 16, 16), "x32y8z64": (32, 8, 64),
}


def _jacobi3d_analysis(p, *, z: int, y: int, x: int,
                       dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols).

    7-point stencil: ~8 vector FLOPs/output; 3 block reads + 1 write.
    """
    bz = np.minimum(np.asarray(p["bz"], dtype=np.int64), z)
    steps = cdiv(z, bz)
    plane = y * x
    return dict(
        in_blocks=[(bz, y, x)] * 3,
        out_blocks=[(bz, y, x)],
        in_dtypes=[dtype] * 3,
        out_dtypes=[dtype],
        flops_per_step=0.0,
        vpu_per_step=8.0 * bz * plane,
        grid_steps=steps,
    )


def _jacobi3d_hopper(cols, *, z: int, y: int, x: int,
                     dtype: str = "float32"):
    """u read once and out written once from device memory, plus the
    plane below and above each block's ZB planes; the in-plane halo
    cells come from L2.  Shared memory: each plane staged once with its
    halo, four neighbours read per point."""
    t = tile_fields(JACOBI_TILES, cols[TILE_AXIS])
    bx, by, zb = t[:, 0], t[:, 1], t[:, 2]
    eb = dtype_bytes(dtype)
    gx, gy, gz = cdiv(x, bx), cdiv(y, by), cdiv(z, zb)
    pts = float(z) * y * x
    staged = gx * gy * float(z) * (bx + 2) * (by + 2)
    return dict(blocks=gx * gy * gz, threads=bx * by,
                busy_threads=np.minimum(bx, x) * np.minimum(by, y),
                regs=32, smem=4 * (bx + 2) * (by + 2), flops=8.0 * pts,
                hbm_bytes=(pts + 2.0 * (gz - 1) * y * x) * eb + pts * eb,
                smem_bytes=(staged + 4.0 * pts) * 4)


def _jacobi3d_inputs(gen, *, z: int, y: int, x: int,
                     dtype: str = "float32"):
    import torch
    return (torch.randn((z, y, x), generator=gen, device=gen.device)
            .to(getattr(torch, dtype)),)


def jacobi3d_plain(u, c0: float = C0_DEFAULT, c1: float = C1_DEFAULT):
    """The plain PyTorch version: the sweep in f32, cast to u's type."""
    return jacobi3d_ref(u, c0, c1)


def jacobi3d_cuda(u, c0: float = C0_DEFAULT, c1: float = C1_DEFAULT, *,
                  tile: str):
    """Launch the CUDA Jacobi instantiation ``tile`` on a CUDA tensor
    u (Z, Y, X) -> (Z, Y, X)."""
    import torch
    _cuda.require_operands("jacobi3d", u)
    if u.dim() != 3 or u.numel() == 0:
        raise ValueError(f"jacobi3d: u must be a non-empty (Z, Y, X) "
                         f"volume, got {tuple(u.shape)}")
    if tile not in JACOBI_TILES:
        raise ValueError(f"jacobi3d: unknown tile {tile!r}")
    z, y, x = u.shape
    out = torch.empty_like(u)
    rc = _cuda.library().repro_jacobi3d(
        list(JACOBI_TILES).index(tile), _cuda.dtype_code(u), u.data_ptr(),
        out.data_ptr(), z, y, x, float(c0), float(c1), _cuda.stream_of(u))
    _cuda.check(rc, "jacobi3d")
    LAUNCHES["jacobi3d"] += 1
    return out


@tuned_kernel(
    "jacobi3d",
    space={"bz": divisors("z", (1, 2, 4, 8, 16, 32, 64))},
    signature=lambda u, **_: dict(z=u.shape[0], y=u.shape[1], x=u.shape[2],
                                  dtype=dtype_name(u)),
    static_info=_jacobi3d_analysis,
    hopper=HopperSpace(tiles=tuple(JACOBI_TILES), analysis=_jacobi3d_hopper),
    out=lambda u, **_: (tuple(u.shape), u.dtype),
    make_inputs=_jacobi3d_inputs,
    reference=jacobi3d_ref,
    pretune=tuple(dict(z=s, y=s, x=s, dtype="float32")
                  for s in (64, 128, 256)),
    # Paper Table VII row (ex14FJ, the finite-difference Jacobi
    # kernel): R^u per compute capability, no shared memory; 7-point
    # stencil = 8 flops/point, read + write per point.
    cuda=cuda_profile(
        regs={"Fermi": 30, "Kepler": 31, "Maxwell": 28},
        workload=lambda z, y, x, **_: dict(
            o_fl=8.0 * z * y * x, o_mem=2.0 * z * y * x,
            o_ctrl=1.0 * z, o_reg=8.0 * z * y * x)),
)
def jacobi3d(u, c0: float = C0_DEFAULT, c1: float = C1_DEFAULT, *,
             tile: str | None = None):
    """One Jacobi sweep of u (Z, Y, X): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if u.device.type == "cpu":
        return jacobi3d_plain(u, c0, c1)
    return jacobi3d_cuda(u, c0, c1, tile=tile)


def jacobi3d_static_info(z: int, y: int, x: int, dtype,
                         params: Dict) -> KernelStaticInfo:
    """Scalar static info for one configuration (wrapper over the
    declared analysis; kept as a stable public helper)."""
    return block_info(**_jacobi3d_analysis(params, z=z, y=y, x=x,
                                         dtype=dtype_str(dtype)))


def make_tunable_jacobi3d(z: int = 128, y: int = 128, x: int = 128,
                          dtype="float32", seed: int = 0,
                          device=None) -> TunableKernel:
    """jacobi3d at (z, y, x) for `repro_torch.core.KernelTuner`: the
    reference's narrowed block space under a TPU target, the tile table
    under the H100 — the active target (see `KernelSpec.tunable`)."""
    space = SearchSpace({
        "bz": pick_divisor_candidates(z, (1, 2, 4, 8, 16, 32, 64)),
    })
    return get_spec("jacobi3d").tunable(
        z=z, y=y, x=x, dtype=dtype_str(dtype), seed=seed, space=space,
        name=f"jacobi3d_{z}x{y}x{x}", device=device)
