"""ex14FJ analogue (paper Table IV): one 7-point 3-D Jacobi sweep.

out = c0·u + c1·(the 6 face neighbours) in f32 on the interior of the
(Z, Y, X) volume; every cell on a face passes through (Dirichlet); the
result is in u's type.

Port of the reference's Pallas kernel
(`src/repro/kernels/jacobi3d.py:_jacobi_kernel`) as the two kernels of
``csrc/jacobi3d.cu`` (design and bound in the note at its top): plane
rows (``jacobi_kernel``: a 2-D thread tile over (y, x) marching along z,
the z-neighbours in registers, the in-plane ones from a shared-memory
tile with a halo; any shape) and ring rows (``jacobi_ring_kernel``: a
ring of S input planes in shared memory fed by TMA, 16-byte vectors
along x; X a multiple of 16 / elem_bytes, else ValueError).

The declaration keeps the reference's TPU block space (``bz`` planes
per grid step), analysis, ``cuda=`` profile (Table VII's R^u) and
pretune grid; its H100 space is the instantiations of `JACOBI_TILES`,
both families priced together by `jacobi_tiles_cost`.
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
from repro_torch.kernels.common import (block_info, cdiv, declared_regs,
                                        dtype_name, dtype_str, family_costs,
                                        pick_divisor_candidates)
from repro_torch.kernels.matmul import tile_fields
from repro_torch.kernels.ref import jacobi3d_ref

__all__ = ["jacobi3d", "jacobi3d_static_info", "jacobi3d_cuda",
           "jacobi3d_plain", "make_tunable_jacobi3d", "JACOBI_TILES",
           "PLANE", "RING", "ring_takes", "jacobi_tiles_cost", "KIND",
           "LAUNCHES"]

C0_DEFAULT = 0.5
C1_DEFAULT = 1.0 / 12.0

# Launches: "jacobi3d" counts calls of `jacobi3d_cuda` (one per call,
# whatever the tile), "jacobi_plane" / "jacobi_ring" the kernel of each
# family that it launched.
LAUNCHES = {"jacobi3d": 0, "jacobi_plane": 0, "jacobi_ring": 0}
_FAMILY_COUNTER = ("jacobi_plane", "jacobi_ring")

# The C library's kernel kind (csrc/common.cuh ReproKind).
KIND = 9

# tile families (csrc/jacobi3d.cu JacobiFamily)
PLANE, RING = 0, 1

# name -> (x tile, y tile, z planes per block, family, ring stages);
# order = csrc/jacobi3d.cu JACOBI_TILES, then JACOBI_RING_TILES.  Plane
# rows run x * y threads; ring rows x / (16 / elem_bytes) * y, the
# longest TMA rows first (where the analysis ties rows, the first wins).
JACOBI_TILES: Dict[str, Tuple[int, ...]] = {
    "x32y1z32": (32, 1, 32, PLANE, 0), "x32y2z32": (32, 2, 32, PLANE, 0),
    "x32y4z16": (32, 4, 16, PLANE, 0), "x32y8z16": (32, 8, 16, PLANE, 0),
    "x64y4z16": (64, 4, 16, PLANE, 0),
    "x32y16z16": (32, 16, 16, PLANE, 0),
    "x64y8z16": (64, 8, 16, PLANE, 0),
    "x32y32z16": (32, 32, 16, PLANE, 0),
    "x64y16z16": (64, 16, 16, PLANE, 0),
    "x32y8z64": (32, 8, 64, PLANE, 0),
    "ring_x128y8z32s6": (128, 8, 32, RING, 6),
    "ring_x64y8z32s8": (64, 8, 32, RING, 8),
    "ring_x128y8z16s4": (128, 8, 16, RING, 4),
    "ring_x64y8z16s4": (64, 8, 16, RING, 4),
    "ring_x64y16z16s4": (64, 16, 16, RING, 4),
    "ring_x128y16z16s4": (128, 16, 16, RING, 4),
}
_TILE_INDEX = {t: i for i, t in enumerate(JACOBI_TILES)}

# declared registers per thread, (float32, bfloat16), of every row: the
# compiled counts for sm_90a, which the smoke prints beside them
_REGS: Dict[str, Tuple[int, int]] = {
    "x32y1z32": (64, 64), "x32y2z32": (56, 56), "x32y4z16": (56, 56),
    "x32y8z16": (64, 64), "x64y4z16": (64, 64), "x32y16z16": (59, 60),
    "x64y8z16": (59, 60), "x32y32z16": (50, 50), "x64y16z16": (50, 50),
    "x32y8z64": (64, 64),
    "ring_x128y8z32s6": (38, 48), "ring_x64y8z32s8": (37, 48),
    "ring_x128y8z16s4": (38, 48), "ring_x64y8z16s4": (37, 48),
    "ring_x64y16z16s4": (38, 48), "ring_x128y16z16s4": (38, 48),
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


def ring_takes(dtype: str, x: int) -> bool:
    """Whether the ring rows take rows of ``x`` elements: TMA's global
    strides are whole 16-byte units, and a thread stores 16 bytes."""
    return x % (16 // dtype_bytes(dtype)) == 0


def _plane_cost(t, *, z: int, y: int, x: int, eb: int):
    """u read once and out written once from device memory, plus the
    plane below and above each block's ZB planes; the in-plane halo
    cells come from L2.  Shared memory: each plane staged once with its
    halo, four neighbours read per point."""
    bx, by, zb = t[:, 0], t[:, 1], t[:, 2]
    gx, gy, gz = cdiv(x, bx), cdiv(y, by), cdiv(z, zb)
    pts = float(z) * y * x
    staged = gx * gy * float(z) * (bx + 2) * (by + 2)
    return dict(blocks=gx * gy * gz, threads=bx * by,
                busy_threads=np.minimum(bx, x) * np.minimum(by, y),
                regs=declared_regs(JACOBI_TILES, _REGS, t, eb),
                smem=4 * (bx + 2) * (by + 2),
                flops=8.0 * pts,
                hbm_bytes=(pts + 2.0 * (gz - 1) * y * x) * eb + pts * eb,
                smem_bytes=(staged + 4.0 * pts) * 4)


def ring_stage_bytes(bx, by, eb: int):
    """Bytes of one ring stage: (BY + 2) rows of BX plus a 16-byte halo
    each side, rounded up to TMA's 128-byte alignment."""
    box = (np.asarray(bx) + 2 * (16 // eb)) * (np.asarray(by) + 2) * eb
    return -(-box // 128) * 128


def _ring_cost(t, *, z: int, y: int, x: int, eb: int):
    """u read once and out written once from device memory, plus the
    plane below and above each block's ZB planes (the ends clamp onto
    planes the block holds).  TMA writes the ring as device memory
    delivers it, one transfer priced once in ``hbm_bytes``; the halo
    rows and columns and the two extra planes a block stages come from
    L2 and are priced as shared-memory traffic, beside a thread's three
    16-byte and two scalar reads per vector of points.  Planes z and z +
    1 are pinned while a block computes z, so S - 1 stages are in flight
    while it waits for its next plane: a block states those bytes in
    flight (Little's law over the card)."""
    bx, by, zb, s = t[:, 0], t[:, 1], t[:, 2], t[:, 4]
    v = 16 // eb
    gx, gy, gz = cdiv(x, bx), cdiv(y, by), cdiv(z, zb)
    pts = float(z) * y * x
    stage = ring_stage_bytes(bx, by, eb)
    staged = gx * gy * (float(z) + 2.0 * gz) * (bx + 2 * v) * (by + 2) * eb
    return dict(blocks=gx * gy * gz, threads=bx // v * by,
                busy_threads=cdiv(np.minimum(bx, x), v) * np.minimum(by, y),
                regs=declared_regs(JACOBI_TILES, _REGS, t, eb),
                smem=s * stage + 8 * s,
                flops=8.0 * pts,
                hbm_bytes=(pts + 2.0 * (gz - 1) * y * x) * eb + pts * eb,
                smem_bytes=staged - pts * eb + pts * eb * (3.0 + 2.0 / v),
                inflight_bytes=(s - 1.0) * stage)


def jacobi_tiles_cost(t, *, z: int, y: int, x: int,
                      dtype: str) -> Dict[str, np.ndarray]:
    """`hopper_info_batch` arguments of JACOBI_TILES rows ``t`` (an (N,
    5) array of the table's fields) for a (z, y, x) ``dtype`` volume,
    each row priced by its family; ring rows are infeasible unless
    `ring_takes` the volume.  Plane rows state no bytes in flight, so
    their latency hiding is counted in warps."""
    eb = dtype_bytes(dtype)
    fam = t[:, 3]
    out = family_costs(
        fam, {PLANE: lambda sel: _plane_cost(t[sel], z=z, y=y, x=x, eb=eb),
              RING: lambda sel: _ring_cost(t[sel], z=z, y=y, x=x, eb=eb)},
        keys=("blocks", "threads", "busy_threads", "regs", "smem", "flops",
              "hbm_bytes", "smem_bytes", "inflight_bytes"))
    out["feasible"] &= (fam != RING) | ring_takes(dtype, x)
    return out


def _jacobi3d_hopper(cols, *, z: int, y: int, x: int,
                     dtype: str = "float32"):
    return jacobi_tiles_cost(tile_fields(JACOBI_TILES, cols[TILE_AXIS]),
                             z=z, y=y, x=x, dtype=dtype)


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
    u (Z, Y, X) -> (Z, Y, X).  A ring row refuses with ValueError a
    volume whose X is not a whole number of 16-byte vectors
    (`ring_takes`) or an operand off a 16-byte boundary."""
    import torch
    _cuda.require_operands("jacobi3d", u)
    if u.dim() != 3 or u.numel() == 0:
        raise ValueError(f"jacobi3d: u must be a non-empty (Z, Y, X) "
                         f"volume, got {tuple(u.shape)}")
    idx = _TILE_INDEX.get(tile)
    if idx is None:
        raise ValueError(f"jacobi3d: unknown tile {tile!r}")
    z, y, x = u.shape
    family = JACOBI_TILES[tile][3]
    if family == RING:
        if not ring_takes(dtype_name(u), x):
            raise ValueError(
                f"jacobi3d: tile {tile} takes X a multiple of "
                f"{16 // u.element_size()} (16-byte rows), got X={x} "
                f"{dtype_name(u)}")
        if u.data_ptr() % 16:
            raise ValueError(f"jacobi3d: tile {tile} needs a 16-byte-"
                             f"aligned volume")
    out = torch.empty_like(u)
    rc = _cuda.library().repro_jacobi3d(
        idx, _cuda.dtype_code(u), u.data_ptr(), out.data_ptr(), z, y, x,
        float(c0), float(c1), _cuda.stream_of(u))
    _cuda.check(rc, "jacobi3d")
    LAUNCHES["jacobi3d"] += 1
    LAUNCHES[_FAMILY_COUNTER[family]] += 1
    return out


def _jacobi3d_symbols(tile: str, *, dtype: str = "float32", **_):
    bx, by, zb, fam, stages = JACOBI_TILES[tile]
    if fam == RING:
        return (template_symbol("jacobi_ring_kernel", dtype, bx, by, zb,
                                stages),)
    return (template_symbol("jacobi_kernel", dtype, bx, by, zb),)


@tuned_kernel(
    "jacobi3d",
    space={"bz": divisors("z", (1, 2, 4, 8, 16, 32, 64))},
    signature=lambda u, **_: dict(z=u.shape[0], y=u.shape[1], x=u.shape[2],
                                  dtype=dtype_name(u)),
    static_info=_jacobi3d_analysis,
    hopper=HopperSpace(tiles=tuple(JACOBI_TILES), analysis=_jacobi3d_hopper,
                       symbols=_jacobi3d_symbols),
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
