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
(`src/repro/kernels/stencil2d.py:_stencil_kernel`) as the two kernels of
``csrc/stencil2d.cu``: march rows (``stencil_kernel``: a thread a
column, marching down a run of rows with the rows above and below in
registers; any shape) and ring rows (``stencil_ring_kernel``: a ring of
S row tiles in shared memory fed by TMA, 16-byte vectors along x; X a
multiple of 16 / elem_bytes and 16-byte-aligned bases, else ValueError).
The declaration keeps the reference's TPU block space (``by`` rows per
grid step), analysis, ``cuda=`` profile and pretune grid; its H100 space
is the instantiations of `STENCIL_TILES`, both families priced together
by `stencil_tiles_cost`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.autotuner import TunableKernel
from repro_torch.core.hw import dtype_bytes
from repro_torch.core.sass import template_symbol
from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, TILE_AXIS, cuda_profile,
                                     divisors, get_spec, tuned_kernel)
from repro_torch.kernels.common import (cdiv, declared_regs, dtype_name,
                                        dtype_str, family_costs)
from repro_torch.kernels.jacobi3d import ring_stage_bytes, ring_takes
from repro_torch.kernels.matmul import tile_fields

__all__ = ["stencil2d", "stencil2d_cuda", "stencil2d_plain", "stencil2d_ref",
           "make_tunable_stencil2d", "extension", "STENCIL_TILES",
           "MARCH", "RING", "stencil_tiles_cost", "LAUNCHES"]

C0_DEFAULT = 0.5
C1_DEFAULT = 0.125

# Launches: "stencil2d" counts calls of `stencil2d_cuda` (one per call,
# whatever the tile), "stencil2d_march" / "stencil2d_ring" the kernel of
# each family that it launched.
LAUNCHES = {"stencil2d": 0, "stencil2d_march": 0, "stencil2d_ring": 0}
_FAMILY_COUNTER = ("stencil2d_march", "stencil2d_ring")

# tile families (csrc/stencil2d.cu StencilFamily)
MARCH, RING = 0, 1

# name -> (x tile BX, row groups BY (march) or rows a stage RB (ring),
# rows per run R, family, ring stages S); order = csrc/stencil2d.cu
# STENCIL_TILES, then STENCIL_RING_TILES.  March rows run BX * BY
# threads, ring rows BX / (16 / elem_bytes) * RB, the deeper rings first
# (where the analysis ties rows, the first wins); a ring row's R + 2 is
# a whole number of stages.
STENCIL_TILES: Dict[str, Tuple[int, ...]] = {
    "x32y1r16": (32, 1, 16, MARCH, 0), "x32y4r16": (32, 4, 16, MARCH, 0),
    "x64y2r32": (64, 2, 32, MARCH, 0), "x128y1r64": (128, 1, 64, MARCH, 0),
    "x128y2r16": (128, 2, 16, MARCH, 0),
    "x256y1r32": (256, 1, 32, MARCH, 0),
    "x128y4r16": (128, 4, 16, MARCH, 0),
    "x256y2r16": (256, 2, 16, MARCH, 0), "x512y1r8": (512, 1, 8, MARCH, 0),
    "x128y8r8": (128, 8, 8, MARCH, 0), "x32y32r4": (32, 32, 4, MARCH, 0),
    "ring_x128y16r126s6": (128, 16, 126, RING, 6),
    "ring_x128y8r62s6": (128, 8, 62, RING, 6),
    "ring_x64y16r126s6": (64, 16, 126, RING, 6),
    "ring_x64y8r62s4": (64, 8, 62, RING, 4),
}
_TILE_INDEX = {t: i for i, t in enumerate(STENCIL_TILES)}

# declared registers per thread, (float32, bfloat16), of every row: the
# compiled counts for sm_90a, which chip_smoke's [build] prints beside
# them (`stencil2d_attrs`)
_REGS: Dict[str, Tuple[int, int]] = {
    "x32y1r16": (42, 40), "x32y4r16": (32, 32), "x64y2r32": (32, 32),
    "x128y1r64": (32, 32), "x128y2r16": (32, 32), "x256y1r32": (32, 32),
    "x128y4r16": (32, 32), "x256y2r16": (32, 32), "x512y1r8": (32, 32),
    "x128y8r8": (32, 32), "x32y32r4": (32, 32),
    "ring_x128y16r126s6": (30, 31), "ring_x128y8r62s6": (30, 31),
    "ring_x64y16r126s6": (30, 31), "ring_x64y8r62s4": (30, 32),
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


def _march_cost(t, *, y: int, x: int, eb: int):
    """u read once and out written once from device memory, plus the
    halo rows of each run (one above, two below its R rows); the
    lane-edge cells come from L1/L2.  No shared memory.  A thread waits
    on the row below its cell with the row after next already issued:
    a block states two rows of its threads' elements in flight (Little's
    law over the card)."""
    bx, by, r = t[:, 0], t[:, 1], t[:, 2]
    runs = cdiv(y, r)
    pts = float(y) * x
    return dict(blocks=cdiv(x, bx) * cdiv(runs, by), threads=bx * by,
                busy_threads=np.minimum(bx, x) * np.minimum(by, runs),
                regs=declared_regs(STENCIL_TILES, _REGS, t, eb), smem=0,
                flops=6.0 * pts,
                hbm_bytes=(pts + 3.0 * (runs - 1) * x) * eb + pts * eb,
                inflight_bytes=2.0 * bx * by * eb)


def _ring_cost(t, *, y: int, x: int, eb: int):
    """u read once and out written once from device memory, plus the
    halo rows of each run: a run stages the row above its R rows and,
    inside the grid, the row below, in whole stages of RB rows.  TMA
    writes the ring as device memory delivers it, one transfer priced
    once in ``hbm_bytes``; the halo columns come from L2 and are priced
    as shared-memory traffic, beside a thread's three 16-byte and two
    scalar reads per vector of points.  Stages j - 1 and j are pinned
    while a block computes step j, so S - 1 stages are in flight while
    it waits for its next stage: a block states those bytes in flight
    (Little's law over the card)."""
    bx, rb, r, s = t[:, 0], t[:, 1], t[:, 2], t[:, 4]
    v = 16 // eb
    gx, runs = cdiv(x, bx), cdiv(y, r)
    pts = float(y) * x
    # a stage of RB rows is jacobi3d's box of RB - 2 rows and its two
    # halo rows
    stage = ring_stage_bytes(bx, rb - 2, eb)
    last = y - (runs - 1) * r                # rows of the bottom run
    staged_rows = ((runs - 1) * cdiv(r + 2, rb) + cdiv(last + 1, rb)) * rb
    staged = gx * staged_rows * (bx + 2.0 * v) * eb
    return dict(blocks=gx * runs, threads=bx // v * rb,
                busy_threads=cdiv(np.minimum(bx, x), v) * np.minimum(rb, y),
                regs=declared_regs(STENCIL_TILES, _REGS, t, eb),
                smem=s * stage + 8 * s,
                flops=6.0 * pts,
                hbm_bytes=(staged_rows * float(x) + pts) * eb,
                smem_bytes=staged - pts * eb + pts * eb * (3.0 + 2.0 / v),
                inflight_bytes=(s - 1.0) * stage)


def stencil_tiles_cost(t, *, y: int, x: int,
                       dtype: str) -> Dict[str, np.ndarray]:
    """`hopper_info_batch` arguments of STENCIL_TILES rows ``t`` (an (N,
    5) array of the table's fields) for a (y, x) ``dtype`` grid, each
    row priced by its family; ring rows are infeasible unless
    `ring_takes` the grid's rows.  Both families state their bytes in
    flight, so both are priced by Little's law over the card."""
    eb = dtype_bytes(dtype)
    fam = t[:, 3]
    out = family_costs(
        fam, {MARCH: lambda sel: _march_cost(t[sel], y=y, x=x, eb=eb),
              RING: lambda sel: _ring_cost(t[sel], y=y, x=x, eb=eb)},
        keys=("blocks", "threads", "busy_threads", "regs", "smem", "flops",
              "hbm_bytes", "smem_bytes", "inflight_bytes"))
    out["feasible"] &= (fam != RING) | ring_takes(dtype, x)
    return out


def _stencil2d_symbols(tile: str, *, y: int, x: int,
                       dtype: str = "float32"):
    bx, by, r, fam, stages = STENCIL_TILES[tile]
    if fam == RING:
        return (template_symbol("stencil_ring_kernel", dtype, bx, by, r,
                                stages),)
    return (template_symbol("stencil_kernel", dtype, bx, by, r),)


def _stencil2d_hopper(cols, *, y: int, x: int, dtype: str = "float32"):
    return stencil_tiles_cost(tile_fields(STENCIL_TILES, cols[TILE_AXIS]),
                              y=y, x=x, dtype=dtype)


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


# the reference's name for its oracle (`repro.kernels.stencil2d`)
stencil2d_ref = stencil2d_plain


def stencil2d_cuda(u, c0: float = C0_DEFAULT, c1: float = C1_DEFAULT, *,
                   tile: str):
    """Launch the CUDA stencil instantiation ``tile`` on a CUDA tensor
    u (Y, X) -> (Y, X).  A ring row refuses with ValueError a grid whose
    X is not a whole number of 16-byte vectors (`ring_takes`) or an
    operand off a 16-byte boundary."""
    import torch
    _cuda.require_operands("stencil2d", u)
    if u.dim() != 2 or u.numel() == 0:
        raise ValueError(f"stencil2d: u must be a non-empty (Y, X) grid, "
                         f"got {tuple(u.shape)}")
    idx = _TILE_INDEX.get(tile)
    if idx is None:
        raise ValueError(f"stencil2d: unknown tile {tile!r}")
    y, x = u.shape
    _, by, r, family, _ = STENCIL_TILES[tile]
    rows = r if family == RING else by * r
    if cdiv(y, rows) > 65535:
        raise ValueError(f"stencil2d: {y} rows exceed tile {tile}'s grid "
                         f"(65535 row blocks of {rows} rows)")
    if family == RING:
        if not ring_takes(dtype_name(u), x):
            raise ValueError(
                f"stencil2d: tile {tile} takes X a multiple of "
                f"{16 // u.element_size()} (16-byte rows), got X={x} "
                f"{dtype_name(u)}")
        if u.data_ptr() % 16:
            raise ValueError(f"stencil2d: tile {tile} needs a 16-byte-"
                             f"aligned grid")
    lib = extension()
    out = torch.empty_like(u)
    rc = lib.stencil2d_launch(
        idx, _cuda.dtype_code(u), u.data_ptr(), out.data_ptr(), y, x,
        float(c0), float(c1), _cuda.stream_of(u))
    _cuda.check(rc, "stencil2d", lib)
    LAUNCHES["stencil2d"] += 1
    LAUNCHES[_FAMILY_COUNTER[family]] += 1
    return out


@tuned_kernel(
    "stencil2d",
    space={"by": divisors("y", (8, 16, 32, 64, 128, 256))},
    signature=lambda u, **_: dict(y=u.shape[0], x=u.shape[1],
                                  dtype=dtype_name(u)),
    static_info=_stencil2d_analysis,
    hopper=HopperSpace(tiles=tuple(STENCIL_TILES),
                       analysis=_stencil2d_hopper,
                       symbols=_stencil2d_symbols),
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
