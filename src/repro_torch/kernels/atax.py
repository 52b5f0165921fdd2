"""atax (paper Table IV): y = Aᵀ(A x), f32 accumulation.

Port of the reference's row-sweep Pallas kernel
(`src/repro/kernels/atax.py:_atax_kernel_rowsweep`) as two families of
``csrc/blas2.cu`` (design and bound in the note at its top), each
followed by ``colsum_kernel``: sweep rows (``atax_kernel``: a stripe
read twice, the second time from L2; any shape) and ring rows
(``atax_ring_kernel``: a persistent block per SM fed by a ring of
bulk-copied row stripes in shared memory, so A is read from device
memory exactly once; N a whole number of 16-byte vectors, at most
RING_MAX_N columns, 16-byte-aligned operands and two stripes within
227 KB, else ValueError).  As the TPU kernel does (``atax.py:43``), t = A·x
is rounded to the input type before the second product; the oracle
(`repro_torch.kernels.ref.atax_ref`) keeps t in f32, so the two agree
in float32 and differ in bfloat16.

y is a sum over every row of A.  CUDA blocks run unordered, so each
block of the persistent grid keeps its own f32 partial y and writes it
as one row of a workspace the wrapper allocates; a second launch adds
the rows in block order.  No float atomics: two runs give bitwise the
same y.

The declaration keeps the reference's TPU block space, analysis,
``cuda=`` profile (Table VII's R^u) and pretune grid; its H100 space is
`ATAX_TILES`: BiCG's `BLAS2_TILES` (threads per block, rows per stripe)
as the sweep rows, then the ring rows, both families priced together by
`atax_tiles_cost`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.autotuner import KernelStaticInfo, TunableKernel
from repro_torch.core.hw import H100_SXM, dtype_bytes
from repro_torch.core.occupancy import cuda_occupancy_batch
from repro_torch.core.sass import template_symbol
from repro_torch.core.search import SearchSpace
from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, TILE_AXIS, cuda_profile,
                                     divisors, get_spec, tuned_kernel)
from repro_torch.kernels.common import (block_info, cdiv, declared_regs,
                                        dtype_name, dtype_str, family_costs,
                                        pick_divisor_candidates,
                                        require_shape)
from repro_torch.kernels.matmul import tile_fields
from repro_torch.kernels.ref import atax_ref

__all__ = ["atax", "atax_static_info", "atax_cuda", "atax_plain",
           "make_tunable_atax", "ATAX_TILES", "SWEEP", "RING",
           "RING_STAGES", "RING_MAX_N", "ring_stages", "ring_refusal",
           "check_ring", "sweep_pick", "atax_tiles_cost",
           "BLAS2_TILES", "blas2_workspace_rows", "KIND", "LAUNCHES"]

# Launches: "atax" counts calls of `atax_cuda` (one per call, whatever
# the tile: the sweep or ring kernel, then the column sums),
# "atax_sweep" / "atax_ring" the family whose kernel it launched.
LAUNCHES = {"atax": 0, "atax_sweep": 0, "atax_ring": 0}
_FAMILY_COUNTER = ("atax_sweep", "atax_ring")

# The C library's kernel kind (csrc/common.cuh ReproKind).
KIND = 7

# name -> (threads per block, rows per stripe); order = csrc/blas2.cu
# BLAS2_TILES (BiCG's table, and the sweep rows of atax's).
BLAS2_TILES: Dict[str, Tuple[int, ...]] = {
    "t32r1": (32, 1), "t64r1": (64, 1), "t128r1": (128, 1),
    "t128r4": (128, 4), "t256r1": (256, 1), "t256r2": (256, 2),
    "t256r4": (256, 4), "t512r1": (512, 1), "t512r2": (512, 2),
    "t1024r1": (1024, 1),
}

# tile families (csrc/blas2.cu AtaxFamily)
SWEEP, RING = 0, 1

# atax's table: name -> (threads, rows per stripe, family); order =
# csrc/blas2.cu BLAS2_TILES (the sweep rows), then ATAX_RING_TILES.
# Where the analysis ties ring rows, the first wins.
ATAX_TILES: Dict[str, Tuple[int, ...]] = {
    **{name: (t, r, SWEEP) for name, (t, r) in BLAS2_TILES.items()},
    "ring_t512r2": (512, 2, RING),
    "ring_t512r1": (512, 1, RING),
    "ring_t1024r2": (1024, 2, RING),
    "ring_t1024r1": (1024, 1, RING),
}
_TILE_INDEX = {t: i for i, t in enumerate(ATAX_TILES)}

# The ring rows' limits (csrc/blas2.cu): a ring holds as many stripes
# as fit a block's shared memory, at most RING_STAGES; a row takes N up
# to RING_MAX_N columns, a thread holding RING_MAX_N / threads of them
# (of x, of y and of each stripe row) in registers.
RING_STAGES = 16
RING_MAX_N = 8192

# declared registers per thread, (float32, bfloat16), of the ring rows:
# the compiled counts for sm_90a, which the smoke prints beside them
_RING_REGS: Dict[str, Tuple[int, int]] = {
    "ring_t512r2": (95, 95), "ring_t512r1": (62, 64),
    "ring_t1024r2": (63, 48), "ring_t1024r1": (37, 37),
}


def _blas2_hopper_grid(threads, rows, regs, *, m: int, n: int,
                      spec=H100_SXM):
    """``(grid, smem)`` of an atax/BiCG launch as the analysis sees it:
    the block's shared bytes (the f32 row ys[n] plus the reduction
    scratch) and one wave of the blocks Eqs. 1-5 fit per SM, at most
    one per stripe — what the C side asks the occupancy calculator for
    (with the compiled, not the declared, registers)."""
    threads = np.asarray(threads, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    smem = 4 * n + 4 * (threads // 32) * rows + 4 * rows
    occ = cuda_occupancy_batch(threads, np.broadcast_to(regs, threads.shape),
                               smem + spec.shmem_reserved_per_block, spec)
    grid = np.minimum(cdiv(m, rows), occ.active_blocks * spec.multiprocessors)
    return grid, smem


def _blas2_sweep_cost(threads, rows, *, m: int, n: int, dtype: str,
                      a_passes: bool, regs_extra: int, vec_loads: int,
                      vector_elems: int):
    """Shared H100 pricing of atax's sweep rows (``a_passes``: the
    stripe is read a second time) and BiCG's rows: A from device memory
    once — twice for atax when the stripes in flight (grid x rows x n x
    bytes) overflow half the L2 —, the workspace written and read once
    (grid x n f32), the ``vector_elems`` vector elements once; ys
    updated in shared memory per stripe row."""
    eb = dtype_bytes(dtype)
    vec = 16 // eb
    regs = 24 + vec_loads * vec + 2 * rows + regs_extra
    grid, smem = _blas2_hopper_grid(threads, rows, regs, m=m, n=n)
    a_bytes = float(m) * n * eb
    hbm = a_bytes + 2.0 * grid * n * 4 + float(vector_elems) * eb
    if a_passes:
        inflight = grid * rows * float(n) * eb
        hbm = hbm + np.where(inflight > H100_SXM.l2_bytes / 2, a_bytes, 0.0)
    return dict(blocks=grid, threads=threads,
                busy_threads=np.minimum(threads, max(1, cdiv(n, vec))),
                regs=regs, smem=smem, flops=4.0 * m * n,
                hbm_bytes=hbm,
                smem_bytes=2.0 * cdiv(m, rows) * n * 4,
                launches=2)


def _blas2_hopper(cols, *, m: int, n: int, dtype: str, a_passes: bool,
                  regs_extra: int, vec_loads: int, vector_elems: int):
    """`_blas2_sweep_cost` of the BLAS2_TILES rows named in ``cols``."""
    t = tile_fields(BLAS2_TILES, cols[TILE_AXIS])
    return _blas2_sweep_cost(t[:, 0], t[:, 1], m=m, n=n, dtype=dtype,
                             a_passes=a_passes, regs_extra=regs_extra,
                             vec_loads=vec_loads, vector_elems=vector_elems)


def ring_static_smem(threads, rows):
    """Static shared bytes of a ring row's block: the warps' sums in two
    halves and a barrier per stage, 16-byte aligned."""
    return -(-(8 * rows * (threads // 32) + 8 * RING_STAGES) // 16) * 16


def ring_stages(threads, rows, n: int, eb: int):
    """Stages of ring rows at n columns of ``eb``-byte elements (arrays
    or scalars): as many stripes as fit a block's 227 KB beside the
    static shared memory, at most RING_STAGES; 0 where the row does not
    take n — a row must be a whole number of 16-byte vectors (the bulk
    copies' unit), at most RING_MAX_N columns (a thread's columns of x,
    y and the stripe live in registers), and two stripes must fit."""
    threads, rows = (np.asarray(v, dtype=np.int64) for v in (threads, rows))
    room = H100_SXM.shmem_per_block - ring_static_smem(threads, rows)
    s = np.minimum(RING_STAGES, room // (rows * n * eb))
    takes = ((n * eb) % 16 == 0) & (n <= RING_MAX_N) & (s >= 2)
    return np.where(takes, s, 0)


@functools.lru_cache(maxsize=None)
def ring_refusal(tile: str, dtype: str, n: int) -> Optional[str]:
    """Why the ring row ``tile`` cannot take rows of ``n`` elements of
    ``dtype`` (None where it can; see `ring_stages`)."""
    threads, rows, _ = ATAX_TILES[tile]
    eb = dtype_bytes(dtype)
    if (n * eb) % 16:
        return (f"takes N a multiple of {16 // eb} (16-byte rows), got "
                f"N={n} {dtype}")
    if n > RING_MAX_N:
        return (f"holds {RING_MAX_N} columns a row, N={n} is wider "
                f"than that")
    if int(ring_stages(threads, rows, n, eb)) == 0:
        return (f"ring of two {rows}-row stripes at N={n} {dtype} does "
                f"not fit a block's {H100_SXM.shmem_per_block} bytes")
    return None


def _ring_cost(t, *, m: int, n: int, eb: int, spec=H100_SXM):
    """A read once from device memory (the bulk copies write the ring
    as it arrives, priced once in ``hbm_bytes``), the workspace written
    and read once (grid x n f32), x read and y written once; pass 1
    reads the stage from shared memory once, into the registers pass 2
    uses.  S - 1 stripes are in flight while a block computes on one:
    the block states those bytes (Little's law over the card).  x and y
    live in registers."""
    threads, rows = t[:, 0], t[:, 1]
    vec = 16 // eb
    regs = declared_regs(ATAX_TILES, _RING_REGS, t, eb)
    stages = ring_stages(threads, rows, n, eb)
    smem = stages * rows * n * eb + ring_static_smem(threads, rows)
    occ = cuda_occupancy_batch(threads, regs,
                               smem + spec.shmem_reserved_per_block, spec)
    grid = np.minimum(cdiv(m, rows), occ.active_blocks * spec.multiprocessors)
    a_bytes = float(m) * n * eb
    return dict(blocks=grid, threads=threads,
                busy_threads=np.minimum(threads, max(1, cdiv(n, vec))),
                regs=regs, smem=smem, flops=4.0 * m * n,
                hbm_bytes=a_bytes + 2.0 * grid * n * 4 + 2.0 * n * eb,
                smem_bytes=a_bytes,
                inflight_bytes=np.maximum(stages - 1.0, 0.0) * rows * n * eb,
                launches=2)


def atax_tiles_cost(t, *, m: int, n: int, dtype: str):
    """`hopper_info_batch` arguments of ATAX_TILES rows ``t`` (an (N, 3)
    array of the table's fields) at an (m, n) ``dtype`` matrix, each row
    priced by its family: the sweep rows as before the ring rows came
    (`_blas2_sweep_cost`), the ring rows by `_ring_cost`, infeasible
    where `ring_stages` refuses the width.  Sweep rows state no bytes
    in flight, so their latency hiding is counted in warps."""
    eb = dtype_bytes(dtype)
    fam = t[:, 2]
    out = family_costs(
        fam, {SWEEP: lambda sel: _blas2_sweep_cost(
                  t[sel, 0], t[sel, 1], m=m, n=n, dtype=dtype, a_passes=True,
                  regs_extra=4, vec_loads=2, vector_elems=2 * n),
              RING: lambda sel: _ring_cost(t[sel], m=m, n=n, eb=eb)},
        keys=("blocks", "threads", "busy_threads", "regs", "smem", "flops",
              "hbm_bytes", "smem_bytes", "inflight_bytes", "launches"))
    stages = ring_stages(t[:, 0], t[:, 1], n, eb)
    out["feasible"] &= (fam != RING) | (stages > 0)
    return out


def _atax_hopper(cols, *, m: int, n: int, dtype: str = "float32"):
    return atax_tiles_cost(tile_fields(ATAX_TILES, cols[TILE_AXIS]),
                           m=m, n=n, dtype=dtype)


def _atax_analysis(p, *, m: int, n: int, dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols)."""
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    steps = cdiv(m, bm)
    return dict(
        in_blocks=[(bm, n), (n, 1)],
        out_blocks=[(n, 1)],
        in_dtypes=[dtype, dtype],
        out_dtypes=[dtype],
        flops_per_step=2.0 * bm * n + 2.0 * n * bm,   # A@x then Aᵀ@t
        grid_steps=steps,
        scratch_bytes=n * 4,
    )


def _atax_inputs(gen, *, m: int, n: int, dtype: str = "float32"):
    import torch
    dt = getattr(torch, dtype)
    return ((torch.randn((m, n), generator=gen, device=gen.device)
             / (n ** 0.5)).to(dt),
            torch.randn((n, 1), generator=gen, device=gen.device).to(dt))


def atax_plain(a, x):
    """The plain PyTorch version: t = A x in f32, rounded to ``a``'s type
    (the TPU kernel's cast), then Aᵀ t in f32, cast to ``a``'s type."""
    t = (a.float() @ x.float()).to(a.dtype).float()
    return (a.float().T @ t).to(a.dtype)


_GRID: Dict[Tuple, int] = {}


def blas2_workspace_rows(kind: int, tile: str, a) -> int:
    """Rows of the f32 workspace (the persistent grid) the C side
    launches for ``tile`` (of ATAX_TILES for atax, BLAS2_TILES for
    BiCG) at ``a``'s shape and type on its card."""
    m, n = a.shape
    key = (kind, tile, a.dtype, m, n, a.device)
    g = _GRID.get(key)
    if g is None:
        table = ATAX_TILES if kind == KIND else BLAS2_TILES
        out = ctypes.c_int()
        rc = _cuda.library().repro_blas2_grid(
            kind, list(table).index(tile), _cuda.dtype_code(a), m, n,
            ctypes.byref(out))
        _cuda.check(rc, f"blas2 grid of {tile}")
        g = _GRID[key] = int(out.value)
    return g


def check_blas2(kernel: str, a, tile: str,
                table: Dict[str, Tuple[int, ...]] = BLAS2_TILES
                ) -> Tuple[int, int]:
    if a.dim() != 2 or a.numel() == 0:
        raise ValueError(f"{kernel}: a must be a non-empty (M, N) matrix, "
                         f"got {tuple(a.shape)}")
    if tile not in table:
        raise ValueError(f"{kernel}: unknown tile {tile!r}")
    return tuple(a.shape)


@functools.lru_cache(maxsize=None)
def sweep_pick(m: int, n: int, dtype: str) -> str:
    """The sweep row that the H100 ranking dispatch uses puts first
    among the sweep rows at an (m, n) ``dtype`` matrix."""
    from repro_torch.core.predict import static_times_batch
    from repro_torch.tuning_cache.registry import _model_for
    sweep = [t for t, f in ATAX_TILES.items() if f[2] == SWEEP]
    info = get_spec("atax")._hopper[None].info(
        sweep, dict(m=m, n=n, dtype=dtype), H100_SXM)
    times = static_times_batch(None, _model_for(H100_SXM), F=info.F,
                               pipe=info.pipe, feasible=info.feasible)
    return sweep[int(np.argmin(times))]


def check_ring(tile: str, a, x) -> None:
    """ValueError unless the ring row ``tile`` takes ``a`` (M, N) and
    ``x``: the width (`ring_refusal`) and 16-byte-aligned operands, which
    the bulk copies and the vector loads of x need."""
    why = ring_refusal(tile, str(a.dtype).rpartition(".")[2], a.shape[1])
    if why is not None:
        raise ValueError(f"atax: tile {tile} {why}")
    if a.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"atax: tile {tile} needs 16-byte-aligned a and x")


def atax_cuda(a, x, *, tile: str):
    """Launch the CUDA atax instantiation ``tile`` of ATAX_TILES on CUDA
    tensors (a (M, N), x (N, 1) -> (N, 1)): the sweep or the ring, then
    the column sums.  A ring row refuses with ValueError a width it
    cannot take (`ring_refusal`) or an operand off a 16-byte
    boundary."""
    import torch
    _cuda.require_operands("atax", a, x)
    m, n = check_blas2("atax", a, tile, ATAX_TILES)
    require_shape("atax", "x", tuple(x.shape), (n, 1))
    family = ATAX_TILES[tile][2]
    if family == RING:
        check_ring(tile, a, x)
    g = blas2_workspace_rows(KIND, tile, a)
    ws = torch.empty((g, n), dtype=torch.float32, device=a.device)
    y = torch.empty((n, 1), dtype=a.dtype, device=a.device)
    rc = _cuda.library().repro_atax(
        _TILE_INDEX[tile], _cuda.dtype_code(a), a.data_ptr(),
        x.data_ptr(), y.data_ptr(), ws.data_ptr(), g, m, n,
        _cuda.stream_of(a))
    _cuda.check(rc, "atax")
    LAUNCHES["atax"] += 1
    LAUNCHES[_FAMILY_COUNTER[family]] += 1
    return y


def blas2_symbols(kernel: str, tile: str, dtype: str):
    """atax's or BiCG's sweep instantiation for BLAS2_TILES row ``tile``
    and the column-sum kernel that reduces its workspace."""
    threads, rows = BLAS2_TILES[tile]
    return (template_symbol(kernel, dtype, threads, rows),
            template_symbol("colsum_kernel", dtype))


def _atax_symbols(tile: str, *, m: int, n: int, dtype: str = "float32"):
    threads, rows, family = ATAX_TILES[tile]
    if family == RING:
        return (template_symbol("atax_ring_kernel", dtype, threads, rows),
                template_symbol("colsum_kernel", dtype))
    return blas2_symbols("atax_kernel", tile, dtype)


@tuned_kernel(
    "atax",
    space={"bm": divisors("m", (16, 32, 64, 128, 256, 512, 1024))},
    signature=lambda a, x, **_: dict(m=a.shape[0], n=a.shape[1],
                                     dtype=dtype_name(a)),
    static_info=_atax_analysis,
    hopper=HopperSpace(tiles=tuple(ATAX_TILES), analysis=_atax_hopper,
                       symbols=_atax_symbols),
    out=lambda a, x, **_: ((a.shape[1], 1), a.dtype),
    make_inputs=_atax_inputs,
    reference=atax_ref,
    pretune=tuple(dict(m=s, n=s, dtype=dt)
                  for s in (512, 1024, 2048, 4096)
                  for dt in ("float32", "bfloat16"))
    + (dict(m=1024, n=512, dtype="float32"),),
    # Paper Table VII row: R^u per compiled compute capability; no
    # shared memory.  Whole-kernel Eq. 6 counts: A read once, fused
    # A@x then A^T@t (4 flops/element), y accumulated in registers.
    cuda=cuda_profile(
        regs={"Fermi": 21, "Kepler": 27, "Maxwell": 30},
        workload=lambda m, n, **_: dict(
            o_fl=4.0 * m * n, o_mem=1.0 * m * n + m + 2.0 * n,
            o_ctrl=1.0 * m, o_reg=4.0 * m * n)),
)
def atax(a, x, *, tile: str | None = None):
    """y = Aᵀ(A x): a (M, N), x (N, 1) -> (N, 1) in ``a``'s type; the
    CUDA kernels for CUDA tensors, the plain version for CPU tensors.

    Dispatch picks ``tile`` from the shape and type alone.  A ring row
    given an operand off a 16-byte boundary, which the bulk copies
    cannot read, launches `sweep_pick` instead; `atax_cuda` refuses
    such a call with ValueError."""
    if a.device.type == "cpu":
        return atax_plain(a, x)
    if (tile in ATAX_TILES and ATAX_TILES[tile][2] == RING
            and (a.data_ptr() % 16 or x.data_ptr() % 16)):
        tile = sweep_pick(*a.shape, dtype_name(a))
    return atax_cuda(a, x, tile=tile)


def atax_static_info(m: int, n: int, dtype,
                     params: Dict) -> KernelStaticInfo:
    """Scalar static info for one configuration (wrapper over the
    declared analysis; kept as a stable public helper)."""
    return block_info(**_atax_analysis(params, m=m, n=n,
                                     dtype=dtype_str(dtype)))


def make_tunable_atax(m: int = 2048, n: int = 2048, dtype="float32",
                      seed: int = 0, device=None) -> TunableKernel:
    """atax at (m, n) for `repro_torch.core.KernelTuner`: the
    reference's narrowed block space under a TPU target, the tile table
    under the H100 — the active target (see `KernelSpec.tunable`)."""
    space = SearchSpace({
        "bm": pick_divisor_candidates(m, (32, 64, 128, 256, 512, 1024)),
    })
    return get_spec("atax").tunable(
        m=m, n=n, dtype=dtype_str(dtype), seed=seed, space=space,
        name=f"atax_{m}x{n}", device=device)
