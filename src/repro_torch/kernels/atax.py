"""atax (paper Table IV): y = Aᵀ(A x), f32 accumulation.

Port of the reference's row-sweep Pallas kernel
(`src/repro/kernels/atax.py:_atax_kernel_rowsweep`) as ``atax_kernel``
+ ``colsum_kernel`` of ``csrc/blas2.cu`` (design and bound in the note
at its top).  As the TPU kernel does (``atax.py:43``), t = A·x is
rounded to the input type before the second product; the oracle
(`repro_torch.kernels.ref.atax_ref`) keeps t in f32, so the two agree
in float32 and differ in bfloat16.

y is a sum over every row of A.  CUDA blocks run unordered, so each
block of the persistent grid keeps its own f32 partial y and writes it
as one row of a workspace the wrapper allocates; a second launch adds
the rows in block order.  No float atomics: two runs give bitwise the
same y.

The declaration keeps the reference's TPU block space, analysis,
``cuda=`` profile (Table VII's R^u) and pretune grid; its H100 space is
the (threads per block, rows per stripe) instantiations of
`BLAS2_TILES`, shared with BiCG.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.autotuner import KernelStaticInfo, TunableKernel
from repro_torch.core.hw import H100_SXM, dtype_bytes
from repro_torch.core.occupancy import cuda_occupancy_batch
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
from repro_torch.kernels.ref import atax_ref

__all__ = ["atax", "atax_static_info", "atax_cuda", "atax_plain",
           "make_tunable_atax",
           "BLAS2_TILES", "blas2_workspace_rows", "KIND", "LAUNCHES"]

# Launches of the CUDA kernel pair by `atax_cuda` (one per call).
LAUNCHES = {"atax": 0}

# The C library's kernel kind (csrc/common.cuh ReproKind).
KIND = 7

# name -> (threads per block, rows per stripe); order = csrc/blas2.cu
# BLAS2_TILES (atax and BiCG).
BLAS2_TILES: Dict[str, Tuple[int, ...]] = {
    "t32r1": (32, 1), "t64r1": (64, 1), "t128r1": (128, 1),
    "t128r4": (128, 4), "t256r1": (256, 1), "t256r2": (256, 2),
    "t256r4": (256, 4), "t512r1": (512, 1), "t512r2": (512, 2),
    "t1024r1": (1024, 1),
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


def _blas2_hopper(cols, *, m: int, n: int, dtype: str, a_passes: bool,
                  regs_extra: int, vec_loads: int, vector_elems: int):
    """Shared H100 pricing of atax (``a_passes``: the stripe is read a
    second time) and BiCG: A from device memory once — twice for atax
    when the stripes in flight (grid x rows x n x bytes) overflow half
    the L2 —, the workspace written and read once (grid x n f32), the
    ``vector_elems`` vector elements once; ys updated in shared memory
    per stripe row."""
    t = tile_fields(BLAS2_TILES, cols[TILE_AXIS])
    threads, rows = t[:, 0], t[:, 1]
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


def _atax_hopper(cols, *, m: int, n: int, dtype: str = "float32"):
    return _blas2_hopper(cols, m=m, n=n, dtype=dtype, a_passes=True,
                         regs_extra=4, vec_loads=2, vector_elems=2 * n)


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
    launches for ``tile`` at ``a``'s shape and type on its card."""
    m, n = a.shape
    key = (kind, tile, a.dtype, m, n, a.device)
    g = _GRID.get(key)
    if g is None:
        out = ctypes.c_int()
        rc = _cuda.library().repro_blas2_grid(
            kind, list(BLAS2_TILES).index(tile), _cuda.dtype_code(a), m, n,
            ctypes.byref(out))
        _cuda.check(rc, f"blas2 grid of {tile}")
        g = _GRID[key] = int(out.value)
    return g


def check_blas2(kernel: str, a, tile: str) -> Tuple[int, int]:
    if a.dim() != 2 or a.numel() == 0:
        raise ValueError(f"{kernel}: a must be a non-empty (M, N) matrix, "
                         f"got {tuple(a.shape)}")
    if tile not in BLAS2_TILES:
        raise ValueError(f"{kernel}: unknown tile {tile!r}")
    return tuple(a.shape)


def atax_cuda(a, x, *, tile: str):
    """Launch the CUDA atax instantiation ``tile`` on CUDA tensors
    (a (M, N), x (N, 1) -> (N, 1)): the sweep, then the column sums."""
    import torch
    _cuda.require_operands("atax", a, x)
    m, n = check_blas2("atax", a, tile)
    require_shape("atax", "x", tuple(x.shape), (n, 1))
    g = blas2_workspace_rows(KIND, tile, a)
    ws = torch.empty((g, n), dtype=torch.float32, device=a.device)
    y = torch.empty((n, 1), dtype=a.dtype, device=a.device)
    rc = _cuda.library().repro_atax(
        list(BLAS2_TILES).index(tile), _cuda.dtype_code(a), a.data_ptr(),
        x.data_ptr(), y.data_ptr(), ws.data_ptr(), g, m, n,
        _cuda.stream_of(a))
    _cuda.check(rc, "atax")
    LAUNCHES["atax"] += 1
    return y


def blas2_symbols(kernel: str, tile: str, dtype: str):
    """atax's or BiCG's sweep instantiation for BLAS2_TILES row ``tile``
    and the column-sum kernel that reduces its workspace."""
    threads, rows = BLAS2_TILES[tile]
    return (template_symbol(kernel, dtype, threads, rows),
            template_symbol("colsum_kernel", dtype))


def _atax_symbols(tile: str, *, m: int, n: int, dtype: str = "float32"):
    return blas2_symbols("atax_kernel", tile, dtype)


@tuned_kernel(
    "atax",
    space={"bm": divisors("m", (16, 32, 64, 128, 256, 512, 1024))},
    signature=lambda a, x, **_: dict(m=a.shape[0], n=a.shape[1],
                                     dtype=dtype_name(a)),
    static_info=_atax_analysis,
    hopper=HopperSpace(tiles=tuple(BLAS2_TILES), analysis=_atax_hopper,
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
    CUDA kernels for CUDA tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return atax_plain(a, x)
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
