"""BiCG subkernel (paper Table IV): q = A p, s = Aᵀ r, fused.

Port of the reference's Pallas kernel (`src/repro/kernels/bicg.py:
_bicg_kernel`) as ``bicg_kernel`` + ``colsum_kernel`` of
``csrc/blas2.cu`` (design and bound in the note at its top): one sweep
reads each element of A once for both products.  q_i is complete in
the block that owns row i; s is a sum over every row, kept per block
in f32 and added in block order by the second launch, as for atax — no
float atomics, so two runs give bitwise the same q and s.

The declaration keeps the reference's TPU block space, analysis,
``cuda=`` profile (Table VII's R^u) and pretune grid; its H100 space is
`BLAS2_TILES`, shared with atax.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.autotuner import KernelStaticInfo, TunableKernel
from repro_torch.core.search import SearchSpace
from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, cuda_profile, divisors,
                                     get_spec, tuned_kernel)
from repro_torch.kernels.atax import (BLAS2_TILES, _blas2_hopper,
                                      blas2_symbols,
                                      blas2_workspace_rows, check_blas2)
from repro_torch.kernels.common import (block_info, cdiv, dtype_name,
                                        dtype_str,
                                        pick_divisor_candidates,
                                        require_shape)
from repro_torch.kernels.ref import bicg_ref

__all__ = ["bicg", "bicg_static_info", "bicg_cuda", "bicg_plain",
           "make_tunable_bicg", "KIND", "LAUNCHES"]

# Launches of the CUDA kernel pair by `bicg_cuda` (one per call).
LAUNCHES = {"bicg": 0}

# The C library's kernel kind (csrc/common.cuh ReproKind).
KIND = 8


def _bicg_analysis(p, *, m: int, n: int, dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols)."""
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    steps = cdiv(m, bm)
    return dict(
        in_blocks=[(bm, n), (n, 1), (bm, 1)],
        out_blocks=[(bm, 1), (n, 1)],
        in_dtypes=[dtype] * 3,
        out_dtypes=[dtype] * 2,
        flops_per_step=4.0 * bm * n,     # two mat-vec MACs over the block
        grid_steps=steps,
        scratch_bytes=n * 4,
    )


def _bicg_hopper(cols, *, m: int, n: int, dtype: str = "float32"):
    return _blas2_hopper(cols, m=m, n=n, dtype=dtype, a_passes=False,
                         regs_extra=0, vec_loads=3,
                         vector_elems=2 * (m + n))


def _bicg_inputs(gen, *, m: int, n: int, dtype: str = "float32"):
    import torch
    dt = getattr(torch, dtype)
    dev = gen.device
    return ((torch.randn((m, n), generator=gen, device=dev)
             / (n ** 0.5)).to(dt),
            torch.randn((n, 1), generator=gen, device=dev).to(dt),
            torch.randn((m, 1), generator=gen, device=dev).to(dt))


def bicg_plain(a, p, r):
    """The plain PyTorch version: both products in f32, cast to ``a``'s
    type."""
    return bicg_ref(a, p, r)


def bicg_cuda(a, p, r, *, tile: str):
    """Launch the CUDA BiCG instantiation ``tile`` on CUDA tensors
    (a (M, N), p (N, 1), r (M, 1) -> q (M, 1), s (N, 1))."""
    import torch
    _cuda.require_operands("bicg", a, p, r)
    m, n = check_blas2("bicg", a, tile)
    require_shape("bicg", "p", tuple(p.shape), (n, 1))
    require_shape("bicg", "r", tuple(r.shape), (m, 1))
    g = blas2_workspace_rows(KIND, tile, a)
    ws = torch.empty((g, n), dtype=torch.float32, device=a.device)
    q = torch.empty((m, 1), dtype=a.dtype, device=a.device)
    s = torch.empty((n, 1), dtype=a.dtype, device=a.device)
    rc = _cuda.library().repro_bicg(
        list(BLAS2_TILES).index(tile), _cuda.dtype_code(a), a.data_ptr(),
        p.data_ptr(), r.data_ptr(), q.data_ptr(), s.data_ptr(),
        ws.data_ptr(), g, m, n, _cuda.stream_of(a))
    _cuda.check(rc, "bicg")
    LAUNCHES["bicg"] += 1
    return q, s


def _bicg_symbols(tile: str, *, m: int, n: int, dtype: str = "float32"):
    return blas2_symbols("bicg_kernel", tile, dtype)


@tuned_kernel(
    "bicg",
    space={"bm": divisors("m", (16, 32, 64, 128, 256, 512, 1024))},
    signature=lambda a, p, r, **_: dict(m=a.shape[0], n=a.shape[1],
                                        dtype=dtype_name(a)),
    static_info=_bicg_analysis,
    hopper=HopperSpace(tiles=tuple(BLAS2_TILES), analysis=_bicg_hopper,
                       symbols=_bicg_symbols),
    out=lambda a, p, r, **_: [((a.shape[0], 1), a.dtype),
                              ((a.shape[1], 1), a.dtype)],
    make_inputs=_bicg_inputs,
    reference=bicg_ref,
    pretune=tuple(dict(m=s, n=s, dtype=dt)
                  for s in (512, 1024, 2048, 4096)
                  for dt in ("float32", "bfloat16")),
    # Paper Table VII row (BiCG kernel of the sub-solver): R^u per
    # compute capability, no shared memory; A read once for both
    # products (4 flops/element), two vector reads + two writes.
    cuda=cuda_profile(
        regs={"Fermi": 27, "Kepler": 28, "Maxwell": 32},
        workload=lambda m, n, **_: dict(
            o_fl=4.0 * m * n, o_mem=1.0 * m * n + 2.0 * (m + n),
            o_ctrl=1.0 * m, o_reg=4.0 * m * n)),
)
def bicg(a, p, r, *, tile: str | None = None):
    """(q, s) = (A p, Aᵀ r): a (M, N), p (N, 1), r (M, 1) -> (M, 1),
    (N, 1) in ``a``'s type; the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if a.device.type == "cpu":
        return bicg_plain(a, p, r)
    return bicg_cuda(a, p, r, tile=tile)


def bicg_static_info(m: int, n: int, dtype,
                     params: Dict) -> KernelStaticInfo:
    """Scalar static info for one configuration (wrapper over the
    declared analysis; kept as a stable public helper)."""
    return block_info(**_bicg_analysis(params, m=m, n=n,
                                     dtype=dtype_str(dtype)))


def make_tunable_bicg(m: int = 2048, n: int = 2048, dtype="float32",
                      seed: int = 0, device=None) -> TunableKernel:
    """BiCG at (m, n) for `repro_torch.core.KernelTuner`: the
    reference's narrowed block space under a TPU target, the tile table
    under the H100 — the active target (see `KernelSpec.tunable`)."""
    space = SearchSpace({
        "bm": pick_divisor_candidates(m, (32, 64, 128, 256, 512, 1024)),
    })
    return get_spec("bicg").tunable(
        m=m, n=n, dtype=dtype_str(dtype), seed=seed, space=space,
        name=f"bicg_{m}x{n}", device=device)
