"""RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w over rows, in f32.

Port of `src/repro/kernels/rms_norm.py:_rms_kernel` as the CUDA
kernels of ``csrc/rms_norm.cu`` (design, bound and what they leave on
the table are noted there).  The serving path normalizes every layer's
input rows through it.

The declaration keeps the reference's TPU space (``bm`` rows per grid
step), analysis and pretune grid; its H100 space is the compiled
instantiations of the kernel (`RMS_TILES`), in three families priced
together by `rms_tiles_cost`: warp-per-row rows (any D), row-in-register
rows (one block per row, 16-byte vectors; D a multiple of a vector and
at most THREADS x VMAX vectors, else infeasible) and cluster rows (a
row over the C blocks of a thread-block cluster, each holding a slice
in registers; D a multiple of a vector and at most C x THREADS x VMAX
vectors, else infeasible).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, TILE_AXIS, divisors,
                                     tuned_kernel)
from repro_torch.core.hw import dtype_bytes
from repro_torch.core.sass import template_symbol
from repro_torch.kernels.common import (cdiv, dtype_name, family_costs,
                                        require_shape)

__all__ = ["rms_norm", "rms_norm_cuda", "rms_norm_plain", "RMS_TILES",
           "SIMT", "VEC", "CLUSTER", "vec_takes", "cluster_takes",
           "rms_tiles_cost", "LAUNCHES"]

# Launches by kernel: "rms_norm" counts calls of `rms_norm_cuda` (one per
# call, whatever the tile), "rms_simt" / "rms_vec" / "rms_cluster" the
# kernel of each family that it launched.
LAUNCHES = {"rms_norm": 0, "rms_simt": 0, "rms_vec": 0, "rms_cluster": 0}
_FAMILY_COUNTER = ("rms_simt", "rms_vec", "rms_cluster")

# tile families (csrc/rms_norm.cu RmsFamily), and the 16-byte vectors of
# x a thread of the vector and cluster rows holds
SIMT, VEC, CLUSTER = 0, 1, 2
VMAX = 8

# name -> (rows per block, threads, family, VMAX, blocks a row); order =
# csrc RMS_TILES, RMS_VEC_TILES, then RMS_CLUSTER_TILES.  Warp-per-row
# rows run 32 threads a row; vector rows one block of THREADS threads a
# row, widest first; cluster rows C blocks of THREADS threads a row, the
# most blocks first (where the analysis ties rows, the first wins).
RMS_TILES: Dict[str, Tuple[int, ...]] = {
    "r1": (1, 32, SIMT, 0, 1), "r2": (2, 64, SIMT, 0, 1),
    "r4": (4, 128, SIMT, 0, 1), "r8": (8, 256, SIMT, 0, 1),
    "r16": (16, 512, SIMT, 0, 1),
    "vec_t256": (1, 256, VEC, VMAX, 1), "vec_t128": (1, 128, VEC, VMAX, 1),
    "vec_t64": (1, 64, VEC, VMAX, 1),
    "cl8_t128": (1, 128, CLUSTER, VMAX, 8),
    "cl8_t256": (1, 256, CLUSTER, VMAX, 8),
    "cl4_t256": (1, 256, CLUSTER, VMAX, 4),
    "cl4_t128": (1, 128, CLUSTER, VMAX, 4),
    "cl2_t256": (1, 256, CLUSTER, VMAX, 2),
}

# a tile's index in the C table (the launch's ``tile`` argument)
_TILE_INDEX = {t: i for i, t in enumerate(RMS_TILES)}
# declared registers per thread: the warp-per-row kernel's, the vector
# kernel's by element size and the cluster kernel's by (element size,
# threads) (their compiled counts for sm_90a: a held bf16 vector widens
# to eight floats, an f32 one to four); the smoke prints the compiled
# counts beside them
_SIMT_REGS = 24
_VEC_REGS = {2: 80, 4: 48}
_CLUSTER_REGS = {(2, 128): 80, (2, 256): 80, (4, 128): 56, (4, 256): 53}


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


def cluster_takes(dtype: str, d: int, threads, c) -> np.ndarray:
    """Whether the rows of ``c`` blocks of ``threads`` threads a row
    (the cluster rows; the vector rows are c = 1) take rows of ``d``
    elements: whole 16-byte vectors, at most VMAX a thread."""
    v = 16 // dtype_bytes(dtype)
    return (d % v == 0) & (d <= np.asarray(c) * np.asarray(threads)
                           * VMAX * v)


def vec_takes(dtype: str, d: int, threads) -> np.ndarray:
    """Whether the vector rows of ``threads`` threads take rows of ``d``
    elements: whole 16-byte vectors, at most VMAX a thread."""
    return cluster_takes(dtype, d, threads, 1)


def _simt_cost(t, *, m: int, d: int, eb: int):
    """One warp per row: no shared memory, x read and y written once
    from device memory (the second pass over a row hits L1/L2), the f32
    weight read once per block."""
    rows = t[:, 0]
    blocks = cdiv(m, rows)
    return dict(blocks=blocks, threads=32 * rows,
                busy_threads=32 * np.minimum(rows, m), regs=_SIMT_REGS,
                smem=0, flops=4.0 * m * d, trans=float(m),
                hbm_bytes=2.0 * m * d * eb + blocks * d * 4.0)


def _vec_cost(t, *, m: int, d: int, eb: int):
    """One block per row: x read and y written once, w once from device
    memory (later blocks find it in L2); the threads that hold a vector
    do work; every vector of the row is in flight at once, so the row's
    bytes are the block's bytes in flight (Little's law over the card),
    and the warps' partial sums meet in shared memory."""
    nt = t[:, 1]
    nv = max(1, d * eb // 16)
    return dict(blocks=np.full(len(t), m), threads=nt,
                busy_threads=np.minimum(nt, nv), regs=_VEC_REGS[eb],
                smem=4 * (nt // 32), flops=4.0 * m * d, trans=float(m),
                hbm_bytes=2.0 * m * d * eb + d * 4.0,
                smem_bytes=m * 8.0 * (nt // 32),
                inflight_bytes=np.full(len(t), float(d * eb)))


def _cluster_cost(t, *, m: int, d: int, eb: int):
    """C blocks per row, each holding a slice of ceil(vectors / C)
    vectors: x read and y written once, w once from device memory; the
    slice's vectors are in flight at once, so a block states D x eb / C
    bytes in flight (Little's law over the card, as the vector rows);
    each block's warps meet in shared memory, and each block reads the C
    slice sums (one per warp, a broadcast) through distributed shared
    memory."""
    nt, c = t[:, 1], t[:, 4]
    nv = max(1, d * eb // 16)
    warps = nt // 32
    return dict(blocks=m * c, threads=nt,
                busy_threads=np.minimum(nt, -(-nv // c)),
                regs=np.array([_CLUSTER_REGS[eb, int(n)] for n in nt],
                              dtype=np.int64), smem=4 * warps + 4,
                flops=4.0 * m * d, trans=m * c.astype(np.float64),
                hbm_bytes=2.0 * m * d * eb + d * 4.0,
                smem_bytes=m * c * (8.0 * warps + 8.0 + 4.0 * c * warps),
                inflight_bytes=float(d * eb) / c)


def rms_tiles_cost(t, *, m: int, d: int,
                   dtype: str) -> Dict[str, np.ndarray]:
    """`hopper_info_batch` arguments of RMS_TILES rows ``t`` (an (N, 5)
    array of the table's fields) for an (m, d) ``dtype`` input, each row
    priced by its family; vector rows are infeasible unless `vec_takes`
    the row, cluster rows unless `cluster_takes` it (both read the
    blocks-a-row field: 1 for a vector row).  Warp-per-row rows
    state no bytes in flight, so their latency hiding is counted in
    warps."""
    eb = dtype_bytes(dtype)
    fam = t[:, 2]
    out = family_costs(
        fam, {SIMT: lambda sel: _simt_cost(t[sel], m=m, d=d, eb=eb),
              VEC: lambda sel: _vec_cost(t[sel], m=m, d=d, eb=eb),
              CLUSTER: lambda sel: _cluster_cost(t[sel], m=m, d=d, eb=eb)},
        keys=("blocks", "threads", "busy_threads", "regs", "smem", "flops",
              "trans", "hbm_bytes", "smem_bytes", "inflight_bytes"))
    out["feasible"] &= (fam == SIMT) | cluster_takes(dtype, d, t[:, 1],
                                                     t[:, 4])
    return out


def _rms_symbols(tile: str, *, m: int, d: int, dtype: str = "float32"):
    rows, threads, fam, _, blocks = RMS_TILES[tile]
    if fam == SIMT:
        return (template_symbol("rms_kernel", dtype, rows),)
    if fam == VEC:
        return (template_symbol("rms_vec_kernel", dtype, threads),)
    return (template_symbol("rms_cluster_kernel", dtype, blocks, threads),)


def _rms_hopper(cols, *, m: int, d: int, dtype: str = "float32"):
    t = np.array([RMS_TILES[str(x)] for x in cols[TILE_AXIS]],
                 dtype=np.int64).reshape(-1, 5)
    return rms_tiles_cost(t, m=m, d=d, dtype=dtype)


def rms_norm_plain(x, w, eps: float = 1e-6):
    """The plain PyTorch version: f32 mean/rsqrt/scale, cast back."""
    import torch
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rms_norm_cuda(x, w, eps: float = 1e-6, *, tile: str):
    """Launch the CUDA RMSNorm instantiation ``tile`` on CUDA tensors
    (x (M, D) float32/bfloat16, w (D,) any float type, widened).  A
    vector or cluster row refuses with ValueError a row it cannot hold
    (`vec_takes`, `cluster_takes`) or an operand off a 16-byte
    boundary."""
    import torch
    _cuda.require_operands("rms_norm", x)
    if x.dim() != 2:
        raise ValueError(f"rms_norm: x must be (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    require_shape("rms_norm", "w", tuple(w.shape), (d,))
    idx = _TILE_INDEX.get(tile)
    if idx is None:
        raise ValueError(f"rms_norm: unknown tile {tile!r}")
    wf = w if (w.dtype == torch.float32 and w.device == x.device
               and w.is_contiguous()) else \
        w.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    _, threads, family, _, blocks = RMS_TILES[tile]
    if family != SIMT:
        v = 16 // x.element_size()
        if d % v or d > blocks * threads * VMAX * v:
            raise ValueError(
                f"rms_norm: tile {tile} takes rows of whole 16-byte vectors"
                f", at most {blocks * threads * VMAX} of them, got D={d} "
                f"{dtype_name(x)}")
        if x.data_ptr() % 16 or wf.data_ptr() % 16:
            raise ValueError(f"rms_norm: tile {tile} needs 16-byte-aligned "
                             f"operands")
    rc = _cuda.library().repro_rms_norm(
        idx, _cuda.dtype_code(x), x.data_ptr(), wf.data_ptr(),
        out.data_ptr(), m, d, float(eps), _cuda.stream_of(x))
    _cuda.check(rc, "rms_norm")
    LAUNCHES["rms_norm"] += 1
    LAUNCHES[_FAMILY_COUNTER[family]] += 1
    return out


@tuned_kernel(
    "rms_norm",
    space={"bm": divisors("m", (8, 16, 32, 64, 128, 256, 512, 1024))},
    signature=lambda x, w, **_: dict(m=x.shape[0], d=x.shape[1],
                                     dtype=dtype_name(x)),
    static_info=_rms_analysis,
    hopper=HopperSpace(tiles=tuple(RMS_TILES), analysis=_rms_hopper,
                       symbols=_rms_symbols),
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
