"""Occupancy models (paper §III-A).

Two models:

1. :func:`cuda_occupancy` — the *faithful* reproduction of the paper's
   Eqs. 1-5 over Table I hardware constants.  Used to validate our math
   against the paper's own Table VII and as the baseline model in the
   benchmarks.

2. :func:`tpu_occupancy` — the TPU adaptation.  A TPU core has no warp
   scheduler; latency is hidden by the Pallas software pipeline
   overlapping the next tile's DMA with the current tile's compute.
   The occupancy analogue is therefore the steady-state MXU/VPU busy
   fraction ``t_compute / max(t_compute, t_dma)`` with the hard
   constraint that the pipelined working set fits VMEM.  "Registers"
   map to accumulator/scratch words per lane; "shared memory" maps to
   VMEM tile bytes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hw import (GpuSpec, TpuSpec, dtype_bytes, require_tpu,
                                 resolve_target)
from repro_torch.core.mix import InstructionMix

__all__ = [
    "CudaOccupancy", "cuda_occupancy", "suggest_cuda_params",
    "CudaOccupancyBatch", "cuda_occupancy_batch",
    "TpuOccupancy", "tpu_occupancy", "suggest_block_shapes",
    "TpuOccupancyBatch", "tpu_occupancy_batch",
]


# ---------------------------------------------------------------------------
# Faithful CUDA occupancy (Eqs. 1-5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CudaOccupancy:
    """Result of the paper's occupancy calculation."""

    active_blocks: int          # B*_mp  (Eq. 1)
    active_warps: int           # W*_mp
    occupancy: float            # Eq. 2
    limiter: str                # which G_psi bound B*_mp ('warps'|'regs'|'shmem')
    g_warps: int
    g_regs: int
    g_shmem: int


def _g_warps(threads_per_block: int, gpu: GpuSpec) -> int:
    """Eq. 3: blocks limited by warp slots."""
    if threads_per_block <= 0:
        return gpu.blocks_per_mp
    warps_per_block = math.ceil(threads_per_block / gpu.threads_per_warp)
    return int(min(gpu.blocks_per_mp,
                   math.floor(gpu.warps_per_mp / warps_per_block)))


def _g_regs(regs_per_thread: int, threads_per_block: int, gpu: GpuSpec) -> int:
    """Eq. 4: blocks limited by the register file."""
    if regs_per_thread > gpu.regs_per_thread:
        return 0  # illegal (case 1)
    if regs_per_thread > 0:
        warps_per_block = max(1, math.ceil(max(threads_per_block, 1)
                                           / gpu.threads_per_warp))
        # registers needed by one warp, rounded to allocation granularity
        regs_per_warp = math.ceil(
            regs_per_thread * gpu.threads_per_warp / gpu.reg_alloc_size
        ) * gpu.reg_alloc_size
        warps_limited = math.floor(gpu.regs_per_block / max(regs_per_warp, 1))
        return int(max(0, math.floor(warps_limited / warps_per_block)))
    return gpu.blocks_per_mp  # case 3: unspecified


def _g_shmem(shmem_per_block: int, gpu: GpuSpec) -> int:
    """Eq. 5: blocks limited by shared memory."""
    if shmem_per_block > gpu.shmem_per_block:
        return 0  # illegal
    if shmem_per_block > 0:
        return int(math.floor(gpu.shmem_per_mp / shmem_per_block))
    return gpu.blocks_per_mp


def cuda_occupancy(threads_per_block: int,
                   regs_per_thread: int,
                   shmem_per_block: int,
                   gpu: GpuSpec) -> CudaOccupancy:
    """Paper Eqs. 1-5 + Eq. 2 over one (T^u, R^u, S^u) configuration."""
    gw = _g_warps(threads_per_block, gpu)
    gr = _g_regs(regs_per_thread, threads_per_block, gpu)
    gs = _g_shmem(shmem_per_block, gpu)
    bounds = {"warps": gw, "regs": gr, "shmem": gs}
    limiter = min(bounds, key=bounds.get)
    active_blocks = max(0, min(bounds.values()))          # Eq. 1
    warps_per_block = math.ceil(max(threads_per_block, 1)
                                / gpu.threads_per_warp)
    active_warps = min(active_blocks * warps_per_block, gpu.warps_per_mp)
    occ = active_warps / gpu.warps_per_mp                 # Eq. 2
    return CudaOccupancy(active_blocks=active_blocks,
                         active_warps=active_warps,
                         occupancy=occ, limiter=limiter,
                         g_warps=gw, g_regs=gr, g_shmem=gs)


def suggest_cuda_params(regs_per_thread: int,
                        shmem_per_block: int,
                        gpu: GpuSpec,
                        thread_candidates: Optional[Sequence[int]] = None,
                        ) -> Dict[str, object]:
    """Table VII analogue: thread sizes achieving max occupancy, plus the
    register headroom ``[R^u : R*]`` and shared-memory headroom ``S*``."""
    if thread_candidates is None:
        thread_candidates = range(32, gpu.threads_per_block + 1, 32)
    best: Dict[int, float] = {}
    for t in thread_candidates:
        occ = cuda_occupancy(t, regs_per_thread, shmem_per_block, gpu).occupancy
        best[t] = occ
    occ_star = max(best.values()) if best else 0.0
    t_star = sorted(t for t, o in best.items() if o >= occ_star - 1e-9)
    # register increase potential at occ*: how many more regs/thread before
    # the register limiter drops the block count at the best thread size.
    r_star = 0
    if t_star:
        t0 = t_star[-1]
        base = cuda_occupancy(t0, regs_per_thread, shmem_per_block, gpu)
        r = regs_per_thread
        while r < gpu.regs_per_thread:
            if cuda_occupancy(t0, r + 1, shmem_per_block, gpu).active_blocks \
                    < base.active_blocks:
                break
            r += 1
        r_star = r - regs_per_thread
    # shared-memory headroom: bytes per block before active blocks drop.
    s_star = 0
    if t_star:
        t0 = t_star[-1]
        base = cuda_occupancy(t0, regs_per_thread, shmem_per_block, gpu)
        if base.active_blocks > 0:
            s_star = gpu.shmem_per_mp // base.active_blocks
    return {"threads": t_star, "occ_star": occ_star,
            "reg_headroom": r_star, "shmem_star": s_star}


# ---------------------------------------------------------------------------
# Batched CUDA occupancy (struct-of-arrays over a thread-size lattice)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CudaOccupancyBatch:
    """`CudaOccupancy` over N configurations, one array per field.

    Produced by :func:`cuda_occupancy_batch`; element ``i`` of every
    field equals the corresponding scalar :func:`cuda_occupancy` field
    for configuration ``i`` exactly (the parity tests compare with
    ``==``, not a tolerance).  This is what keeps `rank_space` a single
    vectorized pass for GPU targets, mirroring `tpu_occupancy_batch`.
    """

    active_blocks: np.ndarray   # (N,) int64
    active_warps: np.ndarray    # (N,) int64
    occupancy: np.ndarray       # (N,) float64
    limiter: np.ndarray         # (N,) str ('warps'|'regs'|'shmem')
    g_warps: np.ndarray         # (N,) int64
    g_regs: np.ndarray          # (N,) int64
    g_shmem: np.ndarray         # (N,) int64

    def __len__(self) -> int:
        return int(self.occupancy.shape[0])

    def at(self, i: int) -> CudaOccupancy:
        """Scalar view of configuration ``i`` (debugging / parity)."""
        return CudaOccupancy(
            active_blocks=int(self.active_blocks[i]),
            active_warps=int(self.active_warps[i]),
            occupancy=float(self.occupancy[i]),
            limiter=str(self.limiter[i]),
            g_warps=int(self.g_warps[i]),
            g_regs=int(self.g_regs[i]),
            g_shmem=int(self.g_shmem[i]))


def _ceil_div(a: np.ndarray, b: int) -> np.ndarray:
    return -(-a // b)


def cuda_occupancy_batch(threads_per_block,
                         regs_per_thread,
                         shmem_per_block,
                         gpu: GpuSpec) -> CudaOccupancyBatch:
    """Vectorized :func:`cuda_occupancy` over whole candidate lattices.

    Same contract, array-valued: each of the three resource-usage
    inputs may be a scalar or an (N,) array (typically the ``threads``
    column of `SearchSpace.enumerate_lattice`); they broadcast against
    each other.  All arithmetic is integer, mirroring the scalar
    ``math.ceil``/``math.floor`` over Python ints bit-for-bit.
    """
    t, r, s = np.broadcast_arrays(
        np.asarray(threads_per_block, dtype=np.int64),
        np.asarray(regs_per_thread, dtype=np.int64),
        np.asarray(shmem_per_block, dtype=np.int64))
    t, r, s = (np.atleast_1d(t), np.atleast_1d(r), np.atleast_1d(s))
    b_mp = gpu.blocks_per_mp
    tw = gpu.threads_per_warp
    # Eq. 3 — warp-slot bound.  The scalar path divides by
    # ceil(t / tw) with t > 0; clamp the denominator so the dead
    # branch of the where() never divides by zero.
    warps_per_block = np.maximum(_ceil_div(np.maximum(t, 1), tw), 1)
    gw = np.where(t <= 0, b_mp,
                  np.minimum(b_mp, gpu.warps_per_mp // warps_per_block))
    # Eq. 4 — register-file bound.
    regs_per_warp = _ceil_div(r * tw, gpu.reg_alloc_size) \
        * gpu.reg_alloc_size
    warps_limited = gpu.regs_per_block // np.maximum(regs_per_warp, 1)
    gr = np.where(r > gpu.regs_per_thread, 0,
                  np.where(r > 0,
                           np.maximum(0, warps_limited // warps_per_block),
                           b_mp))
    # Eq. 5 — shared-memory bound.
    gs = np.where(s > gpu.shmem_per_block, 0,
                  np.where(s > 0, gpu.shmem_per_mp // np.maximum(s, 1),
                           b_mp))
    bounds = np.stack([gw, gr, gs])              # same order as the
    limiter_ix = np.argmin(bounds, axis=0)       # scalar dict-min tie rule
    active = np.maximum(0, bounds.min(axis=0))   # Eq. 1
    aw = np.minimum(active * warps_per_block, gpu.warps_per_mp)
    return CudaOccupancyBatch(
        active_blocks=active.astype(np.int64),
        active_warps=aw.astype(np.int64),
        occupancy=aw / gpu.warps_per_mp,         # Eq. 2
        limiter=np.array(["warps", "regs", "shmem"])[limiter_ix],
        g_warps=gw.astype(np.int64),
        g_regs=gr.astype(np.int64),
        g_shmem=gs.astype(np.int64))


# ---------------------------------------------------------------------------
# TPU occupancy (the adaptation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpuOccupancy:
    """Static pipeline model of one Pallas kernel configuration.

    ``occupancy`` is the steady-state compute-unit busy fraction under
    double-buffered DMA: compute / max(compute, dma).  ``fits_vmem`` is
    the hard feasibility constraint (Eq. 1's min over resources becomes
    a feasibility cut on TPU: 0 active tiles if over VMEM).
    """

    fits_vmem: bool
    vmem_bytes: int             # pipelined working set (incl. buffering)
    vmem_ratio: float           # vmem_bytes / budget
    t_compute: float            # seconds per grid step
    t_dma: float                # seconds per grid step (HBM <-> VMEM)
    occupancy: float            # in [0, 1]
    limiter: str                # 'vmem' | 'dma' | 'compute'
    grid_steps: int
    mxu_alignment: float        # fraction of tile dims aligned to (8,128)/(128,128)
    predicted_step_time: float  # max(t_compute, t_dma) + ctrl overhead


def _align_frac(shape: Sequence[int], spec: TpuSpec) -> float:
    """Lane-padding waste model: fraction of the trailing-2D tile that is
    real data after padding up to (sublane, lane) granularity."""
    if not shape:
        return 1.0
    dims = list(shape)
    last = dims[-1]
    second = dims[-2] if len(dims) >= 2 else 1
    pad_last = math.ceil(last / spec.lane) * spec.lane
    pad_second = math.ceil(second / spec.sublane) * spec.sublane
    real = last * second
    padded = pad_last * pad_second
    return real / padded if padded else 1.0


def tpu_occupancy(block_in_bytes: Sequence[int],
                  block_out_bytes: Sequence[int],
                  flops_per_step: float,
                  *,
                  grid_steps: int = 1,
                  scratch_bytes: int = 0,
                  buffering: int = 2,
                  block_shapes: Optional[Sequence[Sequence[int]]] = None,
                  compute_unit: str = "mxu",
                  spec: Optional[TpuSpec] = None) -> TpuOccupancy:
    """Static occupancy of one Pallas configuration.

    Parameters
    ----------
    block_in_bytes / block_out_bytes:
        bytes of each input/output tile per grid step (BlockSpec-sized).
    flops_per_step:
        useful FLOPs per grid step.
    buffering:
        pipeline depth (2 = double buffering, the Pallas default).
    spec:
        chip to model; ``None`` = the process default target.
    """
    spec = require_tpu(spec, "tpu_occupancy")
    moved = float(sum(block_in_bytes) + sum(block_out_bytes))
    vmem = int(moved * buffering + scratch_bytes)
    budget = spec.vmem_bytes
    fits = vmem <= budget
    peak = spec.peak_flops_bf16 if compute_unit == "mxu" else spec.vpu_flops
    align = 1.0
    if block_shapes:
        fr = [_align_frac(s, spec) for s in block_shapes if s]
        align = float(np.mean(fr)) if fr else 1.0
    eff_peak = peak * max(align, 1e-6)
    t_c = flops_per_step / eff_peak if flops_per_step else 0.0
    t_d = moved / spec.hbm_bw
    if not fits:
        occ, lim = 0.0, "vmem"
    elif t_d > t_c:
        occ, lim = (t_c / t_d if t_d > 0 else 0.0), "dma"
    else:
        occ, lim = 1.0, "compute"
    step = max(t_c, t_d) + spec.ctrl_overhead_s
    return TpuOccupancy(fits_vmem=fits, vmem_bytes=vmem,
                        vmem_ratio=vmem / budget,
                        t_compute=t_c, t_dma=t_d, occupancy=occ,
                        limiter=lim, grid_steps=int(grid_steps),
                        mxu_alignment=align,
                        predicted_step_time=step)


# ---------------------------------------------------------------------------
# Batched TPU occupancy (struct-of-arrays over a whole config lattice)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpuOccupancyBatch:
    """`TpuOccupancy` over N configurations, one array per field.

    Produced by :func:`tpu_occupancy_batch`; every field is an (N,)
    array whose element ``i`` equals the corresponding scalar
    :func:`tpu_occupancy` field for configuration ``i`` exactly (bitwise
    — the parity tests compare with ``==``, not a tolerance).
    """

    fits_vmem: np.ndarray           # (N,) bool
    vmem_bytes: np.ndarray          # (N,) int64
    vmem_ratio: np.ndarray          # (N,) float64
    t_compute: np.ndarray           # (N,) float64
    t_dma: np.ndarray               # (N,) float64
    occupancy: np.ndarray           # (N,) float64
    limiter: np.ndarray             # (N,) str ('vmem'|'dma'|'compute')
    grid_steps: np.ndarray          # (N,) int64
    mxu_alignment: np.ndarray       # (N,) float64
    predicted_step_time: np.ndarray  # (N,) float64

    def __len__(self) -> int:
        return int(self.predicted_step_time.shape[0])

    def at(self, i: int) -> TpuOccupancy:
        """Scalar view of configuration ``i`` (debugging / parity)."""
        return TpuOccupancy(
            fits_vmem=bool(self.fits_vmem[i]),
            vmem_bytes=int(self.vmem_bytes[i]),
            vmem_ratio=float(self.vmem_ratio[i]),
            t_compute=float(self.t_compute[i]),
            t_dma=float(self.t_dma[i]),
            occupancy=float(self.occupancy[i]),
            limiter=str(self.limiter[i]),
            grid_steps=int(self.grid_steps[i]),
            mxu_alignment=float(self.mxu_alignment[i]),
            predicted_step_time=float(self.predicted_step_time[i]))


def _align_frac_batch(shape: Sequence, spec: TpuSpec) -> np.ndarray:
    """Vectorized `_align_frac`: dims may be ints or (N,) arrays."""
    if not len(shape):
        return np.asarray(1.0)
    last = np.asarray(shape[-1], dtype=np.float64)
    second = np.asarray(shape[-2] if len(shape) >= 2 else 1,
                        dtype=np.float64)
    pad_last = np.ceil(last / spec.lane) * spec.lane
    pad_second = np.ceil(second / spec.sublane) * spec.sublane
    real = last * second
    padded = pad_last * pad_second
    return np.where(padded > 0, real / np.where(padded > 0, padded, 1.0), 1.0)


def tpu_occupancy_batch(block_in_bytes: Sequence,
                        block_out_bytes: Sequence,
                        flops_per_step,
                        *,
                        grid_steps=1,
                        scratch_bytes=0,
                        buffering: int = 2,
                        block_shapes: Optional[Sequence[Sequence]] = None,
                        compute_unit: str = "mxu",
                        spec: Optional[TpuSpec] = None) -> TpuOccupancyBatch:
    """Vectorized :func:`tpu_occupancy` over a whole config lattice.

    Same contract, array-valued: each entry of ``block_in_bytes`` /
    ``block_out_bytes`` is the per-step byte count of one operand as a
    scalar or (N,) array; ``flops_per_step`` / ``grid_steps`` /
    ``scratch_bytes`` broadcast likewise; each shape in ``block_shapes``
    may mix int dims with (N,) array dims.  One NumPy pass computes the
    step time, grid steps, and VMEM feasibility of all N configurations.
    """
    spec = require_tpu(spec, "tpu_occupancy_batch")
    moved = np.asarray(sum(np.asarray(b, dtype=np.float64)
                           for b in list(block_in_bytes)
                           + list(block_out_bytes)), dtype=np.float64)
    vmem_f = moved * buffering + scratch_bytes
    budget = spec.vmem_bytes
    fits = vmem_f <= budget
    peak = spec.peak_flops_bf16 if compute_unit == "mxu" else spec.vpu_flops
    if block_shapes:
        fr = [_align_frac_batch(s, spec) for s in block_shapes if len(s)]
        align = np.mean(np.stack(np.broadcast_arrays(*fr)), axis=0) \
            if fr else np.asarray(1.0)
    else:
        align = np.asarray(1.0)
    eff_peak = peak * np.maximum(align, 1e-6)
    flops = np.asarray(flops_per_step, dtype=np.float64)
    t_c = np.where(flops != 0.0, flops / eff_peak, 0.0)
    t_d = moved / spec.hbm_bw
    dma_occ = np.where(t_d > 0, t_c / np.where(t_d > 0, t_d, 1.0), 0.0)
    occ = np.where(~fits, 0.0, np.where(t_d > t_c, dma_occ, 1.0))
    limiter = np.where(~fits, "vmem", np.where(t_d > t_c, "dma", "compute"))
    step = np.maximum(t_c, t_d) + spec.ctrl_overhead_s
    shape = np.broadcast_shapes(np.shape(step), np.shape(align),
                                np.shape(np.asarray(grid_steps)),
                                np.shape(np.asarray(scratch_bytes)))
    n = shape[0] if shape else 1
    full = lambda a, dt: np.ascontiguousarray(
        np.broadcast_to(np.asarray(a, dtype=dt), (n,)))
    return TpuOccupancyBatch(
        fits_vmem=full(fits, bool),
        vmem_bytes=full(vmem_f, np.int64),
        vmem_ratio=full(vmem_f.astype(np.int64) / budget, np.float64),
        t_compute=full(t_c, np.float64),
        t_dma=full(t_d, np.float64),
        occupancy=full(occ, np.float64),
        limiter=np.broadcast_to(limiter, (n,)).copy(),
        grid_steps=full(grid_steps, np.int64),
        mxu_alignment=full(align, np.float64),
        predicted_step_time=full(step, np.float64))


def suggest_block_shapes(m: int, n: int, k: int,
                         dtype_size: int = 2,
                         spec: Optional[TpuSpec] = None,
                         candidates: Optional[Iterable[Tuple[int, int, int]]] = None,
                         ) -> List[Tuple[Tuple[int, int, int], TpuOccupancy]]:
    """Table VII analogue for TPU matmul tiles: rank (bm, bn, bk)
    candidates by static occupancy (no compilation, no execution)."""
    spec = require_tpu(spec, "suggest_block_shapes")
    if candidates is None:
        sizes = [128, 256, 512, 1024]
        candidates = [(bm, bn, bk) for bm in sizes for bn in sizes
                      for bk in sizes]
    out = []
    for (bm, bn, bk) in candidates:
        if bm > m or bn > n or bk > k:
            continue
        blocks_in = [bm * bk * dtype_size, bk * bn * dtype_size]
        blocks_out = [bm * bn * 4]  # f32 accumulator tile
        steps = math.ceil(m / bm) * math.ceil(n / bn) * math.ceil(k / bk)
        occ = tpu_occupancy(blocks_in, blocks_out, 2.0 * bm * bn * bk,
                            grid_steps=steps,
                            scratch_bytes=bm * bn * 4,
                            block_shapes=[(bm, bk), (bk, bn), (bm, bn)],
                            spec=spec)
        if occ.fits_vmem:
            out.append(((bm, bn, bk), occ))
    out.sort(key=lambda t: t[1].predicted_step_time * t[1].grid_steps)
    return out
