"""Shared helpers for the kernel layer.

Every kernel module in this package follows the same contract:

* a CUDA kernel written for Hopper (``csrc/*.cu``) behind a wrapper that
  launches it for CUDA tensors, and a plain PyTorch version of the same
  function that the wrapper uses for CPU tensors;
* the reference's analytic ``static_info`` builders for the TPU block
  space (`block_info`) and the CUDA thread-block space (`cuda_info`),
  so the port ranks exactly as the reference does on those targets;
* a ``hopper=`` launch space and analyzer (`hopper_info_batch`) for the
  H100: the compiled tile instantiations priced by the H100 roofline,
  stretched by wave quantization, with Eqs. 1-5 deciding feasibility.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.hw import GpuSpec, HopperSpec, TpuSpec, dtype_bytes
from repro_torch.core.mix import InstructionMix
from repro_torch.core.occupancy import (CudaOccupancy, CudaOccupancyBatch,
                                        TpuOccupancyBatch, cuda_occupancy,
                                        cuda_occupancy_batch, tpu_occupancy,
                                        tpu_occupancy_batch)
from repro_torch.core.predict import cuda_eq6_time
from repro_torch.core.autotuner import KernelStaticInfo

__all__ = ["cdiv", "block_info",
           "BatchStaticInfo", "block_info_batch",
           "CudaStaticInfo", "cuda_info",
           "CudaBatchStaticInfo", "cuda_info_batch",
           "HopperBatchInfo", "hopper_info_batch",
           "pick_divisor_candidates", "require_shape",
           "dtype_name"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dtype_name(t) -> str:
    """numpy spelling of a tensor's dtype (``"float32"``, ``"bfloat16"``).

    Signatures are cache-key material: ``str(torch.float32)`` is
    ``"torch.float32"``, which would make every key diverge from the
    reference's ``str(jax_array.dtype)``."""
    return str(t.dtype).rpartition(".")[2]


def pick_divisor_candidates(n: int, candidates: Sequence[int]) -> tuple:
    """Keep candidates that divide n (BlockSpec-exact tiling)."""
    vals = tuple(c for c in candidates if c <= n and n % c == 0)
    return vals or (n,)


def require_shape(kernel: str, name: str, got: tuple, want: tuple) -> None:
    """ValueError (not assert) when an operand shape disagrees."""
    if tuple(got) != tuple(want):
        raise ValueError(f"{kernel}: {name} has shape {tuple(got)}, "
                         f"expected {tuple(want)}")


def block_info(*,
               in_blocks: Sequence[tuple],
               out_blocks: Sequence[tuple],
               in_dtypes: Sequence,
               out_dtypes: Sequence,
               flops_per_step: float,
               vpu_per_step: float = 0.0,
               trans_per_step: float = 0.0,
               grid_steps: int = 1,
               scratch_bytes: int = 0,
               mix_scale: float | None = None,
               ctrl_ops: float | None = None,
               spec: TpuSpec | None = None) -> KernelStaticInfo:
    """Analytic KernelStaticInfo from block shapes + per-step op counts.

    ``mix_scale`` defaults to ``grid_steps`` (total work = per-step work
    times the number of grid steps).  ``ctrl_ops`` overrides the
    control-op count (default: one per grid step) — kernels with an
    unroll axis amortize loop control across unrolled iterations.
    ``spec=None`` analyzes for the process-default target
    (`repro_torch.core.target.default_target`).
    """
    in_bytes = [int(np.prod(b)) * dtype_bytes(d)
                for b, d in zip(in_blocks, in_dtypes)]
    out_bytes = [int(np.prod(b)) * dtype_bytes(d)
                 for b, d in zip(out_blocks, out_dtypes)]
    occ = tpu_occupancy(in_bytes, out_bytes, flops_per_step,
                        grid_steps=grid_steps,
                        scratch_bytes=scratch_bytes,
                        block_shapes=list(in_blocks) + list(out_blocks),
                        spec=spec)
    scale = grid_steps if mix_scale is None else mix_scale
    per_step_bytes = float(sum(in_bytes) + sum(out_bytes))
    mix = InstructionMix(
        mxu_flops=flops_per_step * scale,
        vpu_flops=vpu_per_step * scale,
        trans_flops=trans_per_step * scale,
        hbm_bytes=per_step_bytes * scale,
        vmem_bytes=per_step_bytes * scale,
        mem_ops=(per_step_bytes / 4.0) * scale,
        ctrl_ops=float(grid_steps if ctrl_ops is None else ctrl_ops),
        reg_ops=0.0,
    )
    return KernelStaticInfo(mix=mix, occupancy=occ)


@dataclasses.dataclass(frozen=True)
class BatchStaticInfo:
    """Struct-of-arrays `KernelStaticInfo` over N configurations.

    ``F`` is the (N, 7) feature matrix in `repro_torch.core.predict`
    `features_matrix` column order (mxu, vpu, trans, hbm, vmem, ctrl,
    reg); ``occupancy`` carries the vectorized pipeline model.  Row
    ``i`` matches the scalar `block_info` for configuration ``i``
    exactly.  Feed ``F``/``pipe``/``feasible`` straight into
    `repro_torch.core.predict.static_times_batch`.
    """

    F: np.ndarray                   # (N, 7) float64
    occupancy: TpuOccupancyBatch

    def __len__(self) -> int:
        return int(self.F.shape[0])

    @property
    def feasible(self) -> np.ndarray:
        return self.occupancy.fits_vmem

    @property
    def pipe(self) -> np.ndarray:
        """Per-config pipeline floor: step time x grid steps."""
        return (self.occupancy.predicted_step_time
                * np.maximum(self.occupancy.grid_steps, 1))


def block_info_batch(*,
                     in_blocks: Sequence[tuple],
                     out_blocks: Sequence[tuple],
                     in_dtypes: Sequence,
                     out_dtypes: Sequence,
                     flops_per_step,
                     vpu_per_step=0.0,
                     trans_per_step=0.0,
                     grid_steps=1,
                     scratch_bytes=0,
                     mix_scale=None,
                     ctrl_ops=None,
                     spec: TpuSpec | None = None) -> BatchStaticInfo:
    """Vectorized `block_info`: one (N, 7) feature matrix + occupancy
    arrays for a whole config lattice in a single NumPy pass.

    Same contract as `block_info`, but block dims and per-step op
    counts may be (N,) arrays (typically `SearchSpace.enumerate_lattice`
    columns) broadcast against scalars.  No per-config Python objects
    are built — this is what makes cold full-space ranking array math
    instead of object churn.
    """
    def _elems(b):
        out = np.asarray(1, dtype=np.int64)
        for d in b:
            out = out * np.asarray(d, dtype=np.int64)
        return out

    in_bytes = [_elems(b) * dtype_bytes(d)
                for b, d in zip(in_blocks, in_dtypes)]
    out_bytes = [_elems(b) * dtype_bytes(d)
                 for b, d in zip(out_blocks, out_dtypes)]
    occ = tpu_occupancy_batch(in_bytes, out_bytes, flops_per_step,
                              grid_steps=grid_steps,
                              scratch_bytes=scratch_bytes,
                              block_shapes=list(in_blocks) + list(out_blocks),
                              spec=spec)
    n = len(occ)
    scale = grid_steps if mix_scale is None else mix_scale
    scale = np.asarray(scale, dtype=np.float64)
    per_step_bytes = np.asarray(sum(in_bytes) + sum(out_bytes),
                                dtype=np.float64)
    col = lambda a: np.broadcast_to(np.asarray(a, dtype=np.float64), (n,))
    F = np.column_stack([
        col(np.asarray(flops_per_step, dtype=np.float64) * scale),
        col(np.asarray(vpu_per_step, dtype=np.float64) * scale),
        col(np.asarray(trans_per_step, dtype=np.float64) * scale),
        col(per_step_bytes * scale),
        col(per_step_bytes * scale),
        col(np.asarray(grid_steps if ctrl_ops is None else ctrl_ops,
                       dtype=np.float64)),
        col(0.0),
    ])
    return BatchStaticInfo(F=F, occupancy=occ)


# ---------------------------------------------------------------------------
# CUDA static info (the faithful paper model behind GpuSpec targets)
# ---------------------------------------------------------------------------

# Occupancy floor when turning the Eq. 6 serial estimate into a launch-
# configuration cost: infeasible configs (occ == 0) are cut by the
# feasibility mask, so this only guards the division itself.
_CUDA_OCC_FLOOR = 1e-6


def _cuda_serial_seconds(o_fl, o_mem, o_ctrl, o_reg, gpu: GpuSpec):
    """Eq. 6 cycles at the core clock, as seconds (scalar or (N,))."""
    return cuda_eq6_time(o_fl, o_mem, o_ctrl, o_reg, gpu) \
        / (gpu.gpu_clock_mhz * 1e6)


@dataclasses.dataclass(frozen=True)
class CudaStaticInfo:
    """`KernelStaticInfo` analogue for one CUDA launch configuration.

    Duck-typed for `repro_torch.core.predict.static_times_batch`: carries a
    ``mix`` (the Eq. 6 instruction classes on the shared feature
    columns, matching `default_cuda_model`), a ``feasible()`` cut
    (illegal launches: zero resident blocks, or a block wider than the
    chip's thread limit), and an ``occupancy`` view exposing
    ``predicted_step_time`` / ``grid_steps`` — the Eq. 6 serial time
    stretched by the occupancy deficit, which is the ranking signal
    across thread-block candidates (Table VII: prefer max occupancy).
    """

    mix: InstructionMix
    cuda: CudaOccupancy
    threads: int
    predicted_step_time: float
    thread_cap: int             # chip T_B^cc the launch must respect
    grid_steps: int = 1

    @property
    def occupancy(self):
        # static_times_batch reads .occupancy.predicted_step_time and
        # .occupancy.grid_steps; this object carries both itself.
        return self

    def feasible(self) -> bool:
        return bool(self.cuda.active_blocks > 0
                    and 0 < self.threads <= self.thread_cap)


def cuda_info(threads, *,
              regs_per_thread: int,
              shmem_per_block: int,
              o_fl: float = 1.0,
              o_mem: float = 1.0,
              o_ctrl: float = 1.0,
              o_reg: float = 1.0,
              spec: GpuSpec) -> CudaStaticInfo:
    """Analytic `CudaStaticInfo` for one (T^u, R^u, S^u) configuration.

    The CUDA counterpart of :func:`block_info`: instruction-class
    counts (whole-kernel O_fl / O_mem / O_ctrl / O_reg) plus the
    paper's occupancy calculation, no compilation, no execution.
    """
    t = int(threads)
    occ = cuda_occupancy(t, regs_per_thread, shmem_per_block, spec)
    serial = _cuda_serial_seconds(o_fl, o_mem, o_ctrl, o_reg, spec)
    step = serial / max(occ.occupancy, _CUDA_OCC_FLOOR)
    mix = InstructionMix(mxu_flops=o_fl, hbm_bytes=o_mem,
                         ctrl_ops=o_ctrl, reg_ops=o_reg)
    return CudaStaticInfo(mix=mix, cuda=occ, threads=t,
                          predicted_step_time=step,
                          thread_cap=spec.threads_per_block)


@dataclasses.dataclass(frozen=True)
class CudaBatchStaticInfo:
    """Struct-of-arrays `CudaStaticInfo` over N thread-block candidates.

    Same field contract `rank_space` consumes from `BatchStaticInfo`:
    ``F`` is the (N, 7) feature matrix in `features_matrix` column
    order (CUDA classes on the mapped columns), ``pipe`` the per-config
    occupancy-stretched Eq. 6 floor, ``feasible`` the legality mask.
    Row ``i`` matches the scalar :func:`cuda_info` exactly.
    """

    F: np.ndarray                   # (N, 7) float64
    occupancy: CudaOccupancyBatch
    pipe: np.ndarray                # (N,) float64
    feasible: np.ndarray            # (N,) bool

    def __len__(self) -> int:
        return int(self.F.shape[0])


def cuda_info_batch(threads, *,
                    regs_per_thread,
                    shmem_per_block,
                    o_fl: float = 1.0,
                    o_mem: float = 1.0,
                    o_ctrl: float = 1.0,
                    o_reg: float = 1.0,
                    spec: GpuSpec) -> CudaBatchStaticInfo:
    """Vectorized :func:`cuda_info` over a whole thread-size lattice.

    ``threads`` (and, if per-config, ``regs_per_thread`` /
    ``shmem_per_block``) are (N,) arrays — typically the ``threads``
    column of `SearchSpace.enumerate_lattice`; the occupancy pass is
    one `cuda_occupancy_batch` call and the instruction-class counts
    broadcast, so ranking a GPU space is array math end to end, just
    like the TPU path.
    """
    t = np.atleast_1d(np.asarray(threads, dtype=np.int64))
    occ = cuda_occupancy_batch(t, regs_per_thread, shmem_per_block, spec)
    n = len(occ)
    serial = _cuda_serial_seconds(float(o_fl), float(o_mem), float(o_ctrl),
                                  float(o_reg), spec)
    pipe = serial / np.maximum(occ.occupancy, _CUDA_OCC_FLOOR)
    tb = np.broadcast_to(t, (n,))
    feasible = (occ.active_blocks > 0) & (tb > 0) \
        & (tb <= spec.threads_per_block)
    col = lambda a: np.broadcast_to(np.asarray(a, dtype=np.float64), (n,))
    F = np.column_stack([col(o_fl), col(0.0), col(0.0), col(o_mem),
                         col(0.0), col(o_ctrl), col(o_reg)])
    return CudaBatchStaticInfo(F=F, occupancy=occ, pipe=pipe,
                               feasible=feasible)


# ---------------------------------------------------------------------------
# Hopper static info (the H100 launch space of the port's CUDA kernels)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HopperBatchInfo:
    """Struct-of-arrays static info over N compiled-instantiation rows.

    Same field contract `rank_space` consumes from `BatchStaticInfo`:
    ``F`` (N, 7) in `features_matrix` column order, ``pipe`` the
    wave-stretched roofline time, ``feasible`` the card-limit mask.
    ``occupancy`` is the Eqs. 1-5 result per row (active blocks per SM,
    limiter), ``regs`` / ``smem`` the per-block resources fed to it.
    """

    F: np.ndarray                   # (N, 7) float64
    pipe: np.ndarray                # (N,) float64
    feasible: np.ndarray            # (N,) bool
    occupancy: CudaOccupancyBatch
    blocks: np.ndarray              # (N,) int64 grid size per launch
    regs: np.ndarray                # (N,) int64 declared regs/thread
    smem: np.ndarray                # (N,) int64 shared bytes per block

    def __len__(self) -> int:
        return int(self.F.shape[0])


def hopper_info_batch(*, blocks, threads, regs, smem, flops,
                      trans=0.0, hbm_bytes, smem_bytes=0.0, launches=1,
                      busy_threads=None,
                      spec: HopperSpec) -> HopperBatchInfo:
    """Price N launch configurations of one CUDA kernel on ``spec``.

    Inputs are scalars or (N,) arrays: the grid size and threads per
    block of one launch, the declared registers per thread and shared
    bytes per block of the instantiation, and the whole op's FP32
    ``flops``, special-function ``trans`` results, device-memory
    ``hbm_bytes``, shared-memory ``smem_bytes`` traffic and number of
    kernel ``launches``; ``busy_threads`` (default ``threads``) counts
    the threads of a block that do work, where a kernel idles part of a
    block on a short grid dimension.

    * Feasibility and active blocks per SM come from Eqs. 1-5
      (`cuda_occupancy_batch`) over the per-block footprint (shared
      bytes plus the driver's reserved kilobyte).
    * The work time is the roofline of `default_hopper_model` — compute
      overlaps memory — stretched by wave quantization over the SMs:
      with ``slots = SMs x active`` a grid of at least ``slots`` blocks
      pays its partial last wave (``ceil(blocks/slots) * slots /
      blocks``); a smaller grid leaves ``SMs - blocks`` SMs idle
      (``SMs / min(blocks, SMs)``).
    * A busy SM holding fewer warps than ``spec.latency_warps`` cannot
      keep enough loads in flight: the work time is further divided by
      ``min(1, resident warps / latency_warps)``.
    * Each launch adds ``spec.launch_overhead_s``, unstretched.
    """
    if busy_threads is None:
        busy_threads = threads
    n = int(np.broadcast_shapes(*(np.shape(np.asarray(a)) for a in (
        blocks, threads, regs, smem, flops, trans, hbm_bytes, smem_bytes,
        launches, busy_threads)), (1,))[0])
    vec = lambda a, dt: np.ascontiguousarray(
        np.broadcast_to(np.asarray(a, dtype=dt), (n,)))
    blocks = vec(blocks, np.int64)
    threads = vec(threads, np.int64)
    regs = vec(regs, np.int64)
    smem = vec(smem, np.int64)
    occ = cuda_occupancy_batch(threads, regs,
                               smem + spec.shmem_reserved_per_block, spec)
    feasible = ((occ.active_blocks > 0) & (threads > 0)
                & (threads <= spec.threads_per_block)
                & (smem <= spec.shmem_per_block))
    flops = vec(flops, np.float64)
    trans = vec(trans, np.float64)
    hbm = vec(hbm_bytes, np.float64)
    shm = vec(smem_bytes, np.float64)
    launches = vec(launches, np.float64)
    compute = flops / spec.fp32_flops + trans / spec.sfu_rate
    memory = hbm / spec.hbm_bw + shm / spec.smem_bw
    work = np.maximum(compute, memory)
    sms = spec.multiprocessors
    active = np.maximum(occ.active_blocks, 1)
    slots = active * sms
    waves = -(-blocks // slots)
    bl = np.maximum(blocks, 1).astype(np.float64)
    stretch = np.where(blocks >= slots, waves * slots / bl,
                       sms / np.minimum(bl, sms))
    # latency hiding: warps resident on a busy SM against the warps it
    # needs to keep its share of loads in flight (Eq. 2's occupancy in
    # units of the card's latency_warps)
    per_sm = np.minimum(active, -(-blocks // sms))
    busy = vec(busy_threads, np.int64)
    warps = per_sm * -(-busy // spec.threads_per_warp)
    hide = np.minimum(1.0, warps / float(spec.latency_warps))
    pipe = np.where(feasible, work * stretch / np.maximum(hide, 1e-9)
                    + launches * spec.launch_overhead_s, np.inf)
    zero = np.zeros(n)
    F = np.column_stack([zero, flops, trans, hbm, shm, launches, zero])
    return HopperBatchInfo(F=F, pipe=pipe, feasible=feasible,
                           occupancy=occ, blocks=blocks, regs=regs,
                           smem=smem)
