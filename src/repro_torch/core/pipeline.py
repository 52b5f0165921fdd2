"""Pipeline cost-model tier: abstract streams + in-order scoreboard.

Eq. 6 prices instruction *counts*; this tier prices *schedules*.  A
candidate configuration is lowered to an abstract per-iteration
instruction stream (`InstructionStream`: one `StreamOp` segment per
instruction class, with explicit producer->consumer dependences), and
a greedy in-order scoreboard simulator (`simulate`) prices the stream
against the chip family's `repro_torch.core.isa.IsaTable`:

* **per-pipe busy-until cycles** — a segment of N instructions holds
  its pipe for ``N x issue`` cycles; different classes on different
  pipes overlap,
* **register-writeback scoreboard** — a consumer cannot issue before
  its producer's result-ready cycle (``issue end + latency``); the
  wait is recorded as a per-pipe dependence stall,
* **memory barrier slots** — at most ``IsaTable.barrier_slots``
  memory results may be outstanding; a further memory op waits for the
  oldest to land (SASSOverlay's WR/RD barrier counters),
* **dual-issue pairing** — adjacent dual-issue-eligible segments on
  different pipes co-issue (the program-order floor relaxes),
* **occupancy-driven interleave** — ``concurrency`` contexts (CUDA
  active warps from Eqs. 4-5 — on the H100 the resident warps per SM of
  the launch row —, double-buffered grid steps on TPU)
  hide yielding-producer latency (critical path / c) and, below the
  chip's saturation point, stretch issue bandwidth by the occupancy
  deficit — exactly the Eq. 2 ratio.

`PipelineModel` packages the tier as a *shortlist reranker*: the
vectorized Eq. 6 SoA path (its ``base`` cost model) produces a top-K
shortlist bit-identically to `StaticPrunedSearch`, then `simulate`
reranks only those K candidates (`registry._rank_space_pipeline`).
Selected via ``model="pipeline"`` — see DESIGN.md §16.

This module must stay importable from `repro.tuning_cache.registry`
without touching `repro.kernels` (which imports the registry): info
objects are duck-typed (``.mix`` / ``.occupancy`` / ``.cuda`` /
``.feasible()``), never isinstance-checked against kernel classes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, \
    Tuple, Union

from repro_torch.core.hw import ChipSpec, GpuSpec, HopperSpec, resolve_target
from repro_torch.core.isa import CLASSES, FEATURE_CLASS, IsaTable, isa_table_for
from repro_torch.core.predict import CostModel, default_cuda_model, \
    default_hopper_model, default_tpu_model

__all__ = [
    "StreamOp", "InstructionStream", "PipelineResult", "simulate",
    "synthesize_stream", "stream_of_info", "stream_from_hlo", "as_stream",
    "PipelineModel", "pipeline_model",
]


@dataclasses.dataclass(frozen=True)
class StreamOp:
    """One segment of an abstract stream: ``units`` feature units of one
    instruction class, optionally dependent on an earlier segment's
    result (``dep`` = its index in the stream)."""

    cls: str
    units: float
    dep: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class InstructionStream:
    """A per-iteration schedule: ``ops`` execute ``iterations`` times,
    with ``concurrency`` independent contexts in flight (active warps /
    double-buffered grid steps)."""

    ops: Tuple[StreamOp, ...]
    iterations: float = 1.0
    concurrency: float = 1.0


@dataclasses.dataclass(frozen=True)
class PipelineResult:
    """`simulate` output: total cycles/seconds plus the explainability
    breakdown (per-pipe busy and dependence-stall cycles for one
    iteration, single-context critical path, the limiting resource)."""

    cycles: float
    seconds: float
    per_pipe_busy: Dict[str, float]
    stalls: Dict[str, float]
    critical_path: float
    iterations: float
    concurrency: float
    limiter: str


# Deterministic class order for synthesized streams (the dataflow
# skeleton of a generic Pallas step: stream operands in, stage to
# VMEM, contract on the MXU, post-process on the VPU).
_CLASS_ORDER: Tuple[str, ...] = ("hbm", "vmem", "mxu", "vpu", "trans",
                                 "reg", "ctrl")
# class -> producers it consumes, most specific first.
_CLASS_DEPS: Dict[str, Tuple[str, ...]] = {
    "vmem": ("hbm",),
    "mxu": ("vmem", "hbm"),
    "vpu": ("mxu", "vmem", "hbm"),
    "trans": ("vpu", "mxu", "vmem", "hbm"),
    "reg": ("vpu", "mxu"),
}


def synthesize_stream(units: Mapping[str, float], *, iterations: float = 1.0,
                      concurrency: float = 1.0) -> InstructionStream:
    """Default stream extractor: one segment per instruction class with
    positive units, in deterministic `_CLASS_ORDER`, chained by the
    generic dataflow skeleton (`_CLASS_DEPS`)."""
    ops: List[StreamOp] = []
    at: Dict[str, int] = {}
    for cls in _CLASS_ORDER:
        u = float(units.get(cls, 0.0))
        if u <= 0.0:
            continue
        dep = next((at[d] for d in _CLASS_DEPS.get(cls, ()) if d in at),
                   None)
        at[cls] = len(ops)
        ops.append(StreamOp(cls, u, dep))
    return InstructionStream(tuple(ops), iterations=float(iterations),
                             concurrency=float(concurrency))


def _tpu_units(info: Any) -> Tuple[Dict[str, float], float, float]:
    """(per-iteration units, iterations, concurrency) for a TPU
    `KernelStaticInfo`-shaped object."""
    mix, occ = info.mix, getattr(info, "occupancy", None)
    iters = float(max(getattr(occ, "grid_steps", 1) or 1, 1))
    # padded lanes are issued work: inflate MXU/VPU units by the
    # alignment waste the occupancy model measured (Eq. 6 never sees
    # this — it is one of the signals the reranker adds).
    align = float(getattr(occ, "mxu_alignment", 1.0) or 1.0)
    align = min(max(align, 1e-6), 1.0)
    units = {
        "mxu": float(mix.mxu_flops) / align / iters,
        "vpu": float(mix.vpu_flops) / align / iters,
        "trans": float(mix.trans_flops) / iters,
        "hbm": float(mix.hbm_bytes) / iters,
        "vmem": float(mix.vmem_bytes) / iters,
        "ctrl": float(mix.ctrl_ops) / iters,
        "reg": float(mix.reg_ops) / iters,
    }
    # double-buffered Pallas pipeline: the next step's (or next
    # chunk's, for single-step grids) DMA overlaps this step's
    # compute, so two contexts are always in flight.
    conc = 2.0
    return units, iters, conc


def _cuda_units(info: Any) -> Tuple[Dict[str, float], float, float]:
    """Same for a `CudaStaticInfo`-shaped object: whole-kernel class
    counts, interleaved by the Eq. 4-5 active-warp count."""
    mix = info.mix
    units = {
        "mxu": float(mix.mxu_flops),
        "hbm": float(mix.hbm_bytes),
        "ctrl": float(mix.ctrl_ops),
        "reg": float(mix.reg_ops),
        "vpu": float(mix.vpu_flops),
        "trans": float(mix.trans_flops),
        "vmem": float(mix.vmem_bytes),
    }
    conc = float(max(int(getattr(info.cuda, "active_warps", 1)), 1))
    return units, 1.0, conc


def _hopper_units(info: Any) -> Tuple[Dict[str, float], float, float]:
    """Same for a `HopperStaticInfo`-shaped object: the whole launch's
    H100 feature row (tensor-core flops, FP32 flops, special-function
    results, device and shared bytes, launches), interleaved by the
    row's resident warps per SM (its Eqs. 1-5 ``active_warps``)."""
    mix = info.mix
    units = {
        "mxu": float(mix.mxu_flops),
        "vpu": float(mix.vpu_flops),
        "trans": float(mix.trans_flops),
        "hbm": float(mix.hbm_bytes),
        "vmem": float(mix.vmem_bytes),
        "ctrl": float(mix.ctrl_ops),
        "reg": float(mix.reg_ops),
    }
    conc = float(max(int(getattr(info.hopper, "active_warps", 1)), 1))
    return units, 1.0, conc


def _units_of(info: Any) -> Tuple[Dict[str, float], float, float]:
    if getattr(info, "hopper", None) is not None:
        return _hopper_units(info)
    if getattr(info, "cuda", None) is not None:
        return _cuda_units(info)
    return _tpu_units(info)


def stream_of_info(info: Any) -> InstructionStream:
    """Lower a static-info object (TPU `KernelStaticInfo`, CUDA
    `CudaStaticInfo` or H100 `HopperStaticInfo`, duck-typed) to its
    default synthesized stream."""
    units, iters, conc = _units_of(info)
    return synthesize_stream(units, iterations=iters, concurrency=conc)


def as_stream(obj: Any, info: Any = None) -> InstructionStream:
    """Coerce a kernel ``schedule()`` hook's return value.

    Accepts an `InstructionStream` as-is, or an iterable of
    ``(cls, units)`` / ``(cls, units, dep)`` rows — ``dep`` names an
    earlier row's index (omitted = independent).  Iterations and
    concurrency default from ``info`` exactly as `stream_of_info`
    derives them.
    """
    if isinstance(obj, InstructionStream):
        return obj
    ops: List[StreamOp] = []
    for row in obj:
        if isinstance(row, StreamOp):
            ops.append(row)
            continue
        cls, units = row[0], float(row[1])
        dep = int(row[2]) if len(row) > 2 and row[2] is not None else None
        if cls not in CLASSES:
            raise ValueError(f"schedule row has unknown instruction class "
                             f"{cls!r}; expected one of {CLASSES}")
        if dep is not None and not (0 <= dep < len(ops)):
            raise ValueError(f"schedule row {len(ops)} depends on {dep}, "
                             f"which is not an earlier row")
        ops.append(StreamOp(cls, units, dep))
    iters, conc = 1.0, 1.0
    if info is not None:
        _, iters, conc = _units_of(info)
    return InstructionStream(tuple(ops), iterations=iters, concurrency=conc)


def simulate(stream: InstructionStream, table: IsaTable, *,
             concurrency: Optional[float] = None,
             saturation: Optional[float] = None) -> PipelineResult:
    """Greedy in-order scoreboard simulation of one stream.

    One pass prices a single iteration in cycles; ``concurrency``
    contexts interleave it (critical path / c, the Eq. 4-5 warp
    count), and below ``saturation`` contexts the issue bandwidth is
    stretched by the occupancy deficit (Eq. 2).  Stalls on producers
    that do not yield (in-order TPU compute) cannot be hidden and are
    added to the busy bound.
    """
    c = max(float(stream.concurrency if concurrency is None
                  else concurrency), 1.0)
    sat = max(float(c if saturation is None else saturation), 1.0)

    pipe_free: Dict[str, float] = {}
    busy: Dict[str, float] = {}
    stalls: Dict[str, float] = {}
    ready: List[float] = []          # per-op result-ready cycle
    yields: List[bool] = []          # per-op producer-yield flag
    outstanding: List[float] = []    # in-flight barrier'd memory results
    hard_stall = 0.0
    floor = 0.0                      # program-order issue floor
    t_end = 0.0
    prev: Optional[Tuple[float, Any]] = None   # (start, IsaOp) of prev op

    for sop in stream.ops:
        row = table.op(sop.cls)
        if sop.units <= 0.0:
            ready.append(floor)
            yields.append(row.yields)
            continue
        n = max(sop.units / row.work, 1.0)     # instructions in segment
        seg = n * row.issue                    # pipe occupancy cycles
        start_floor = floor
        if (prev is not None and row.dual_issue and prev[1].dual_issue
                and row.pipe != prev[1].pipe):
            start_floor = prev[0]              # co-issue with predecessor
        base = max(start_floor, pipe_free.get(row.pipe, 0.0))
        if row.barrier:
            # retire anything already landed, then wait for a slot
            outstanding = [t for t in outstanding if t > base]
            if len(outstanding) >= table.barrier_slots:
                oldest = min(outstanding)
                base = max(base, oldest)
                outstanding.remove(oldest)
        start = base
        if sop.dep is not None:
            dep_ready = ready[sop.dep]
            if dep_ready > start:
                st = dep_ready - start
                stalls[row.pipe] = stalls.get(row.pipe, 0.0) + st
                if not yields[sop.dep]:
                    hard_stall += st
                start = dep_ready
        end_issue = start + seg
        pipe_free[row.pipe] = end_issue
        busy[row.pipe] = busy.get(row.pipe, 0.0) + seg
        # last instruction of the segment issues at start+(n-1)*issue;
        # its result lands `latency` later
        res = start + (n - 1.0) * row.issue + row.latency
        ready.append(res)
        yields.append(row.yields)
        if row.barrier:
            outstanding.append(res)
        floor = end_issue
        t_end = max(t_end, end_issue, res)
        prev = (start, row)

    if not busy:
        return PipelineResult(0.0, 0.0, {}, {}, 0.0, stream.iterations, c,
                              "empty")
    busy_max = max(busy.values())
    bound = busy_max + hard_stall
    latency_bound = t_end / c
    single = max(bound, latency_bound)
    # below saturation the SM issues only on resident-warp slots:
    # bandwidth scales with c/sat (Eq. 2's occupancy ratio).
    single /= min(c / sat, 1.0)
    iters = max(float(stream.iterations), 1.0)
    cycles = single * iters
    if latency_bound > bound:
        limiter = "latency"
    else:
        limiter = max(busy, key=lambda p: busy[p])
    return PipelineResult(
        cycles=cycles, seconds=cycles / table.clock_hz,
        per_pipe_busy=dict(busy), stalls=dict(stalls),
        critical_path=t_end, iterations=iters, concurrency=c,
        limiter=limiter)


# ---------------------------------------------------------------------------
# HLO streams (compiled-artifact extraction)
# ---------------------------------------------------------------------------


def stream_from_hlo(text_or_module: Any) -> InstructionStream:
    """Extract a stream from compiled HLO text — the reference walks
    its `core.hlo` module tree.  This package has no HLO front end yet:
    the extraction tier (ROADMAP A5, `core/hlo.py`) is not ported, so
    this raises ``NotImplementedError``."""
    raise NotImplementedError(
        "stream_from_hlo needs the extraction tier (core/hlo.py, ROADMAP "
        "A5), which repro_torch does not have yet")


# ---------------------------------------------------------------------------
# The model wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PipelineModel:
    """The pipeline tier as a rankable model.

    Not a `CostModel` subclass on purpose: it prices *info objects*
    (which carry occupancy/schedule context), not bare feature rows.
    ``base`` is the Eq. 6 model that produces the top-``keep_n``
    shortlist (bit-identical to the plain path); `simulate` then
    reranks the shortlist.  `registry.rank_space` dispatches on this
    type.  ``fingerprint()`` is distinct from every `CostModel`
    fingerprint, so cache keys separate automatically.
    """

    base: CostModel
    table: IsaTable
    spec: ChipSpec
    keep_n: int = 64
    name: str = "pipeline"

    @property
    def mode(self) -> str:
        return getattr(self.base, "mode", "max")

    def fingerprint(self) -> str:
        fp = self.__dict__.get("_fp")
        if fp is None:
            h = hashlib.sha256()
            h.update(f"{self.base.fingerprint()}|{self.table.fingerprint()}"
                     f"|{self.keep_n}".encode())
            fp = f"{self.name}-{self.table.family}@{h.hexdigest()[:10]}"
            self.__dict__["_fp"] = fp
        return fp

    def result_of(self, info: Any,
                  schedule: Any = None) -> Optional[PipelineResult]:
        """Full simulation result for one config (None if infeasible)."""
        feasible = getattr(info, "feasible", None)
        if callable(feasible) and not feasible():
            return None
        if schedule is not None:
            stream = as_stream(schedule, info)
        else:
            stream = stream_of_info(info)
        sat = None
        if (getattr(info, "cuda", None) is not None
                or getattr(info, "hopper", None) is not None):
            sat = float(getattr(self.spec, "warps_per_mp", 0) or 0) or None
        return simulate(stream, self.table, saturation=sat)

    def time_info(self, info: Any, schedule: Any = None) -> float:
        """Predicted seconds for one config; +inf when infeasible."""
        res = self.result_of(info, schedule)
        return math.inf if res is None else res.seconds


def pipeline_model(spec: Optional[Union[str, ChipSpec]] = None, *,
                   base: Optional[CostModel] = None,
                   keep_n: int = 64) -> PipelineModel:
    """The default pipeline tier for a chip: family `IsaTable` +
    the family's Eq. 6 model (the H100 roofline under a `HopperSpec`)
    as the shortlist producer."""
    spec = resolve_target(spec)
    if base is None:
        if isinstance(spec, HopperSpec):
            base = default_hopper_model(spec)
        elif isinstance(spec, GpuSpec):
            base = default_cuda_model(spec)
        else:
            base = default_tpu_model(spec, mode="max")
    return PipelineModel(base=base, table=isa_table_for(spec), spec=spec,
                         keep_n=int(keep_n))
