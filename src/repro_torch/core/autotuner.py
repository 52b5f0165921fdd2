"""Autotuner (the Orio-integration layer, paper §III-C / §IV-C).

Two tuners:

* :class:`KernelTuner` — tunes one kernel's launch configuration.  Modes:

  - ``static``     zero executions: rank by the predictive model +
                   occupancy feasibility, return the model argmin
                   (the paper's headline capability),
  - ``hybrid``     static shortlist, then empirically time the top-k
                   (the paper's "first stage of regular autotuning"),
  - ``empirical``  classic Orio: a search strategy over measured times.

  Under a `TpuSpec` it ranks the Pallas block space exactly as the
  reference does (same model, rule, cache key).  Under a `HopperSpec`
  it ranks the kernel's compiled tile table (``{"tile": ...}``, from
  `repro_torch.kernels.api.KernelSpec.tunable`) with
  `default_hopper_model`, and the winner is what launches.  A `GpuSpec`
  (the paper's Table I parts) raises the reference's TypeError: those
  targets rank through `repro_torch.tuning_cache.lookup_or_tune`.

  The paper's intensity rule (`make_intensity_rule`) is not applied
  under the H100: its default ``size_axes`` there is empty.  The
  reference picks the axes whose name holds "tile", which under the
  H100 is the axis of compiled instantiations — names like "t512r2"
  whose sorted order is no size order — and the rule's threshold of
  4.0 FLOPs per memory operation is a TPU number.  Ordering tiles by
  threads per block instead would drop half of a table the model ranks
  in under a millisecond, and would decide in advance the very question
  the paper's Fig. 4 asks (do atax and BiCG prefer few threads?).
  Under a TPU target the rule is the reference's, bit for bit.

* :meth:`GraphTuner.tune_config` — graph-level pretune of one serving
  config: enumerate every ``(kernel_id, signature)`` instance prefill
  and one decode step dispatch, then rank each through
  `repro_torch.tuning_cache.lookup_or_tune` — zero kernel executions.

Empirical timing protocol (DESIGN.md §8): one warm-up call, then the
median of ``repeats`` timed calls.  On the card each call is fenced by
its own pair of ``torch.cuda.Event(enable_timing=True)``, recorded
behind a short device-side spin (``torch.cuda._sleep``) that keeps the
stream busy while the host enqueues the call: without it the events
would also time the host's launch latency (tens of microseconds, as
much as a whole 0.1 ms kernel's spread).  On the CPU a call is timed
with ``perf_counter``.  L2 is not flushed between repeats: a
memory-bound kernel whose operands fit the card's 50 MB L2 is then timed
against the cache, so measure such kernels at sizes above L2.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import logging

import numpy as np

from repro_torch.core.hw import HopperSpec, require_tpu, resolve_target
from repro_torch.core.mix import (InstructionMix, classify_boundedness,
                                  intensity)
from repro_torch.core.occupancy import TpuOccupancy
from repro_torch.core.predict import (CostModel, default_hopper_model,
                                      default_tpu_model, spearman,
                                      static_times_batch)
from repro_torch.core.search import (ExhaustiveSearch, Params, SearchResult,
                                     SearchSpace, StaticPrunedSearch, _Base)
from repro_torch.core.target import use_target

_log = logging.getLogger(__name__)

__all__ = [
    "KernelStaticInfo", "TunableKernel", "TuningReport",
    "KernelTuner", "GraphTuner", "make_intensity_rule",
]


@dataclasses.dataclass
class KernelStaticInfo:
    """Everything the static analyzer derives for one configuration."""

    mix: InstructionMix
    occupancy: Optional[TpuOccupancy] = None

    def feasible(self) -> bool:
        return self.occupancy is None or self.occupancy.fits_vmem

    def static_time(self, model: CostModel) -> float:
        """Predicted seconds; infeasible configs get +inf."""
        if not self.feasible():
            return math.inf
        t_model = model.time(self.mix)
        if self.occupancy is not None:
            t_pipe = (self.occupancy.predicted_step_time
                      * max(self.occupancy.grid_steps, 1))
            return max(t_model, t_pipe)
        return t_model


@dataclasses.dataclass
class TunableKernel:
    """A kernel + its tuning space (what an Orio annotation declares).

    ``static_info_batch``, when provided, is the struct-of-arrays
    analyzer: a dict of (N,) value columns in, a batch info with ``F``,
    ``pipe`` and ``feasible`` rows out, matching ``static_info`` row for
    row.  ``target`` is the chip the space was built for (the TPU block
    space or the H100 tile table); `KernelTuner` tunes for it unless
    told otherwise.
    """

    name: str
    space: SearchSpace
    build: Callable[[Params], Callable[..., Any]]
    static_info: Callable[[Params], Any]
    make_inputs: Callable[[], tuple]
    reference: Optional[Callable[..., Any]] = None
    static_info_batch: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None
    target: Any = None


@dataclasses.dataclass
class TuningReport:
    kernel: str
    mode: str
    best_params: Params
    best_predicted_s: float
    best_measured_s: Optional[float]
    space_size: int
    static_rank_time_s: float          # cost of the static pass itself
    empirical_evals: int
    search_space_reduction: float      # Fig. 6 metric
    spearman_static_vs_measured: Optional[float]
    boundedness: str
    intensity: float
    table: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    from_cache: bool = False           # served from the tuning database

    def summary(self) -> str:
        sp = ("%.3f" % self.spearman_static_vs_measured
              if self.spearman_static_vs_measured is not None else "n/a")
        return (f"[{self.kernel}:{self.mode}] best={self.best_params} "
                f"pred={self.best_predicted_s:.3e}s "
                f"evals={self.empirical_evals}/{self.space_size} "
                f"reduction={100*self.search_space_reduction:.1f}% "
                f"spearman={sp} {self.boundedness} I={self.intensity:.2f}")


def make_intensity_rule(mix: InstructionMix,
                        space: SearchSpace,
                        size_axes: Sequence[str],
                        threshold: float = 4.0) -> Callable[[Params], bool]:
    """The paper's rule-based heuristic (§III-C).

    intensity > threshold (compute-bound)  ⇒ keep the *upper* half of
    each size axis (bigger tiles feed the MXU);
    intensity ≤ threshold (memory-bound)   ⇒ keep the *lower* half
    (smaller tiles pipeline DMA better).
    """
    hot = intensity(mix) > threshold

    def rule(p: Params) -> bool:
        for ax in size_axes:
            vals = space.axes.get(ax)
            if not vals:
                continue
            order = sorted(vals)
            half = order[len(order) // 2:] if hot else order[:max(1, len(order) // 2)]
            if p[ax] not in half:
                return False
        return True

    return rule


def _device_of(inputs: tuple):
    for t in inputs:
        dev = getattr(t, "device", None)
        if dev is not None:
            return dev
    return None


# Device clock cycles the stream spins before each timed call (~0.5 ms
# at the H100's 1.98 GHz boost): longer than the host takes to enqueue
# one call of a port kernel.
_SPIN_CYCLES = 1_000_000


def _median_time(fn: Callable[..., Any], inputs: tuple, repeats: int) -> float:
    """Median seconds of ``repeats`` calls after one warm-up call: CUDA
    events around each call on the card (behind a device-side spin, so
    the host's launch latency is not timed), ``perf_counter`` on the
    CPU."""
    import torch
    dev = _device_of(inputs)
    if dev is not None and dev.type == "cuda":
        fn(*inputs)
        torch.cuda.synchronize(dev)
        ts = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SPIN_CYCLES)
            start.record()
            fn(*inputs)
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) * 1e-3)
        return float(np.median(ts))
    fn(*inputs)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*inputs)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


class KernelTuner:
    """Tunes one kernel; results persist in the tuning database.

    ``db`` controls result reuse: the default sentinel ``"default"``
    resolves to :func:`repro_torch.tuning_cache.get_default_db`,
    ``None`` disables caching, and any
    :class:`~repro_torch.tuning_cache.TuningDatabase` is used as-is.  On
    a cache hit :meth:`tune` returns without a single cost-model
    evaluation.

    ``spec`` defaults to the kernel's own target, else the process
    default.  Under a `HopperSpec` the default ``size_axes`` is empty, so
    the paper's intensity rule keeps every tile (see the module
    docstring for why).
    """

    def __init__(self, kernel: TunableKernel,
                 model: Optional[CostModel] = None,
                 spec: Any = None,
                 repeats: int = 5,
                 keep_frac: float = 0.125,
                 use_rule: bool = True,
                 size_axes: Optional[Sequence[str]] = None,
                 seed: int = 0,
                 db: Any = "default"):
        self.kernel = kernel
        spec = resolve_target(spec if spec is not None else kernel.target)
        self.hopper = isinstance(spec, HopperSpec)
        # KernelTuner drives the Pallas pipeline model or the H100
        # roofline; a GpuSpec target fails here with the family-check
        # error (GPU rankings go through lookup_or_tune)
        self.spec = spec if self.hopper else require_tpu(
            spec, type(self).__name__)
        if kernel.target is not None and \
                isinstance(resolve_target(kernel.target), HopperSpec) \
                != self.hopper:
            raise ValueError(
                f"kernel {kernel.name!r} was packaged for "
                f"{resolve_target(kernel.target).name!r}, whose space "
                f"does not name launch params for {self.spec.name!r}; "
                f"build it again for this target")
        if model is None:
            model = (default_hopper_model(self.spec) if self.hopper
                     else default_tpu_model(self.spec, mode="max"))
        self.model = model
        self.repeats = repeats
        self.keep_frac = keep_frac
        self.use_rule = use_rule
        if size_axes:
            self.size_axes = list(size_axes)
        elif self.hopper:
            self.size_axes = []
        else:
            self.size_axes = [
                a for a in kernel.space.names
                if a.startswith("b") or "block" in a or "tile" in a]
        self.seed = seed
        self.db = db
        self._info_cache: Dict[Tuple, Any] = {}

    # -- static machinery ----------------------------------------------------
    # Kernel-supplied static_info builders resolve their own spec from
    # the default target, so every analysis call runs under
    # `use_target(self.spec)`.
    def _info(self, p: Params):
        key = tuple(str(p[k]) for k in self.kernel.space.names)
        if key not in self._info_cache:
            with use_target(self.spec):
                self._info_cache[key] = self.kernel.static_info(p)
        return self._info_cache[key]

    def static_cost(self, p: Params) -> float:
        return self._info(p).static_time(self.model)

    def static_cost_batch(self, pts: Sequence[Params]) -> np.ndarray:
        """Score a candidate set in one vectorized model pass (the
        struct-of-arrays builder when the kernel has one, else the
        scalar analyzer per point)."""
        if self.kernel.static_info_batch is not None:
            cols = {k: np.asarray([p[k] for p in pts])
                    for k in self.kernel.space.names}
            with use_target(self.spec):
                b = self.kernel.static_info_batch(cols)
            return static_times_batch(None, self.model, F=b.F, pipe=b.pipe,
                                      feasible=b.feasible)
        return static_times_batch([self._info(p) for p in pts], self.model)

    def static_cost_cols(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        """Columns-based scorer for the streaming shortlist."""
        if self.kernel.static_info_batch is None:
            raise TypeError(
                f"kernel {self.kernel.name!r} has no static_info_batch; "
                "the streaming shortlist needs a columns analyzer")
        with use_target(self.spec):
            b = self.kernel.static_info_batch(cols)
        return static_times_batch(None, self.model, F=b.F, pipe=b.pipe,
                                  feasible=b.feasible)

    def _mid_params(self) -> Params:
        mid = {k: v[len(v) // 2] for k, v in self.kernel.space.axes.items()}
        # a joint (variant, tile) table pairs each variant with its own
        # tiles only: the middle row of each axis may name no launch
        space = self.kernel.space
        if self.hopper and not space.satisfies(mid):
            pts = space.enumerate()
            mid = pts[len(pts) // 2]
        return mid

    def representative_mix(self) -> InstructionMix:
        return self._info(self._mid_params()).mix

    def _classify(self, mix: InstructionMix) -> Tuple[str, float]:
        """(boundedness, intensity).  Under a `HopperSpec` the intensity
        is FLOPs per device-memory byte and the threshold the card's
        ridge point (FP32 rate over memory rate); on a TPU, the paper's
        FLOPs per memory operation against its threshold of 4.0."""
        if not self.hopper:
            return classify_boundedness(mix), intensity(mix)
        inten = mix.flops_total / max(1.0, mix.hbm_bytes)
        ridge = self.spec.fp32_flops / self.spec.hbm_bw
        if inten > ridge:
            return "compute_bound", inten
        return ("balanced" if inten > ridge / 2 else "memory_bound"), inten

    # -- tuning-database plumbing ---------------------------------------------
    def _database(self):
        if self.db == "default":
            from repro_torch.tuning_cache import get_default_db
            return get_default_db()
        return self.db

    def _analysis_fingerprint(self) -> str:
        """Static-analysis identity of the kernel instance (the
        mid-config mix + step time reflect every analytic input)."""
        info = self._info(self._mid_params())
        parts = [repr(float(getattr(info.mix, f))) for f in (
            "mxu_flops", "vpu_flops", "trans_flops", "hbm_bytes",
            "vmem_bytes", "ctrl_ops", "reg_ops")]
        if info.occupancy is not None:
            parts.append(repr(float(info.occupancy.predicted_step_time)))
            parts.append(repr(int(info.occupancy.grid_steps)))
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]

    def _cache_key(self, mode: str, empirical_budget: Optional[int],
                   strategy: Optional[_Base]):
        from repro_torch.tuning_cache import make_key
        return make_key(
            f"tuner/{self.kernel.name}", spec=self.spec, mode=mode,
            model_name=self.model.fingerprint(),
            analysis=self._analysis_fingerprint(),
            axes={k: list(map(str, v))
                  for k, v in self.kernel.space.axes.items()},
            keep_frac=self.keep_frac, use_rule=self.use_rule,
            size_axes=list(self.size_axes), repeats=self.repeats,
            empirical_budget=empirical_budget,
            # full strategy config (primitive attrs only: object reprs
            # embed memory addresses)
            strategy=(type(strategy).__name__
                      + repr(sorted(
                          (k, v) for k, v in vars(strategy).items()
                          if isinstance(v, (int, float, str, bool,
                                            type(None)))))
                      if strategy else None))

    def _report_from_record(self, rec, mode: str) -> "TuningReport":
        ex = rec.extras
        return TuningReport(
            kernel=self.kernel.name, mode=mode,
            best_params=dict(rec.params),
            best_predicted_s=rec.predicted_s,
            best_measured_s=rec.measured_s,
            space_size=rec.space_size,
            static_rank_time_s=0.0,
            empirical_evals=0,
            search_space_reduction=ex.get("search_space_reduction", 1.0),
            spearman_static_vs_measured=ex.get("spearman"),
            boundedness=ex.get("boundedness", "unknown"),
            intensity=ex.get("intensity", 0.0),
            from_cache=True)

    # -- tuning modes ----------------------------------------------------------
    def tune(self, mode: str = "static",
             strategy: Optional[_Base] = None,
             empirical_budget: Optional[int] = None) -> TuningReport:
        db = self._database()
        key = self._cache_key(mode, empirical_budget, strategy) \
            if db is not None else None
        if db is not None:
            rec = db.lookup(key)
            if rec is not None:
                return self._report_from_record(rec, mode)
        space = self.kernel.space
        mix0 = self.representative_mix()
        rule = (make_intensity_rule(mix0, space, self.size_axes)
                if self.use_rule else None)
        t0 = time.perf_counter()

        def objective(p: Params) -> float:
            fn = self.kernel.build(p)
            return _median_time(fn, self.kernel.make_inputs(), self.repeats)

        table: List[Dict[str, Any]] = []
        measured_for_corr: List[float] = []
        predicted_for_corr: List[float] = []

        cols_scorer = (self.static_cost_cols
                       if self.kernel.static_info_batch is not None else None)
        if mode == "static":
            pruner = StaticPrunedSearch(self.static_cost,
                                        keep_frac=self.keep_frac,
                                        rule=rule, seed=self.seed,
                                        static_cost_batch=self.static_cost_batch,
                                        static_cost_cols=cols_scorer)
            res = pruner.minimize(objective, space, empirical_budget=0)
            static_time = time.perf_counter() - t0
            best_pred = res.best_value
            best_meas = None
        elif mode == "hybrid":
            pruner = StaticPrunedSearch(self.static_cost,
                                        keep_frac=self.keep_frac,
                                        rule=rule, seed=self.seed,
                                        static_cost_batch=self.static_cost_batch,
                                        static_cost_cols=cols_scorer)
            short = pruner.shortlist(space)
            static_time = time.perf_counter() - t0
            cap = empirical_budget or len(short)
            hist = []
            for p, pred in short[:cap]:
                meas = objective(p)
                hist.append((p, meas))
                predicted_for_corr.append(pred)
                measured_for_corr.append(meas)
                table.append({"params": p, "predicted_s": pred,
                              "measured_s": meas})
            best_p, best_meas = min(hist, key=lambda t: t[1])
            best_pred = self.static_cost(best_p)
            res = SearchResult(best_p, best_meas, len(hist), space.size,
                               len(short), hist)
        elif mode == "empirical":
            strat = strategy or ExhaustiveSearch(seed=self.seed)
            res = strat.minimize(objective, space, budget=empirical_budget)
            static_time = 0.0
            best_pred = self.static_cost(res.best_params)
            best_meas = res.best_value
            for p, v in res.history:
                predicted_for_corr.append(self.static_cost(p))
                measured_for_corr.append(v)
                table.append({"params": p,
                              "predicted_s": predicted_for_corr[-1],
                              "measured_s": v})
        else:
            raise ValueError(f"unknown mode {mode!r}")

        corr = (spearman(predicted_for_corr, measured_for_corr)
                if len(measured_for_corr) >= 3 else None)
        bound, inten = self._classify(self._info(res.best_params).mix)
        report = TuningReport(
            kernel=self.kernel.name, mode=mode,
            best_params=res.best_params,
            best_predicted_s=float(best_pred),
            best_measured_s=best_meas,
            space_size=space.size,
            static_rank_time_s=static_time,
            empirical_evals=res.evaluations,
            search_space_reduction=res.search_space_reduction,
            spearman_static_vs_measured=corr,
            boundedness=bound,
            intensity=inten,
            table=table,
        )
        if db is not None:
            from repro_torch.tuning_cache import TuningRecord
            from repro_torch.tuning_cache.store import now_unix
            db.put(TuningRecord(
                key=key, params=dict(report.best_params),
                predicted_s=report.best_predicted_s,
                measured_s=report.best_measured_s,
                space_size=report.space_size, source=mode,
                created_unix=now_unix(),
                extras={
                    "search_space_reduction": report.search_space_reduction,
                    "spearman": report.spearman_static_vs_measured,
                    "boundedness": report.boundedness,
                    "intensity": report.intensity,
                }))
        return report


@dataclasses.dataclass(frozen=True)
class LoweredStep:
    """The port's counterpart of a compiled step for `GraphTuner`: the
    per-device instruction mix and collective stats of a traced step
    (`repro_torch.launch.dryrun.lower_step`)."""

    mix: InstructionMix
    collectives: Any            # repro_torch.core.hlo.CollectiveStats
    comm_debug_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)   # CommDebugMode's, by collective
    memory: Optional[Dict[str, Any]] = None   # the trace's live bytes
    # the largest storages alive at the memory peak (`LiveBytes.at_peak`)
    peak_storages: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)


class GraphTuner:
    """Static (compile-only) tuner for graph-level knobs.

    ``lower_fn(params)`` returns either the reference's interface — an
    object whose ``.compile()`` result has ``.cost_analysis()`` and
    ``.as_text()`` (a ``jax.stages.Lowered``) — or the port's own
    `LoweredStep` (a traced step's mix and collectives, from
    `repro_torch.launch.dryrun.lower_step`).  Each candidate is scored
    with the 3-term roofline under ``spec``: a `TpuSpec` (the
    reference's terms, bit for bit) or the H100 (its NVLink collective
    term).  No device execution.

    ``db`` + ``cache_signature`` opt into the tuning database: because
    ``lower_fn`` is an opaque callable, the caller must supply the
    signature kwargs (arch name, batch, seq, ...) that make the result
    reusable.  A cached hit skips every lowering and returns ``(params,
    terms, [])`` with terms rebuilt as a `RooflineTerms` (or ``None`` if
    the stored record cannot be rebuilt); history is not cached.
    """

    def __init__(self, space: SearchSpace,
                 lower_fn: Callable[[Params], Any],
                 chips: int, model_flops: float,
                 spec=None, ici_links: Optional[int] = None,
                 db: Any = None,
                 cache_signature: Optional[Dict[str, Any]] = None):
        self.space = space
        self.lower_fn = lower_fn
        self.chips = chips
        self.model_flops = model_flops
        spec = resolve_target(spec)
        if isinstance(spec, HopperSpec):
            self.spec = spec
            default_links = spec.nvlink_links
        else:
            self.spec = require_tpu(spec, type(self).__name__)
            default_links = self.spec.ici_links
        self.ici_links = default_links if ici_links is None else ici_links
        self.db = db
        self.cache_signature = cache_signature

    def score(self, p: Params) -> Tuple[float, Any]:
        from repro_torch.core.roofline import roofline_from_artifacts
        lowered = self.lower_fn(p)
        if isinstance(lowered, LoweredStep):
            terms = roofline_from_artifacts(
                name=str(p), cost={}, hlo_text=None, chips=self.chips,
                model_flops=self.model_flops, spec=self.spec,
                ici_links=self.ici_links, collectives=lowered.collectives,
                mix=lowered.mix)
        else:
            compiled = lowered.compile()
            cost = compiled.cost_analysis() or {}
            text = compiled.as_text()
            terms = roofline_from_artifacts(
                name=str(p), cost=cost, hlo_text=text, chips=self.chips,
                model_flops=self.model_flops, spec=self.spec,
                ici_links=self.ici_links)
        t = max(terms.t_compute, terms.t_memory, terms.t_collective)
        return t, terms

    def _cache_key(self):
        if self.db is None or self.cache_signature is None:
            return None
        from repro_torch.tuning_cache import make_key
        return make_key(
            "graph", spec=self.spec, mode="graph",
            chips=self.chips, model_flops=self.model_flops,
            ici_links=self.ici_links,
            axes={k: list(map(str, v)) for k, v in self.space.axes.items()},
            **self.cache_signature)

    def tune(self) -> Tuple[Params, Any, List[Tuple[Params, float]]]:
        key = self._cache_key()
        if key is not None:
            rec = self.db.lookup(key)
            if rec is not None:
                terms = rec.extras.get("terms")
                if isinstance(terms, dict):
                    # rebuild the dataclass so hit and miss return the
                    # same type (callers access .t_compute etc.)
                    from repro_torch.core.roofline import RooflineTerms
                    try:
                        terms = RooflineTerms(**terms)
                    except TypeError:
                        terms = None
                return dict(rec.params), terms, []
        hist: List[Tuple[Params, float]] = []
        best_p, best_t, best_terms = None, math.inf, None
        for p in self.space.enumerate():
            try:
                t, terms = self.score(p)
            except (ValueError, TypeError, LookupError, RuntimeError,
                    ArithmeticError, AssertionError) as e:
                # an infeasible candidate (unshardable layout, a lowering
                # that fails): scored +inf, never wins; logged so a
                # sharding that always loses is diagnosable
                _log.debug("GraphTuner: candidate %s infeasible: %s",
                           p, e, exc_info=True)
                hist.append((p, math.inf))
                continue
            hist.append((p, t))
            if t < best_t:
                best_p, best_t, best_terms = p, t, terms
        if key is not None and best_p is not None:
            from repro_torch.tuning_cache import TuningRecord
            from repro_torch.tuning_cache.store import now_unix
            terms_d = (dataclasses.asdict(best_terms)
                       if dataclasses.is_dataclass(best_terms) else None)
            self.db.put(TuningRecord(
                key=key, params=dict(best_p), predicted_s=float(best_t),
                space_size=self.space.size, source="graph",
                created_unix=now_unix(), extras={"terms": terms_d}))
        return best_p, best_terms, hist

    @classmethod
    def tune_config(cls, cfg, *, batch: int = 2, prompt_len: int = 64,
                    decode: bool = True, spec=None, db=None,
                    mode: str = "static",
                    tune: bool = True) -> Dict[str, Any]:
        """Enumerate and rank every kernel instance of one serving config.

        The enumeration builds parameters and the token batch on the
        ``meta`` device and runs prefill (and, with ``decode=True``, one
        decode step) under tuned layers with dispatch collection on:
        every op records its signature and returns an empty ``meta``
        tensor of its output shape, so no kernel runs and no memory is
        allocated.  Each distinct instance then resolves through
        `repro_torch.tuning_cache.lookup_or_tune`.  Returns::

            {"config": name, "batch": B, "prompt_len": S,
             "instances": [{"kernel": id, "signature": {...},
                            "params": {...} | None}, ...],
             "dispatches": total_collected, "tuned": n_resolved}
        """
        import torch

        from repro_torch.distributed import make_serve_fns
        from repro_torch.kernels import api
        from repro_torch.models import build_model
        from repro_torch.models.layers import use_tuned_layers

        model = build_model(cfg)
        params = model.init(seed=0, device="meta")
        prefill, decode_step = make_serve_fns(model)
        inputs = {"tokens": torch.zeros((batch, prompt_len),
                                        dtype=torch.long, device="meta")}
        if cfg.frontend == "frames":
            inputs["frames"] = torch.zeros(
                (batch, cfg.enc_seq, cfg.d_model),
                dtype=getattr(torch, cfg.dtype), device="meta")
        with use_tuned_layers(), api.collect_dispatches() as col:
            _, cache = prefill(params, inputs)
            if decode:
                tok = torch.zeros((batch, 1), dtype=torch.long,
                                  device="meta")
                decode_step(params, cache, tok)
        # dedup preserving first-seen order (layers repeat instances)
        seen: Dict[Any, Dict[str, Any]] = {}
        for kid, sig in col:
            k = (kid, tuple(sorted(sig.items())))
            if k not in seen:
                seen[k] = {"kernel": kid, "signature": sig,
                           "params": None}
        report = {"config": cfg.name, "batch": batch,
                  "prompt_len": prompt_len,
                  "instances": list(seen.values()),
                  "dispatches": len(col), "tuned": 0}
        if tune:
            from repro_torch.tuning_cache import lookup_or_tune
            for inst in report["instances"]:
                kw = {} if db is None else {"db": db}
                inst["params"] = lookup_or_tune(
                    inst["kernel"], spec=spec, mode=mode, **kw,
                    **inst["signature"])
                report["tuned"] += 1
        return report
