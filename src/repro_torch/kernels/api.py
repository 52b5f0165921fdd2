"""`@tuned_kernel` — one declarative registration for the whole stack.

One declaration site per kernel::

    @tuned_kernel(
        "matmul",
        space={"bm": divisors("m", (...)), ...},     # the TPU block space
        signature=lambda a, b, **_: dict(m=..., n=..., k=...,
                                         dtype=dtype_name(a)),
        static_info=_matmul_analysis,                # TPU analyzer
        cuda=cuda_profile(...),                      # Table I GPUs
        hopper=HopperSpace(tiles=..., analysis=...), # the H100 launch space
        out=lambda a, b, **_: ((a.shape[0], b.shape[1]), a.dtype),
        make_inputs=_matmul_inputs,                  # (generator, **sig)
        reference=matmul_ref,
        pretune=(...),
    )
    def matmul(a, b, *, tile=None): ...

derives the dispatch wrapper (`KernelSpec.op`, re-exported as
``repro_torch.kernels.ops.<kernel_id>``), the registry entry consumed by
`repro_torch.tuning_cache.lookup_or_tune`, the fallback launch, and the
`TunableKernel` that `repro_torch.core.KernelTuner` tunes
(`KernelSpec.tunable`).

The space the registry ranks follows the active target
(`repro_torch.core.target.default_target`): a `TpuSpec` ranks the
declared Pallas block space exactly as the reference does, a `GpuSpec`
the CUDA thread-block lattice of the paper's Table I parts, and a
`HopperSpec` the ``hopper=`` space — the tile instantiations compiled
into the CUDA library, whose winner is what the wrapper launches.
Under a TPU or legacy GPU target the winner names no compiled tile, so
the wrapper launches its variant's own feasible fallback tile (the
counterpart of the reference wrapper running the fallback tiling for a
`GpuSpec`).

``space`` also accepts an Orio-style ``PerfTuning`` annotation string
(paper Fig. 3); see `repro_torch.core.annotations.parse_tuning_spec`.
A kernel declared outside this package (`register_spec`, or
``@tuned_kernel`` in the caller's own module) gets the same stack; its
CUDA source builds through `repro_torch.kernels._cuda.load_extension`.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import hashlib
import inspect
import logging
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch import tuning_cache
from repro_torch.core.annotations import parse_tuning_spec
from repro_torch.core.autotuner import TunableKernel
from repro_torch.core.hw import H100_SXM, GpuSpec, HopperSpec
from repro_torch.core.mix import InstructionMix
from repro_torch.core.occupancy import CudaOccupancy
from repro_torch.core import sass as _sass
from repro_torch.core.search import Constraint, Params, SearchSpace
from repro_torch.core.target import default_target
from repro_torch.kernels.common import (BatchStaticInfo, HopperBatchInfo,
                                        block_info, block_info_batch,
                                        cuda_info, cuda_info_batch,
                                        hopper_info_batch,
                                        pick_divisor_candidates,
                                        resolve_device)
from repro_torch.kernels.variants import (JointBatchInfo, KernelVariant,
                                          VARIANT_AXIS,
                                          check_variant_schema, joint_space,
                                          joint_static_info,
                                          joint_static_info_batch,
                                          variants_fingerprint)
from repro_torch.runtime import spans
from repro_torch.tuning_cache.binder import (SigBinder, compile_binder,
                                             schema_of)

__all__ = [
    "KernelSpec", "tuned_kernel", "divisors", "Divisors",
    "CudaProfile", "cuda_profile", "KernelVariant", "HopperSpace",
    "TILE_AXIS", "register_spec", "register_variant",
    "unregister_variant", "get_spec", "registered_kernels", "unregister",
    "reset_dispatch_failure_log",
    "dispatch_stats", "reset_dispatch_stats", "collect_dispatches",
]

_log = logging.getLogger(__name__)

# The H100 space's axis naming one compiled instantiation.
TILE_AXIS = "tile"


# ---------------------------------------------------------------------------
# Axis declarations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Divisors:
    """A tunable axis whose candidates must tile a signature dimension.

    At problem-construction time the candidate list is filtered to the
    values that divide ``signature[dim]`` (BlockSpec-exact tiling); if
    none divide, the dimension itself is the only candidate.
    """

    dim: str
    candidates: Tuple[int, ...]

    def materialize(self, signature: Mapping[str, Any]) -> Tuple[int, ...]:
        if self.dim not in signature:
            raise KeyError(
                f"axis is tied to signature dim {self.dim!r}, which the "
                f"signature {dict(signature)} does not carry")
        return pick_divisor_candidates(int(signature[self.dim]),
                                       self.candidates)


def divisors(dim: str, candidates: Sequence[int]) -> Divisors:
    """Declare an axis of block sizes that must divide ``dim``."""
    return Divisors(dim=dim, candidates=tuple(candidates))


class _Literal:
    """A fixed candidate tuple (signature-independent axis)."""

    __slots__ = ("values",)

    def __init__(self, values: Sequence[Any]):
        self.values = tuple(values)
        if not self.values:
            raise ValueError("literal axis needs at least one candidate")

    def materialize(self, signature: Mapping[str, Any]) -> Tuple[Any, ...]:
        return self.values


def _coerce_space(kernel_id: str, space) -> Dict[str, Any]:
    """Accept {name: Divisors | sequence} or an Orio annotation string."""
    if isinstance(space, str):
        space = {name: tuple(vals)
                 for name, vals in parse_tuning_spec(space).axes.items()}
    if not isinstance(space, Mapping) or not space:
        raise ValueError(
            f"@tuned_kernel({kernel_id!r}): space must declare at least "
            f"one tunable axis (a dict of axes or a PerfTuning "
            f"annotation string), got {space!r}")
    out: Dict[str, Any] = {}
    for name, axis in space.items():
        if isinstance(axis, Divisors):
            out[name] = axis
        elif isinstance(axis, (tuple, list)):
            out[name] = _Literal(axis)
        else:
            raise ValueError(
                f"@tuned_kernel({kernel_id!r}): axis {name!r} must be "
                f"divisors(...) or a sequence of candidates, "
                f"got {axis!r}")
    return out


# ---------------------------------------------------------------------------
# CUDA-side declaration (GpuSpec targets)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CudaProfile:
    """What the faithful CUDA models need to know about one kernel:
    register pressure R^u (flat or per `GpuSpec.family`), shared memory
    per block S^u, Eq. 6 instruction-class counts, and optional thread
    candidates (default: every warp multiple up to the block limit)."""

    regs: Union[int, Mapping[str, int]] = 32
    shmem_per_block: Union[int, Callable[..., int]] = 0
    workload: Optional[Callable[..., Mapping[str, float]]] = None
    threads: Optional[Tuple[int, ...]] = None

    _COUNTS = ("o_fl", "o_mem", "o_ctrl", "o_reg")

    def regs_for(self, gpu: GpuSpec) -> int:
        if isinstance(self.regs, Mapping):
            v = self.regs.get(gpu.family, self.regs.get("default"))
            return int(v if v is not None else max(self.regs.values()))
        return int(self.regs)

    def shmem_for(self, **signature) -> int:
        if callable(self.shmem_per_block):
            return int(self.shmem_per_block(**signature))
        return int(self.shmem_per_block)

    def counts(self, **signature) -> Dict[str, float]:
        out = dict.fromkeys(self._COUNTS, 1.0)
        if self.workload is not None:
            declared = dict(self.workload(**signature))
            unknown = set(declared) - set(self._COUNTS)
            if unknown:
                raise ValueError(
                    f"cuda workload returned unknown instruction "
                    f"classes {sorted(unknown)}; expected a subset of "
                    f"{list(self._COUNTS)}")
            out.update({k: float(v) for k, v in declared.items()})
        return out

    def thread_candidates(self, gpu: GpuSpec) -> Tuple[int, ...]:
        if self.threads is not None:
            return self.threads
        return tuple(range(gpu.warp_size, gpu.threads_per_block + 1,
                           gpu.warp_size))


def cuda_profile(**kwargs) -> CudaProfile:
    """Declare a kernel's CUDA-side analysis inputs (``cuda=``)."""
    return CudaProfile(**kwargs)


_GENERIC_CUDA = CudaProfile()


# ---------------------------------------------------------------------------
# Hopper-side declaration (the H100 launch space)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HopperSpace:
    """One implementation's H100 launch space.

    * ``tiles`` — the names of the tile instantiations compiled into the
      CUDA library for this implementation, in the C table's order
      (the tile's index there is its position here).
    * ``analysis(cols, **signature)`` — array-agnostic analyzer:
      ``cols[TILE_AXIS]`` is an (N,) array of tile names; returns the
      keyword arguments of
      `repro_torch.kernels.common.hopper_info_batch` (grid size,
      threads, declared registers, shared bytes, FLOPs, bytes, ...)
      for those rows, without the ``spec``.
    * ``symbols(tile, **signature)`` — the SASS functions one launch of
      the row runs, as `repro_torch.core.sass.template_symbol` prefixes,
      the kernel that does the row's work first (optional: a space
      without it has no SASS stream for the pipeline tier).
    """

    tiles: Tuple[str, ...]
    analysis: Callable[..., Dict[str, Any]]
    symbols: Optional[Callable[..., Tuple[str, ...]]] = None

    def info(self, tiles: Sequence[str], sig: Mapping[str, Any],
             spec: HopperSpec) -> HopperBatchInfo:
        cols = {TILE_AXIS: np.asarray(list(tiles))}
        return hopper_info_batch(**self.analysis(cols, **sig), spec=spec)


@dataclasses.dataclass(frozen=True)
class HopperStaticInfo:
    """Scalar view of one H100 row, duck-typed like `CudaStaticInfo`
    for `repro_torch.core.predict.static_times_batch` and like
    `KernelStaticInfo` for `repro_torch.core.KernelTuner`.  ``hopper``
    is the row's Eqs. 1-5 occupancy (resident blocks and warps per SM),
    which the pipeline tier interleaves the row's stream by."""

    mix: InstructionMix
    predicted_step_time: float
    ok: bool
    grid_steps: int = 1
    hopper: Optional[CudaOccupancy] = None

    @property
    def occupancy(self):
        return self

    def feasible(self) -> bool:
        return self.ok

    def static_time(self, model) -> float:
        """The row's `static_times_batch` value: the model time of its
        mix floored by its wave-stretched time; +inf when infeasible."""
        if not self.ok:
            return float("inf")
        return max(model.time(self.mix), self.predicted_step_time)


@dataclasses.dataclass
class SassRow:
    """One H100 row read from the disassembly (`KernelSpec.sass_row`):
    its kernels' SASS functions (the working kernel first), the main
    loop's trips per warp pass, the launch's warps, the bytes its TMA
    and bulk copies move, the row's H100 static info, and the census of
    the working kernel."""

    functions: Tuple[Any, ...]
    trips: Dict[int, float]
    warps: float
    tma_bytes: float
    info: "HopperStaticInfo"
    census: Any

    @property
    def function(self) -> Any:
        return self.functions[0]

    def stream(self):
        """The row's `repro_torch.core.pipeline.stream_from_sass`."""
        from repro_torch.core.pipeline import stream_from_sass
        return stream_from_sass(self.function, self.trips, warps=self.warps,
                                info=self.info, tma_bytes=self.tma_bytes)


# ---------------------------------------------------------------------------
# Dispatch accounting + graph enumeration (shared by every op wrapper)
# ---------------------------------------------------------------------------


class _DispatchStats:
    """Process-wide op-dispatch tier counters (plain increments)."""

    __slots__ = ("frozen", "live", "fallback", "explicit", "collected")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.frozen = 0         # frozen-table probe answered
        self.live = 0           # db/memo resolve answered in full
        self.fallback = 0       # the fallback launch filled gaps
        self.explicit = 0       # caller passed tuned_params=
        self.collected = 0      # recorded by collect_dispatches()

    def snapshot(self) -> Dict[str, int]:
        d = {"frozen": self.frozen, "live": self.live,
             "fallback": self.fallback, "explicit": self.explicit,
             "collected": self.collected}
        d["total"] = d["frozen"] + d["live"] + d["fallback"] + d["explicit"]
        return d


_STATS = _DispatchStats()


def dispatch_stats() -> Dict[str, int]:
    """Counters of how op dispatches resolved since the last reset:
    ``frozen`` / ``live`` / ``fallback`` / ``explicit`` (+ their sum
    ``total``) and ``collected`` (enumeration-only dispatches recorded
    under `collect_dispatches`, excluded from ``total``)."""
    return _STATS.snapshot()


def reset_dispatch_stats() -> None:
    _STATS.reset()


# the active collector: an object whose ``record(spec, signature, args,
# kwargs)`` takes an op dispatch in place of running it and returns its
# outputs (`collect_dispatches`; `repro_torch.core.mix.trace_fn`)
_COLLECT: "contextvars.ContextVar[Optional[Any]]" = \
    contextvars.ContextVar("repro_torch_collect_dispatches", default=None)


class _Dispatches(list):
    """`collect_dispatches`' collector: ``(kernel_id, signature)`` per
    dispatch, empty ``meta`` outputs."""

    def record(self, spec: "KernelSpec", sig: Dict[str, Any], args,
               kw) -> Any:
        self.append((spec.kernel_id, dict(sig)))
        return spec.meta_out(*args, **kw)


@contextlib.contextmanager
def collect_dispatches():
    """Record every op dispatch as ``(kernel_id, signature)`` instead of
    running it.

    While active, op wrappers append the extracted signature to the
    yielded list and return an empty ``meta`` tensor of their output
    shape — no database lookup, no tuning, no kernel.  Run a model's
    forward pass on ``meta`` tensors inside this context and the list is
    exactly the (kernel, shape, dtype) instance set runtime dispatch
    will ask for (`GraphTuner.tune_config`).
    """
    sink = _Dispatches()
    tok = _COLLECT.set(sink)
    try:
        yield sink
    finally:
        _COLLECT.reset(tok)


# kernel_ids whose dispatch failure already produced a full traceback;
# a persistently broken entry logs once per process.
_logged_dispatch_failures: set = set()
_failures_lock = threading.Lock()


def reset_dispatch_failure_log() -> None:
    """Forget which kernels already logged a dispatch failure (tests)."""
    with _failures_lock:
        _logged_dispatch_failures.clear()


tuning_cache.registry.on_dispatch_memo_clear(reset_dispatch_failure_log)


def _resolve(kernel_id: str, signature: Dict) -> Dict:
    """Launch-config lookup for the active hardware target; never
    raises (returns {} on failure so the fallback launch applies)."""
    try:
        return tuning_cache.lookup_or_tune(
            kernel_id, spec=default_target(), **signature)
    except Exception:
        with _failures_lock:
            first = kernel_id not in _logged_dispatch_failures
            if first:
                _logged_dispatch_failures.add(kernel_id)
        if first:
            _log.exception("tuning-cache dispatch failed for %s %s; "
                           "using the fallback launch (further failures "
                           "for this kernel log at DEBUG)",
                           kernel_id, signature)
        else:
            _log.debug("tuning-cache dispatch failed for %s %s; "
                       "using the fallback launch", kernel_id, signature)
        return {}


# ---------------------------------------------------------------------------
# KernelSpec
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelSpec:
    """Everything the tuning stack derives from one `@tuned_kernel`.

    * ``fn(*tensors, **op_kwargs, tile=...)`` — the primary
      implementation: launches the CUDA kernel ``tile`` for CUDA
      tensors, runs the plain PyTorch version for CPU tensors.
    * ``extract_signature(*args, **kwargs) -> dict`` — shape/dtype
      signature of a call (dtypes in numpy spelling).
    * ``analysis(p, **signature) -> dict`` — the reference's TPU
      analyzer (`block_info` kwargs); its keyword parameters *are* the
      signature schema.
    * ``hopper`` — the H100 launch space: one `HopperSpace`, or, with
      variants, ``{variant_id: HopperSpace}``.
    * ``out(*args, **kwargs) -> (shape, dtype)`` — the output of a call
      (a list of such pairs for several outputs), for the
      enumeration-only ``meta`` dispatch.
    * ``make_inputs(generator, **signature) -> tuple`` — random inputs
      for empirical/hybrid tuning, made on ``generator``'s device
      (optional; static-only kernels may omit it).
    * ``reference`` — the plain-PyTorch oracle (optional).
    * ``constraints`` — feasibility predicates over the declared axes
      (`Constraint`s or bare columns->mask callables, or one
      ``(**signature) -> sequence`` factory), as the reference's.  They
      restrict the TPU block space only: the H100 tile table is its own
      lattice of compiled instantiations, as the CUDA threads space is
      in the reference.
    * ``chunk_size`` — preferred `rank_space` streaming chunk (None:
      ``DEFAULT_CHUNK``).
    * ``cuda``, ``pretune``, ``variants``, ``primary_variant``,
      ``model`` — as the reference.
    * ``schedule(p, **signature)`` — the pipeline tier's per-config
      instruction stream under a TPU target, (class, units[, dep]) rows
      (`repro_torch.core.pipeline.as_stream`), as the reference; None
      synthesizes the stream from the feature mix.  The H100 rows use
      their feature row, or — inside `repro_torch.core.sass.use_sass` —
      the SASS stream of the functions their `HopperSpace` names
      (`sass_row`), so the TPU schedule stays the reference's.
    """

    kernel_id: str
    fn: Callable[..., Any]
    space: Dict[str, Any]
    extract_signature: Callable[..., Dict[str, Any]]
    analysis: Callable[..., Dict[str, Any]]
    hopper: Any
    out: Callable[..., Any]
    make_inputs: Optional[Callable[..., tuple]] = None
    reference: Optional[Callable[..., Any]] = None
    pretune: Tuple[Dict[str, Any], ...] = ()
    cuda: Optional[CudaProfile] = None
    model: Optional[str] = None
    constraints: Any = None
    chunk_size: Optional[int] = None
    variants: Any = None
    primary_variant: Optional[str] = None
    schedule: Optional[Callable[..., Any]] = None

    def __post_init__(self):
        if not self.kernel_id or not isinstance(self.kernel_id, str):
            raise ValueError(f"kernel_id must be a non-empty string, "
                             f"got {self.kernel_id!r}")
        if self.model is not None and \
                self.model not in tuning_cache.MODEL_KINDS:
            raise ValueError(
                f"@tuned_kernel({self.kernel_id!r}): model must be one "
                f"of {tuning_cache.MODEL_KINDS}, got {self.model!r}")
        self.space = _coerce_space(self.kernel_id, self.space)
        if VARIANT_AXIS in self.space or TILE_AXIS in self.space:
            raise ValueError(
                f"@tuned_kernel({self.kernel_id!r}): axes "
                f"{VARIANT_AXIS!r} and {TILE_AXIS!r} are reserved")
        params = list(inspect.signature(self.analysis).parameters.values())
        if not params:
            raise ValueError(
                f"@tuned_kernel({self.kernel_id!r}): static_info builder "
                f"must take (params, **signature)")
        self._sig_schema = inspect.Signature(params[1:])
        self._sig_names = tuple(self._sig_schema.parameters)
        self._binder = compile_binder(schema_of(params[1:]))
        self.pretune = tuple(dict(s) for s in self.pretune)
        self._op = None
        self._fn_kw = None
        self._axis_names = frozenset(self.space)
        self._primary_id = self.primary_variant or "primary"
        variants: Optional[Dict[str, KernelVariant]] = None
        extra = tuple(self.variants or ())
        if extra or self.primary_variant is not None:
            variants = {self._primary_id: self._primary_as_variant()}
            for v in extra:
                v = self._checked_variant(v, variants)
                variants[v.variant_id] = v
        self.variants = None     # consumed into _impls; don't alias
        # the H100 space per implementation id (None: single-variant)
        if isinstance(self.hopper, HopperSpace):
            hopper = {None if variants is None
                      else self._primary_id: self.hopper}
        else:
            hopper = dict(self.hopper)
        want = set(variants) if variants is not None else {None}
        if set(hopper) != want:
            raise ValueError(
                f"@tuned_kernel({self.kernel_id!r}): hopper= must give a "
                f"HopperSpace for exactly the implementations "
                f"{sorted(map(str, want))}, got "
                f"{sorted(map(str, hopper))}")
        # (implementations, their H100 spaces), published as ONE tuple
        # so a dispatch racing `add_variant` sees the old pair or the new
        self._impls = (variants, hopper)
        self._tile_fallback: Dict[Tuple, Tuple[Optional[str], str]] = {}

    @property
    def _variants(self) -> Optional[Dict[str, KernelVariant]]:
        return self._impls[0]

    @property
    def _hopper(self) -> Dict[Optional[str], HopperSpace]:
        return self._impls[1]

    # -- variant set --------------------------------------------------------
    def _primary_as_variant(self) -> KernelVariant:
        return KernelVariant(variant_id=self._primary_id, fn=self.fn,
                             space=self.space, analysis=self.analysis,
                             constraints=self.constraints)

    def _checked_variant(self, variant: KernelVariant,
                         current: Mapping[str, KernelVariant]
                         ) -> KernelVariant:
        if not isinstance(variant, KernelVariant):
            raise TypeError(f"a variant must be a KernelVariant, "
                            f"got {variant!r}")
        v = dataclasses.replace(variant, space=_coerce_space(
            f"{self.kernel_id}/{variant.variant_id}", variant.space))
        check_variant_schema(self.kernel_id, self._sig_names, v)
        if v.variant_id in current:
            raise ValueError(
                f"@tuned_kernel({self.kernel_id!r}): variant "
                f"{v.variant_id!r} is already registered")
        return v

    def variant_ids(self) -> Tuple[str, ...]:
        """Implementation ids, insertion-ordered (empty for a
        single-implementation kernel)."""
        return tuple(self._variants) if self._variants is not None else ()

    def add_variant(self, variant: KernelVariant,
                    hopper: HopperSpace) -> None:
        """Register another implementation of this logical op, with its
        H100 launch space (the tiles its CUDA source compiles).

        Converts a single-implementation spec to variant dispatch (the
        decorated fn becomes the primary variant) and invalidates this
        kernel's dispatch state — frozen tables thaw and its live memo
        shard drops, because every existing record now answers for a
        different (smaller) variant set.
        """
        if not isinstance(hopper, HopperSpace):
            raise TypeError(f"add_variant needs the variant's H100 launch "
                            f"space as a HopperSpace, got {hopper!r}")
        cur, hop = self._impls
        if cur is None:
            cur = {self._primary_id: self._primary_as_variant()}
            hop = {self._primary_id: hop[None]}
        v = self._checked_variant(variant, cur)
        self._impls = ({**cur, v.variant_id: v},
                       {**hop, v.variant_id: hopper})
        self._tile_fallback = {}
        tuning_cache.registry.invalidate_kernel(self.kernel_id)

    def remove_variant(self, variant_id: str) -> KernelVariant:
        """Unregister an implementation (the primary cannot be removed —
        it backs the fallback launch).  Invalidates dispatch state like
        `add_variant`; the spec stays in variant mode even with only
        the primary left, because its records carry a variant id.
        Returns the removed variant."""
        cur, hop = self._impls
        if cur is None or variant_id not in cur:
            raise KeyError(
                f"@tuned_kernel({self.kernel_id!r}) has no variant "
                f"{variant_id!r}; registered: {list(cur or ())}")
        if variant_id == self._primary_id:
            raise ValueError(
                f"@tuned_kernel({self.kernel_id!r}): cannot remove the "
                f"primary variant {variant_id!r}")
        new = dict(cur)
        removed = new.pop(variant_id)
        self._impls = (new, {k: h for k, h in hop.items()
                             if k != variant_id})
        self._tile_fallback = {}
        tuning_cache.registry.invalidate_kernel(self.kernel_id)
        return removed

    def key_extras(self, spec: Any = None) -> Dict[str, Any]:
        """Extra cache-key signature entries for ``spec``: the variant-set
        digest in variant mode (the reference's), and under a
        `HopperSpec` a digest of the compiled launch space, so records
        ranked over another tile set never answer."""
        out: Dict[str, Any] = {}
        if self._variants is not None:
            out["variants"] = variants_fingerprint(self._variants)
        if isinstance(spec, HopperSpec):
            payload = ";".join(f"{vid}:{','.join(h.tiles)}"
                               for vid, h in self._hopper.items())
            out["hopper"] = hashlib.sha256(payload.encode()).hexdigest()[:12]
        return out

    # -- signature plumbing -------------------------------------------------
    def sig_binder(self) -> Optional[SigBinder]:
        return self._binder

    def normalize(self, signature: Mapping[str, Any]) -> Dict[str, Any]:
        """Bind a partial signature through the declared defaults
        (TypeError on missing or unknown keys)."""
        b = self._binder
        if b is not None:
            out = b.normalized(signature)
            if out is not None:
                return out
        ba = self._sig_schema.bind(**signature)
        ba.apply_defaults()
        return dict(ba.arguments)

    # -- TPU-space static analysis (the reference's) ------------------------
    def static_info(self, params: Params, **signature):
        sig = self.normalize(signature)
        if self._variants is not None:
            p = dict(params)
            p.setdefault(VARIANT_AXIS, self._primary_id)
            return joint_static_info(self._variants, p, sig)
        return block_info(**self.analysis(params, **sig))

    def static_info_batch(self, cols: Mapping[str, np.ndarray],
                          **signature) -> BatchStaticInfo:
        sig = self.normalize(signature)
        if self._variants is not None:
            return joint_static_info_batch(self._variants, cols, sig)
        return block_info_batch(**self.analysis(cols, **sig))

    def _materialize_constraints(self,
                                 sig: Dict[str, Any]) -> Tuple[Any, ...]:
        cons = self.constraints
        if cons is None:
            return ()
        if callable(cons) and not isinstance(cons, Constraint):
            cons = cons(**sig)
        return tuple(cons or ())

    def search_space(self, **signature) -> SearchSpace:
        sig = self.normalize(signature)
        if self._variants is not None:
            return joint_space(self._variants, sig)
        return SearchSpace({name: axis.materialize(sig)
                            for name, axis in self.space.items()},
                           constraints=self._materialize_constraints(sig))

    # -- the H100 launch space ----------------------------------------------
    def hopper_space(self, **signature) -> SearchSpace:
        """The H100 search space: ``{"tile": ...}``, or with variants the
        joint ``{"variant": ..., "tile": ...}`` lattice restricted to
        each implementation's own compiled tiles."""
        if self._variants is None:
            return SearchSpace({TILE_AXIS: self._hopper[None].tiles})
        vids = tuple(self._hopper)
        union: Tuple[str, ...] = ()
        for h in self._hopper.values():
            union += tuple(t for t in h.tiles if t not in union)
        own = {vid: np.asarray(h.tiles) for vid, h in self._hopper.items()}

        def _membership(cols):
            var = np.asarray(cols[VARIANT_AXIS])
            tile = np.asarray(cols[TILE_AXIS])
            ok = np.zeros(len(var), dtype=bool)
            for vid, tiles in own.items():
                ok |= (var == vid) & np.isin(tile, tiles)
            return ok

        return SearchSpace({VARIANT_AXIS: vids, TILE_AXIS: union},
                           constraints=(Constraint(
                               _membership, name="variant-tiles"),))

    def hopper_info_batch(self, cols: Mapping[str, np.ndarray],
                          spec: HopperSpec, **signature):
        """Price a chunk of H100 rows: each row's implementation analyzes
        its own tiles, results scatter back in row order (the fields
        `rank_space` reads: ``F``, ``pipe``, ``feasible``)."""
        sig = self.normalize(signature)
        tiles = np.asarray(cols[TILE_AXIS])
        n = len(tiles)
        if self._variants is None:
            return self._hopper[None].info(tiles, sig, spec)
        var = np.asarray(cols[VARIANT_AXIS])
        F = np.zeros((n, 7), dtype=np.float64)
        pipe = np.full(n, np.inf, dtype=np.float64)
        feasible = np.zeros(n, dtype=bool)
        for vid, h in self._hopper.items():
            m = var == vid
            if not m.any():
                continue
            info = h.info(tiles[m], sig, spec)
            F[m], pipe[m], feasible[m] = info.F, info.pipe, info.feasible
        return JointBatchInfo(F=F, pipe=pipe, feasible=feasible, variant=var)

    def _launchable_space(self, spec: HopperSpec,
                          sig: Dict[str, Any]) -> SearchSpace:
        """`hopper_space` less the rows the H100 analysis marks
        infeasible at ``sig``."""
        if self._variants is None:
            h = self._hopper[None]
            ok = h.info(h.tiles, sig, spec).feasible
            return SearchSpace({TILE_AXIS: tuple(
                t for t, f in zip(h.tiles, ok) if f)})
        ok = {(vid, t) for vid, h in self._hopper.items()
              for t, f in zip(h.tiles, h.info(h.tiles, sig, spec).feasible)
              if f}

        def _launchable(cols):
            return np.array([(v, t) in ok for v, t in zip(
                cols[VARIANT_AXIS], cols[TILE_AXIS])], dtype=bool)

        sp = self.hopper_space(**sig)
        return SearchSpace(dict(sp.axes), constraints=tuple(sp.constraints)
                           + (Constraint(_launchable, name="launchable"),))

    def _hopper_scalar(self, spec: HopperSpec, sig: Dict[str, Any]
                       ) -> Callable[[Params], HopperStaticInfo]:
        """Scalar H100 analyzer: one row through its implementation's
        batch analyzer (a row of an unknown variant is infeasible, as in
        `hopper_info_batch`)."""
        def scalar(p):
            vid = None if self._variants is None else p.get(VARIANT_AXIS)
            h = self._hopper.get(vid)
            if h is None:
                return HopperStaticInfo(mix=InstructionMix(),
                                        predicted_step_time=float("inf"),
                                        ok=False)
            b = h.info([p[TILE_AXIS]], sig, spec)
            return HopperStaticInfo(
                mix=InstructionMix(mxu_flops=b.F[0, 0], vpu_flops=b.F[0, 1],
                                   trans_flops=b.F[0, 2],
                                   hbm_bytes=b.F[0, 3], vmem_bytes=b.F[0, 4],
                                   ctrl_ops=b.F[0, 5]),
                predicted_step_time=float(b.pipe[0]),
                ok=bool(b.feasible[0]), hopper=b.occupancy.at(0))
        return scalar

    def hopper_static_info(self, params: Params, spec: HopperSpec,
                           **signature) -> HopperStaticInfo:
        """One H100 row (``{"tile": ...}``, plus ``"variant"`` with
        variants) priced by the H100 analysis."""
        return self._hopper_scalar(spec, self.normalize(signature))(params)

    def _hopper_problem(self, spec: HopperSpec,
                        sig: Dict[str, Any]) -> "tuning_cache.TuningProblem":
        active = _sass.active_sass()
        schedule = None
        if active is not None:
            funcs = active[0]

            def schedule(p):
                row = self.sass_row(p, funcs, spec, **sig)
                return None if row is None else row.stream()
        return tuning_cache.TuningProblem(
            space=self.hopper_space(**sig),
            static_info=self._hopper_scalar(spec, sig),
            static_info_batch=lambda c: self.hopper_info_batch(c, spec,
                                                               **sig),
            schedule=schedule)

    def sass_symbols(self, params: Params, **signature) -> Tuple[str, ...]:
        """The SASS functions one launch of an H100 row runs
        (`HopperSpace.symbols`; ``()`` where the space names none)."""
        vid = None if self._variants is None else params.get(VARIANT_AXIS)
        h = self._hopper[vid]
        if h.symbols is None:
            return ()
        return tuple(h.symbols(params[TILE_AXIS], **self.normalize(
            signature)))

    def sass_row(self, params: Params, functions: Mapping[str, Any],
                 spec: HopperSpec = H100_SXM,
                 **signature) -> Optional[SassRow]:
        """An H100 row read from a disassembly (``functions``, as
        `repro_torch.core.sass.parse_sass` gives them): its functions,
        the main loop's trips read off the row's analysis
        (`repro_torch.core.sass.fit_trips`), the launch's warps (blocks x
        threads / 32) and the device bytes its TMA and bulk copies move
        (the row's device bytes past those of its loads and stores of
        stated width).  None where the row is infeasible or its space
        names no functions; KeyError where a function is missing from
        the disassembly."""
        sig = self.normalize(signature)
        syms = self.sass_symbols(params, **sig)
        info = self._hopper_scalar(spec, sig)(params)
        if not syms or not info.ok:
            return None
        found = tuple(_sass.find_function(functions, s) for s in syms)
        missing = [s for s, f in zip(syms, found) if f is None]
        if missing:
            raise KeyError(f"{self.kernel_id} {dict(params)}: no SASS "
                           f"function {missing} in the disassembly")
        vid = None if self._variants is None else params.get(VARIANT_AXIS)
        cost = self._hopper[vid].analysis(
            {TILE_AXIS: np.asarray([params[TILE_AXIS]])}, **sig)
        one = lambda v: float(np.asarray(v).reshape(-1)[0])
        warps = one(cost["blocks"]) * -(-one(cost["threads"]) // 32)
        fn = found[0]
        trips = _sass.fit_trips(fn, info.mix, warps=warps)
        tma = _sass.copy_bytes(fn, info.mix.hbm_bytes, trips, warps)
        return SassRow(functions=found, trips=trips, warps=warps,
                       tma_bytes=tma, info=info,
                       census=_sass.census(fn, trips, warps=warps,
                                           tma_bytes=tma))

    def fallback_tile(self, variant_id: Optional[str],
                      **signature) -> Tuple[Optional[str], str]:
        """``(variant, tile)`` launched when dispatch names no compiled
        tile: the implementation's first tile the H100's limits accept
        for this signature, or — when none fits — the primary
        implementation's.  Memoized per signature."""
        sig = self.normalize(signature)
        try:
            key = (variant_id, tuple(sorted(sig.items())))
            hit = self._tile_fallback.get(key)
            if hit is not None:
                return hit
        except TypeError:               # unhashable signature value
            key = None
        variants, hopper = self._impls
        primary = None if variants is None else self._primary_id
        out = None
        for vid in dict.fromkeys((variant_id, primary)):
            h = hopper[vid]
            ok = h.info(h.tiles, sig, H100_SXM).feasible
            if ok.any():
                out = (vid, h.tiles[int(np.argmax(ok))])
                break
        if out is None:   # nothing fits the card's limits: let it raise
            out = (primary, hopper[primary].tiles[0])
        if key is not None:
            self._tile_fallback[key] = out
        return out

    def fallback_params(self, **signature) -> Dict[str, Any]:
        """Launch params used when dispatch is unavailable: the primary
        implementation's fallback tile."""
        primary = None if self._variants is None else self._primary_id
        vid, tile = self.fallback_tile(primary, **signature)
        return {TILE_AXIS: tile} if vid is None \
            else {VARIANT_AXIS: vid, TILE_AXIS: tile}

    # -- the registry entry -------------------------------------------------
    def problem(self, **signature) -> "tuning_cache.TuningProblem":
        """The dispatch-registry factory, polymorphic over the active
        target: the TPU block space under a `TpuSpec`, the thread-block
        lattice under a `GpuSpec`, the compiled tiles under a
        `HopperSpec`."""
        sig = self.normalize(signature)
        spec = default_target()
        if isinstance(spec, HopperSpec):
            return self._hopper_problem(spec, sig)
        if isinstance(spec, GpuSpec):
            return self._cuda_problem(spec, sig)
        return tuning_cache.TuningProblem(
            space=self.search_space(**sig),
            static_info=lambda p: self.static_info(p, **sig),
            static_info_batch=lambda c: self.static_info_batch(c, **sig),
            chunk_size=self.chunk_size,
            schedule=(lambda p, _sig=sig: self.schedule(p, **_sig))
            if self.schedule is not None else None)

    def _cuda_problem(self, gpu: GpuSpec,
                      sig: Dict[str, Any]) -> "tuning_cache.TuningProblem":
        prof = self.cuda if self.cuda is not None else _GENERIC_CUDA
        kw = dict(regs_per_thread=prof.regs_for(gpu),
                  shmem_per_block=prof.shmem_for(**sig),
                  spec=gpu, **prof.counts(**sig))
        return tuning_cache.TuningProblem(
            space=SearchSpace({"threads": prof.thread_candidates(gpu)}),
            static_info=lambda p: cuda_info(p["threads"], **kw),
            static_info_batch=lambda c: cuda_info_batch(c["threads"], **kw))

    # -- launch ---------------------------------------------------------------
    def _launch(self, p: Optional[Mapping[str, Any]],
                sig: Dict[str, Any]) -> Tuple[Callable, Dict[str, Any], bool]:
        """Turn resolved params ``p`` into ``(fn, launch_kwargs,
        complete)``.

        H100 params (they carry ``"tile"``) launch that tile of their
        implementation.  TPU or legacy-GPU params pick the
        implementation (``"variant"``) when they name one, and the tile
        is that implementation's H100 fallback.  ``complete`` is False
        when the params did not cover the implementation's axes (or
        named no known implementation), i.e. the fallback filled gaps —
        the same accounting as the reference.
        """
        variants, hopper = self._impls
        if variants is None:
            vid, var_fn = None, self.fn
            names = self._axis_names
        else:
            vid = p.get(VARIANT_AXIS) if p else None
            if vid not in variants:
                vid = None
            var = variants.get(vid)
            var_fn = var.fn if var is not None else None
            names = frozenset(var.space) if var is not None else frozenset()
        if p and TILE_AXIS in p:
            h = hopper.get(vid)
            complete = (h is not None and (vid is not None or variants is None)
                        and p[TILE_AXIS] in h.tiles)
        else:
            complete = bool(names) and bool(p) and \
                all(k in p for k in names)
        if complete and p and TILE_AXIS in p:
            return var_fn, {TILE_AXIS: p[TILE_AXIS]}, True
        if variants is not None and vid is None:
            vid = self._primary_id
        vid, tile = self.fallback_tile(vid, **sig)
        fn = self.fn if variants is None else variants[vid].fn
        return fn, {TILE_AXIS: tile}, complete

    @property
    def op(self) -> Callable[..., Any]:
        """The dispatch wrapper (what ``ops.py`` re-exports).

        Resolves launch params through the tuning database for the
        active target on every call (the frozen tables first, after
        ``freeze()``); ``tuned_params`` injects params explicitly,
        bypassing the database.  If dispatch fails the fallback launch
        applies.  While spans record (`repro_torch.runtime.spans`) each
        call is the host span ``kernels.<kernel_id>``, and its dispatch
        time, from inside that span to the launch, is counted.
        """
        if self._op is None:
            kernel_id = self.kernel_id
            registry = tuning_cache.registry
            stats = _STATS
            # (frozen state, probe) pair published as ONE tuple, checked
            # against registry._FROZEN by identity on every call
            cache = [(None, None)]
            span_name = "kernels." + kernel_id

            def pick(args, kw, tuned_params):
                """(fn, launch kwargs) for this call; (None, outputs)
                where a collector takes it."""
                sig = self.extract_signature(*args, **kw)
                col = _COLLECT.get()
                if col is not None:
                    stats.collected += 1
                    return None, col.record(self, sig, args, kw)
                if tuned_params is not None:
                    stats.explicit += 1
                    fn, launch, _ = self._launch(tuned_params, sig)
                    return fn, launch
                fz = registry._FROZEN
                state, probe = cache[0]
                if state is not fz:
                    probe = (fz.tables.get((kernel_id, "static"))
                             if fz is not None else None)
                    cache[0] = (fz, probe)
                p = None
                if probe is not None:
                    try:
                        p = probe(sig)
                    except TypeError:   # unhashable signature value
                        p = None
                hit_frozen = p is not None
                if p is None:
                    p = _resolve(kernel_id, sig)
                fn, launch, complete = self._launch(p, sig)
                if not complete:
                    stats.fallback += 1
                elif hit_frozen:
                    stats.frozen += 1
                else:
                    stats.live += 1
                return fn, launch

            def op(*args, tuned_params: Optional[Dict] = None, **kw):
                if not spans.active():
                    fn, launch = pick(args, kw, tuned_params)
                    return launch if fn is None else fn(*args, **launch, **kw)
                with spans.span(span_name):
                    t0 = time.perf_counter_ns()
                    fn, launch = pick(args, kw, tuned_params)
                    if fn is None:
                        return launch
                    spans.count_dispatch(time.perf_counter_ns() - t0)
                    return fn(*args, **launch, **kw)

            op.__name__ = self.kernel_id
            op.__qualname__ = self.kernel_id
            op.__doc__ = (f"Tuning-database-dispatched entry point for "
                          f"{self.kernel_id!r} (see repro_torch.kernels.api)."
                          + (f"\n\n{self.fn.__doc__}"
                             if getattr(self.fn, "__doc__", None) else ""))
            op.spec = self
            self._op = op
        return self._op

    def meta_out(self, *args, **kw) -> Any:
        """Empty ``meta`` tensors of a call's outputs (``out``): what an
        op returns while a collector takes its dispatches."""
        import torch
        outs = self.out(*args, **kw)
        if isinstance(outs, list):
            return tuple(torch.empty(s, dtype=d, device="meta")
                         for s, d in outs)
        shape, dtype = outs
        return torch.empty(shape, dtype=dtype, device="meta")

    def _fn_keywords(self) -> frozenset:
        if self._fn_kw is None:
            ps = inspect.signature(self.fn).parameters.values()
            self._fn_kw = frozenset(
                p.name for p in ps
                if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                              inspect.Parameter.KEYWORD_ONLY))
        return self._fn_kw

    def tunable(self, *, seed: int = 0,
                space: Optional[SearchSpace] = None,
                name: Optional[str] = None, device: Any = None,
                **signature) -> TunableKernel:
        """Package this kernel as a `TunableKernel` for `KernelTuner`.

        The active target picks the space: under a `HopperSpec` the
        compiled tile table (`hopper_space`) less the rows the H100
        analysis marks infeasible for this signature (a shape the tile's
        kernel does not take, a footprint past the card's limits: the
        timed modes launch every row), priced by the H100 analysis;
        under any other target the declared Pallas block space
        (``space`` narrows it), priced by the reference's analysis.
        ``build(p)`` returns a callable that launches the CUDA
        instantiation ``p["tile"]`` on CUDA tensors and runs the plain
        version on CPU tensors; TPU params name no tile, so it launches
        the implementation's fallback tile.  ``make_inputs``
        draws from a ``torch.Generator`` seeded with ``seed`` on
        ``device`` — the CUDA card unless ``device`` says otherwise.
        """
        sig = self.normalize(signature)
        target = default_target()
        if isinstance(target, HopperSpec):
            sp = self._launchable_space(target, sig)
            static_info = self._hopper_scalar(target, sig)
            static_info_batch = (lambda c: self.hopper_info_batch(
                c, target, **sig))
        else:
            sp = space if space is not None else self.search_space(**sig)
            if isinstance(sp, Mapping):
                sp = SearchSpace(dict(sp))
            static_info = lambda p: self.static_info(p, **sig)
            static_info_batch = lambda c: self.static_info_batch(c, **sig)
        fwd = {k: v for k, v in sig.items() if k in self._fn_keywords()}

        def build(p: Params) -> Callable[..., Any]:
            fn, launch, _ = self._launch(p, sig)
            return functools.partial(fn, **fwd, **launch)

        if self.make_inputs is None:
            def make_inputs():
                raise NotImplementedError(
                    f"@tuned_kernel({self.kernel_id!r}) declared no "
                    f"make_inputs=; empirical/hybrid tuning needs one")
        else:
            def make_inputs():
                import torch
                gen = torch.Generator(device=resolve_device(device))
                gen.manual_seed(seed)
                return self.make_inputs(gen, **sig)

        if name is None:
            dims = "x".join(str(v) for v in sig.values()
                            if isinstance(v, (int, np.integer)))
            name = f"{self.kernel_id}_{dims}" if dims else self.kernel_id
        return TunableKernel(
            name=name, space=sp, build=build, static_info=static_info,
            make_inputs=make_inputs, reference=self.reference,
            static_info_batch=static_info_batch, target=target)


# ---------------------------------------------------------------------------
# The decorator + the spec registry
# ---------------------------------------------------------------------------

_SPECS: Dict[str, KernelSpec] = {}


def tuned_kernel(kernel_id: str, *,
                 space: Union[Mapping[str, Any], str],
                 signature: Callable[..., Dict[str, Any]],
                 static_info: Callable[..., Dict[str, Any]],
                 hopper: Any,
                 out: Callable[..., Any],
                 make_inputs: Optional[Callable[..., tuple]] = None,
                 reference: Optional[Callable[..., Any]] = None,
                 pretune: Sequence[Mapping[str, Any]] = (),
                 cuda: Optional[CudaProfile] = None,
                 model: Optional[str] = None,
                 constraints: Any = None,
                 chunk_size: Optional[int] = None,
                 variants: Sequence[KernelVariant] = (),
                 primary_variant: Optional[str] = None,
                 schedule: Optional[Callable[..., Any]] = None):
    """Declare a kernel as a first-class tuning citizen: registers a
    :class:`KernelSpec` under ``kernel_id`` and returns the decorated
    function unchanged (with a ``.spec`` attribute)."""
    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        spec = KernelSpec(kernel_id=kernel_id, fn=fn, space=space,
                          extract_signature=signature, analysis=static_info,
                          hopper=hopper, out=out, make_inputs=make_inputs,
                          reference=reference, pretune=tuple(pretune),
                          cuda=cuda, model=model, constraints=constraints,
                          chunk_size=chunk_size, variants=tuple(variants),
                          primary_variant=primary_variant, schedule=schedule)
        register_spec(spec)
        fn.spec = spec
        return fn
    return deco


def register_spec(spec: KernelSpec) -> KernelSpec:
    """Register a `KernelSpec` with the dispatch registry (duplicate
    kernel_ids raise — two declarations must not silently shadow)."""
    tuning_cache.registry.register_entry(spec.kernel_id, spec)
    _SPECS[spec.kernel_id] = spec
    return spec


def get_spec(kernel_id: str, default: Any = dataclasses.MISSING
             ) -> KernelSpec:
    spec = _SPECS.get(kernel_id)
    if spec is None:
        if default is not dataclasses.MISSING:
            return default
        raise KeyError(f"no @tuned_kernel declaration for {kernel_id!r}; "
                       f"declared: {registered_kernels()}")
    return spec


def registered_kernels() -> Tuple[str, ...]:
    """kernel_ids declared via `@tuned_kernel`, sorted."""
    return tuple(sorted(_SPECS))


def register_variant(kernel_id: str, variant: KernelVariant,
                     hopper: HopperSpace) -> None:
    """Register another implementation of a declared logical op, with
    the H100 launch space its CUDA source compiles.

    The variant id joins the op's joint search space immediately: the
    kernel's frozen tables thaw and its live memo entries drop (records
    ranked without this variant answer for a stale variant set), and
    the next cold rank scores the new implementation's sub-space
    alongside every existing one.
    """
    get_spec(kernel_id).add_variant(variant, hopper)


def unregister_variant(kernel_id: str, variant_id: str) -> KernelVariant:
    """Remove a registered implementation (the primary cannot be
    removed); invalidates the kernel's dispatch state like
    `register_variant`.  Returns the removed variant."""
    return get_spec(kernel_id).remove_variant(variant_id)


def unregister(kernel_id: str) -> None:
    """Remove a declaration (tests and examples cleaning up after
    themselves, or deliberately replacing one); missing ids are a
    no-op.  Also evicts the op wrapper `ops.__getattr__` may have
    memoized into the module, so a re-declaration under the same id
    dispatches through the new spec rather than a stale global."""
    import sys
    _SPECS.pop(kernel_id, None)
    tuning_cache.registry.unregister(kernel_id)
    ops_mod = sys.modules.get("repro_torch.kernels.ops")
    if ops_mod is not None:
        ops_mod.__dict__.pop(kernel_id, None)
