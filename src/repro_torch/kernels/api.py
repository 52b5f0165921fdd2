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
        pretune=(...),
    )
    def matmul(a, b, *, tile=None): ...

derives the dispatch wrapper (`KernelSpec.op`, re-exported as
``repro_torch.kernels.ops.<kernel_id>``), the registry entry consumed by
`repro_torch.tuning_cache.lookup_or_tune`, and the fallback launch.

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
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import inspect
import logging
import threading
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch import tuning_cache
from repro_torch.core.hw import H100_SXM, GpuSpec, HopperSpec
from repro_torch.core.mix import InstructionMix
from repro_torch.core.search import Constraint, Params, SearchSpace
from repro_torch.core.target import default_target
from repro_torch.kernels.common import (BatchStaticInfo, HopperBatchInfo,
                                        block_info, block_info_batch,
                                        cuda_info, cuda_info_batch,
                                        hopper_info_batch,
                                        pick_divisor_candidates)
from repro_torch.kernels.variants import (JointBatchInfo, KernelVariant,
                                          VARIANT_AXIS,
                                          check_variant_schema, joint_space,
                                          joint_static_info,
                                          joint_static_info_batch,
                                          variants_fingerprint)
from repro_torch.tuning_cache.binder import (SigBinder, compile_binder,
                                             schema_of)

__all__ = [
    "KernelSpec", "tuned_kernel", "divisors", "Divisors",
    "CudaProfile", "cuda_profile", "KernelVariant", "HopperSpace",
    "TILE_AXIS", "get_spec", "registered_kernels",
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
    """Accept {name: Divisors | sequence}."""
    if not isinstance(space, Mapping) or not space:
        raise ValueError(
            f"@tuned_kernel({kernel_id!r}): space must declare at least "
            f"one tunable axis, got {space!r}")
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
    """

    tiles: Tuple[str, ...]
    analysis: Callable[..., Dict[str, Any]]

    def info(self, tiles: Sequence[str], sig: Mapping[str, Any],
             spec: HopperSpec) -> HopperBatchInfo:
        cols = {TILE_AXIS: np.asarray(list(tiles))}
        return hopper_info_batch(**self.analysis(cols, **sig), spec=spec)


@dataclasses.dataclass(frozen=True)
class HopperStaticInfo:
    """Scalar view of one H100 row, duck-typed like `CudaStaticInfo`
    for `repro_torch.core.predict.static_times_batch`."""

    mix: InstructionMix
    predicted_step_time: float
    ok: bool
    grid_steps: int = 1

    @property
    def occupancy(self):
        return self

    def feasible(self) -> bool:
        return self.ok


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


_COLLECT: "contextvars.ContextVar[Optional[List[Tuple[str, Dict]]]]" = \
    contextvars.ContextVar("repro_torch_collect_dispatches", default=None)


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
    sink: List[Tuple[str, Dict]] = []
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
    * ``out(*args, **kwargs) -> (shape, dtype)`` — the output of a call,
      for the enumeration-only ``meta`` dispatch.
    * ``cuda``, ``pretune``, ``variants``, ``primary_variant``,
      ``model`` — as the reference.
    """

    kernel_id: str
    fn: Callable[..., Any]
    space: Dict[str, Any]
    extract_signature: Callable[..., Dict[str, Any]]
    analysis: Callable[..., Dict[str, Any]]
    hopper: Any
    out: Callable[..., Tuple[Tuple[int, ...], Any]]
    pretune: Tuple[Dict[str, Any], ...] = ()
    cuda: Optional[CudaProfile] = None
    model: Optional[str] = None
    variants: Any = None
    primary_variant: Optional[str] = None

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
        self._axis_names = frozenset(self.space)
        self._primary_id = self.primary_variant or "primary"
        self._variants: Optional[Dict[str, KernelVariant]] = None
        extra = tuple(self.variants or ())
        if extra:
            self._variants = {self._primary_id: KernelVariant(
                variant_id=self._primary_id, fn=self.fn, space=self.space,
                analysis=self.analysis)}
            for v in extra:
                v = dataclasses.replace(v, space=_coerce_space(
                    f"{self.kernel_id}/{v.variant_id}", v.space))
                check_variant_schema(self.kernel_id, self._sig_names, v)
                if v.variant_id in self._variants:
                    raise ValueError(
                        f"@tuned_kernel({self.kernel_id!r}): variant "
                        f"{v.variant_id!r} is declared twice")
                self._variants[v.variant_id] = v
        self.variants = None     # consumed into _variants; don't alias
        # the H100 space per implementation id (None: single-variant)
        if isinstance(self.hopper, HopperSpace):
            self._hopper = {None if self._variants is None
                            else self._primary_id: self.hopper}
        else:
            self._hopper = dict(self.hopper)
        want = set(self._variants) if self._variants is not None else {None}
        if set(self._hopper) != want:
            raise ValueError(
                f"@tuned_kernel({self.kernel_id!r}): hopper= must give a "
                f"HopperSpace for exactly the implementations "
                f"{sorted(map(str, want))}, got "
                f"{sorted(map(str, self._hopper))}")
        self._tile_fallback: Dict[Tuple, Tuple[Optional[str], str]] = {}

    # -- variant set --------------------------------------------------------
    def variant_ids(self) -> Tuple[str, ...]:
        """Implementation ids, declaration-ordered (empty for a
        single-implementation kernel)."""
        return tuple(self._variants) if self._variants is not None else ()

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

    def search_space(self, **signature) -> SearchSpace:
        sig = self.normalize(signature)
        if self._variants is not None:
            return joint_space(self._variants, sig)
        return SearchSpace({name: axis.materialize(sig)
                            for name, axis in self.space.items()})

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

    def _hopper_problem(self, spec: HopperSpec,
                        sig: Dict[str, Any]) -> "tuning_cache.TuningProblem":
        def batch(c):
            return self.hopper_info_batch(c, spec, **sig)

        def scalar(p):
            cols = {k: np.asarray([v]) for k, v in p.items()}
            b = batch(cols)
            return HopperStaticInfo(
                mix=InstructionMix(vpu_flops=b.F[0, 1], trans_flops=b.F[0, 2],
                                   hbm_bytes=b.F[0, 3], vmem_bytes=b.F[0, 4],
                                   ctrl_ops=b.F[0, 5]),
                predicted_step_time=float(b.pipe[0]),
                ok=bool(b.feasible[0]))

        return tuning_cache.TuningProblem(
            space=self.hopper_space(**sig), static_info=scalar,
            static_info_batch=batch)

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
        primary = None if self._variants is None else self._primary_id
        out = None
        for vid in dict.fromkeys((variant_id, primary)):
            h = self._hopper[vid]
            ok = h.info(h.tiles, sig, H100_SXM).feasible
            if ok.any():
                out = (vid, h.tiles[int(np.argmax(ok))])
                break
        if out is None:   # nothing fits the card's limits: let it raise
            out = (primary, self._hopper[primary].tiles[0])
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
            static_info_batch=lambda c: self.static_info_batch(c, **sig))

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
        variants = self._variants
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
            h = self._hopper.get(vid)
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
        applies.
        """
        if self._op is None:
            kernel_id = self.kernel_id
            registry = tuning_cache.registry
            stats = _STATS
            # (frozen state, probe) pair published as ONE tuple, checked
            # against registry._FROZEN by identity on every call
            cache = [(None, None)]

            def op(*args, tuned_params: Optional[Dict] = None, **kw):
                sig = self.extract_signature(*args, **kw)
                col = _COLLECT.get()
                if col is not None:
                    import torch
                    col.append((kernel_id, dict(sig)))
                    stats.collected += 1
                    shape, dtype = self.out(*args, **kw)
                    return torch.empty(shape, dtype=dtype, device="meta")
                if tuned_params is not None:
                    stats.explicit += 1
                    fn, launch, _ = self._launch(tuned_params, sig)
                    return fn(*args, **launch, **kw)
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


# ---------------------------------------------------------------------------
# The decorator + the spec registry
# ---------------------------------------------------------------------------

_SPECS: Dict[str, KernelSpec] = {}


def tuned_kernel(kernel_id: str, *,
                 space: Mapping[str, Any],
                 signature: Callable[..., Dict[str, Any]],
                 static_info: Callable[..., Dict[str, Any]],
                 hopper: Any,
                 out: Callable[..., Tuple[Tuple[int, ...], Any]],
                 pretune: Sequence[Mapping[str, Any]] = (),
                 cuda: Optional[CudaProfile] = None,
                 model: Optional[str] = None,
                 variants: Sequence[KernelVariant] = (),
                 primary_variant: Optional[str] = None):
    """Declare a kernel as a first-class tuning citizen: registers a
    :class:`KernelSpec` under ``kernel_id`` and returns the decorated
    function unchanged (with a ``.spec`` attribute)."""
    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        spec = KernelSpec(kernel_id=kernel_id, fn=fn, space=space,
                          extract_signature=signature, analysis=static_info,
                          hopper=hopper, out=out, pretune=tuple(pretune),
                          cuda=cuda, model=model, variants=tuple(variants),
                          primary_variant=primary_variant)
        tuning_cache.registry.register_entry(spec.kernel_id, spec)
        _SPECS[spec.kernel_id] = spec
        fn.spec = spec
        return fn
    return deco


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
