"""Trace-time dispatch registry (DESIGN.md §7, §10).

Kernel modules register under a stable ``kernel_id`` either

* a :class:`~repro_torch.kernels.api.KernelSpec` (the `@tuned_kernel`
  declaration — every in-tree kernel registers this way), via
  :func:`register_entry`; or
* a hand-rolled *dispatch problem factory* ``(**signature) ->
  TuningProblem`` via the :func:`register` decorator (signature
  normalization is derived from the factory's own
  ``inspect.signature``).

The registry consumes only the entry protocol — ``problem(**signature)``,
``normalize(signature)``, ``sig_binder()`` and, where an entry has it,
``key_extras(spec)`` — so it needs no import of the kernel layer.

``lookup_or_tune(kernel_id, m=.., n=.., dtype=..)`` is then the one call
a kernel entry point makes at trace time: key the tuning database on
(kernel_id, signature, chip fingerprint, mode, model version); on a hit
return the stored params with **zero** cost-model evaluations; on a
miss, rank the entire space in one vectorized pass
(`repro_torch.core.predict.static_times_batch`), store the winner, return it.

Warm dispatch has three tiers, fastest first (DESIGN.md §12):

1. **frozen** — after :func:`freeze`, an immutable per-(kernel, mode)
   table probed lock-free with no generation check; invalidated as a
   whole (thaw) by any database generation bump, `clear_dispatch_memo`,
   or `set_default_target`;
2. **live memo** — per-kernel shards of ``{(mode, fingerprint,
   sig-key): (generation, params)}`` entries that self-invalidate
   against `TuningDatabase.generation`;
3. **database** — normalize + content-addressed key + LRU probe (and,
   cold, the full vectorized rank).

Signature normalization happens at *declaration* time: each entry
exposes a compiled `repro_torch.tuning_cache.binder.SigBinder` that maps any
valid spelling (kwarg-order permuted, defaults elided) straight to a
canonical value tuple, so tiers 1-2 never call ``inspect`` machinery or
sort the signature per dispatch.

Under a `repro_torch.core.hw.HopperSpec` target the ranked space is the
CUDA kernels' own launch space (the entry's ``problem`` switches on the
active target) and the model is the H100 roofline
(`repro_torch.core.predict.default_hopper_model`); ``model="pipeline"``
reranks that roofline's shortlist with the scoreboard simulator over the
Hopper ISA table (`repro_torch.core.pipeline`).  On the all-default path
a configured tuning service (`repro_torch.tuning_cache.service`) is
consulted between the live memo and the local database, and a target's
shipped pretuned JSONL is warmed into the default database on its first
dispatch.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import math
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.hw import (ChipSpec, GPU_TABLE, GpuSpec, HOPPER_TABLE,
                                 HopperSpec, TPU_TABLE, TpuSpec,
                                 resolve_target)
from repro_torch.core.pipeline import PipelineModel, pipeline_model
from repro_torch.core.predict import (CostModel, default_cuda_model,
                                      default_hopper_model,
                                      default_tpu_model, static_times_batch)
from repro_torch.core.target import (on_default_target_change,
                                     unscoped_default, use_target)
from repro_torch.core.search import DEFAULT_CHUNK, Params, SearchSpace
from repro_torch.tuning_cache.binder import (SigBinder, compile_binder,
                                             compile_probe, schema_of)
from repro_torch.tuning_cache.keys import (CacheKey, MODEL_VERSION,
                                           fingerprint_spec, make_key)
from repro_torch.tuning_cache.store import (TuningDatabase, TuningRecord,
                                            now_unix)

__all__ = ["TuningProblem", "register", "register_entry", "unregister",
           "invalidate_kernel", "dispatch_key",
           "get_problem", "registered", "rank_space", "lookup_or_tune",
           "clear_dispatch_memo", "on_dispatch_memo_clear", "reset_models",
           "freeze", "thaw", "is_frozen", "frozen_lookup", "frozen_table",
           "dispatch_memo_keys",
           "MODEL_KINDS", "ENV_MODEL", "default_model_kind",
           "set_default_model"]

# The selectable cost-model tiers (DESIGN.md §16): "eq6" is the paper's
# CPI-linear model (the vectorized SoA path; the H100 roofline under a
# HopperSpec), "pipeline" the scoreboard-simulation reranker layered on
# top of it.
MODEL_KINDS: Tuple[str, ...] = ("eq6", "pipeline")

# Environment override for the process-default model kind.
ENV_MODEL = "REPRO_TUNING_MODEL"


@dataclasses.dataclass
class TuningProblem:
    """What dispatch needs to rank one kernel instance statically.

    ``static_info_batch`` is the struct-of-arrays analyzer: it takes
    the value columns of `SearchSpace.enumerate_lattice` and returns a
    `repro_torch.kernels.common.BatchStaticInfo`.  When present, `rank_space`
    never builds a per-config dict or info object; the scalar
    ``static_info`` stays as the parity fallback.
    """

    space: SearchSpace
    static_info: Callable[[Params], Any]    # -> KernelStaticInfo-like
    static_info_batch: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None
    # preferred streaming chunk for rank_space (None: DEFAULT_CHUNK) —
    # declarations with very wide rows can lower it to cap peak memory
    chunk_size: Optional[int] = None
    # optional per-config instruction-stream hook for the pipeline tier:
    # ``schedule(params)`` returns what `repro_torch.core.pipeline.as_stream`
    # accepts (an InstructionStream or (class, units[, dep]) rows).
    # None: the stream is synthesized from the 7-feature mix.
    schedule: Optional[Callable[[Params], Any]] = None


class _FactoryEntry:
    """Adapter giving a ``(**signature) -> TuningProblem`` factory the
    entry protocol."""

    __slots__ = ("factory", "_sig", "_binder", "_binder_built")

    def __init__(self, factory: Callable[..., TuningProblem]):
        self.factory = factory
        self._sig: Optional[inspect.Signature] = None
        self._binder: Optional[SigBinder] = None
        self._binder_built = False

    def problem(self, **signature: Any) -> TuningProblem:
        return self.factory(**signature)

    def sig_binder(self) -> Optional[SigBinder]:
        """Declaration-derived key builder (``None``: the factory's
        signature is not compilable — e.g. ``**kwargs``)."""
        if not self._binder_built:
            self._binder = compile_binder(schema_of(
                inspect.signature(self.factory).parameters.values()))
            self._binder_built = True
        return self._binder

    def normalize(self, signature: Dict[str, Any]) -> Dict[str, Any]:
        b = self.sig_binder()
        if b is not None:
            out = b.normalized(signature)
            if out is not None:
                return out
        if self._sig is None:
            self._sig = inspect.signature(self.factory)
        ba = self._sig.bind(**signature)
        ba.apply_defaults()
        out: Dict[str, Any] = {}
        for name, value in ba.arguments.items():
            # a **kwargs factory collects the signature under the
            # var-keyword name — flatten it back to the caller's keys
            if (self._sig.parameters[name].kind
                    is inspect.Parameter.VAR_KEYWORD):
                out.update(value)
            else:
                out[name] = value
        return out


# kernel_id -> entry with .problem(**sig) / .normalize(sig): a KernelSpec
# or a _FactoryEntry (duck-typed: the registry never imports the kernel
# layer).
_REGISTRY: Dict[str, Any] = {}


def register_entry(kernel_id: str, entry: Any) -> Any:
    """Register an entry object (``problem``/``normalize`` protocol).

    Duplicate kernel_ids raise: two declarations silently shadowing each
    other would make dispatch results dependent on import order.  Use
    :func:`unregister` first to deliberately replace one.
    """
    if kernel_id in _REGISTRY:
        raise ValueError(
            f"kernel_id {kernel_id!r} is already registered; "
            f"unregister({kernel_id!r}) first to replace it "
            f"(registered: {registered()})")
    _REGISTRY[kernel_id] = entry
    return entry


def register(kernel_id: str):
    """Decorator: register a ``(**signature) -> TuningProblem`` factory."""
    def deco(factory: Callable[..., TuningProblem]):
        register_entry(kernel_id, _FactoryEntry(factory))
        return factory
    return deco


def unregister(kernel_id: str) -> None:
    """Remove a registration (no-op when absent).  Drops the kernel's
    memo shard and thaws any frozen table so a re-registration under
    the same id can never be served another declaration's params."""
    if _REGISTRY.pop(kernel_id, None) is not None:
        thaw()
    with _models_lock:
        _DISPATCH_MEMO.pop(kernel_id, None)


def invalidate_kernel(kernel_id: str) -> None:
    """Invalidate one kernel's dispatch state in place: thaw the frozen
    tier (its tables may hold this kernel's now-stale records) and drop
    the kernel's live memo shard.  The registration itself stays.

    This is the hook `register_variant` / `unregister_variant` fire —
    a variant-set mutation changes the kernel's key extras, so every
    frozen or memoized answer for it belongs to a key the kernel no
    longer asks.
    """
    if kernel_id in _REGISTRY:
        thaw()
    with _models_lock:
        _DISPATCH_MEMO.pop(kernel_id, None)


def registered() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _entry(kernel_id: str) -> Any:
    try:
        return _REGISTRY[kernel_id]
    except KeyError:
        raise KeyError(
            f"no dispatch entry for kernel {kernel_id!r}; "
            f"registered: {registered()}") from None


def get_problem(kernel_id: str, **signature: Any) -> TuningProblem:
    return _entry(kernel_id).problem(**signature)


def normalize_signature(kernel_id: str,
                        signature: Dict[str, Any]) -> Dict[str, Any]:
    """Bind a partial signature through the entry's declared defaults.

    Keys must be identical no matter how the signature was spelled:
    `tune --sig m=1024 ...` (dtype omitted, the declared default
    applies) has to produce the same record as `ops.matmul` passing
    `dtype='float32'` explicitly, or CLI-produced databases would be
    permanent cache misses at trace time.
    """
    return _entry(kernel_id).normalize(signature)


def rank_space(problem: TuningProblem, model: CostModel, *,
               chunk_size: Optional[int] = None,
               workers: Optional[int] = None
               ) -> Tuple[Params, float, int]:
    """Argmin of the static model over the whole space, streamed.

    With a struct-of-arrays builder the cold rank is a running-argmin
    reduction over `SearchSpace.iter_lattice` chunks: each chunk decodes
    at most ``chunk_size`` lattice rows, drops constraint-infeasible
    rows *before* feature construction, scores the survivors with the
    vectorized model, and contributes one ``(time, flat index, params)``
    candidate.  Peak memory is O(chunk_size), never O(space), and the
    reduction merges candidates by ``(time, flat index)`` — exactly the
    tie-break `np.argmin` applies over the materialized lattice — so
    the winner is bit-identical to the eager path for any chunk size
    and any ``workers`` count.

    ``workers > 1`` scores chunks on a bounded thread pool (at most
    ``2*workers`` chunks in flight, preserving the memory bound); each
    task runs under a copy of the submitting thread's context so
    `use_target` scoping survives the hop.

    Returns ``(params, predicted seconds, rows scored)``; raises
    ``ValueError`` when constraints eliminate every configuration.

    A `repro_torch.core.pipeline.PipelineModel` routes through the two-stage
    reranker instead: its Eq. 6 ``base`` produces the top-K shortlist
    (same streamed scoring as above), then the scoreboard simulator
    reranks only those K candidates.
    """
    if isinstance(model, PipelineModel):
        return _rank_space_pipeline(problem, model, chunk_size=chunk_size,
                                    workers=workers)
    batch = getattr(problem, "static_info_batch", None)
    if batch is None:
        pts = problem.space.enumerate()
        if not pts:
            raise ValueError("search space has no feasible configurations")
        infos = [problem.static_info(p) for p in pts]
        times = static_times_batch(infos, model)
        i = int(np.argmin(times))
        return pts[i], float(times[i]), len(pts)

    chunk = (chunk_size or getattr(problem, "chunk_size", None)
             or DEFAULT_CHUNK)

    def score(lat) -> Tuple[int, float, int, Optional[Params]]:
        if lat.size == 0:
            return 0, math.inf, -1, None
        info = batch(lat.columns)
        times = static_times_batch(None, model, F=info.F, pipe=info.pipe,
                                   feasible=info.feasible)
        j = int(np.argmin(times))
        off = lat.offsets
        g = int(off[j]) if off is not None else j
        return lat.size, float(times[j]), g, lat.params_at(j)

    chunks = problem.space.iter_lattice(chunk)
    if workers is not None and workers > 1:
        results = _map_bounded(score, chunks, workers)
    else:
        results = map(score, chunks)

    scored = 0
    best: Optional[Tuple[float, int, Params]] = None
    for n, t, g, params in results:
        scored += n
        if n == 0:
            continue
        # lexicographic (time, flat index): first-of-the-ties wins, the
        # same row np.argmin picks over the full lattice (inf times
        # included — an all-infeasible space still resolves to row 0).
        if best is None or t < best[0] or (t == best[0] and g < best[1]):
            best = (t, g, params)
    if best is None:
        raise ValueError("search space has no feasible configurations")
    return best[2], best[0], scored


def _rank_space_pipeline(problem: TuningProblem, model: PipelineModel, *,
                         chunk_size: Optional[int] = None,
                         workers: Optional[int] = None
                         ) -> Tuple[Params, float, int]:
    """Two-stage rank: Eq. 6 shortlist, scoreboard rerank (DESIGN.md §16).

    Stage 1 runs the *base* model over the whole space exactly like the
    plain path, but keeps the top ``model.keep_n`` rows instead of one —
    merged across chunks on ``(time, flat index)``, the stable-argsort
    order of the materialized lattice, so the shortlist is bit-identical
    for any chunk size or worker count.  Stage 2 builds the scalar
    static info for each shortlisted config (at most K objects — the
    SoA path stays object-free) and prices it with `simulate`; the
    winner is the lexicographic minimum of ``(pipeline time, base time,
    flat index)``, deterministic by the same argument.  An
    all-infeasible space resolves to row 0 with +inf, matching the
    plain path.
    """
    space = problem.space
    base = model.base
    cap = max(int(model.keep_n), 1)
    batch = getattr(problem, "static_info_batch", None)

    if batch is None:
        pts = space.enumerate()
        if not pts:
            raise ValueError("search space has no feasible configurations")
        infos = [problem.static_info(p) for p in pts]
        times = np.asarray(static_times_batch(infos, base),
                           dtype=np.float64)
        scored = len(pts)
        sel = np.lexsort((np.arange(scored), times))[:cap]
        short = [(float(times[i]), int(i), pts[int(i)]) for i in sel]
    else:
        chunk = (chunk_size or getattr(problem, "chunk_size", None)
                 or DEFAULT_CHUNK)

        def score(lat) -> Tuple[int, Optional[np.ndarray],
                                Optional[np.ndarray]]:
            if lat.size == 0:
                return 0, None, None
            info = batch(lat.columns)
            times = static_times_batch(None, base, F=info.F,
                                       pipe=info.pipe,
                                       feasible=info.feasible)
            g = lat.offsets if lat.offsets is not None \
                else np.arange(lat.size, dtype=np.int64)
            sel = np.lexsort((g, times))[:cap]
            return lat.size, times[sel], np.asarray(g)[sel]

        chunks = space.iter_lattice(chunk)
        if workers is not None and workers > 1:
            results = _map_bounded(score, chunks, workers)
        else:
            results = map(score, chunks)
        scored = 0
        best_t = np.empty(0, dtype=np.float64)
        best_g = np.empty(0, dtype=np.int64)
        for n, t, g in results:
            scored += n
            if n == 0:
                continue
            t_all = np.concatenate((best_t, t))
            g_all = np.concatenate((best_g, g))
            sel = np.lexsort((g_all, t_all))[:cap]
            best_t, best_g = t_all[sel], g_all[sel]
        if scored == 0:
            raise ValueError("search space has no feasible configurations")
        short = [(float(tv), int(gv), space.from_flat(int(gv)))
                 for tv, gv in zip(best_t, best_g)]

    sched = getattr(problem, "schedule", None)
    best: Optional[Tuple[float, float, int, Params]] = None
    for base_t, g, params in short:
        info = problem.static_info(params)
        t = model.time_info(info, schedule=sched(params) if sched else None)
        cand = (float(t), base_t, g, params)
        if best is None or cand[:3] < best[:3]:
            best = cand
    assert best is not None    # short is non-empty by construction
    return best[3], best[0], scored


def _map_bounded(fn: Callable, items, workers: int):
    """`map(fn, items)` on a thread pool with at most ``2*workers``
    futures in flight (so a lazy generator is never drained eagerly),
    yielding results in submission order.  Each task runs under a copy
    of the caller's `contextvars` context, preserving `use_target`
    scoping across the thread hop."""
    import contextvars
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    def gen():
        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending = deque()
            for item in items:
                while len(pending) >= workers * 2:
                    yield pending.popleft().result()
                ctx = contextvars.copy_context()
                pending.append(ex.submit(ctx.run, fn, item))
            while pending:
                yield pending.popleft().result()
    return gen()


# Guards the check-then-set on _DEFAULT_MODELS and shard creation in
# _DISPATCH_MEMO (plus clear_dispatch_memo): two threads
# cold-tuning the same kernel must not build duplicate cost models or
# interleave an insert with a concurrent clear.  The warm-path memo
# *read* stays a bare dict probe on purpose — dict get/set are atomic
# under the GIL, entries are immutable tuples tagged with the database
# generation (so a stale probe self-invalidates), and taking a lock
# there would put a contended acquire on every repeat trace.
_models_lock = threading.Lock()

# (spec fingerprint, model kind) -> CostModel | PipelineModel
_DEFAULT_MODELS: Dict[Tuple[str, str], Any] = {}


class _MemoShard:
    """One kernel's slice of the live warm-dispatch memo.

    Entries: ``(mode, spec fingerprint, sig key, model kind) ->
    (db generation, params dict)`` where the sig key is the entry's
    binder-canonical value tuple (so every valid spelling of a
    signature shares one entry), or ``("#raw", sorted items)`` for
    entries whose declaration is not binder-compilable, and the model
    kind is the entry's effective cost-model tier (``"eq6"`` or
    ``"pipeline"``) at insert time — a `set_default_model` switch
    re-keys instead of re-serving the previous tier's params.  Each
    shard has its own insert lock — concurrent dispatch of *different*
    kernels never contends.
    """

    __slots__ = ("lock", "entries")

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: Dict[Tuple, Tuple[int, Dict[str, Any]]] = {}


# Live warm-dispatch memo, sharded per kernel_id.  A repeat trace of the
# same op instance skips signature normalization, canonical-JSON
# rendering, and SHA-256 key hashing entirely — the memo hit is one
# dict probe.  Only engaged for the process-default database and model
# (explicit db/model callers get exact database semantics, e.g.
# hit/miss stats); invalidated by a default-database swap
# (`set_default_db`) and, via the stored generation, by bulk mutation
# of the live default database (`clear()` / `import_jsonl` /
# `warm_jsonl`).
_DISPATCH_MEMO: Dict[str, _MemoShard] = {}


def _shard(kernel_id: str) -> _MemoShard:
    s = _DISPATCH_MEMO.get(kernel_id)
    if s is None:
        with _models_lock:
            s = _DISPATCH_MEMO.get(kernel_id)
            if s is None:
                s = _DISPATCH_MEMO[kernel_id] = _MemoShard()
    return s


def dispatch_memo_keys() -> List[Tuple]:
    """Flat ``(kernel_id, mode, spec_fingerprint, sig_key, model_kind)``
    view of every live memo entry — introspection for tests and
    tooling; the memo itself is sharded per kernel_id."""
    out: List[Tuple] = []
    for kid, shard in list(_DISPATCH_MEMO.items()):
        with shard.lock:
            keys = list(shard.entries)
        out.extend((kid,) + k for k in keys)
    return out


def _binder_of(entry: Any) -> Optional[SigBinder]:
    get = getattr(entry, "sig_binder", None)
    return get() if get is not None else None


def _key_extras_of(entry: Any, spec: ChipSpec) -> Dict[str, Any]:
    """Entry-declared extra cache-key signature entries for one target
    (e.g. the variant-set digest a `KernelSpec` in variant mode
    contributes, and under a `HopperSpec` the digest of the compiled
    launch space); ``{}`` for entries without the hook."""
    get = getattr(entry, "key_extras", None)
    return get(spec) if get is not None else {}


def dispatch_key(kernel_id: str, *, spec: ChipSpec, mode: str,
                 model_name: Optional[str],
                 signature: Dict[str, Any]) -> CacheKey:
    """The one `CacheKey` construction every dispatch tier uses.

    Folds the entry's :func:`_key_extras_of` into the signature before
    keying, so the dispatch path (`lookup_or_tune`) and the frozen-table
    build agree on which records answer which questions.  Two variant
    sets of one logical op can therefore never share a digest.
    ``signature`` must already be normalized.
    """
    extras = _key_extras_of(_REGISTRY.get(kernel_id), spec)
    clash = set(extras) & set(signature)
    if clash:
        raise ValueError(
            f"kernel {kernel_id!r}: signature keys {sorted(clash)} "
            f"collide with reserved cache-key extras")
    return make_key(kernel_id, spec=spec, mode=mode,
                    model_name=model_name, **signature, **extras)

# Callbacks run by clear_dispatch_memo.  The kernel layer registers its
# per-process dispatch state here (e.g. the once-per-kernel failure log
# in repro_torch.kernels.api) so tests that reset the memo reset everything,
# without the registry importing the kernel layer.
_MEMO_CLEAR_HOOKS: list = []


def on_dispatch_memo_clear(hook: Callable[[], None]) -> Callable[[], None]:
    """Register a callback invoked whenever the dispatch memo clears."""
    if hook not in _MEMO_CLEAR_HOOKS:
        _MEMO_CLEAR_HOOKS.append(hook)
    return hook


def reset_models() -> None:
    """Drop the per-spec default-model memo (`_model_for`) — without
    this the memo grows one entry per distinct spec fingerprint forever
    and keeps serving stale models after a spec-table change.

    :func:`clear_dispatch_memo` performs the same sweep itself,
    atomically with the memo clear; this standalone hook is for callers
    that want fresh models without discarding the warm memo."""
    with _models_lock:
        _DEFAULT_MODELS.clear()


def clear_dispatch_memo() -> None:
    thaw()               # the frozen tier compiles memo + db state
    with _models_lock:
        for shard in _DISPATCH_MEMO.values():
            with shard.lock:
                shard.entries.clear()
        _DEFAULT_MODELS.clear()
        hooks = list(_MEMO_CLEAR_HOOKS)
    # hooks run unlocked: they may take their own locks (e.g. the
    # kernel layer's failure-log lock) and must not nest under ours
    for hook in hooks:
        hook()


# Resolved process-default model kind; None = not yet read from the
# environment.  Mutated only via set_default_model (tests, CLI) — the
# dispatch fast path reads the cached value without a lock.
_model_kind: Optional[str] = None


def _check_model_kind(kind: str) -> str:
    if kind not in MODEL_KINDS:
        raise ValueError(f"unknown tuning model {kind!r}; "
                         f"expected one of {MODEL_KINDS}")
    return kind


def default_model_kind() -> str:
    """The process-default model kind: `set_default_model`'s value, else
    ``REPRO_TUNING_MODEL`` (read once), else ``"eq6"``."""
    global _model_kind
    kind = _model_kind
    if kind is None:
        raw = os.environ.get(ENV_MODEL, "").strip().lower()
        kind = _check_model_kind(raw) if raw else "eq6"
        _model_kind = kind
    return kind


def set_default_model(kind: Optional[str]) -> str:
    """Set the process-default model kind (``None`` re-reads the
    environment on next use).  Thaws the frozen dispatch tier: frozen
    tables bake in each record's model fingerprint check, so answers
    frozen under the old kind must not survive the switch.  Returns the
    now-effective kind."""
    global _model_kind
    if kind is not None:
        kind = _check_model_kind(str(kind).strip().lower())
    thaw()
    with _models_lock:
        _model_kind = kind
    return default_model_kind()


def _kind_of(entry: Any) -> str:
    """Effective model kind for one registry entry: the declaration's
    ``model=`` when set (`KernelSpec.model`), else the process
    default."""
    kind = getattr(entry, "model", None)
    return kind if kind is not None else default_model_kind()


def _model_for(spec: ChipSpec, kind: Optional[str] = None):
    # memoized on (full-field fingerprint, kind): a modified spec that
    # keeps the default name must still get its own rate coefficients.
    # The fast path is a lock-free probe; the build is double-checked
    # under the module lock so concurrent cold tunes share one model
    # instance.  kind=None (the historical single-argument call) means
    # the process default.
    if kind is None:
        kind = default_model_kind()
    mk = (fingerprint_spec(spec), kind)
    model = _DEFAULT_MODELS.get(mk)
    if model is None:
        with _models_lock:
            model = _DEFAULT_MODELS.get(mk)
            if model is None:
                if isinstance(spec, HopperSpec):
                    base = default_hopper_model(spec)
                elif isinstance(spec, GpuSpec):
                    base = default_cuda_model(spec)
                else:
                    base = default_tpu_model(spec, mode="max")
                model = pipeline_model(spec, base=base) \
                    if kind == "pipeline" else base
                _DEFAULT_MODELS[mk] = model
    return model


# ---------------------------------------------------------------------------
# Frozen warm-dispatch tier (DESIGN.md §12)
# ---------------------------------------------------------------------------


class _FrozenState:
    """One immutable freeze: compiled probes + the provenance needed to
    decide whether a later freeze() can reuse it."""

    __slots__ = ("tables", "generation", "db", "size")

    def __init__(self, tables: Dict[Tuple[str, str], Callable],
                 generation: int, db: TuningDatabase, size: int):
        self.tables = tables        # (kernel_id, mode) -> probe
        self.generation = generation
        self.db = db
        self.size = size


# The whole frozen tier is one reference: readers load it once per
# dispatch (a local), so they see either a complete frozen state or
# none — never a half-built one.  Invalidation is a bare `_FROZEN =
# None` (atomic under the GIL, safe to run from the database's
# invalidation hook while its lock is held).
_FROZEN: Optional[_FrozenState] = None

# Serializes freeze() itself: concurrent freezes must yield ONE table,
# not race to publish two.
_freeze_lock = threading.Lock()


def thaw() -> None:
    """Drop the frozen dispatch tables; dispatch falls back to the live
    memo tier until the next :func:`freeze`."""
    global _FROZEN
    _FROZEN = None


def is_frozen() -> bool:
    return _FROZEN is not None


def _build_frozen_tables(db: TuningDatabase, gen: int
                         ) -> Tuple[Dict[Tuple[str, str], Callable], int]:
    binders = {kid: b for kid, entry in list(_REGISTRY.items())
               if (b := _binder_of(entry)) is not None}
    # (kernel_id, mode) -> {spec fingerprint -> {sig key -> params}}
    tables: Dict[Tuple[str, str], Dict[str, Dict[tuple, Dict[str, Any]]]] = {}
    size = 0

    def insert(kid: str, mode: str, fp: str, vals: tuple,
               params: Dict[str, Any]) -> int:
        sub = tables.setdefault((kid, mode), {}).setdefault(fp, {})
        if vals in sub:
            return 0
        sub[vals] = dict(params)
        return 1

    # 1) Database-resident records — this is what makes freeze-after-warm
    #    useful at serve startup, where the shipped pretuned JSONLs are
    #    loaded but nothing has dispatched yet.  A record is compiled in
    #    only when the frozen answer provably equals what the live
    #    default-model path would return: current MODEL_VERSION, a spec
    #    we can map back from its fingerprint, and the record's model
    #    name matching the freeze-time default model for that spec.
    fp_to_spec = {fingerprint_spec(s): s
                  for table in (TPU_TABLE, GPU_TABLE, HOPPER_TABLE)
                  for s in table.values()}
    for rec in db.snapshot():
        binder = binders.get(rec.key.kernel_id)
        if binder is None or rec.key.model_version != MODEL_VERSION:
            continue
        spec = fp_to_spec.get(rec.key.spec_fingerprint)
        if spec is None:
            continue
        try:
            sig = json.loads(rec.key.signature)
        except ValueError:
            continue
        kind = _kind_of(_REGISTRY.get(rec.key.kernel_id))
        if sig.pop("model", None) != _model_for(spec, kind).fingerprint():
            continue
        # Key extras ride in the stored signature but are not binder
        # axes: pop and require an exact match with the entry's CURRENT
        # extras (e.g. the variant-set digest).  A record ranked under a
        # since-mutated variant set silently stays out of the frozen
        # tier — same posture as the model check above.
        extras = _key_extras_of(_REGISTRY.get(rec.key.kernel_id), spec)
        if any(sig.pop(name, None) != extras.get(name)
               for name in ("variants", "hopper")):
            continue
        vals = binder.key(sig)
        if vals is None:
            continue
        try:
            size += insert(rec.key.kernel_id, rec.key.mode,
                           rec.key.spec_fingerprint, vals, rec.params)
        except TypeError:               # unhashable signature value
            continue

    # 2) Live memo entries of the current generation overlay — they are
    #    answers the default path already served this generation
    #    (including freshly cold-tuned signatures not in any JSONL).
    for kid, shard in list(_DISPATCH_MEMO.items()):
        binder = binders.get(kid)
        if binder is None:
            continue                    # raw-keyed shard: not freezable
        with shard.lock:
            entries = list(shard.entries.items())
        cur_kind = _kind_of(_REGISTRY.get(kid))
        for (mode, fp, vals, k), (g, params) in entries:
            if g != gen or k != cur_kind:
                continue
            size += insert(kid, mode, fp, vals, params)

    default_fp = fingerprint_spec(unscoped_default())
    probes = {}
    for km, sub in tables.items():
        # insert() may have created a subtable and then failed the hash
        # (unhashable signature value) — an empty table earns no probe.
        sub = {fp: t for fp, t in sub.items() if t}
        if sub:
            probes[km] = compile_probe(binders[km[0]], sub, default_fp)
    return probes, size


def freeze() -> int:
    """Compile the live dispatch state into immutable frozen tables.

    Sources both the process-default database's resident records (the
    shipped pretuned JSONLs plus anything warmed/tuned into it) and the
    current-generation live memo; returns the number of frozen entries.
    Binder-less registrations (legacy ``**kwargs`` factories) and
    records tuned under a non-default model are excluded — they keep
    dispatching through the live tiers.

    The frozen tier thaws automatically on any database generation bump
    (``clear`` / ``import_jsonl`` / ``warm_jsonl``),
    `clear_dispatch_memo`, `set_default_db`,
    and `repro_torch.core.target.set_default_target`; re-freeze
    after re-warming.  Mutating ``REPRO_TUNING_TARGET`` directly after a
    freeze is the one unsupported path — call :func:`thaw` yourself.
    """
    global _FROZEN
    from repro_torch.tuning_cache import get_default_db
    db = get_default_db()
    with _freeze_lock:
        cur = _FROZEN
        if (cur is not None and cur.db is db
                and cur.generation == db.generation):
            return cur.size             # already frozen and current
        # Register the thaw hook BEFORE reading the generation: a bump
        # that lands during the build either fires the hook after we
        # publish (thawing the stale state) or is caught by the
        # re-check below — it can never be lost.
        db.on_invalidate(thaw)
        gen = db.generation
        tables, size = _build_frozen_tables(db, gen)
        _FROZEN = _FrozenState(tables, gen, db, size)
        if db.generation != gen:        # a bump raced the build
            _FROZEN = None
            return 0
        return size


def frozen_table(kernel_id: str, mode: str = "static"
                 ) -> Optional[Callable[..., Optional[Dict[str, Any]]]]:
    """The raw compiled probe for one (kernel, mode), or ``None`` when
    nothing is frozen for it.  ``probe(signature_dict)`` returns a
    fresh params dict or ``None`` — the hot-loop entry point for op
    wrappers and benchmarks; re-fetch it whenever :func:`is_frozen` /
    the table identity changes."""
    fz = _FROZEN
    if fz is None:
        return None
    return fz.tables.get((kernel_id, mode))


def frozen_lookup(kernel_id: str, signature: Dict[str, Any], *,
                  spec: Union[str, ChipSpec, None] = None,
                  mode: str = "static") -> Optional[Dict[str, Any]]:
    """Probe the frozen tier only: params dict on a hit, ``None`` on a
    miss (nothing frozen, unknown signature spelling, uncovered spec,
    or an unhashable signature value)."""
    fz = _FROZEN
    if fz is None:
        return None
    probe = fz.tables.get((kernel_id, mode))
    if probe is None:
        return None
    try:
        return probe(signature, spec)
    except TypeError:                   # unhashable signature value
        return None


# A process-default-target change invalidates the frozen fast path's
# specialization (it bakes in the freeze-time unscoped default).
on_default_target_change(thaw)


def _service_resolve(key: CacheKey, kernel_id: str,
                     signature: Dict[str, Any], spec: ChipSpec,
                     mode: str) -> Optional[TuningRecord]:
    """Consult the configured tuning service for one kernel instance.

    Returns a `TuningRecord` under *our* locally-computed key, or
    ``None`` on miss or degradation.  Never raises — the service tier
    is optional by contract (`ServiceClient.resolve` already absorbs
    every transport failure; this guard covers payload surprises)."""
    from repro_torch.tuning_cache import service_client
    try:
        client = service_client()
        if client is None:
            return None
        payload = client.resolve(kernel_id, dict(signature),
                                 target=spec.name,
                                 fingerprint=fingerprint_spec(spec),
                                 mode=mode)
        if payload is None or payload.get("digest") != key.digest:
            # A digest mismatch means the server ranked under a
            # different model/key schema: its params answer some other
            # question, not our key.  Treat as a miss.
            return None
        return TuningRecord.from_dict({**payload, "key": key.to_dict()})
    except Exception:
        return None


_tc = None   # the repro_torch.tuning_cache package, bound on first dispatch


def lookup_or_tune(kernel_id: str, *,
                   spec: Union[str, ChipSpec, None] = None,
                   mode: str = "static",
                   model: Union[CostModel, str, None] = None,
                   db: Optional[TuningDatabase] = None,
                   **signature: Any) -> Dict[str, Any]:
    """Resolve launch params for a kernel instance, cache-first.

    Returns a plain params dict for the kernel's launch.
    ``spec=None`` tunes for the process-default target
    (`repro_torch.core.target.default_target`); every spec family works
    — a `GpuSpec` (``spec="kepler_k20"``) ranks the kernel's CUDA
    thread-block space under the faithful Eqs. 1-6 models and yields
    Table-VII-consistent ``{"threads": ...}`` params, a `TpuSpec`
    ranks the Pallas block space, and a `HopperSpec` ranks the compiled
    CUDA instantiations (``{"tile": ...}``, plus ``"variant"``) that
    the kernel wrapper then launches.  The spec fingerprint is part of the
    cache key and the dispatch memo, so per-target results are fully
    isolated.  Identical ``(kernel_id, signature, spec)`` calls after
    the first are pure cache hits: no space enumeration, no
    static_info construction, no cost-model evaluation.  On the default
    db/model path repeat calls are additionally memoized per process,
    skipping even key construction — warm dispatch is a single dict
    probe (and after :func:`freeze`, a lock-free frozen-table probe
    with no generation check at all).

    ``model`` takes a `CostModel`/`PipelineModel` instance, a model
    *kind* name from `MODEL_KINDS` (``"eq6"`` / ``"pipeline"`` — the CLI
    ``--model`` spelling, resolved per spec like
    ``@tuned_kernel(model=...)``), or ``None`` for the kernel's declared
    kind under the process default.  The model's fingerprint
    rides on the cache key, so records ranked under different tiers
    never mix.

    Only the all-default path (``db`` and ``model`` both ``None``)
    consults a configured tuning service, between the live memo and the
    local database; it also warms the target's shipped pretuned JSONL
    into the default database on the target's first dispatch.
    """
    kind: Optional[str] = None
    if isinstance(model, str):
        # a kind name is an *explicit* model request: same database
        # semantics as passing the built model object (no memo, no
        # service), just resolved per spec below.
        kind = _check_model_kind(model)
        model = None
    if db is None and model is None and kind is None:
        fz = _FROZEN
        if fz is not None:
            probe = fz.tables.get((kernel_id, mode))
            if probe is not None:
                try:
                    hit = probe(signature, spec)
                except TypeError:       # unhashable signature value
                    hit = None
                if hit is not None:
                    return hit
    if not isinstance(spec, (TpuSpec, GpuSpec, HopperSpec)):  # resolve once
        spec = resolve_target(spec)
    memo_key = shard = None
    gen0 = 0
    use_service = False
    if db is None:
        # parent package — circular at module-import time, so bound
        # lazily once rather than paying a per-dispatch `from ... import`
        global _tc
        if _tc is None:
            import repro_torch.tuning_cache as _tc_mod
            _tc = _tc_mod
        db = _tc.get_default_db()
        if spec.name not in db.warmed_targets:     # once per (db, target)
            _tc._warm_pretuned_spec(db, spec)
        # Only the all-default path consults the tuning service: an
        # explicit model (or kind) would key a digest the server
        # (which ranks under ITS default model) can never answer.
        use_service = model is None and kind is None
        if use_service:         # default db + default model: memo engages
            entry = _REGISTRY.get(kernel_id)
            binder = _binder_of(entry) if entry is not None else None
            # the entry's effective model kind is part of the memo key:
            # a set_default_model switch must re-key, not re-serve the
            # previous tier's params
            eff_kind = _kind_of(entry)
            try:
                if binder is not None:
                    vals = binder.key(signature)
                    if vals is not None:   # canonical: all spellings share it
                        memo_key = (mode, fingerprint_spec(spec), vals,
                                    eff_kind)
                elif entry is not None:    # not compilable: raw spelling
                    memo_key = (mode, fingerprint_spec(spec),
                                ("#raw", tuple(sorted(signature.items()))),
                                eff_kind)
                if memo_key is not None:
                    shard = _shard(kernel_id)
                    # generation read BEFORE the database consult: if a
                    # bulk mutation lands in between, the entry we
                    # insert is tagged stale and self-invalidates.
                    gen0 = db.generation
                    hit = shard.entries.get(memo_key)
                    if hit is not None and hit[0] == gen0:
                        return hit[1].copy()
            except TypeError:       # unhashable signature value
                memo_key = None
    if model is None:
        model = _model_for(spec, kind if kind is not None
                           else _kind_of(_REGISTRY.get(kernel_id)))
    signature = normalize_signature(kernel_id, signature)
    key = dispatch_key(kernel_id, spec=spec, mode=mode,
                       model_name=model.fingerprint(), signature=signature)

    if use_service:
        # Service tier (DESIGN.md §13): between the live memo and the
        # local database.  A hit is written through to the local tiers
        # so later dispatches (and other processes sharing the disk
        # store) stay warm even if the service dies; any failure —
        # unreachable, slow, corrupt — returns None and we fall
        # through to the local tiers below.
        rec = _service_resolve(key, kernel_id, signature, spec, mode)
        if rec is not None:
            db.put(rec)
            params = dict(rec.params)
            if memo_key is not None:
                with shard.lock:
                    shard.entries[memo_key] = (gen0, dict(params))
            return params

    def tune() -> TuningRecord:
        # The problem's static_info builders resolve their own spec from
        # the default target; pin it to the spec this key was built for.
        with use_target(spec):
            problem = get_problem(kernel_id, **signature)
            params, predicted, n = rank_space(problem, model)
        return TuningRecord(key=key, params=dict(params),
                            predicted_s=predicted, space_size=n,
                            source=mode, created_unix=now_unix())

    params = dict(db.lookup_or_tune(key, tune).params)
    if memo_key is not None:
        # stored as a private dict (readers get .copy()) so a caller
        # mutating the returned params can never poison later
        # dispatches; tagged with the pre-consult generation so bulk db
        # mutation invalidates the entry.  Insert under the shard lock
        # so it cannot interleave with a concurrent clear's sweep.
        with shard.lock:
            shard.entries[memo_key] = (gen0, dict(params))
    return params
