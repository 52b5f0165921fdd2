"""Kernel-variant dispatch: *which implementation* as a tuning axis.

Parametric-kernel autotuning treats code variants as first-class
dimensions of the search space (Chen et al., arXiv:1801.04348), and
tuner benchmarking shows variant choice often dominates parameter
choice (Schoonhoven et al., arXiv:2210.01465).  This module makes that
structural for `@tuned_kernel`: a logical op may register several
Pallas implementations (flash vs. blocked attention, fused vs. split
MLP), each contributing its own parameter sub-space, and the variant id
becomes one more axis — ``"variant"`` — of a **joint** `SearchSpace`
ranked by the same streaming struct-of-arrays cold path as any block
axis (DESIGN.md §15).

Joint-space layout
------------------

For variants ``{vid: axes_vid}`` over one normalized signature:

* axes = ``{"variant": (vid, ...)}`` plus the ordered union of every
  variant's materialized axes;
* a vectorized **membership constraint** keeps exactly one joint row
  per (variant, own-config): rows tagged ``variant == vid`` must hold a
  candidate of *vid's* sub-space on each axis vid declares, and the
  union axes vid does *not* declare are pinned to their first union
  candidate (so foreign axes never multiply vid's row count);
* each variant's own ``constraints=`` are lifted to
  ``(variant != vid) | constraint`` — they restrict only their rows.

Constraint pushdown then prunes infeasible variants **before** feature
construction, and `SearchSpace.satisfies` routes scalars through the
same predicates, so scalar==batch parity holds by construction.

Batched analysis routes each row subset to its variant's own analyzer
and scatters the results back into one `JointBatchInfo` (duck-typed for
`rank_space`: ``F``/``pipe``/``feasible``/``__len__``), so a cold rank
of a multi-variant op is still one vectorized pass.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.search import Constraint, SearchSpace
from repro_torch.kernels.common import block_info, block_info_batch

__all__ = ["KernelVariant", "JointBatchInfo", "VARIANT_AXIS",
           "joint_space", "joint_static_info", "joint_static_info_batch",
           "variants_fingerprint"]

# The reserved joint-space axis carrying the implementation id.
VARIANT_AXIS = "variant"


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One implementation of a logical op.

    * ``variant_id`` — the value stored on the ``"variant"`` axis (and
      in every cached/frozen record that picks this implementation).
    * ``fn(*arrays, **launch_params)`` — the Pallas entry point; launch
      params are keywords named exactly like this variant's own axes.
    * ``space`` — this variant's axes (`divisors(...)` / sequences),
      coerced exactly like a `@tuned_kernel` ``space=``.
    * ``analysis(p, **signature)`` — array-agnostic static analyzer over
      this variant's axes only; same `block_info` kwargs contract, and
      the same signature schema as the primary declaration (the logical
      op has ONE signature; implementations share it).
    * ``constraints`` — optional feasibility predicates over this
      variant's axes (same forms as ``@tuned_kernel constraints=``);
      lifted so they only restrict this variant's joint rows.
    """

    variant_id: str
    fn: Callable[..., Any]
    space: Dict[str, Any]
    analysis: Callable[..., Dict[str, Any]]
    constraints: Any = None

    def __post_init__(self):
        if not self.variant_id or not isinstance(self.variant_id, str):
            raise ValueError(f"variant_id must be a non-empty string, "
                             f"got {self.variant_id!r}")
        if VARIANT_AXIS in self.space:
            raise ValueError(
                f"variant {self.variant_id!r} declares an axis named "
                f"{VARIANT_AXIS!r} — that name is reserved for the "
                f"joint variant axis")

    def materialized_axes(self, sig: Mapping[str, Any]
                          ) -> Dict[str, Tuple[Any, ...]]:
        return {name: axis.materialize(sig)
                for name, axis in self.space.items()}

    def materialized_constraints(self, sig: Mapping[str, Any]
                                 ) -> Tuple[Any, ...]:
        cons = self.constraints
        if cons is None:
            return ()
        if callable(cons) and not isinstance(cons, Constraint):
            cons = cons(**sig)
        return tuple(cons or ())


def _axis_decl_repr(axis: Any) -> str:
    """Stable structural rendering of one axis declaration (Divisors
    carry (dim, candidates); literal axes carry their value tuple)."""
    dim = getattr(axis, "dim", None)
    if dim is not None:
        return f"div:{dim}:{tuple(axis.candidates)}"
    return f"lit:{tuple(axis.values)}"


def variants_fingerprint(variants: Mapping[str, KernelVariant]) -> str:
    """Structural digest of a variant set: ids + each variant's axis
    declarations.  Part of the cache-key signature (``"variants"``), so
    records ranked under one variant set can never answer dispatch for
    another — adding, removing, or re-spacing a variant changes every
    affected digest, and the single-flight service tier (keyed on the
    digest) never coalesces across variant sets."""
    parts = []
    for vid in sorted(variants):
        axes = variants[vid].space
        decl = ",".join(f"{name}={_axis_decl_repr(axes[name])}"
                        for name in sorted(axes))
        parts.append(f"{vid}({decl})")
    payload = ";".join(parts)
    return hashlib.sha256(payload.encode()).hexdigest()[:12]


def _union_axes(variants: Mapping[str, KernelVariant],
                sig: Mapping[str, Any]
                ) -> Tuple[Dict[str, Dict[str, Tuple]], Dict[str, Tuple]]:
    """Per-variant materialized axes + their ordered-dedup union."""
    mat = {vid: v.materialized_axes(sig) for vid, v in variants.items()}
    union: Dict[str, Tuple[Any, ...]] = {}
    for vid in variants:
        for name, cands in mat[vid].items():
            cur = union.get(name, ())
            for c in cands:
                if c not in cur:
                    cur = cur + (c,)
            union[name] = cur
    return mat, union


def joint_space(variants: Mapping[str, KernelVariant],
                sig: Mapping[str, Any],
                shared_constraints: Tuple[Any, ...] = ()) -> SearchSpace:
    """The joint `SearchSpace` over every variant's sub-space.

    ``shared_constraints`` (the primary declaration's materialized
    ``constraints=``) apply to every row regardless of variant — they
    see the full joint columns, including ``"variant"``.
    """
    vids = tuple(variants)
    mat, union = _union_axes(variants, sig)
    axes: Dict[str, Tuple[Any, ...]] = {VARIANT_AXIS: vids}
    axes.update(union)

    # Precompute per-variant (own-axis candidate sets, foreign pins) so
    # the membership predicate is pure array ops per chunk.
    member_decl = {}
    for vid in vids:
        own = {name: np.asarray(cands)
               for name, cands in mat[vid].items()}
        pins = {name: cands[0] for name, cands in union.items()
                if name not in mat[vid]}
        member_decl[vid] = (own, pins)

    def _membership(cols: Dict[str, np.ndarray]) -> np.ndarray:
        var = np.asarray(cols[VARIANT_AXIS])
        ok = np.ones(len(var), dtype=bool)
        for vid, (own, pins) in member_decl.items():
            is_v = var == vid
            if not is_v.any():
                continue
            for name, cands in own.items():
                ok &= ~is_v | np.isin(np.asarray(cols[name]), cands)
            for name, pin in pins.items():
                ok &= ~is_v | (np.asarray(cols[name]) == pin)
        return ok

    constraints = [Constraint(_membership, name="variant-membership")]
    for vid, v in variants.items():
        for c in v.materialized_constraints(sig):
            c = c if isinstance(c, Constraint) \
                else Constraint(c, getattr(c, "__name__", "") or "")

            def _lifted(cols, _c=c, _vid=vid):
                var = np.asarray(cols[VARIANT_AXIS])
                return (var != _vid) | _c.mask(cols, len(var))

            constraints.append(
                Constraint(_lifted, name=f"{vid}:{c.name}"))
    constraints.extend(shared_constraints)
    return SearchSpace(axes, constraints=tuple(constraints))


@dataclasses.dataclass(frozen=True)
class JointBatchInfo:
    """Struct-of-arrays static info over a joint (multi-variant) chunk.

    Duck-typed for `repro_torch.tuning_cache.registry.rank_space`, which
    consumes exactly ``F`` (N, 7), ``pipe`` (N,), ``feasible`` (N,) and
    ``len()``.  Rows were produced by each variant's own
    `block_info_batch` on its subset and scattered back in row order,
    so row ``i`` matches the scalar `joint_static_info` for row ``i``'s
    params exactly.
    """

    F: np.ndarray                   # (N, 7) float64
    pipe: np.ndarray                # (N,) float64
    feasible: np.ndarray            # (N,) bool
    variant: np.ndarray             # (N,) the variant column (diagnostics)

    def __len__(self) -> int:
        return int(self.F.shape[0])


def joint_static_info_batch(variants: Mapping[str, KernelVariant],
                            cols: Mapping[str, np.ndarray],
                            sig: Mapping[str, Any]) -> JointBatchInfo:
    """Batched analysis of a joint chunk: route each row subset to its
    variant's analyzer, scatter F/pipe/feasible back into full-length
    arrays.  Rows whose variant id is unknown (a stale lattice raced a
    variant unregister) stay infeasible/inf and can never win."""
    var = np.asarray(cols[VARIANT_AXIS])
    n = len(var)
    F = np.zeros((n, 7), dtype=np.float64)
    pipe = np.full(n, np.inf, dtype=np.float64)
    feasible = np.zeros(n, dtype=bool)
    for vid, v in variants.items():
        m = var == vid
        if not m.any():
            continue
        sub = {name: np.asarray(cols[name])[m] for name in v.space}
        info = block_info_batch(**v.analysis(sub, **sig))
        F[m] = info.F
        pipe[m] = info.pipe
        feasible[m] = info.feasible
    return JointBatchInfo(F=F, pipe=pipe, feasible=feasible, variant=var)


def joint_static_info(variants: Mapping[str, KernelVariant],
                      params: Mapping[str, Any],
                      sig: Mapping[str, Any]):
    """Scalar analysis of one joint config: route on ``params["variant"]``
    and analyze only that variant's own axes (pinned foreign axes are
    ignored, exactly as the batched path masks them out)."""
    v = variants.get(params.get(VARIANT_AXIS))
    if v is None:
        raise KeyError(
            f"joint params carry no known variant id: "
            f"{params.get(VARIANT_AXIS)!r} not in {sorted(variants)}")
    sub = {name: params[name] for name in v.space}
    return block_info(**v.analysis(sub, **sig))


def check_variant_schema(kernel_id: str, primary_names: Tuple[str, ...],
                         variant: KernelVariant) -> None:
    """A logical op has ONE signature schema; every variant's analyzer
    must bind the same keyword names (required names and defaults are
    the primary declaration's business — variants just consume the
    normalized signature)."""
    params = list(inspect.signature(variant.analysis).parameters.values())
    if not params:
        raise ValueError(
            f"@tuned_kernel({kernel_id!r}) variant "
            f"{variant.variant_id!r}: analysis must take "
            f"(params, **signature)")
    names = tuple(p.name for p in params[1:]
                  if p.kind is not inspect.Parameter.VAR_KEYWORD)
    has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in params[1:])
    unknown = set(names) - set(primary_names)
    if unknown:
        raise ValueError(
            f"@tuned_kernel({kernel_id!r}) variant "
            f"{variant.variant_id!r}: analysis binds signature keys "
            f"{sorted(unknown)} the primary declaration does not "
            f"define (primary schema: {list(primary_names)})")
    if not has_var_kw and set(primary_names) - set(names):
        raise ValueError(
            f"@tuned_kernel({kernel_id!r}) variant "
            f"{variant.variant_id!r}: analysis must accept every "
            f"primary signature key (missing "
            f"{sorted(set(primary_names) - set(names))}; add **_ to "
            f"ignore extras)")
