"""Discrete search spaces (paper §III-C).

Orio's menu — exhaustive, random, simulated annealing, genetic,
Nelder–Mead — plus the paper's contribution: **static-model pruning**
that ranks the whole space with the predictive model (zero executions)
and hands a small candidate subset to any inner strategy.

All strategies share one interface::

    result = strategy.minimize(objective, space, budget=...)

where ``objective(params) -> float`` is only invoked for *empirical*
evaluations (the thing the paper is trying to avoid); every strategy
reports how many times it called it.  Each draws from
``random.Random(seed)`` exactly as the reference does, so with the same
seed and objective it visits the same points in the same order.

Spaces can carry **constraints** — vectorized predicates over axis
columns — and enumerate lazily in bounded-memory chunks
(`SearchSpace.iter_lattice`), so ranking scales to multi-million-point
constrained spaces without materializing an O(N) lattice (DESIGN.md
§14).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

__all__ = [
    "SearchSpace", "ConfigLattice", "Constraint", "SearchResult",
    "ExhaustiveSearch", "RandomSearch", "SimulatedAnnealing",
    "GeneticSearch", "NelderMeadSearch", "StaticPrunedSearch",
    "DEFAULT_CHUNK",
]

Params = Dict[str, object]
Objective = Callable[[Params], float]

# Default streaming chunk: 128k rows ≈ a few MB of int64 indices plus
# one value column per axis — big enough to amortize numpy dispatch,
# small enough that peak memory stays O(chunk), not O(space).
DEFAULT_CHUNK = 131072


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A vectorized feasibility predicate over axis columns.

    ``fn(columns) -> bool mask`` receives ``{name: (n,) array}`` — one
    column per axis, same row order — and returns a boolean array (or a
    scalar, broadcast to all rows).  Constraints are evaluated per chunk
    *before* feature construction, so infeasible rows never reach the
    cost model (constraint pushdown).
    """

    fn: Callable[[Dict[str, np.ndarray]], object]
    name: str = ""

    def mask(self, columns: Dict[str, np.ndarray], n: int) -> np.ndarray:
        m = np.asarray(self.fn(columns))
        if m.shape == ():
            return np.full(n, bool(m))
        return m.astype(bool, copy=False)


@dataclasses.dataclass(frozen=True)
class ConfigLattice:
    """Struct-of-arrays view of a `SearchSpace` enumeration.

    ``columns[name]`` is the (N,) array of that axis's value for every
    configuration; ``indices`` is the (ndim, N) axis-index lattice. Row
    ``i`` corresponds exactly to ``space.enumerate()[i]`` (same C order,
    last axis fastest), so an argmin over batch-scored times identifies
    the same configuration the scalar path would pick — including ties.

    ``offsets[i]`` is row ``i``'s flat index into the *unconstrained*
    lattice — the global tie-break key that keeps chunked/filtered
    enumeration bit-identical to the materialized path.
    """

    space: "SearchSpace"
    indices: np.ndarray                  # (ndim, N) int
    columns: Dict[str, np.ndarray]       # name -> (N,) axis values
    offsets: Optional[np.ndarray] = None  # (N,) flat enumeration index

    @property
    def size(self) -> int:
        return int(self.indices.shape[1]) if self.indices.ndim == 2 else 0

    def params_at(self, i: int) -> Params:
        """Config ``i`` as a plain params dict (original axis objects,
        not numpy scalars — these get JSON-serialized downstream)."""
        return {k: self.space.axes[k][int(row[i])]
                for k, row in zip(self.space.names, self.indices)}


ConstraintLike = Union[Constraint, Callable[[Dict[str, np.ndarray]], object]]


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Cartesian product of named discrete axes (paper Table III style),
    optionally restricted by vectorized `Constraint` predicates.

    ``size`` is the full lattice size; ``enumerate()`` /
    ``enumerate_lattice()`` / ``iter_lattice()`` yield only feasible
    configurations, in lattice order.
    """

    axes: Dict[str, Tuple[object, ...]]
    constraints: Tuple[Constraint, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "axes",
                           {k: tuple(v) for k, v in self.axes.items()})
        cons = tuple(c if isinstance(c, Constraint)
                     else Constraint(c, getattr(c, "__name__", "") or "")
                     for c in (self.constraints or ()))
        object.__setattr__(self, "constraints", cons)
        # Memoized per-axis value->first-index maps: index_of/neighbors
        # are O(ndim) dict probes instead of linear tuple.index scans.
        # Unhashable axis values fall back to the linear scan.
        maps = {}
        for k, vals in self.axes.items():
            try:
                m: Optional[Dict[object, int]] = {}
                for i, v in enumerate(vals):
                    m.setdefault(v, i)
            except TypeError:
                m = None
            maps[k] = m
        object.__setattr__(self, "_index_maps", maps)

    @property
    def names(self) -> List[str]:
        return list(self.axes.keys())

    @property
    def size(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= len(v)
        return n

    # -- feasibility ---------------------------------------------------
    def feasible_mask(self, columns: Dict[str, np.ndarray],
                      n: int) -> np.ndarray:
        mask = np.ones(n, dtype=bool)
        for c in self.constraints:
            mask &= c.mask(columns, n)
        return mask

    def satisfies(self, params: Params) -> bool:
        """Scalar constraint check (1-row columns through the same
        vectorized predicates, so scalar and batch agree by
        construction)."""
        if not self.constraints:
            return True
        cols = {k: np.asarray([params[k]]) for k in self.names}
        return bool(self.feasible_mask(cols, 1)[0])

    # -- enumeration ---------------------------------------------------
    def iter_configs(self) -> Iterator[Params]:
        """Lazily yield feasible configs as dicts, in lattice order."""
        keys = self.names
        for combo in itertools.product(*self.axes.values()):
            p = dict(zip(keys, combo))
            if self.satisfies(p):
                yield p

    def enumerate(self) -> List[Params]:
        keys = self.names
        if not self.constraints:
            return [dict(zip(keys, combo))
                    for combo in itertools.product(*self.axes.values())]
        return list(self.iter_configs())

    def enumerate_lattice(self) -> ConfigLattice:
        """The whole space as index/value arrays — no per-config dicts.

        This is the batched-analysis entry point: one (ndim, N) index
        lattice plus one value column per axis, in `enumerate()` order
        (constraint-filtered, with `offsets` recording each surviving
        row's flat lattice index).
        """
        sizes = [len(self.axes[k]) for k in self.names]
        if not sizes:
            return ConfigLattice(space=self, indices=np.zeros((0, 1), int),
                                 columns={},
                                 offsets=np.zeros(1, dtype=np.int64))
        idx = np.indices(sizes).reshape(len(sizes), -1)
        cols = {k: np.asarray(self.axes[k])[row]
                for k, row in zip(self.names, idx)}
        off = np.arange(idx.shape[1], dtype=np.int64)
        if self.constraints:
            mask = self.feasible_mask(cols, idx.shape[1])
            if not mask.all():
                idx = idx[:, mask]
                cols = {k: c[mask] for k, c in cols.items()}
                off = off[mask]
        return ConfigLattice(space=self, indices=idx, columns=cols,
                             offsets=off)

    def iter_lattice(self, chunk_size: int = DEFAULT_CHUNK
                     ) -> Iterator[ConfigLattice]:
        """Yield `ConfigLattice` chunks in exact `enumerate()` order.

        Each chunk decodes at most ``chunk_size`` flat lattice indices
        via mixed-radix arithmetic (bit-identical to ``np.indices`` C
        order), applies the constraints, and yields only feasible rows
        — peak memory is O(chunk_size · ndim), never O(space.size).
        Chunks may be empty after filtering; ``offsets`` carries the
        surviving rows' global flat indices for cross-chunk tie-breaks.
        """
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        sizes = [len(self.axes[k]) for k in self.names]
        if not sizes:
            yield self.enumerate_lattice()
            return
        strides = np.ones(len(sizes), dtype=np.int64)
        for d in range(len(sizes) - 2, -1, -1):
            strides[d] = strides[d + 1] * sizes[d + 1]
        values = [np.asarray(self.axes[k]) for k in self.names]
        total = self.size
        for lo in range(0, total, chunk_size):
            g = np.arange(lo, min(lo + chunk_size, total), dtype=np.int64)
            idx = np.empty((len(sizes), g.size), dtype=np.int64)
            for d in range(len(sizes)):
                idx[d] = (g // strides[d]) % sizes[d]
            cols = {k: values[d][idx[d]]
                    for d, k in enumerate(self.names)}
            if self.constraints:
                mask = self.feasible_mask(cols, g.size)
                if not mask.all():
                    idx = idx[:, mask]
                    cols = {k: c[mask] for k, c in cols.items()}
                    g = g[mask]
            yield ConfigLattice(space=self, indices=idx, columns=cols,
                                offsets=g)

    def from_flat(self, flat: int) -> Params:
        """Decode a flat lattice index (a `ConfigLattice.offsets` entry)
        back into a params dict of original axis objects."""
        out: Dict[str, object] = {}
        g = int(flat)
        for k in reversed(self.names):
            n = len(self.axes[k])
            out[k] = self.axes[k][g % n]
            g //= n
        return {k: out[k] for k in self.names}

    # -- point ops -----------------------------------------------------
    def sample(self, rng: random.Random, max_tries: int = 1000) -> Params:
        for _ in range(max_tries):
            p = {k: rng.choice(v) for k, v in self.axes.items()}
            if self.satisfies(p):
                return p
        raise ValueError(
            "could not sample a feasible configuration in "
            f"{max_tries} tries (constraints too tight?)")

    def _axis_index(self, k: str, v: object) -> int:
        m = self._index_maps[k]
        if m is not None:
            try:
                return m[v]
            except (KeyError, TypeError):
                pass
        return self.axes[k].index(v)

    def index_of(self, params: Params) -> Tuple[int, ...]:
        return tuple(self._axis_index(k, params[k]) for k in self.names)

    def from_indices(self, idx: Sequence[int]) -> Params:
        return {k: self.axes[k][min(max(int(round(i)), 0),
                                    len(self.axes[k]) - 1)]
                for k, i in zip(self.names, idx)}

    def neighbors(self, params: Params, rng: random.Random) -> Params:
        """Perturb one random axis by one step (for SA); with
        constraints, retry until the perturbed point is feasible."""
        for _ in range(64):
            out = dict(params)
            k = rng.choice(self.names)
            vals = self.axes[k]
            i = self._axis_index(k, out[k])
            j = min(max(i + rng.choice([-1, 1]), 0), len(vals) - 1)
            out[k] = vals[j]
            if self.satisfies(out):
                return out
        return dict(params)


@dataclasses.dataclass
class SearchResult:
    best_params: Params
    best_value: float
    evaluations: int                 # empirical objective calls
    space_size: int
    candidates_considered: int       # statically-ranked or enumerated points
    history: List[Tuple[Params, float]] = dataclasses.field(default_factory=list)

    @property
    def search_space_reduction(self) -> float:
        """Paper Fig. 6 metric: fraction of the space never measured."""
        if self.space_size == 0:
            return 0.0
        return 1.0 - self.evaluations / self.space_size


class _Base:
    def __init__(self, seed: int = 0):
        self.seed = seed

    def minimize(self, objective: Objective, space: SearchSpace,
                 budget: Optional[int] = None) -> SearchResult:
        raise NotImplementedError


class ExhaustiveSearch(_Base):
    def minimize(self, objective, space, budget=None):
        hist, best_p, best_v = [], None, math.inf
        # lazy: a budgeted exhaustive pass over a mega-space must not
        # allocate O(N) dicts up front
        pts: Iterator[Params] = space.iter_configs()
        if budget is not None:
            pts = itertools.islice(pts, budget)
        count = 0
        for p in pts:
            count += 1
            v = float(objective(p))
            hist.append((p, v))
            if v < best_v:
                best_p, best_v = p, v
        return SearchResult(best_p, best_v, len(hist), space.size,
                            count, hist)


class RandomSearch(_Base):
    def minimize(self, objective, space, budget=None):
        rng = random.Random(self.seed)
        budget = budget or max(1, space.size // 10)
        seen, hist, best_p, best_v = set(), [], None, math.inf
        tries = 0
        while len(hist) < budget and tries < budget * 20:
            tries += 1
            p = space.sample(rng)
            key = space.index_of(p)   # axis indices: cheap, collision-free
            if key in seen:
                continue
            seen.add(key)
            v = float(objective(p))
            hist.append((p, v))
            if v < best_v:
                best_p, best_v = p, v
        return SearchResult(best_p, best_v, len(hist), space.size,
                            len(hist), hist)


class SimulatedAnnealing(_Base):
    def __init__(self, seed: int = 0, t0: float = 1.0, alpha: float = 0.95):
        super().__init__(seed)
        self.t0, self.alpha = t0, alpha

    def minimize(self, objective, space, budget=None):
        rng = random.Random(self.seed)
        budget = budget or max(4, space.size // 10)
        cur = space.sample(rng)
        cur_v = float(objective(cur))
        hist = [(cur, cur_v)]
        best_p, best_v = cur, cur_v
        temp = self.t0
        while len(hist) < budget:
            cand = space.neighbors(cur, rng)
            v = float(objective(cand))
            hist.append((cand, v))
            # scale-free acceptance on relative regression
            rel = (v - cur_v) / max(abs(cur_v), 1e-30)
            if v <= cur_v or rng.random() < math.exp(-rel / max(temp, 1e-9)):
                cur, cur_v = cand, v
            if v < best_v:
                best_p, best_v = cand, v
            temp *= self.alpha
        return SearchResult(best_p, best_v, len(hist), space.size,
                            len(hist), hist)


class GeneticSearch(_Base):
    def __init__(self, seed: int = 0, pop: int = 12, elite: int = 3,
                 mut_rate: float = 0.25):
        super().__init__(seed)
        self.pop, self.elite, self.mut_rate = pop, elite, mut_rate

    def minimize(self, objective, space, budget=None):
        rng = random.Random(self.seed)
        budget = budget or max(self.pop * 4, space.size // 8)
        evals = 0
        cache: Dict[Tuple, float] = {}
        hist: List[Tuple[Params, float]] = []

        def ev(p: Params) -> float:
            nonlocal evals
            key = space.index_of(p)   # axis indices: collision-free
            if key not in cache:
                if evals >= budget:
                    return math.inf      # budget exhausted: no new evals
                cache[key] = float(objective(p))
                evals += 1
                hist.append((p, cache[key]))
            return cache[key]

        popn = [space.sample(rng) for _ in range(self.pop)]
        stagnant = 0
        while evals < budget and stagnant < 5 and evals < space.size:
            before = evals
            scored = sorted(popn, key=ev)
            if evals >= budget:
                break
            parents = scored[:max(self.elite, 2)]
            children = list(parents)
            while len(children) < self.pop:
                a, b = rng.sample(parents, 2) if len(parents) >= 2 else (parents[0], parents[0])
                child = {k: (a if rng.random() < 0.5 else b)[k]
                         for k in space.names}
                for k in space.names:     # mutation
                    if rng.random() < self.mut_rate:
                        child[k] = rng.choice(space.axes[k])
                children.append(child)
            popn = children
            # stagnation guard: converged populations only hit the eval
            # cache; inject random immigrants, give up after 5 dry gens.
            stagnant = stagnant + 1 if evals == before else 0
            if stagnant >= 2:
                popn[self.elite:] = [space.sample(rng)
                                     for _ in range(self.pop - self.elite)]
        best_p, best_v = min(hist, key=lambda t: t[1]) if hist else (None, math.inf)
        return SearchResult(best_p, best_v, evals, space.size, evals, hist)


class NelderMeadSearch(_Base):
    """Nelder–Mead on the index lattice (rounded to grid points)."""

    def minimize(self, objective, space, budget=None):
        rng = random.Random(self.seed)
        budget = budget or max(8, space.size // 8)
        dim = len(space.names)
        evals = 0
        cache: Dict[Tuple[int, ...], float] = {}
        hist: List[Tuple[Params, float]] = []

        def ev(x: np.ndarray) -> float:
            nonlocal evals
            idx = tuple(int(round(max(0, min(xi, len(space.axes[k]) - 1))))
                        for xi, k in zip(x, space.names))
            if idx not in cache:
                if evals >= budget:
                    return math.inf      # budget exhausted: no new evals
                p = space.from_indices(idx)
                cache[idx] = float(objective(p))
                hist.append((p, cache[idx]))
                evals += 1
            return cache[idx]

        # initial simplex
        x0 = np.array([rng.randrange(len(space.axes[k])) for k in space.names],
                      dtype=np.float64)
        simplex = [x0]
        for d in range(dim):
            x = x0.copy()
            span = len(space.axes[space.names[d]])
            x[d] = (x[d] + max(1, span // 2)) % span
            simplex.append(x)
        vals = [ev(x) for x in simplex]
        stagnant, iters = 0, 0
        while evals < budget and stagnant < 8 and iters < budget * 20 \
                and evals < space.size:
            iters += 1
            before = evals
            order = np.argsort(vals)
            simplex = [simplex[i] for i in order]
            vals = [vals[i] for i in order]
            centroid = np.mean(simplex[:-1], axis=0)
            xr = centroid + (centroid - simplex[-1])     # reflect
            vr = ev(xr)
            if vr < vals[0]:
                xe = centroid + 2.0 * (centroid - simplex[-1])
                ve = ev(xe)
                simplex[-1], vals[-1] = (xe, ve) if ve < vr else (xr, vr)
            elif vr < vals[-2]:
                simplex[-1], vals[-1] = xr, vr
            else:
                xc = centroid + 0.5 * (simplex[-1] - centroid)
                vc = ev(xc)
                if vc < vals[-1]:
                    simplex[-1], vals[-1] = xc, vc
                else:                                     # shrink
                    for i in range(1, len(simplex)):
                        simplex[i] = simplex[0] + 0.5 * (simplex[i] - simplex[0])
                        vals[i] = ev(simplex[i])
                        if evals >= budget:
                            break
            stagnant = stagnant + 1 if evals == before else 0
        best_p, best_v = min(hist, key=lambda t: t[1]) if hist else (None, math.inf)
        return SearchResult(best_p, best_v, evals, space.size, evals, hist)


class StaticPrunedSearch(_Base):
    """The paper's contribution (§III-C, Fig. 6).

    1. Rank the *entire* space with a static predictor
       (``static_cost(params) -> float`` — no compilation or execution).
    2. Optionally apply the rule-based intensity heuristic to bias
       toward the upper/lower parameter ranges (paper: intensity > 4.0
       ⇒ upper thread ranges).
    3. Keep the best ``keep_frac`` (or ``keep_n``) candidates and run an
       inner strategy (default: exhaustive over the kept set) with the
       *empirical* objective — or, in pure-static mode
       (``empirical_budget=0``), return the model's argmin directly.

    With a columns-based scorer (``static_cost_cols(columns) -> (n,)
    times``), spaces larger than ``chunk_size`` are ranked by a
    streaming top-k reduction over `SearchSpace.iter_lattice` chunks —
    bounded memory, bit-identical shortlist (the running top-k merges on
    ``(time, flat index)``, exactly the stable-argsort order of the
    materialized path).
    """

    def __init__(self, static_cost: Callable[[Params], float],
                 keep_frac: float = 0.125, keep_n: Optional[int] = None,
                 rule: Optional[Callable[[Params], bool]] = None,
                 seed: int = 0,
                 static_cost_batch: Optional[
                     Callable[[Sequence[Params]], "np.ndarray"]] = None,
                 static_cost_cols: Optional[
                     Callable[[Dict[str, np.ndarray]], "np.ndarray"]] = None,
                 chunk_size: Optional[int] = None):
        super().__init__(seed)
        self.static_cost = static_cost
        self.static_cost_batch = static_cost_batch
        self.static_cost_cols = static_cost_cols
        self.chunk_size = chunk_size
        self.keep_frac, self.keep_n, self.rule = keep_frac, keep_n, rule

    def shortlist(self, space: SearchSpace) -> List[Tuple[Params, float]]:
        chunk = self.chunk_size or DEFAULT_CHUNK
        if (self.static_cost_cols is not None and self.rule is None
                and space.size > chunk):
            return self._shortlist_streaming(space, chunk)
        pts = space.enumerate()
        if self.rule is not None:
            ruled = [p for p in pts if self.rule(p)]
            if ruled:
                pts = ruled
        if self.static_cost_batch is not None:
            # vectorized hot path: score the whole space in one batch
            costs = np.asarray(self.static_cost_batch(pts),
                               dtype=np.float64)
            order = np.argsort(costs, kind="stable")
            scored = [(pts[i], float(costs[i])) for i in order]
        else:
            scored = [(p, float(self.static_cost(p))) for p in pts]
            scored.sort(key=lambda t: t[1])
        n = self.keep_n or max(1, int(len(scored) * self.keep_frac))
        return scored[:n]

    def _shortlist_streaming(self, space: SearchSpace,
                             chunk: int) -> List[Tuple[Params, float]]:
        # Upper bound on the final shortlist length: keep_frac of the
        # (unknown, <= space.size) feasible count. Only (time, flat
        # index) scalars are buffered — params materialize at the end.
        cap = self.keep_n or max(1, math.ceil(space.size * self.keep_frac))
        best_t = np.empty(0, dtype=np.float64)
        best_g = np.empty(0, dtype=np.int64)
        scored_rows = 0
        for lat in space.iter_lattice(chunk):
            if lat.size == 0:
                continue
            t = np.asarray(self.static_cost_cols(lat.columns),
                           dtype=np.float64)
            scored_rows += lat.size
            t_all = np.concatenate((best_t, t))
            g_all = np.concatenate((best_g, lat.offsets))
            # primary key: time; secondary: flat lattice index — the
            # same order a stable argsort over the full space produces
            sel = np.lexsort((g_all, t_all))[:cap]
            best_t, best_g = t_all[sel], g_all[sel]
        if scored_rows == 0:
            raise ValueError("search space has no feasible configurations")
        n = self.keep_n or max(1, int(scored_rows * self.keep_frac))
        keep = min(n, len(best_t))
        return [(space.from_flat(int(g)), float(tv))
                for tv, g in zip(best_t[:keep], best_g[:keep])]

    def minimize(self, objective, space, budget=None,
                 empirical_budget: Optional[int] = None):
        short = self.shortlist(space)
        if empirical_budget == 0:   # pure static mode: zero executions
            best_p, best_v = short[0]
            return SearchResult(best_p, best_v, 0, space.size,
                                len(short), [])
        hist, best_p, best_v = [], None, math.inf
        cap = empirical_budget if empirical_budget is not None else len(short)
        for p, _pred in short[:cap]:
            v = float(objective(p))
            hist.append((p, v))
            if v < best_v:
                best_p, best_v = p, v
        return SearchResult(best_p, best_v, len(hist), space.size,
                            len(short), hist)
