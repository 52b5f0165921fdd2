"""Discrete search spaces (paper §III-C).

`SearchSpace` is the Cartesian product of named axes the static ranking
walks; the reference's search strategies (exhaustive, random, annealing,
genetic, Nelder–Mead, static pruning) wait for the port of its
`KernelTuner`.

Spaces can carry **constraints** — vectorized predicates over axis
columns — and enumerate lazily in bounded-memory chunks
(`SearchSpace.iter_lattice`), so ranking scales to multi-million-point
constrained spaces without materializing an O(N) lattice (DESIGN.md
§14).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

__all__ = ["SearchSpace", "ConfigLattice", "Constraint", "DEFAULT_CHUNK"]

Params = Dict[str, object]

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
