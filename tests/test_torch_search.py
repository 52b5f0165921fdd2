"""The port's search strategies against the reference's.

Every strategy draws from ``random.Random(seed)`` the way the
reference's does, so under the same deterministic objective the two
visit the same points in the same order: histories, winners, evaluation
counts and the static shortlist (eager, ruled, batched and streaming)
must be equal, not merely close.
"""
import math

import numpy as np
import pytest

from repro.core import search as ref_search
from repro_torch.core import search

AXES = {"a": (1, 2, 4, 8, 16), "b": (32, 64, 128), "c": ("x", "y", "z")}


def _objective(p):
    """Deterministic, tie-free, not monotone in any axis."""
    return ((math.log2(p["a"]) - 2.3) ** 2 + (p["b"] / 64 - 1.4) ** 2
            + {"x": 0.31, "y": 0.0, "z": 0.17}[p["c"]])


def _fits(cols):
    return np.asarray(cols["a"]) * np.asarray(cols["b"]) <= 1024


def _spaces(constrained):
    cons = (_fits,) if constrained else ()
    return (ref_search.SearchSpace(dict(AXES), constraints=cons),
            search.SearchSpace(dict(AXES), constraints=cons))


def _same_result(want, got):
    assert got.best_params == want.best_params
    assert got.best_value == want.best_value
    assert got.evaluations == want.evaluations
    assert got.space_size == want.space_size
    assert got.candidates_considered == want.candidates_considered
    assert got.history == want.history
    assert got.search_space_reduction == want.search_space_reduction


STRATEGIES = [
    ("ExhaustiveSearch", {}),
    ("RandomSearch", {}),
    ("SimulatedAnnealing", {}),
    ("SimulatedAnnealing", {"t0": 0.3, "alpha": 0.8}),
    ("GeneticSearch", {}),
    ("GeneticSearch", {"pop": 6, "elite": 2, "mut_rate": 0.5}),
    ("NelderMeadSearch", {}),
]


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("budget", [None, 7])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name,kw", STRATEGIES,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(STRATEGIES)])
def test_strategy_history_matches_reference(name, kw, seed, budget,
                                            constrained):
    rsp, psp = _spaces(constrained)
    want = getattr(ref_search, name)(seed=seed, **kw).minimize(
        _objective, rsp, budget=budget)
    got = getattr(search, name)(seed=seed, **kw).minimize(
        _objective, psp, budget=budget)
    _same_result(want, got)


def _static_cost(p):
    return _objective(p) * 1e-6


def _static_cost_cols(cols):
    return np.asarray([_static_cost({k: cols[k][i] for k in cols})
                       for i in range(len(cols["a"]))])


def _rule(p):
    return p["a"] <= 4


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("opts", [
    dict(), dict(keep_frac=0.5), dict(keep_n=5), dict(rule=_rule),
    dict(batch=True), dict(cols=True, chunk_size=4),
    dict(cols=True, chunk_size=4, keep_n=3)],
    ids=["eager", "half", "keep5", "rule", "batch", "stream", "stream3"])
def test_static_shortlist_matches_reference(opts, constrained):
    opts = dict(opts)
    kw = {}
    if opts.pop("batch", False):
        kw["static_cost_batch"] = lambda pts: np.asarray(
            [_static_cost(p) for p in pts])
    if opts.pop("cols", False):
        kw["static_cost_cols"] = _static_cost_cols
    kw.update(opts)
    rsp, psp = _spaces(constrained)
    want = ref_search.StaticPrunedSearch(_static_cost, **kw).shortlist(rsp)
    got = search.StaticPrunedSearch(_static_cost, **kw).shortlist(psp)
    assert got == want


@pytest.mark.parametrize("empirical_budget", [0, None, 2])
def test_static_pruned_minimize_matches_reference(empirical_budget):
    rsp, psp = _spaces(True)
    want = ref_search.StaticPrunedSearch(_static_cost, keep_n=4).minimize(
        _objective, rsp, empirical_budget=empirical_budget)
    got = search.StaticPrunedSearch(_static_cost, keep_n=4).minimize(
        _objective, psp, empirical_budget=empirical_budget)
    _same_result(want, got)


def test_space_point_ops_match_reference():
    import random
    rsp, psp = _spaces(True)
    for flat in range(rsp.size):
        assert psp.from_flat(flat) == rsp.from_flat(flat)
    r1, r2 = random.Random(5), random.Random(5)
    for _ in range(20):
        p = rsp.sample(r1)
        assert psp.sample(r2) == p
        assert psp.index_of(p) == rsp.index_of(p)
        assert psp.neighbors(p, r2) == rsp.neighbors(p, r1)
    for idx in [(0, 0, 0), (4.4, 1.6, -1), (9, 9, 9)]:
        assert psp.from_indices(idx) == rsp.from_indices(idx)


def test_streaming_shortlist_with_no_feasible_point_raises():
    sp = search.SearchSpace(dict(AXES), constraints=(lambda c: False,))
    pruner = search.StaticPrunedSearch(_static_cost,
                                       static_cost_cols=_static_cost_cols,
                                       chunk_size=4)
    with pytest.raises(ValueError, match="no feasible"):
        pruner.shortlist(sp)
