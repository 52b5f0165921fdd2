"""The port's `KernelTuner` against the reference's, and its H100 mode.

* Under ``tpu-v5e`` a static tune of each ``make_tunable_*`` at the
  reference's shapes gives the reference's report and cache key.
* Hybrid and empirical tunes time kernels.  Both tuners get the same
  injected timer — a deterministic function of the params — so their
  reports must be equal too.
* Under the H100 a static tune ranks the compiled tile table and runs
  nothing; the Table I GPUs raise, as in the reference.
* The dispatch registry answers the four Table IV kernels' pretune
  signatures exactly as the reference does under ``tpu-v5e`` and
  ``kepler_k20``.
"""
import zlib

import numpy as np
import pytest
import torch

import repro.kernels as ref_kernels
import repro_torch.kernels as kernels
from repro import tuning_cache as ref_tc
from repro.core import autotuner as ref_autotuner
from repro.core import search as ref_search
from repro.kernels import api as ref_api
from repro_torch import tuning_cache as tc
from repro_torch.core import autotuner, hw, search
from repro_torch.core.target import set_default_target, use_target
from repro_torch.kernels import api

TABLE4 = ("matvec", "atax", "bicg", "jacobi3d")

# (factory, signature): the reference's benchmark shapes
# (benchmarks/common.py paper_kernels, both sizes) and its quickstart.
CASES = [
    ("atax", dict(m=2048, n=1024)), ("atax", dict(m=512, n=512)),
    ("atax", dict(m=1024, n=512)),
    ("atax", dict(m=1024, n=512, dtype="bfloat16")),
    ("bicg", dict(m=2048, n=1024)), ("bicg", dict(m=512, n=512)),
    ("bicg", dict(m=1024, n=1024, dtype="bfloat16")),
    ("jacobi3d", dict(z=64, y=64, x=128)), ("jacobi3d", dict(z=32, y=32,
                                                            x=64)),
    ("matvec", dict(m=2048, n=2048)), ("matvec", dict(m=1024, n=512)),
    ("matvec", dict(m=4096, n=1024, dtype="bfloat16")),
    ("matmul", dict(m=512, n=512, k=512)), ("matmul", dict(m=256, n=256,
                                                          k=256)),
    ("matmul", dict(m=1024, n=1024, k=1024)),
]
_IDS = [f"{k}-{'x'.join(str(v) for v in s.values())}" for k, s in CASES]

REPORT_FIELDS = ("best_params", "best_predicted_s", "best_measured_s",
                 "space_size", "empirical_evals", "search_space_reduction",
                 "spearman_static_vs_measured", "boundedness", "intensity",
                 "table", "from_cache")


def _make(kernel_id, sig, target, **kw):
    """The port's factory for ``kernel_id`` under ``target``."""
    with use_target(target):
        return kernels.TUNABLE_FACTORIES[kernel_id](**sig, **kw)


def _pair(kernel_id, sig):
    return (ref_kernels.TUNABLE_FACTORIES[kernel_id](**sig),
            _make(kernel_id, sig, "tpu-v5e"))


def _same_report(want, got):
    for f in REPORT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.kernel == want.kernel and got.mode == want.mode


def _only_key(db):
    (rec,) = db.snapshot()
    return rec.key


@pytest.mark.parametrize("kernel_id,sig", CASES, ids=_IDS)
def test_static_tune_and_key_match_reference(kernel_id, sig):
    rk, pk = _pair(kernel_id, sig)
    rdb, pdb = ref_tc.TuningDatabase(), tc.TuningDatabase()
    want = ref_autotuner.KernelTuner(rk, db=rdb, spec="tpu-v5e").tune()
    got = autotuner.KernelTuner(pk, db=pdb).tune()
    _same_report(want, got)
    assert _only_key(pdb).to_dict() == _only_key(rdb).to_dict()
    # and the repeat is a cache hit on both sides
    again = autotuner.KernelTuner(_make(kernel_id, sig, "tpu-v5e"),
                                  db=pdb).tune()
    assert again.from_cache and again.best_params == got.best_params


def _fake_time(fn, inputs, repeats):
    """The injected timer: ``build`` returns the params, so the
    'measurement' is a deterministic function of them."""
    key = repr(sorted(fn.items())).encode()
    return 1e-6 * (1 + zlib.crc32(key) % 997)


@pytest.fixture
def fake_timer(monkeypatch):
    monkeypatch.setattr(ref_autotuner, "_median_time", _fake_time)
    monkeypatch.setattr(autotuner, "_median_time", _fake_time)


def _timed_pair(kernel_id, sig):
    rk, pk = _pair(kernel_id, sig)
    for k in (rk, pk):
        k.build = lambda p: dict(p)
        k.make_inputs = lambda: ()
    return rk, pk


MODES = [
    ("hybrid", None, None), ("hybrid", 2, None),
    ("empirical", None, None),
    ("empirical", 4, ("RandomSearch", dict(seed=3))),
    ("empirical", 5, ("SimulatedAnnealing", dict(seed=1, t0=0.5))),
    ("empirical", 6, ("GeneticSearch", dict(seed=2, pop=4, elite=2))),
]


@pytest.mark.parametrize("mode,budget,strategy", MODES,
                         ids=[f"{m}-{b}-{s[0] if s else 'exh'}"
                              for m, b, s in MODES])
@pytest.mark.parametrize("kernel_id,sig", [CASES[0], CASES[9], CASES[12]],
                         ids=["atax", "matvec", "matmul"])
def test_timed_modes_match_reference(fake_timer, kernel_id, sig, mode,
                                     budget, strategy):
    rk, pk = _timed_pair(kernel_id, sig)
    rs = ps = None
    if strategy is not None:
        rs = getattr(ref_search, strategy[0])(**strategy[1])
        ps = getattr(search, strategy[0])(**strategy[1])
    rdb, pdb = ref_tc.TuningDatabase(), tc.TuningDatabase()
    want = ref_autotuner.KernelTuner(rk, db=rdb, spec="tpu-v5e",
                                     keep_frac=0.5).tune(
        mode, strategy=rs, empirical_budget=budget)
    got = autotuner.KernelTuner(pk, db=pdb, keep_frac=0.5).tune(
        mode, strategy=ps, empirical_budget=budget)
    _same_report(want, got)
    assert _only_key(pdb).to_dict() == _only_key(rdb).to_dict()
    (rrec,), (prec,) = rdb.snapshot(), pdb.snapshot()
    assert prec.extras == rrec.extras and prec.params == rrec.params


def test_table_i_gpus_raise_like_the_reference():
    rk, pk = _pair("atax", dict(m=1024, n=512))
    with pytest.raises(TypeError, match="TpuSpec"):
        ref_autotuner.KernelTuner(rk, spec="kepler_k20")
    with pytest.raises(TypeError, match="TpuSpec"):
        autotuner.KernelTuner(pk, spec="kepler_k20")


def test_a_kernel_packaged_for_one_family_refuses_the_other():
    pk = _make("atax", dict(m=1024, n=512), "tpu-v5e")
    with pytest.raises(ValueError, match="packaged for"):
        autotuner.KernelTuner(pk, spec="h100")
    hk = _make("atax", dict(m=1024, n=512), "h100")
    with pytest.raises(ValueError, match="packaged for"):
        autotuner.KernelTuner(hk, spec="tpu-v5e")


H100_CASES = [("matvec", dict(m=8192, n=8192)),
              ("matvec", dict(m=8192, n=8192, dtype="bfloat16")),
              ("atax", dict(m=8192, n=8192)),
              ("atax", dict(m=1024, n=512)),
              ("bicg", dict(m=8192, n=8192, dtype="bfloat16")),
              ("jacobi3d", dict(z=256, y=256, x=256)),
              ("matmul", dict(m=4, n=3072, k=24576, dtype="bfloat16"))]


@pytest.mark.parametrize("kernel_id,sig", H100_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s.values()))}"
                              for k, s in H100_CASES])
def test_h100_static_tune_runs_nothing_and_picks_a_feasible_tile(
        kernel_id, sig):
    tk = _make(kernel_id, sig, "h100")

    def no_run(*_a, **_k):
        raise AssertionError("a static tune must not build or run")
    tk.build = no_run
    tk.make_inputs = no_run
    spec = api.get_spec(kernel_id)
    assert tk.space.names == ["tile"]
    assert tk.space.axes["tile"] == spec._hopper[None].tiles
    kernels.reset_launch_counts()
    db = tc.TuningDatabase()
    tuner = autotuner.KernelTuner(tk, db=db)
    assert tuner.hopper and tuner.size_axes == []
    rep = tuner.tune("static")
    assert set(kernels.launch_counts().values()) == {0}
    assert rep.empirical_evals == 0 and rep.search_space_reduction == 1.0
    info = spec._hopper[None].info([rep.best_params["tile"]],
                                   spec.normalize(sig), hw.H100_SXM)
    assert bool(info.feasible[0]) and np.isfinite(rep.best_predicted_s)
    # the tuner's pick is the dispatch registry's pick
    assert rep.best_params == tc.lookup_or_tune(
        kernel_id, spec="h100", db=tc.TuningDatabase(), **sig)
    # Table IV kernels stream their operands: memory bound on the card
    if kernel_id in TABLE4:
        assert rep.boundedness == "memory_bound"
    again = autotuner.KernelTuner(_make(kernel_id, sig, "h100"),
                                  db=db).tune("static")
    assert again.from_cache and again.best_params == rep.best_params


@pytest.mark.parametrize("kernel_id,sig", [
    ("matvec", dict(m=40, n=24)), ("atax", dict(m=40, n=24)),
    ("bicg", dict(m=40, n=24, dtype="bfloat16")),
    ("jacobi3d", dict(z=4, y=6, x=8)), ("matmul", dict(m=8, n=16, k=24))])
def test_h100_timed_modes_run_the_plain_versions_on_cpu(kernel_id, sig):
    """The H100 tunable's build/make_inputs wiring, on CPU tensors: each
    tile's callable runs the plain version, and hybrid/empirical time
    it (CPU numbers: only the counts and shapes mean anything here)."""
    tk = _make(kernel_id, sig, "h100", device="cpu")
    inputs = tk.make_inputs()
    assert all(t.device.type == "cpu" for t in inputs)
    want = tk.reference(*inputs)
    for p in tk.space.enumerate():
        got = tk.build(p)(*inputs)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.shape == w.shape and g.dtype == w.dtype
    tuner = autotuner.KernelTuner(tk, db=None, keep_frac=0.5, repeats=1)
    hy = tuner.tune("hybrid", empirical_budget=3)
    assert hy.empirical_evals == 3 and hy.best_measured_s > 0
    em = tuner.tune("empirical")
    assert em.empirical_evals == tk.space.size
    assert em.spearman_static_vs_measured is not None


def test_make_inputs_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    tk = _make("atax", dict(m=64, n=32), "h100")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tk.make_inputs()


def test_make_inputs_are_seeded():
    a = kernels.make_tunable_bicg(16, 8, seed=4, device="cpu").make_inputs()
    b = kernels.make_tunable_bicg(16, 8, seed=4, device="cpu").make_inputs()
    c = kernels.make_tunable_bicg(16, 8, seed=5, device="cpu").make_inputs()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.fixture
def fresh_dbs():
    ref_tc.set_default_db(ref_tc.TuningDatabase())
    tc.set_default_db(tc.TuningDatabase())
    yield
    ref_tc.reset_default_db()
    tc.reset_default_db()


PRETUNE = [(k, s) for k in TABLE4 for s in ref_api.get_spec(k).pretune]


@pytest.mark.parametrize("target", ["tpu-v5e", "kepler_k20"])
@pytest.mark.parametrize("kernel_id,sig", PRETUNE,
                         ids=[f"{k}-{'-'.join(map(str, s.values()))}"
                              for k, s in PRETUNE])
def test_table4_dispatch_matches_reference(fresh_dbs, kernel_id, sig,
                                           target):
    ref_db, db = ref_tc.TuningDatabase(), tc.TuningDatabase()
    want = ref_tc.lookup_or_tune(kernel_id, spec=target, db=ref_db, **sig)
    got = tc.lookup_or_tune(kernel_id, spec=target, db=db, **sig)
    assert got == want
    assert _only_key(db).to_dict() == _only_key(ref_db).to_dict()


def test_table4_ops_dispatch_frozen_on_cpu_tensors(fresh_dbs):
    """Warm, freeze, dispatch: every Table IV op answers from the frozen
    table and runs its plain version on CPU tensors."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((48, 32)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((32, 1)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((48, 1)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((4, 6, 8)).astype(np.float32))
    ops = kernels.ops
    with use_target("h100"):
        for kid, args in (("matvec", (a, x)), ("atax", (a, x)),
                          ("bicg", (a, x, r)), ("jacobi3d", (u,))):
            sig = api.get_spec(kid).extract_signature(*args)
            tc.lookup_or_tune(kid, **sig)
    set_default_target("h100")
    try:
        tc.freeze()
        api.reset_dispatch_stats()
        tunes = tc.get_default_db().stats.tunes
        outs = [ops.matvec(a, x), ops.atax(a, x), *ops.bicg(a, x, r),
                ops.jacobi3d(u)]
        want = [kernels.ref.matvec_ref(a, x), kernels.atax.atax_plain(a, x),
                *kernels.ref.bicg_ref(a, x, r), kernels.ref.jacobi3d_ref(u)]
        for g, w in zip(outs, want):
            torch.testing.assert_close(g, w)
        st = api.dispatch_stats()
        assert st["frozen"] == st["total"] == 4
        assert tc.get_default_db().stats.tunes == tunes
    finally:
        set_default_target(None)
        tc.thaw()


def test_quickstart_runs_on_the_cpu_when_asked(fresh_dbs, capsys):
    from repro_torch.examples import quickstart
    out = quickstart.main(["--device", "cpu", "--smoke"])
    assert out["static"].empirical_evals == 0
    assert "from_cache=True" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quickstart.main(["--smoke"])
