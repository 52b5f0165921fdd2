"""The pipeline cost-model tier in the port against the reference, on the
CPU.

* ISA tables: the TPU and Fermi/Kepler/Maxwell tables (rows, clocks,
  provenance, fingerprints) equal the reference's; the Hopper table is
  complete, with provenance, and with zero latency its busy cycles are
  `default_hopper_model`'s per-class times.
* The scoreboard simulator gives the reference's results on the same
  streams and tables (exact), and the reference's hand-computed cases.
* `lookup_or_tune(model="pipeline")` gives the reference's params,
  ``predicted_s`` and cache-key digests on every pretune-grid instance
  under the six reference targets (exact); under the H100 it ranks the
  compiled tile tables, deterministically across chunk sizes and
  workers.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

import repro.kernels  # noqa: F401  (registers every reference kernel)
import repro_torch.kernels  # noqa: F401
from repro import tuning_cache as ref_tc
from repro.core import isa as ref_isa
from repro.core import pipeline as ref_pipeline
from repro.core.hw import resolve_target as ref_resolve
from repro.core.target import use_target as ref_use_target
from repro.kernels import api as ref_api
from repro.tuning_cache import registry as ref_registry
from repro_torch import tuning_cache as tc
from repro_torch.core import isa, pipeline
from repro_torch.core.hw import H100_SXM, isa_family, resolve_target
from repro_torch.core.isa import CLASSES, IsaOp, IsaTable, isa_table_for
from repro_torch.core.pipeline import (InstructionStream, StreamOp,
                                       as_stream, simulate, stream_from_hlo,
                                       synthesize_stream)
from repro_torch.core.predict import default_hopper_model, spearman
from repro_torch.core.target import use_target
from repro_torch.kernels import api
from repro_torch.tuning_cache import (TuningDatabase, get_problem,
                                      lookup_or_tune, rank_space, registry)
from repro_torch.tuning_cache.cli import (SHIPPED_TARGETS,
                                          default_pretune_cases)

REF_TARGETS = tuple(t for t in SHIPPED_TARGETS if t != "h100-sxm")
ALL_TARGETS = REF_TARGETS + ("tpu-v4",)
TPU = resolve_target("tpu-v5e")
MM_SIG = dict(m=256, n=256, k=256, dtype="float32")
# gemma-7b's serving instances for its two requests, 4 x 64 and 1 x 64
# prompt tokens: prefill rows m = 64 b, decode rows m = b
SERVE_H100 = [inst for b in (4, 1) for inst in (
    [(kid, sig) for m in (64 * b, b) for kid, sig in (
        ("rms_norm", dict(m=m, d=3072, dtype="bfloat16")),
        ("mlp_matmul", dict(m=m, d=3072, f=24576, act="gelu",
                            dtype="bfloat16")),
        ("matmul", dict(m=m, n=3072, k=24576, dtype="bfloat16")))]
    + [("flash_attention", dict(b=b, h=16, sq=64, skv=64, d=256,
                                causal=True, dtype="bfloat16"))])]
_IDS = [f"{k}-{'-'.join(str(v) for v in s.values())}" for k, s in SERVE_H100]


@pytest.fixture(autouse=True)
def _fresh_dbs():
    ref_tc.set_default_db(ref_tc.TuningDatabase())
    tc.set_default_db(tc.TuningDatabase())
    yield
    ref_tc.reset_default_db()
    tc.reset_default_db()


# ---------------------------------------------------------------------------
# ISA tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", ALL_TARGETS)
def test_isa_table_equals_the_reference(target):
    got = isa_table_for(resolve_target(target))
    want = ref_isa.isa_table_for(ref_resolve(target))
    assert (got.family, got.clock_hz, got.barrier_slots, got.provenance) \
        == (want.family, want.clock_hz, want.barrier_slots, want.provenance)
    assert {c: dataclasses.astuple(o) for c, o in got.ops.items()} \
        == {c: dataclasses.astuple(o) for c, o in want.ops.items()}
    assert got.fingerprint() == want.fingerprint()
    assert isa_family(target) == ref_isa.isa_family(target)


@pytest.mark.parametrize("target", ALL_TARGETS + ("h100-sxm",))
def test_isa_table_complete(target):
    table = isa_table_for(resolve_target(target))
    assert table.clock_hz > 0
    assert table.barrier_slots >= 1
    assert table.provenance
    for cls in CLASSES:
        row = table.op(cls)
        # never silently defaulted: every class priced with positive
        # numbers and a documented provenance
        assert row.work > 0, (target, cls)
        assert row.issue > 0, (target, cls)
        assert row.latency > 0, (target, cls)
        assert row.provenance, (target, cls)


def test_hopper_table_is_the_h100_family():
    table = isa_table_for("h100")
    assert table.family == isa_family("h100") == "Hopper"
    assert table.clock_hz == H100_SXM.gpu_clock_mhz * 1e6
    # latencies from the literature name it; modelled ones say so
    for cls in CLASSES:
        note = table.op(cls).provenance
        assert ("microbench:" in note) != ("model:" in note), (cls, note)
    assert "Luo et al. 2024" in table.op("hbm").provenance
    fps = {isa_table_for(t).fingerprint() for t in ALL_TARGETS}
    assert table.fingerprint() not in fps


@pytest.mark.parametrize("cls", CLASSES)
def test_hopper_busy_cycles_are_the_h100_model_per_class(cls):
    """With zero latency, one segment's busy cycles over the clock are
    the H100 roofline's time for that class (reg: the model prices none,
    the table prices it at the FP32 lane rate)."""
    table = isa_table_for("h100")
    zero = IsaTable(family="Hopper", clock_hz=table.clock_hz,
                    barrier_slots=table.barrier_slots,
                    ops={c: dataclasses.replace(o, latency=1e-9)
                         for c, o in table.ops.items()})
    units = 3.0e9 if cls != "ctrl" else 3.0
    res = simulate(InstructionStream((StreamOp(cls, units),)), zero)
    busy_s = res.per_pipe_busy[table.op(cls).pipe] / table.clock_hz
    coeff = default_hopper_model(H100_SXM).coeffs[isa.CLASS_FEATURE[cls]]
    if cls == "reg":
        coeff = 1.0 / H100_SXM.fp32_flops
    assert busy_s == pytest.approx(coeff * units, rel=1e-12)
    assert res.seconds == pytest.approx(coeff * units, rel=1e-9)


def test_isa_unknown_class_raises():
    with pytest.raises(KeyError, match="prices no class"):
        isa_table_for(TPU).op("tensor-cores")


def test_model_fingerprints_separate_tiers():
    for target in ("tpu-v5e", "kepler-k20", "h100"):
        spec = resolve_target(target)
        eq6 = registry._model_for(spec, "eq6").fingerprint()
        pipe = registry._model_for(spec, "pipeline").fingerprint()
        assert eq6 != pipe
        assert pipe.startswith("pipeline-")
    for target in ("tpu-v5e", "kepler-k20"):
        assert registry._model_for(resolve_target(target),
                                   "pipeline").fingerprint() \
            == ref_registry._model_for(ref_resolve(target),
                                       "pipeline").fingerprint()
    h100 = registry._model_for(H100_SXM, "pipeline")
    assert h100.base.fingerprint() \
        == default_hopper_model(H100_SXM).fingerprint()
    assert h100.table is isa_table_for("h100")


# ---------------------------------------------------------------------------
# scoreboard simulator
# ---------------------------------------------------------------------------


def _table(mod, rows, *, barrier_slots=4):
    ops = {cls: mod.IsaOp(cls=cls, pipe=pipe, work=work, issue=issue,
                          latency=lat, dual_issue=dual, yields=yields,
                          barrier=barrier, provenance="test")
           for cls, (pipe, work, issue, lat, dual, yields, barrier)
           in rows.items()}
    return mod.IsaTable(family="test", clock_hz=1.0e9,
                        barrier_slots=barrier_slots, ops=ops)


def _both(stream_rows, table_rows, barrier_slots=4, **kw):
    """simulate() through the port and the reference on the same stream
    and synthetic table: the two results as dicts."""
    out = []
    for mod, imod in ((pipeline, isa), (ref_pipeline, ref_isa)):
        stream = mod.InstructionStream(
            tuple(mod.StreamOp(*r) for r in stream_rows["ops"]),
            iterations=stream_rows.get("iterations", 1.0),
            concurrency=stream_rows.get("concurrency", 1.0))
        res = mod.simulate(stream, _table(imod, table_rows,
                                          barrier_slots=barrier_slots), **kw)
        out.append(dataclasses.asdict(res))
    return out


def test_simulate_dependence_stall():
    # mxu: pipe A, 1 cy issue, 10 cy latency, does NOT yield;
    # vpu: pipe B, 1 cy issue, 2 cy latency.
    rows = {"mxu": ("A", 1.0, 1.0, 10.0, False, False, ""),
            "vpu": ("B", 1.0, 1.0, 2.0, False, True, "")}
    got, want = _both({"ops": [("mxu", 4.0), ("vpu", 8.0, 0)],
                       "concurrency": 2.0}, rows)
    assert got == want
    # producer result-ready = 3*1 + 10 = 13; consumer could issue at 4
    # -> 9 stall cycles on pipe B, charged hard (producer doesn't
    # yield): busy_max(8) + 9 = 17 beats t_end/c = 22/2.
    assert got["cycles"] == pytest.approx(17.0)
    assert got["stalls"] == {"B": pytest.approx(9.0)}
    assert got["limiter"] == "B"
    free, ref_free = _both({"ops": [("mxu", 4.0), ("vpu", 8.0)],
                            "concurrency": 2.0}, rows)
    assert free == ref_free
    assert free["cycles"] == pytest.approx(8.0) and free["stalls"] == {}


def test_simulate_dual_issue_pairing():
    stream = {"ops": [("ctrl", 4.0), ("reg", 4.0)]}
    paired, ref_paired = _both(stream, {
        "ctrl": ("S", 1.0, 1.0, 1.0, True, False, ""),
        "reg": ("B", 1.0, 1.0, 1.0, True, False, "")})
    serial, ref_serial = _both(stream, {
        "ctrl": ("S", 1.0, 1.0, 1.0, True, False, ""),
        "reg": ("B", 1.0, 1.0, 1.0, False, False, "")})
    assert (paired, serial) == (ref_paired, ref_serial)
    assert paired["cycles"] == pytest.approx(4.0)
    assert serial["cycles"] == pytest.approx(8.0)


def test_simulate_memory_barrier_slots():
    rows = {"hbm": ("M", 1.0, 1.0, 100.0, False, True, "wr")}
    stream = {"ops": [("hbm", 1.0)] * 3}
    # 2 slots: the third load waits for the oldest outstanding result
    # (cycle 100), landing its own at 200
    tight, ref_tight = _both(stream, rows, barrier_slots=2)
    roomy, ref_roomy = _both(stream, rows, barrier_slots=8)
    assert (tight, roomy) == (ref_tight, ref_roomy)
    assert tight["cycles"] == pytest.approx(200.0)
    assert roomy["cycles"] == pytest.approx(102.0)
    assert tight["limiter"] == "latency"


@pytest.mark.parametrize("c,sat,want", [(1, None, 29.0), (4, 4, 10.0),
                                        (4, 8, 20.0), (8, 8, 10.0)])
def test_simulate_occupancy_interleave_and_saturation(c, sat, want):
    # a single context exposes the trailing result latency; 4 hide it;
    # below saturation, issue bandwidth stretches by c/sat (Eq. 2)
    rows = {"vpu": ("B", 1.0, 1.0, 20.0, False, True, "")}
    got, ref = _both({"ops": [("vpu", 10.0)]}, rows, concurrency=c,
                     saturation=sat)
    assert got == ref
    assert got["cycles"] == pytest.approx(want)


def test_simulate_empty_stream():
    res = simulate(InstructionStream(()), isa_table_for(TPU))
    assert res.cycles == 0.0 and res.limiter == "empty"


def test_simulate_iterations_scale():
    rows = {"vpu": ("B", 1.0, 1.0, 1.0, False, True, "")}
    one, _ = _both({"ops": [("vpu", 8.0)]}, rows)
    many, ref_many = _both({"ops": [("vpu", 8.0)], "iterations": 5.0}, rows)
    assert many == ref_many
    assert many["cycles"] == pytest.approx(5.0 * one["cycles"])


@pytest.mark.parametrize("target", ALL_TARGETS + ("h100-sxm",))
def test_simulate_random_streams_match_the_reference(target):
    """Synthesized streams of random units on every family's real table:
    the port's simulate() is the reference's, result for result (the
    H100 table priced through both simulators)."""
    rng = np.random.default_rng(7)
    table = isa_table_for(target)
    ref_table = (ref_isa.IsaTable(
        family=table.family, clock_hz=table.clock_hz,
        barrier_slots=table.barrier_slots,
        ops={c: ref_isa.IsaOp(*dataclasses.astuple(o))
             for c, o in table.ops.items()}, provenance=table.provenance)
                 if target == "h100-sxm"
                 else ref_isa.isa_table_for(ref_resolve(target)))
    for _ in range(25):
        units = {c: float(rng.choice([0.0, rng.uniform(1, 1e9)]))
                 for c in CLASSES}
        kw = dict(iterations=float(rng.integers(1, 64)),
                  concurrency=float(rng.integers(1, 65)))
        got = simulate(synthesize_stream(units, **kw), table,
                       saturation=64.0)
        want = ref_pipeline.simulate(ref_pipeline.synthesize_stream(
            units, **kw), ref_table, saturation=64.0)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_synthesize_stream_deterministic_order_and_deps():
    s = synthesize_stream({"mxu": 5.0, "hbm": 3.0, "ctrl": 1.0,
                           "vpu": 0.0})
    assert [op.cls for op in s.ops] == ["hbm", "mxu", "ctrl"]
    assert s.ops[0].dep is None
    assert s.ops[1].dep == 0          # mxu consumes the hbm stage
    assert s.ops[2].dep is None


def test_as_stream_validates_rows():
    with pytest.raises(ValueError, match="unknown instruction class"):
        as_stream([("simd", 1.0)])
    with pytest.raises(ValueError, match="not an earlier row"):
        as_stream([("mxu", 1.0, 0)])
    s = as_stream([("hbm", 2.0), ("mxu", 4.0, 0)])
    assert s.ops[1].dep == 0 and s.iterations == 1.0


def test_stream_from_hlo_waits_for_the_extraction_tier():
    with pytest.raises(NotImplementedError, match="core/hlo.py"):
        stream_from_hlo("HloModule m")


def test_matmul_schedule_hook_matches_the_reference():
    from repro.kernels.matmul import _matmul_schedule as ref_schedule
    from repro_torch.kernels.matmul import _matmul_schedule
    p = {"bm": 128, "bn": 128, "bk": 128}
    for dt in ("float32", "bfloat16"):
        sig = dict(m=512, n=512, k=512, dtype=dt)
        assert _matmul_schedule(p, **sig) == ref_schedule(p, **sig)
    model = registry._model_for(TPU, "pipeline")
    with use_target(TPU):
        problem = get_problem("matmul", m=512, n=512, k=512,
                              dtype="float32")
        assert problem.schedule is not None
        info = problem.static_info(p)
    rows = _matmul_schedule(p, m=512, n=512, k=512)
    res = model.result_of(info, schedule=rows)
    assert res is not None
    assert math.isfinite(res.seconds) and res.seconds > 0
    # the declared stream's contraction depends on the staged tiles
    stream = as_stream(rows, info)
    assert stream.iterations > 1 and stream.ops[2].dep == 1


# ---------------------------------------------------------------------------
# the two-stage rank: parity with the reference, determinism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", REF_TARGETS)
def test_pipeline_lookup_matches_the_reference_on_the_grid(target):
    """Every pretune-grid instance ranked under model="pipeline": the
    reference's params, predicted seconds and cache keys, exactly."""
    cases = default_pretune_cases()
    assert cases == [(k, dict(s)) for k in ref_api.registered_kernels()
                     for s in ref_api.get_spec(k).pretune]
    assert len(cases) == 86
    db, ref_db = TuningDatabase(), ref_tc.TuningDatabase()
    for kid, sig in cases:
        got = lookup_or_tune(kid, spec=target, model="pipeline", db=db,
                             **sig)
        want = ref_tc.lookup_or_tune(kid, spec=target, model="pipeline",
                                     db=ref_db, **sig)
        assert got == want, (kid, sig)
    recs = {r.key.digest: r for r in db.records()}
    ref_recs = {r.key.digest: r for r in ref_db.records()}
    assert set(recs) == set(ref_recs) and len(recs) == 86
    for d, r in recs.items():
        assert r.key.to_dict() == ref_recs[d].key.to_dict()
        assert r.predicted_s == ref_recs[d].predicted_s
        assert r.space_size == ref_recs[d].space_size
        assert json.loads(r.key.signature)["model"].startswith("pipeline-")


def test_pipeline_ranks_every_h100_grid_and_serve_instance():
    db = TuningDatabase()
    for kid, sig in default_pretune_cases() + SERVE_H100:
        p = lookup_or_tune(kid, spec="h100", model="pipeline", db=db, **sig)
        spec = api.get_spec(kid)
        info = spec.hopper_static_info(p, H100_SXM, **sig)
        assert info.feasible(), (kid, sig, p)
        assert info.hopper is not None and info.hopper.active_warps >= 1
    assert len(db) == 86 + len(SERVE_H100)
    assert all(math.isfinite(r.predicted_s) and r.predicted_s > 0
               for r in db.records())


@pytest.mark.parametrize("kid,sig", SERVE_H100, ids=_IDS)
def test_h100_rerank_deterministic_across_chunks_and_workers(kid, sig):
    model = registry._model_for(H100_SXM, "pipeline")
    with use_target("h100"):
        problem = get_problem(kid, **sig)
        results = [rank_space(problem, model, chunk_size=cs, workers=w)
                   for cs in (None, 3, 7) for w in (None, 4)]
    first = results[0]
    assert first[2] == len(problem.space.enumerate())
    for other in results[1:]:
        assert other == first


@pytest.mark.parametrize("kid,sig", SERVE_H100, ids=_IDS)
def test_h100_rerank_is_the_argmin_of_the_scoreboard(kid, sig):
    """Every table here has fewer than keep_n rows, so the rerank takes
    the whole table: the pick is the row of least simulated time (ties
    to the roofline's order), and a row's stream is its H100 feature row
    interleaved by its resident warps, saturated at warps_per_mp."""
    model = registry._model_for(H100_SXM, "pipeline")
    spec = api.get_spec(kid)
    pts = spec.hopper_space(**sig).enumerate()
    assert len(pts) < model.keep_n
    times = [model.time_info(spec.hopper_static_info(p, H100_SXM, **sig))
             for p in pts]
    pick = lookup_or_tune(kid, spec="h100", model="pipeline",
                          db=TuningDatabase(), **sig)
    assert times[pts.index(pick)] == min(times)
    info = spec.hopper_static_info(pick, H100_SXM, **sig)
    stream = pipeline.stream_of_info(info)
    assert stream.concurrency == info.hopper.active_warps
    units = {op.cls: op.units for op in stream.ops}
    assert units.get("hbm") == info.mix.hbm_bytes
    assert units.get("ctrl") == info.mix.ctrl_ops
    res = model.result_of(info)
    assert res == simulate(stream, model.table, saturation=64.0)


def test_rerank_deterministic_across_chunks_and_workers_tpu():
    model = registry._model_for(TPU, "pipeline")
    with use_target(TPU), ref_use_target("tpu-v5e"):
        problem = get_problem("matmul", m=512, n=512, k=512,
                              dtype="float32")
        results = [rank_space(problem, model, chunk_size=cs, workers=w)
                   for cs in (None, 7, 64) for w in (None, 4)]
        want = ref_registry.rank_space(
            ref_registry.get_problem("matmul", m=512, n=512, k=512,
                                     dtype="float32"),
            ref_registry._model_for(ref_resolve("tpu-v5e"), "pipeline"))
    assert results[0][2] > 0
    for other in results:
        assert other == results[0]
    assert results[0] == want


def test_rerank_scalar_batch_parity():
    model = registry._model_for(TPU, "pipeline")
    with use_target(TPU):
        problem = get_problem("matmul", **MM_SIG)
        got = rank_space(problem, model)
        scalar = tc.TuningProblem(space=problem.space,
                                  static_info=problem.static_info,
                                  schedule=problem.schedule)
        got_scalar = rank_space(scalar, model)
    assert got_scalar[0] == got[0]
    assert got_scalar[1] == pytest.approx(got[1])


def test_eq6_path_unchanged_by_the_pipeline_tier():
    model = registry._model_for(TPU, "eq6")
    with use_target(TPU):
        problem = get_problem("matmul", **MM_SIG)
        a = rank_space(problem, model)
        b = rank_space(problem, model, chunk_size=11, workers=3)
    assert a == b


def test_cache_keys_separate_model_kinds():
    mem = TuningDatabase()
    p_eq6 = lookup_or_tune("matmul", db=mem, spec=TPU, **MM_SIG)
    p_pipe = lookup_or_tune("matmul", db=mem, spec=TPU, model="pipeline",
                            **MM_SIG)
    assert len(mem) == 2          # distinct records, never a collision
    fps = {json.loads(r.key.signature).get("model") for r in mem.records()}
    assert len(fps) == 2
    assert lookup_or_tune("matmul", db=mem, spec=TPU, **MM_SIG) == p_eq6
    assert lookup_or_tune("matmul", db=mem, spec=TPU, model="pipeline",
                          **MM_SIG) == p_pipe
    assert len(mem) == 2


def test_unknown_model_kind_rejected():
    with pytest.raises(ValueError, match="unknown tuning model"):
        lookup_or_tune("matmul", db=TuningDatabase(), spec=TPU,
                       model="oracle", **MM_SIG)


def test_default_model_switch_thaws_and_rekeys():
    tc.clear_dispatch_memo()
    try:
        lookup_or_tune("matmul", spec=TPU, **MM_SIG)
        tc.freeze()
        assert tc.is_frozen()
        # switching the process default invalidates frozen answers
        assert tc.set_default_model("pipeline") == "pipeline"
        assert not tc.is_frozen()
        lookup_or_tune("matmul", spec=TPU, **MM_SIG)
        kinds = {k[-1] for k in registry.dispatch_memo_keys()
                 if k[0] == "matmul"}
        assert "pipeline" in kinds
        # the frozen tier keeps pipeline records out while eq6 is the
        # default, so a freeze after switching back serves eq6 answers
        tc.set_default_model(None)
        tc.freeze()
        assert tc.frozen_lookup("matmul", MM_SIG, spec=TPU) \
            == lookup_or_tune("matmul", db=TuningDatabase(), spec=TPU,
                              **MM_SIG)
    finally:
        tc.set_default_model(None)
        tc.thaw()
        tc.clear_dispatch_memo()


def test_env_selects_default_kind(monkeypatch):
    monkeypatch.setenv(tc.ENV_MODEL, "pipeline")
    try:
        tc.set_default_model(None)      # drop the cached read
        assert tc.default_model_kind() == "pipeline"
    finally:
        monkeypatch.delenv(tc.ENV_MODEL)
        tc.set_default_model(None)
        assert tc.default_model_kind() == "eq6"


def _toy_hopper(cols, *, x):
    n = len(cols["tile"])
    return dict(blocks=max(x // 8, 1), threads=np.full(n, 128), regs=32,
                smem=0, flops=1.0 * x, hbm_bytes=8.0 * x)


def test_kernel_declared_kind():
    from repro_torch.kernels.api import (HopperSpace, divisors,
                                         tuned_kernel, unregister)

    @tuned_kernel("pipe_toy", space={"b": divisors("x", (8, 16, 32))},
                  signature=lambda u, **_: dict(x=u.shape[0]),
                  static_info=lambda p, *, x: dict(
                      in_blocks=[(p["b"], 128)], out_blocks=[(p["b"], 128)],
                      in_dtypes=["float32"], out_dtypes=["float32"],
                      flops_per_step=np.asarray(p["b"],
                                                dtype=np.float64) * 128.0,
                      grid_steps=x // np.maximum(np.asarray(p["b"]), 1)),
                  hopper=HopperSpace(tiles=("t1", "t2"),
                                     analysis=_toy_hopper),
                  out=lambda u, **_: (tuple(u.shape), u.dtype),
                  model="pipeline")
    def pipe_toy(u, *, b=8):
        return u

    try:
        for target in ("tpu-v5e", "h100"):
            mem = TuningDatabase()
            lookup_or_tune("pipe_toy", db=mem, spec=target, x=64)
            (rec,) = mem.records()
            fp = json.loads(rec.key.signature)["model"]
            assert fp.startswith("pipeline-")
    finally:
        unregister("pipe_toy")


def test_declared_kind_validated():
    from repro_torch.kernels.api import divisors, tuned_kernel
    with pytest.raises(ValueError, match="model must be one of"):
        @tuned_kernel("bad_kind", space={"b": divisors("x", (8,))},
                      signature=lambda u, **_: dict(x=u.shape[0]),
                      static_info=lambda p, *, x: {},
                      hopper=None, out=lambda u, **_: None,
                      model="exact")
        def bad(u, *, b=8):
            return u


@pytest.mark.parametrize("a,b,want", [
    ([1.0, 1.0, 1.0], [1.0, 2.0, 3.0], 0.0),
    ([1, 2, 2, 3], [1, 2, 3, 4], 0.9486832980505138),
    ([1, 2, 2, 3], [30, 20, 20, 10], -1.0)])
def test_spearman_matches_the_reference(a, b, want):
    from repro.core.predict import spearman as ref_spearman
    assert spearman(a, b) == ref_spearman(a, b)
    assert spearman(a, b) == pytest.approx(want)
