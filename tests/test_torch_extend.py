"""The kernel API's extension path in the port against the reference, on
the CPU.

* saxpy2d, declared in ``repro_torch/examples/custom_kernel.py``: its
  plain version against the reference's Pallas kernel (interpret mode)
  on the same numpy inputs (f32 to 1e-6, bf16 to 2e-2), and its cache
  keys and winners equal to the reference's.
* The Orio annotation front end: ``parse_tuning_spec`` and
  ``annotate_kernel`` give the reference's axes, errors and winners.
* Eq. 6 calibration and ranking: bitwise the reference's.
* The mega-space matmul factory: the reference's lattice, feasibility
  mask, streamed shortlist and full-space winner under ``tpu-v5e``; the
  GEMM tile table under the H100; registered only on request.
* Discovery, ``unregister`` and variant registration.
* The three examples run to completion with ``--device cpu``.
"""
import importlib
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as ref_kernels
import repro_torch.kernels as kernels
from repro import tuning_cache as ref_tc
from repro.core import annotations as ref_annotations
from repro.core import predict as ref_predict
from repro.core.mix import InstructionMix as RefMix
from repro.core.search import StaticPrunedSearch as RefPruned
from repro.core.target import use_target as ref_use_target
from repro.kernels import api as ref_api
from repro.kernels.megamatmul import mega_matmul_spec as ref_mega_spec
from repro.tuning_cache.registry import _model_for as ref_model_for
from repro.tuning_cache.registry import rank_space as ref_rank_space
from repro_torch import tuning_cache as tc
from repro_torch.core import annotations, hw, predict
from repro_torch.core.mix import InstructionMix
from repro_torch.core.predict import static_times_batch
from repro_torch.core.search import StaticPrunedSearch
from repro_torch.core.target import use_target
from repro_torch.kernels import api, ops
from repro_torch.kernels.api import HopperSpace, KernelVariant, TILE_AXIS
from repro_torch.kernels.matmul import GEMM_TILES, _matmul_hopper
from repro_torch.kernels.megamatmul import mega_matmul, mega_matmul_spec
from repro_torch.tuning_cache.registry import _model_for, rank_space

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUSTOM = "repro_torch.examples.custom_kernel"


@pytest.fixture(autouse=True)
def _fresh_dbs():
    ref_tc.set_default_db(ref_tc.TuningDatabase())
    tc.set_default_db(tc.TuningDatabase())
    yield
    ref_tc.reset_default_db()
    tc.reset_default_db()


@pytest.fixture(scope="module")
def ref_custom():
    """The reference's examples/custom_kernel.py, imported once by path
    (its declaration registers saxpy2d) and unregistered after."""
    ref_api.unregister("saxpy2d")
    path = os.path.join(REPO, "examples", "custom_kernel.py")
    spec = importlib.util.spec_from_file_location("_ref_custom_kernel",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    ref_api.unregister("saxpy2d")


@pytest.fixture(scope="module")
def custom():
    """The port's example module, imported (its declaration registers
    saxpy2d) and unregistered after."""
    api.unregister("saxpy2d")
    sys.modules.pop(CUSTOM, None)
    mod = importlib.import_module(CUSTOM)
    yield mod
    api.unregister("saxpy2d")
    sys.modules.pop(CUSTOM, None)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# saxpy2d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(64, 48), (256, 128), (8, 1000)])
def test_saxpy2d_plain_matches_pallas(ref_custom, custom, shape, dtype, tol):
    a, b = _rand(shape, 0), _rand(shape, 1)
    jdt = jnp.dtype(dtype)
    want = np.asarray(ref_custom.saxpy2d_pallas(
        jnp.asarray(a, jdt), jnp.asarray(b, jdt), bm=8).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = custom.saxpy2d_plain(torch.from_numpy(a).to(tdt),
                               torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_saxpy2d_op_runs_the_plain_version_on_cpu(custom):
    a, b = torch.from_numpy(_rand((40, 24), 2)), torch.from_numpy(
        _rand((40, 24), 3))
    torch.testing.assert_close(ops.saxpy2d(a, b), 2.0 * a + b)
    torch.testing.assert_close(custom.saxpy2d(a, b, tile="t128v1"),
                               2.0 * a + b)


SAXPY_SIGS = [dict(m=256, n=256), dict(m=2048, n=1024, dtype="float32"),
              dict(m=8192, n=8192, dtype="bfloat16"), dict(m=96, n=40)]


@pytest.mark.parametrize("target", ["tpu-v5e", "kepler_k20"])
@pytest.mark.parametrize("sig", SAXPY_SIGS,
                         ids=["256", "2048x1024", "8192bf16", "96x40"])
def test_saxpy2d_keys_and_winners_match_reference(ref_custom, custom, sig,
                                                  target):
    ref_db, db = ref_tc.TuningDatabase(), tc.TuningDatabase()
    want = ref_tc.lookup_or_tune("saxpy2d", spec=target, db=ref_db, **sig)
    got = tc.lookup_or_tune("saxpy2d", spec=target, db=db, **sig)
    assert got == want
    (rk,), (pk,) = ([r.key for r in d.snapshot()] for d in (ref_db, db))
    assert pk.to_dict() == rk.to_dict()
    assert pk.digest == rk.digest


def test_saxpy2d_h100_space_is_its_compiled_tiles(custom):
    p = tc.lookup_or_tune("saxpy2d", spec="h100", db=tc.TuningDatabase(),
                          m=8192, n=8192)
    assert set(p) == {TILE_AXIS} and p[TILE_AXIS] in custom.SAXPY_TILES
    spec = api.get_spec("saxpy2d")
    an = spec._hopper[None].analysis(
        {TILE_AXIS: np.asarray(list(custom.SAXPY_TILES))}, m=8192, n=8192,
        dtype="float32")
    np.testing.assert_array_equal(an["hbm_bytes"], 3.0 * 8192 * 8192 * 4)


@pytest.mark.parametrize("stem", ["stencil2d", "saxpy2d"])
def test_extension_sources_are_named_only_by_their_modules(stem):
    """Within the port only the kernel's own module and CUDA source name
    it (and the kernel package's factory table for stencil2d)."""
    own = {"stencil2d": {"kernels/stencil2d.py", "kernels/csrc/stencil2d.cu",
                         "kernels/__init__.py"},
           "saxpy2d": {"examples/custom_kernel.py", "examples/saxpy2d.cu"}}
    root = os.path.join(REPO, "src", "repro_torch")
    found = set()
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(d, n)
                if stem in open(path, encoding="utf-8").read():
                    found.add(os.path.relpath(path, root).replace(os.sep,
                                                                  "/"))
    assert found == own[stem]


# ---------------------------------------------------------------------------
# the Orio annotation front end
# ---------------------------------------------------------------------------

FIG3_SPEC = """
/*@ begin PerfTuning (
 def performance_params {
 param TC[] = range(32,1025,32);
 param BC[] = range(24,193,24);
 param UIF[] = range(1,6);
 param PL[] = [16,48];
 param CFLAGS[] = ['', '-use_fast_math'];
 }
) @*/
"""
SPECS = [FIG3_SPEC,
         "def performance_params { param BM[] = [64, 128]; }",
         "def performance_params { param bm[] = [64, 128, 256]; }",
         "param A[] = range(8, 0, -2); param B[] = 'x';",
         "def performance_params { param bm[] = [16, 32, 64, 128]; "
         "param bn[] = [16, 32, 64, 128]; param bk[] = [16, 32, 64]; }"]


@pytest.mark.parametrize("text", SPECS, ids=range(len(SPECS)))
def test_parse_tuning_spec_matches_reference(text):
    want = ref_annotations.parse_tuning_spec(text)
    got = annotations.parse_tuning_spec(text)
    assert got.axes == want.axes and got.size == want.size


def test_fig3_spec_is_the_papers_5120_variants():
    assert annotations.parse_tuning_spec(FIG3_SPEC).size == 5120


@pytest.mark.parametrize("text", ["def performance_params { }",
                                  "param X[] = [1, 2;"])
def test_parse_errors_match_reference(text):
    with pytest.raises(ValueError):
        ref_annotations.parse_tuning_spec(text)
    with pytest.raises(ValueError):
        annotations.parse_tuning_spec(text)


def _scale_analysis(p, *, m: int, n: int, dtype: str = "float32"):
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    return dict(in_blocks=[(bm, n)], out_blocks=[(bm, n)],
                in_dtypes=[dtype], out_dtypes=[dtype], flops_per_step=0.0,
                vpu_per_step=1.0 * bm * n, grid_steps=-(-m // bm))


def _scale_hopper(cols, *, m: int, n: int, dtype: str = "float32"):
    t = np.asarray([int(s[1:]) for s in np.asarray(cols[TILE_AXIS])])
    return dict(blocks=-(-m * n // t), threads=t, regs=16, smem=0,
                flops=1.0 * m * n, hbm_bytes=8.0 * m * n)


_HOPPER = HopperSpace(tiles=("t128", "t256"), analysis=_scale_hopper)
_DECL = dict(signature=lambda a, **_: dict(m=a.shape[0], n=a.shape[1]),
             static_info=_scale_analysis)
_SPEC = "def performance_params { param bm[] = range(8, 129, 8); }"


@pytest.fixture
def annotated():
    """The same PerfTuning-declared kernel in both packages."""
    ref_annotations.annotate_kernel("tmp_annotated", _SPEC, **_DECL)(
        lambda a, *, bm=8, interpret=None: a)
    annotations.annotate_kernel("tmp_annotated", _SPEC, hopper=_HOPPER,
                                out=lambda a, **_: (tuple(a.shape), a.dtype),
                                **_DECL)(lambda a, *, tile=None: a)
    yield
    ref_api.unregister("tmp_annotated")
    api.unregister("tmp_annotated")


@pytest.mark.parametrize("target", ["tpu-v5e", "kepler_k20"])
def test_annotate_kernel_matches_reference(annotated, target):
    sig = dict(m=1024, n=512)
    assert api.get_spec("tmp_annotated").search_space(**sig).axes == \
        ref_api.get_spec("tmp_annotated").search_space(**sig).axes
    want = ref_tc.lookup_or_tune("tmp_annotated", spec=target,
                                 db=ref_tc.TuningDatabase(), **sig)
    got = tc.lookup_or_tune("tmp_annotated", spec=target,
                            db=tc.TuningDatabase(), **sig)
    assert got == want


def test_annotate_kernel_rejects_an_empty_spec_at_declaration():
    for mod, kw in ((ref_annotations, {}),
                    (annotations, dict(hopper=_HOPPER,
                                       out=lambda a, **_: (a.shape, a.dtype)))):
        with pytest.raises(ValueError):
            mod.annotate_kernel("tmp_empty", "def performance_params { }",
                                **_DECL, **kw)
    assert "tmp_empty" not in api.registered_kernels()
    with pytest.raises(ValueError):
        api.tuned_kernel("tmp_empty", space="no params here",
                         hopper=_HOPPER, out=lambda a, **_: None,
                         **_DECL)(lambda a, *, tile=None: a)


def test_annotate_binds_to_the_tuner_statically():
    tk = annotations.annotate(
        "atax_annotated", "def performance_params { param bm[] = [64, 128, "
        "256]; }", build=lambda p: None,
        static_info=lambda p: api.get_spec("atax").static_info(
            p, m=512, n=256), make_inputs=lambda: ())
    assert tk.space.size == 3
    from repro_torch.core import KernelTuner
    rep = KernelTuner(tk, spec="tpu-v5e", db=None).tune("static")
    assert rep.best_params["bm"] in (64, 128, 256)
    assert rep.empirical_evals == 0


# ---------------------------------------------------------------------------
# Eq. 6 calibration and ranking
# ---------------------------------------------------------------------------

_FIELDS = ("mxu_flops", "vpu_flops", "trans_flops", "hbm_bytes",
           "vmem_bytes", "ctrl_ops", "reg_ops")


def _mixes(seed, n=24, zero=()):
    rng = np.random.default_rng(seed)
    rows = rng.uniform(1e3, 1e9, size=(n, len(_FIELDS)))
    for c in zero:
        rows[:, c] = 0.0
    return ([RefMix(**dict(zip(_FIELDS, r))) for r in rows],
            [InstructionMix(**dict(zip(_FIELDS, r))) for r in rows],
            rng.uniform(1e-6, 1e-3, size=n))


@pytest.mark.parametrize("seed,zero,mode", [(0, (), "sum"), (1, (2, 6),
                                                             "sum"),
                                            (2, (0,), "max")])
def test_calibrate_is_bitwise_the_reference(seed, zero, mode):
    rm, pm, t = _mixes(seed, zero=zero)
    want = ref_predict.calibrate(rm, t, mode=mode)
    got = predict.calibrate(pm, t, mode=mode)
    assert got.coeffs == want.coeffs
    assert (got.mode, got.name) == (want.mode, want.name)
    assert [got.time(m) for m in pm] == [want.time(m) for m in rm]


def test_nnls_is_bitwise_the_reference():
    rng = np.random.default_rng(3)
    A, b = rng.uniform(0, 5, size=(30, 4)), rng.uniform(-1, 9, size=30)
    np.testing.assert_array_equal(predict._nnls(A, b),
                                  ref_predict._nnls(A, b))


@pytest.mark.parametrize("seed", [4, 5])
def test_predict_time_and_rank_candidates_are_bitwise(seed):
    rm, pm, _ = _mixes(seed)
    for model, ref_model in ((predict.default_tpu_model(),
                              ref_predict.default_tpu_model()),
                             (predict.default_tpu_model(mode="max"),
                              ref_predict.default_tpu_model(mode="max"))):
        assert [predict.predict_time(m, model) for m in pm] == \
            [ref_predict.predict_time(m, ref_model) for m in rm]
        t, order = predict.rank_candidates(pm, model)
        rt, rorder = ref_predict.rank_candidates(rm, ref_model)
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(order, rorder)
    assert predict.predict_time(pm[0]) == ref_predict.predict_time(rm[0])


def test_hopper_calibration_keeps_the_base_names_and_unused_columns():
    _, pm, t = _mixes(6, zero=(0, 6))
    base = predict.default_hopper_model(hw.H100_SXM)
    fit = predict.calibrate(pm, t, base=base, mode="sum")
    assert fit.name == base.name + "-calibrated" and fit.mode == "sum"
    assert fit.coeffs["mxu_flops"] == base.coeffs["mxu_flops"]
    assert all(v >= 0.0 for v in fit.coeffs.values())


# ---------------------------------------------------------------------------
# the mega-space matmul
# ---------------------------------------------------------------------------

_SMALL = dict(blocks=(8, 16, 24, 32, 40, 48), unrolls=(1, 2, 3),
              orders=("mnk", "kmn"), schemes=("blocked",), accs=("f32",))
_SMALL_SIG = dict(m=192, n=192, k=192, dtype="float32")


def _small_problems():
    with ref_use_target("tpu-v5e"), use_target("tpu-v5e"):
        return (ref_mega_spec(**_SMALL).problem(**_SMALL_SIG),
                mega_matmul_spec(**_SMALL).problem(**_SMALL_SIG))


def test_mega_small_lattice_matches_reference():
    ref_prob, prob = _small_problems()
    assert prob.space.size == ref_prob.space.size == 6 ** 3 * 3 * 2
    assert prob.space.axes == ref_prob.space.axes
    lat, ref_lat = prob.space.enumerate_lattice(), \
        ref_prob.space.enumerate_lattice()
    assert 0 < lat.size == ref_lat.size < prob.space.size
    for k in ref_lat.columns:
        np.testing.assert_array_equal(lat.columns[k], ref_lat.columns[k])
    full = {k: np.asarray(v) for k, v in ref_prob.space.axes.items()}
    grid = np.meshgrid(*full.values(), indexing="ij")
    cols = {k: g.ravel() for k, g in zip(full, grid)}
    np.testing.assert_array_equal(
        prob.space.feasible_mask(cols, grid[0].size),
        ref_prob.space.feasible_mask(cols, grid[0].size))


@pytest.mark.parametrize("keep", [dict(keep_n=16), dict(keep_frac=0.05)],
                         ids=["n16", "frac"])
def test_mega_streamed_shortlist_matches_reference(keep):
    ref_prob, prob = _small_problems()
    out = []
    for p, Pruned, use, mf in ((ref_prob, RefPruned, ref_use_target,
                                ref_model_for),
                               (prob, StaticPrunedSearch, use_target,
                                _model_for)):
        with use("tpu-v5e") as spec:
            model = mf(spec)

            def cost_cols(cols, p=p, model=model):
                b = p.static_info_batch(cols)
                return static_times_batch(None, model, F=b.F, pipe=b.pipe,
                                          feasible=b.feasible)
            out.append(Pruned(lambda q: 0.0, static_cost_cols=cost_cols,
                              chunk_size=97, **keep).shortlist(p.space))
    assert out[0] == out[1]


def test_mega_full_space_rank_matches_reference():
    """The 4,214,784-point lattice at 6144^3 f32, streamed with
    constraint pushdown: the reference's winner, time and rows."""
    sig = dict(m=6144, n=6144, k=6144, dtype="float32")
    with ref_use_target("tpu-v5e") as rs:
        want = ref_rank_space(ref_mega_spec().problem(**sig),
                              ref_model_for(rs))
    with use_target("tpu-v5e") as s:
        prob = mega_matmul_spec().problem(**sig)
        assert prob.space.size == 4214784
        got = rank_space(prob, _model_for(s))
    assert got == want


def test_mega_is_a_factory_not_a_registration():
    assert "mega_matmul" not in api.registered_kernels()
    assert "mega_matmul" not in tc.registered()
    assert "mega_matmul" not in ops.__all__


def test_mega_h100_space_is_the_gemm_tile_table():
    spec = mega_matmul_spec(register=True)
    try:
        sig = dict(m=2048, n=2048, k=2048, dtype="bfloat16")
        with use_target("h100"):
            assert spec.problem(**sig).space.axes == {
                TILE_AXIS: tuple(GEMM_TILES)}
        p = tc.lookup_or_tune("mega_matmul", spec="h100",
                              db=tc.TuningDatabase(), **sig)
        want = tc.lookup_or_tune("matmul", spec="h100",
                                 db=tc.TuningDatabase(), **sig)
        assert p == want
        a = torch.from_numpy(_rand((24, 40), 7))
        b = torch.from_numpy(_rand((40, 16), 8))
        torch.testing.assert_close(ops.mega_matmul(a, b), a @ b)
    finally:
        api.unregister("mega_matmul")
    assert "mega_matmul" not in ops.__dict__
    assert "mega_matmul" not in tc.registered()


def test_mega_fallback_is_the_references():
    from repro.kernels.megamatmul import _mega_fallback as ref_fb
    from repro_torch.kernels.megamatmul import _mega_fallback
    for sig in (dict(m=6144, n=6144, k=6144), dict(m=192, n=100, k=7)):
        assert _mega_fallback(**sig) == ref_fb(**sig)
    a = torch.ones(4, 3)
    assert mega_matmul(a, a.T).shape == (4, 4)


# ---------------------------------------------------------------------------
# discovery, unregister, variants
# ---------------------------------------------------------------------------


def test_ops_all_is_the_registry():
    assert sorted(ops.__all__) == sorted(api.registered_kernels())
    assert sorted(api.registered_kernels()) == sorted(tc.registered())


def test_tunable_factories_match_reference():
    assert set(kernels.TUNABLE_FACTORIES) == set(
        ref_kernels.TUNABLE_FACTORIES)


def test_flash_tunable_parity_and_h100_pick():
    """The reference's flash tunable narrows the joint space to (bq,
    bkv) and so cannot rank it (no "variant" column): the port keeps
    that behaviour under tpu-v5e; under the H100 it ranks the joint
    (variant, tile) table."""
    from repro.core import KernelTuner as RefTuner
    from repro_torch.core import KernelTuner
    with pytest.raises(KeyError):
        RefTuner(ref_kernels.TUNABLE_FACTORIES["flash"](),
                 db=None).tune("static")
    with use_target("tpu-v5e"):
        tk = kernels.TUNABLE_FACTORIES["flash"]()
    assert tk.space.axes == ref_kernels.TUNABLE_FACTORIES["flash"]().space.axes
    with pytest.raises(KeyError):
        KernelTuner(tk, db=None).tune("static")
    with use_target("h100"):
        tk = kernels.TUNABLE_FACTORIES["flash"](b=4, h=16, s=64, d=256,
                                                dtype="bfloat16")
    rep = KernelTuner(tk, db=None).tune("static")
    assert rep.best_params["variant"] in ("flash", "blocked")
    assert rep.empirical_evals == 0


def _declare_tmp(fn=lambda a, *, tile=None: a, **kw):
    return api.tuned_kernel(
        "tmp_scale", space={"bm": api.divisors("m", (8, 16, 32))},
        hopper=_HOPPER, out=lambda a, **_: (tuple(a.shape), a.dtype),
        **_DECL, **kw)(fn)


def test_unregister_evicts_the_memoized_op():
    _declare_tmp()
    try:
        first = ops.tmp_scale
        assert ops.__dict__["tmp_scale"] is first
        api.unregister("tmp_scale")
        assert "tmp_scale" not in ops.__dict__
        assert "tmp_scale" not in tc.registered()
        with pytest.raises(AttributeError):
            ops.tmp_scale
        _declare_tmp(fn=lambda a, *, tile=None: a * 2)
        x = torch.ones(16, 4)
        assert ops.tmp_scale is not first
        torch.testing.assert_close(ops.tmp_scale(x), x * 2)
    finally:
        api.unregister("tmp_scale")
    api.unregister("tmp_scale")             # missing ids are a no-op


def test_register_variant_thaws_and_rekeys():
    _declare_tmp()
    try:
        sig = dict(m=64, n=32)
        x = torch.ones(64, 32)
        with use_target("tpu-v5e"):
            ops.tmp_scale(x)
            key0 = tc.registry.dispatch_key(
                "tmp_scale", spec=hw.resolve_target("tpu-v5e"),
                mode="static", model_name=None, signature=sig)
            tc.freeze()
            assert tc.is_frozen()
            var = KernelVariant(variant_id="half", fn=lambda a, *, tile=None:
                                a * 0.5, space={"bm": (8, 16)},
                                analysis=_scale_analysis)
            api.register_variant("tmp_scale", var, _HOPPER)
            assert not tc.is_frozen()
            spec = api.get_spec("tmp_scale")
            assert spec.variant_ids() == ("primary", "half")
            key1 = tc.registry.dispatch_key(
                "tmp_scale", spec=hw.resolve_target("tpu-v5e"),
                mode="static", model_name=None, signature=sig)
            assert key1.digest != key0.digest
            p = tc.lookup_or_tune("tmp_scale", **sig)
            assert p["variant"] in ("primary", "half")
            with pytest.raises(ValueError):
                api.register_variant("tmp_scale", var, _HOPPER)
            with pytest.raises(TypeError):
                api.register_variant("tmp_scale", dict(var=1), _HOPPER)
            tc.freeze()
            removed = api.unregister_variant("tmp_scale", "half")
            assert removed.variant_id == "half" and not tc.is_frozen()
            assert spec.variant_ids() == ("primary",)
            with pytest.raises(ValueError):
                api.unregister_variant("tmp_scale", "primary")
            with pytest.raises(KeyError):
                api.unregister_variant("tmp_scale", "half")
            assert "half" not in spec.hopper_space(**sig).axes["variant"]
    finally:
        tc.thaw()
        api.unregister("tmp_scale")


def test_constraints_restrict_the_tpu_space_only():
    _declare_tmp(constraints=(lambda c: c["bm"] != 16,), chunk_size=5)
    try:
        sig = dict(m=64, n=32)
        spec = api.get_spec("tmp_scale")
        sp = spec.search_space(**sig)
        assert [p["bm"] for p in sp.enumerate()] == [8, 32]
        with use_target("tpu-v5e"):
            assert spec.problem(**sig).chunk_size == 5
            assert tc.lookup_or_tune("tmp_scale", db=tc.TuningDatabase(),
                                     **sig)["bm"] != 16
        with use_target("h100"):
            assert spec.problem(**sig).space.size == 2
    finally:
        api.unregister("tmp_scale")


def test_register_spec_duplicate_raises():
    spec = mega_matmul_spec(register=True)
    try:
        with pytest.raises(ValueError):
            api.register_spec(spec)
    finally:
        api.unregister("mega_matmul")


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [["--device", "cpu", "--smoke"],
                                  ["--device", "cpu"]],
                         ids=["smoke", "full"])
def test_custom_kernel_example_runs_on_cpu(custom, argv):
    out = custom.main(argv)
    assert out["static"].empirical_evals == 0
    assert ("hybrid" in out) == ("--smoke" not in argv)


def test_annotated_tuning_example_picks_a_compiled_tile_on_cpu():
    from repro_torch.examples import annotated_tuning
    kernels.reset_launch_counts()
    rep = annotated_tuning.main(["--device", "cpu"])
    p = rep.best_params
    assert (p["bm"], p["bn"], p["bk"]) in annotated_tuning.TILE_OF
    assert rep.empirical_evals == 0 and rep.space_size == 48
    assert not any(kernels.launch_counts().values())


def test_autotune_kernel_example_runs_on_cpu():
    from repro_torch.examples import autotune_kernel
    rows = autotune_kernel.main(["--device", "cpu"])
    assert rows["exhaustive"].empirical_evals == 27
    assert rows["static"].empirical_evals == 0
    cal = rows["calibration"]
    assert cal["base"] == "tpu-eq6-sum" and cal["calibrated"] >= 0.0


def test_examples_raise_without_a_card_unless_told_cpu(custom):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from repro_torch.examples import annotated_tuning, autotune_kernel
    for main in (custom.main, annotated_tuning.main, autotune_kernel.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
