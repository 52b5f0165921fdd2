"""stencil2d (B9) in the port against the reference, on the CPU.

* The plain version against the reference's Pallas kernel (interpret
  mode) and its oracle, on the same numpy inputs: f32 to 1e-5, bf16 to
  2e-2 (both sides compute in f32 and round once; the tolerance is the
  reference's for the Jacobi sweeps).
* The dispatch registry answers stencil2d's signatures with the
  reference's cache keys and winners under ``tpu-v5e`` and
  ``kepler_k20``; `KernelTuner` gives the reference's static report.
* Under the H100 the ranked space is the compiled tile table, and a
  static tune launches nothing.
* The module is found by discovery: nothing else names it.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as ref_kernels
import repro_torch.kernels as kernels
from repro import tuning_cache as ref_tc
from repro.core import KernelTuner as RefKernelTuner
from repro.kernels.stencil2d import stencil2d_pallas, stencil2d_ref
from repro_torch import tuning_cache as tc
from repro_torch.core import KernelTuner, hw
from repro_torch.core.target import use_target
from repro_torch.kernels import api, ops
from repro_torch.kernels.stencil2d import (STENCIL_TILES, stencil2d,
                                           stencil2d_plain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_dbs():
    ref_tc.set_default_db(ref_tc.TuningDatabase())
    tc.set_default_db(tc.TuningDatabase())
    yield
    ref_tc.reset_default_db()
    tc.reset_default_db()


def _u(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("by", [8, 16, 64])
def test_plain_matches_pallas_f32(by):
    u = _u((64, 48))
    want = np.asarray(stencil2d_pallas(jnp.asarray(u), by=by))
    got = stencil2d_plain(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 40), (2, 40), (3, 3), (40, 1),
                                   (40, 2)])
def test_plain_matches_pallas_on_boundary_only_grids(shape):
    """Y or X below 3: every cell is a boundary cell and passes
    through."""
    u = _u(shape, seed=1)
    want = np.asarray(stencil2d_pallas(jnp.asarray(u), by=8))
    got = stencil2d_plain(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if min(shape) < 3:
        np.testing.assert_array_equal(got, u)


@pytest.mark.parametrize("by", [16, 64])
def test_plain_matches_pallas_bf16(by):
    u = _u((64, 48), seed=2)
    want = np.asarray(stencil2d_pallas(jnp.asarray(u, jnp.bfloat16),
                                       by=by).astype(jnp.float32))
    got = stencil2d_plain(torch.from_numpy(u).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_plain_matches_the_reference_oracle_with_other_weights():
    u = _u((33, 17), seed=3)
    want = np.asarray(stencil2d_ref(jnp.asarray(u), 0.25, 0.1875))
    got = stencil2d_plain(torch.from_numpy(u), 0.25, 0.1875).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_and_op_run_the_plain_version():
    u = torch.from_numpy(_u((20, 30), seed=4))
    api.reset_dispatch_stats()
    torch.testing.assert_close(ops.stencil2d(u), stencil2d_plain(u))
    torch.testing.assert_close(stencil2d(u, tile="x32y1r16"),
                               stencil2d_plain(u))
    assert api.dispatch_stats()["live"] == 1


SIGS = [dict(y=512, x=512, dtype="float32"),
        dict(y=1024, x=1024, dtype="float32"),
        dict(y=2048, x=2048, dtype="float32"),
        dict(y=1024, x=1024, dtype="bfloat16"),
        dict(y=8192, x=8192, dtype="float32"),
        dict(y=8192, x=8192, dtype="bfloat16"),
        dict(y=256, x=256), dict(y=96, x=40, dtype="float32")]
_IDS = ["-".join(str(v) for v in s.values()) for s in SIGS]


@pytest.mark.parametrize("target", ["tpu-v5e", "kepler_k20"])
@pytest.mark.parametrize("sig", SIGS, ids=_IDS)
def test_lookup_or_tune_and_key_match_reference(sig, target):
    ref_db, db = ref_tc.TuningDatabase(), tc.TuningDatabase()
    want = ref_tc.lookup_or_tune("stencil2d", spec=target, db=ref_db, **sig)
    got = tc.lookup_or_tune("stencil2d", spec=target, db=db, **sig)
    assert got == want
    (rk,), (pk,) = ([r.key for r in d.snapshot()] for d in (ref_db, db))
    assert pk.to_dict() == rk.to_dict()
    assert pk.digest == rk.digest


def test_pretune_grid_is_the_reference_one():
    assert api.get_spec("stencil2d").pretune == \
        ref_kernels.api.get_spec("stencil2d").pretune


@pytest.mark.parametrize("sig", [dict(y=512, x=512),
                                 dict(y=1024, x=1024, dtype="bfloat16"),
                                 dict(y=96, x=64)],
                         ids=["512", "1024bf16", "96x64"])
def test_static_tune_matches_the_reference(sig):
    """`make_tunable_stencil2d` under tpu-v5e: the reference's report
    and cache key."""
    ref_db, db = ref_tc.TuningDatabase(), tc.TuningDatabase()
    want = RefKernelTuner(ref_kernels.TUNABLE_FACTORIES["stencil2d"](**sig),
                          db=ref_db).tune("static")
    with use_target("tpu-v5e"):
        tk = kernels.TUNABLE_FACTORIES["stencil2d"](**sig)
    got = KernelTuner(tk, db=db).tune("static")
    for f in ("best_params", "best_predicted_s", "space_size",
              "search_space_reduction", "boundedness", "intensity"):
        assert getattr(got, f) == getattr(want, f), f
    assert tk.name == want.kernel
    (rk,), (pk,) = ([r.key for r in d.snapshot()] for d in (ref_db, db))
    assert pk.digest == rk.digest


@pytest.mark.parametrize("sig", SIGS[:6], ids=_IDS[:6])
def test_h100_winner_is_a_compiled_feasible_tile(sig):
    spec = api.get_spec("stencil2d")
    p = tc.lookup_or_tune("stencil2d", spec="h100", db=tc.TuningDatabase(),
                          **sig)
    assert set(p) == {"tile"} and p["tile"] in STENCIL_TILES
    info = spec._hopper[None].info([p["tile"]], spec.normalize(sig),
                                   hw.H100_SXM)
    assert bool(info.feasible[0])


def test_h100_space_spans_32_to_1024_threads_and_prices_the_bytes():
    spec = api.get_spec("stencil2d")
    h = spec._hopper[None]
    sig = dict(y=8192, x=8192, dtype="float32")
    cols = {"tile": np.asarray(h.tiles)}
    an = h.analysis(cols, **sig)
    assert int(np.min(an["threads"])) == 32
    assert int(np.max(an["threads"])) == 1024
    # u read once, out written once, plus 3 halo rows per run of R rows
    pts = 8192 * 8192 * 4
    r = np.asarray([STENCIL_TILES[t][2] for t in h.tiles])
    np.testing.assert_allclose(an["hbm_bytes"],
                               2 * pts + 3 * (8192 // r - 1) * 8192 * 4)
    info = h.info(h.tiles, sig, hw.H100_SXM)
    assert info.feasible.all()


def test_h100_static_tune_launches_nothing():
    kernels.reset_launch_counts()
    with use_target("h100"):
        tk = kernels.make_tunable_stencil2d(y=8192, x=8192, device="cpu")
    rep = KernelTuner(tk, db=None).tune("static")
    assert rep.best_params["tile"] in STENCIL_TILES
    assert rep.empirical_evals == 0 and rep.space_size == len(STENCIL_TILES)
    assert kernels.launch_counts()["stencil2d"] == 0


def test_stencil2d_is_discovered_not_named():
    """`ops.stencil2d` exists because `kernels/stencil2d.py` was found,
    and no file of the dispatch stack names the kernel."""
    assert "stencil2d" in api.registered_kernels()
    assert "stencil2d" in tc.registered()
    assert "stencil2d" in ops.__all__
    port = os.path.join(REPO, "src", "repro_torch")
    stack = [os.path.join(port, "kernels", n) for n in (
        "ops.py", "api.py", "_cuda.py", "common.py", "variants.py",
        os.path.join("csrc", "library.cu"), os.path.join("csrc",
                                                         "common.cuh"))]
    tcdir = os.path.join(port, "tuning_cache")
    stack += [os.path.join(tcdir, n) for n in os.listdir(tcdir)
              if n.endswith(".py")]
    for path in stack:
        text = open(path, encoding="utf-8").read()
        assert "stencil" not in text and "saxpy" not in text, path
    init = open(os.path.join(port, "kernels", "__init__.py"),
                encoding="utf-8").read()
    lines = [l for l in init.splitlines() if "stencil2d" in l]
    assert all("make_tunable_stencil2d" in l for l in lines), lines
