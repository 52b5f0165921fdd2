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
* The tile table mirrors both C X-macros of ``csrc/stencil2d.cu`` (march
  rows, then ring rows), family and stage fields included; ring rows
  take X a multiple of 16 / elem_bytes and are priced finite exactly
  there, state their shared memory and bytes in flight, and every row
  declares its compiled register count.  The H100 picks a ring row at
  8192^2 and a march row where X is ragged.
* A numpy model of the ring kernel (TMA boxes at signed coordinates with
  zero fill, the slot schedule, the rows read across stage and run
  boundaries, the sum order) gives the plain version's bits in float32
  and bfloat16.
* The module is found by discovery: nothing else names it.
"""
import os
import re

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
from repro_torch.core.predict import static_times_batch
from repro_torch.kernels import _cuda, api, ops
from repro_torch.kernels import stencil2d as st
from repro_torch.kernels.stencil2d import (STENCIL_TILES, stencil2d,
                                           stencil2d_plain)
from repro_torch.tuning_cache.registry import _model_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = hw.H100_SXM
RING_ROWS = [t for t, f in STENCIL_TILES.items() if f[3] == st.RING]
MARCH_ROWS = [t for t, f in STENCIL_TILES.items() if f[3] == st.MARCH]


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
    """The march rows: 32 to 1024 threads, u read once and out written
    once plus 3 halo rows per run of R rows; every row is feasible on a
    grid both families take."""
    spec = api.get_spec("stencil2d")
    h = spec._hopper[None]
    sig = dict(y=8192, x=8192, dtype="float32")
    cols = {"tile": np.asarray(MARCH_ROWS)}
    an = h.analysis(cols, **sig)
    assert int(np.min(an["threads"])) == 32
    assert int(np.max(an["threads"])) == 1024
    pts = 8192 * 8192 * 4
    r = np.asarray([STENCIL_TILES[t][2] for t in MARCH_ROWS])
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


# ---------------------------------------------------------------------------
# the tile table, its two families and their pricing
# ---------------------------------------------------------------------------


def _macro_rows(macro: str):
    text = (_cuda.CSRC / "stencil2d.cu").read_text()
    m = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)", text)
    assert m, macro
    return [tuple(int(v) for v in r.split(","))
            for r in re.findall(r"X\(([\d,\s]+)\)", m.group(1))]


def _times(sig):
    spec = api.get_spec("stencil2d")
    pts = spec.hopper_space(**sig).enumerate()
    cols = {k: np.asarray([p[k] for p in pts]) for k in pts[0]}
    info = spec.hopper_info_batch(cols, H100, **sig)
    return pts, static_times_batch(None, _model_for(H100), F=info.F,
                                   pipe=info.pipe, feasible=info.feasible)


def _pick(**sig):
    return tc.lookup_or_tune("stencil2d", spec="h100",
                             db=tc.TuningDatabase(), **sig)["tile"]


def test_the_table_mirrors_the_c_x_macros():
    march = _macro_rows("STENCIL_TILES")
    ring = _macro_rows("STENCIL_RING_TILES")
    assert [r[0] for r in march + ring] == list(range(len(STENCIL_TILES)))
    want = [(bx, by, r, st.MARCH, 0) for _, bx, by, r in march] + \
        [(bx, rb, r, st.RING, s) for _, bx, rb, r, s in ring]
    assert list(STENCIL_TILES.values()) == want
    src = (_cuda.CSRC / "stencil2d.cu").read_text()
    assert "STENCIL_MARCH = 0, STENCIL_RING = 1" in src
    assert (st.MARCH, st.RING) == (0, 1)
    assert st._TILE_INDEX == {t: i for i, t in enumerate(STENCIL_TILES)}
    # two pinned stages and one in flight at least; a TMA box side of at
    # most 256 elements in both types; a run and its two halo rows fill
    # whole stages; step 0's row groups reach the run's first row
    for _, bx, rb, r, s in ring:
        assert s >= 3 and 4 <= rb <= 256 and (r + 2) % rb == 0
        for eb in (4, 2):
            assert bx % (16 // eb) == 0 and bx + 2 * (16 // eb) <= 256
    assert set(st._REGS) == set(STENCIL_TILES)


@pytest.mark.parametrize("dtype,v", [("float32", 4), ("bfloat16", 8)])
@pytest.mark.parametrize("x", [4, 8, 12, 1003, 1000, 8192, 36])
def test_ring_rows_are_feasible_exactly_where_the_ring_takes_x(dtype, v,
                                                               x):
    pts, t = _times(dict(y=40, x=x, dtype=dtype))
    for p, time in zip(pts, t):
        ring = STENCIL_TILES[p["tile"]][3] == st.RING
        assert np.isfinite(time) == (not ring or x % v == 0), p


@pytest.mark.parametrize("dtype,eb", [("float32", 4), ("bfloat16", 2)])
def test_ring_rows_state_their_bytes_in_flight_and_shared_memory(dtype,
                                                                 eb):
    rows = np.array(list(STENCIL_TILES.values()), dtype=np.int64)
    c = st.stencil_tiles_cost(rows, y=8192, x=8192, dtype=dtype)
    ring = rows[:, 3] == st.RING
    v = 16 // eb
    for (bx, rb, r, _, s), inflight, smem, threads in zip(
            rows[ring], c["inflight_bytes"][ring], c["smem"][ring],
            c["threads"][ring]):
        box = (bx + 2 * v) * rb * eb
        stage = -(-box // 128) * 128
        assert inflight == (s - 1) * stage
        assert smem == s * stage + 8 * s
        assert threads == bx // v * rb
    # the march rows: two rows of their threads' elements in flight, no
    # shared memory
    bx, by = rows[~ring, 0], rows[~ring, 1]
    np.testing.assert_array_equal(c["inflight_bytes"][~ring],
                                  2 * bx * by * eb)
    assert (c["smem"][~ring] == 0).all()
    # the ring reads u once plus two halo rows a run (R + 2 is whole
    # stages); the bottom run stages its rows and the one above in whole
    # stages
    pts = 8192.0 * 8192
    rb, r = rows[ring, 1], rows[ring, 2]
    runs = -(-8192 // r)
    last = 8192 - (runs - 1) * r
    staged = (runs - 1) * (r + 2) + -(-(last + 1) // rb) * rb
    np.testing.assert_allclose(c["hbm_bytes"][ring],
                               (pts + staged * 8192.0) * eb)
    assert (staged - 8192 <= 2 * runs + rb).all()
    assert c["hbm_bytes"][ring].max() < c["hbm_bytes"][~ring].min()


def test_declared_registers_are_the_compiled_counts_not_a_guess():
    """Both families declare `_REGS`, per element type (chip_smoke's
    [build] prints them beside `stencil2d_attrs`)."""
    rows = np.array(list(STENCIL_TILES.values()), dtype=np.int64)
    for dtype, col in (("float32", 0), ("bfloat16", 1)):
        c = st.stencil_tiles_cost(rows, y=64, x=64, dtype=dtype)
        np.testing.assert_array_equal(
            c["regs"], [st._REGS[t][col] for t in STENCIL_TILES])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_h100_picks_a_ring_row_at_8192_squared(dtype):
    assert _pick(y=8192, x=8192, dtype=dtype) in RING_ROWS
    pts, t = _times(dict(y=8192, x=8192, dtype=dtype))
    best_march = min(v for p, v in zip(pts, t) if p["tile"] in MARCH_ROWS)
    assert min(t) < best_march


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("y,x", [(1000, 1003), (8192, 8190), (64, 36)])
def test_h100_picks_a_march_row_where_x_is_ragged(dtype, y, x):
    if dtype == "float32" and x == 36:
        x = 38                      # 36 is whole float32 vectors
    assert _pick(y=y, x=x, dtype=dtype) in MARCH_ROWS


# ---------------------------------------------------------------------------
# the ring kernel's schedule and arithmetic, in numpy
# ---------------------------------------------------------------------------


def _ring_model(u: np.ndarray, tile: str, v: int, c0: float, c1: float):
    """What ``stencil_ring_kernel`` computes, block by block, on the f32
    values of u: stage q a TMA box of RB rows x (BX + 2V) at (x0 - V, y0
    - 1 + q RB), zeros outside the grid and never wholly outside it; the
    loads issued as the kernel issues them (S at first, then after step
    j the stage j - 1 + S), each checked to overwrite only the stage the
    step just released; every read checked to find its stage in its slot,
    waited for, and one of the two the step pins; the sum in the
    kernel's order.  Returns f32 results."""
    bx, rb, r, _, s = STENCIL_TILES[tile]
    y_n, x_n = u.shape
    f = np.float32
    out = np.full(u.shape, np.nan, dtype=f)

    def box(q, y0, x0):
        b = np.zeros((rb, bx + 2 * v), dtype=f)
        ys = np.arange(y0 - 1 + q * rb, y0 - 1 + (q + 1) * rb)
        xs = np.arange(x0 - v, x0 + bx + v)
        yi, xi = np.meshgrid(ys, xs, indexing="ij")
        ok = (yi >= 0) & (yi < y_n) & (xi >= 0) & (xi < x_n)
        assert (yi[:, 0] < y_n).any(), "a box wholly below the grid"
        b[ok] = u[yi[ok], xi[ok]]
        return b

    cols = slice(v, v + bx)
    for y0 in range(0, y_n, r):
        for x0 in range(0, x_n, bx):
            ny = min(r, y_n - y0)
            nin = ny + 2 if y0 + ny < y_n else ny + 1
            nst = -(-nin // rb)
            steps = -(-(ny + 2) // rb)
            slot, waited = {}, set()

            def issue(q, j):
                old = slot.get(q % s)
                if old is not None:         # released after step j
                    assert old[0] == q - s == j - 1
                slot[q % s] = (q, box(q, y0, x0))

            def row(i, j):
                q = i // rb
                assert q in (j - 1, j) and q in waited
                assert slot[q % s][0] == q
                return slot[q % s][1][i % rb]

            for q in range(min(s, nst)):
                issue(q, 0)
            gx = x0 + np.arange(bx)
            for j in range(steps):
                if j < nst:
                    waited.add(j)
                for ty in range(rb):
                    i = j * rb - 1 + ty
                    if not 1 <= i <= ny:
                        continue
                    yy = y0 - 1 + i
                    mid = row(i, j)
                    cen = mid[cols].copy()
                    res = cen
                    if 0 < yy < y_n - 1:
                        up, dn = row(i - 1, j)[cols], row(i + 1, j)[cols]
                        west = mid[v - 1:v - 1 + bx]
                        east = mid[v + 1:v + 1 + bx]
                        s4 = ((up + dn) + west) + east
                        res = np.where((gx > 0) & (gx < x_n - 1),
                                       f(c0) * cen + f(c1) * s4, cen)
                    live = gx < x_n
                    out[yy, gx[live]] = res[live]
                if j >= 1 and j - 1 + s < nst:
                    issue(j - 1 + s, j)
    return out


# (Y, X): Y of 1-3 rows, under RB, not a multiple of RB or R (a run at
# the grid's bottom whose row below is outside it, one whose last stage
# holds only the run's last row), X = one vector, X not of BX
RING_SHAPES = [(1, 16), (2, 8), (3, 24), (7, 8), (15, 40), (37, 72),
               (300, 136), (261, 16), (127, 264), (64, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", RING_ROWS)
@pytest.mark.parametrize("shape", RING_SHAPES,
                         ids=[f"{y}x{x}" for y, x in RING_SHAPES])
def test_the_ring_schedule_computes_the_plain_versions_bits(tile, shape,
                                                            dtype):
    """The model of the kernel gives the plain version's bits: both add
    the neighbours in one order, round each product and the sum in f32,
    and round once to the input type."""
    td = getattr(torch, dtype)
    u = torch.from_numpy(np.random.default_rng(90).standard_normal(
        shape).astype(np.float32)).to(td)
    v = 16 // u.element_size()
    got = _ring_model(u.float().numpy(), tile, v, st.C0_DEFAULT,
                      st.C1_DEFAULT)
    want = stencil2d_plain(u)
    assert not np.isnan(got).any()
    assert torch.equal(torch.from_numpy(got).to(td), want)


def test_the_ring_schedule_with_one_float32_vector_per_row():
    """X = 4: one float32 vector, both of its edge cells boundary."""
    u = torch.from_numpy(np.random.default_rng(91).standard_normal(
        (50, 4)).astype(np.float32))
    for tile in RING_ROWS:
        got = _ring_model(u.numpy(), tile, 4, 0.25, 0.1875)
        assert torch.equal(torch.from_numpy(got),
                           stencil2d_plain(u, 0.25, 0.1875))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("y,x,by", [(64, 48, 16), (96, 40, 32)])
def test_stencil2d_agrees_with_the_pallas_kernel(dtype, tol, y, x, by):
    """X a multiple of 8 (a ring row takes it in either type): the plain
    version and the dispatching wrapper (CPU tensors) against the Pallas
    kernel in interpret mode, at this file's tolerances."""
    a = np.random.default_rng(92).standard_normal((y, x)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(stencil2d_pallas(jnp.asarray(a, jd), by=by,
                                       interpret=True).astype(jnp.float32))
    assert _pick(y=y, x=x, dtype=dtype) in STENCIL_TILES
    tu = torch.from_numpy(a).to(td)
    for got in (stencil2d_plain(tu), stencil2d(tu)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
