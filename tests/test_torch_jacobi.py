"""B8 (jacobi3d) on the H100, on the CPU: the tile table, its analysis
and the ring kernel's schedule.

* The Python table mirrors the C X-macros of ``csrc/jacobi3d.cu``
  (plane rows, then ring rows), family and stage fields included.
* The ring rows take X a multiple of 16 / elem_bytes (TMA's global
  strides are whole 16-byte units) and are priced finite exactly there;
  they state their bytes in flight ((S - 1) stages) and their shared
  memory (S stages and S barriers); every row declares the compiled
  register count.
* Under the H100 a ring row is picked at 256^3 and a plane row where X
  is ragged.
* A numpy model of the ring kernel (TMA boxes with zero fill, clamped
  end planes, the slot schedule, planes z - 1 and z carried in
  registers, the sum order) gives the plain version's bits, and the
  plain version and the dispatching wrapper agree with the Pallas
  kernel in interpret mode.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401  (registers every kernel)
from repro.kernels.jacobi3d import jacobi3d_pallas
from repro_torch import tuning_cache as tc
from repro_torch.core import hw
from repro_torch.core.predict import static_times_batch
from repro_torch.kernels import _cuda, api
from repro_torch.kernels import jacobi3d as jc
from repro_torch.tuning_cache.registry import _model_for

H100 = hw.H100_SXM
RING_ROWS = [t for t, f in jc.JACOBI_TILES.items() if f[3] == jc.RING]
PLANE_ROWS = [t for t, f in jc.JACOBI_TILES.items() if f[3] == jc.PLANE]


def _macro_rows(macro: str):
    text = (_cuda.CSRC / "jacobi3d.cu").read_text()
    m = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)", text)
    assert m, macro
    return [tuple(int(v) for v in r.split(","))
            for r in re.findall(r"X\(([\d,\s]+)\)", m.group(1))]


def _times(sig):
    spec = api.get_spec("jacobi3d")
    pts = spec.hopper_space(**sig).enumerate()
    cols = {k: np.asarray([p[k] for p in pts]) for k in pts[0]}
    info = spec.hopper_info_batch(cols, H100, **sig)
    return pts, static_times_batch(None, _model_for(H100), F=info.F,
                                   pipe=info.pipe, feasible=info.feasible)


def _pick(**sig):
    return tc.lookup_or_tune("jacobi3d", spec="h100",
                             db=tc.TuningDatabase(), **sig)["tile"]


def test_the_table_mirrors_the_c_x_macros():
    plane = _macro_rows("JACOBI_TILES")
    ring = _macro_rows("JACOBI_RING_TILES")
    assert [r[0] for r in plane + ring] == list(range(len(jc.JACOBI_TILES)))
    want = [(bx, by, zb, jc.PLANE, 0) for _, bx, by, zb in plane] + \
        [(bx, by, zb, jc.RING, s) for _, bx, by, zb, s in ring]
    assert list(jc.JACOBI_TILES.values()) == want
    src = (_cuda.CSRC / "jacobi3d.cu").read_text()
    assert "JACOBI_PLANE = 0, JACOBI_RING = 1" in src
    assert (jc.PLANE, jc.RING) == (0, 1)
    assert jc._TILE_INDEX == {t: i for i, t in enumerate(jc.JACOBI_TILES)}
    # three staged planes at least; a TMA box row of at most 256
    # elements in both element types
    for _, bx, by, zb, s in ring:
        assert s >= 3
        for eb in (4, 2):
            assert bx % (16 // eb) == 0 and bx + 2 * (16 // eb) <= 256
    assert set(jc._REGS) == set(jc.JACOBI_TILES)


@pytest.mark.parametrize("dtype,v", [("float32", 4), ("bfloat16", 8)])
@pytest.mark.parametrize("x", [8, 12, 70, 256, 33, 64, 72])
def test_ring_rows_take_whole_16_byte_rows(dtype, v, x):
    assert jc.ring_takes(dtype, x) == (x % v == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z,y,x", [(256, 256, 256), (5, 37, 70),
                                   (40, 9, 33), (3, 4, 8), (37, 20, 40),
                                   (64, 64, 64), (1, 4, 4), (9, 33, 72)])
def test_every_row_is_priced_finite_exactly_where_it_launches(dtype, z, y,
                                                               x):
    pts, t = _times(dict(z=z, y=y, x=x, dtype=dtype))
    for p, v in zip(pts, t):
        ring = jc.JACOBI_TILES[p["tile"]][3] == jc.RING
        assert np.isfinite(v) == (not ring or jc.ring_takes(dtype, x)), p


@pytest.mark.parametrize("dtype,eb", [("float32", 4), ("bfloat16", 2)])
def test_ring_rows_state_their_bytes_in_flight_and_shared_memory(dtype,
                                                                 eb):
    rows = np.array(list(jc.JACOBI_TILES.values()), dtype=np.int64)
    c = jc.jacobi_tiles_cost(rows, z=256, y=256, x=256, dtype=dtype)
    ring = rows[:, 3] == jc.RING
    v = 16 // eb
    for (bx, by, zb, _, s), inflight, smem, threads in zip(
            rows[ring], c["inflight_bytes"][ring], c["smem"][ring],
            c["threads"][ring]):
        box = (bx + 2 * v) * (by + 2) * eb
        stage = jc.ring_stage_bytes(bx, by, eb)
        assert stage % 128 == 0 and box <= stage < box + 128
        assert inflight == (s - 1) * stage
        assert smem == s * stage + 8 * s
        assert threads == bx // v * by
    assert (c["inflight_bytes"][~ring] == 0).all()
    # the plane rows keep their static tile, four bytes a staged cell
    bx, by = rows[~ring, 0], rows[~ring, 1]
    np.testing.assert_array_equal(c["smem"][~ring], 4 * (bx + 2) * (by + 2))
    # both families move u once and out once, plus two planes a block
    pts = 256.0 ** 3
    assert (c["hbm_bytes"] >= 2 * pts * eb).all()
    # the TMA ring stages device memory's bytes once: its shared traffic
    # is the halo and the reads, under the plane rows' fill and reads
    assert c["smem_bytes"][ring].max() < c["smem_bytes"][~ring].min()


def test_declared_registers_are_the_compiled_counts_not_a_guess():
    """The plane rows compile to 50-64 registers (chip_smoke's [build]
    prints them), not the 32 once declared; both element types are
    declared."""
    for tile in PLANE_ROWS:
        f32, bf = jc._REGS[tile]
        assert 50 <= f32 <= 64 and 50 <= bf <= 64, tile
    rows = np.array([jc.JACOBI_TILES[t] for t in jc.JACOBI_TILES],
                    dtype=np.int64)
    for dtype, col in (("float32", 0), ("bfloat16", 1)):
        c = jc.jacobi_tiles_cost(rows, z=64, y=64, x=64, dtype=dtype)
        np.testing.assert_array_equal(
            c["regs"], [jc._REGS[t][col] for t in jc.JACOBI_TILES])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_h100_picks_a_ring_row_at_256_cubed(dtype):
    tile = _pick(z=256, y=256, x=256, dtype=dtype)
    assert tile in RING_ROWS
    pts, t = _times(dict(z=256, y=256, x=256, dtype=dtype))
    best_plane = min(v for p, v in zip(pts, t) if p["tile"] in PLANE_ROWS)
    assert min(t) < best_plane


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z,y,x", [(5, 37, 70), (64, 64, 70),
                                   (256, 256, 250)])
def test_h100_picks_a_plane_row_where_x_is_ragged(dtype, z, y, x):
    assert _pick(z=z, y=y, x=x, dtype=dtype) in PLANE_ROWS


# ---------------------------------------------------------------------------
# the ring kernel's schedule and arithmetic, in numpy
# ---------------------------------------------------------------------------


def _ring_model(u: np.ndarray, tile: str, c0: float, c1: float):
    """What ``jacobi_ring_kernel`` computes, block by block: each stage
    a TMA box of (BY + 2) rows x (BX + 2V) at (x0 - V, y0 - 1) of the
    plane clamped into the volume, zeros outside it; the loads issued as
    the kernel issues them (S at first, then after output plane k the
    planes k + 1 + S, and S after plane 0), each checked to overwrite
    only a plane whose last read is done and each read checked to find
    its plane; planes z - 1 and z of a thread's points carried from the
    planes before.  float32 volumes, the sum in the kernel's order."""
    bx, by, zb, _, s = jc.JACOBI_TILES[tile]
    z_n, y_n, x_n = u.shape
    v = 4
    f = np.float32
    out = np.full(u.shape, np.nan, dtype=f)

    def box(zz, y0, x0):
        b = np.zeros((by + 2, bx + 2 * v), dtype=f)
        ys = np.arange(y0 - 1, y0 + by + 1)
        xs = np.arange(x0 - v, x0 + bx + v)
        yi, xi = np.meshgrid(ys, xs, indexing="ij")
        ok = (yi >= 0) & (yi < y_n) & (xi >= 0) & (xi < x_n)
        b[ok] = u[zz, yi[ok], xi[ok]]
        return b

    for z0 in range(0, z_n, zb):
        for y0 in range(0, y_n, by):
            for x0 in range(0, x_n, bx):
                nz = min(zb, z_n - z0)
                nin = nz + 2
                slot = {}                    # slot -> (plane, data)

                def issue(j):
                    old = slot.get(j % s)
                    if old is not None:      # its last read: output j - S - 1
                        assert old[0] == j - s and old[0] <= k + 1
                    slot[j % s] = (j, box(min(max(z0 - 1 + j, 0), z_n - 1),
                                          y0, x0))

                def plane(j):
                    assert slot[j % s][0] == j   # the wait finds its plane
                    return slot[j % s][1]

                k = -1
                for j in range(min(s, nin)):
                    issue(j)
                rows = slice(1, by + 1)
                cols = slice(v, v + bx)
                zm = plane(0)[rows, cols].copy()
                cen = plane(1)[rows, cols].copy()
                gy = y0 + np.arange(by)[:, None]
                gx = x0 + np.arange(bx)[None, :]
                for k in range(nz):
                    zp = plane(k + 2)[rows, cols].copy()
                    mid = plane(k + 1)
                    ym = mid[0:by, cols]
                    yp = mid[2:by + 2, cols]
                    xm = mid[rows, v - 1:v - 1 + bx]
                    xp = mid[rows, v + 1:v + 1 + bx]
                    zz = z0 + k
                    s6 = ((((zm + zp) + ym) + yp) + xm) + xp
                    r = f(c0) * cen + f(c1) * s6
                    inner = ((zz > 0) & (zz < z_n - 1) & (gy > 0)
                             & (gy < y_n - 1) & (gx > 0) & (gx < x_n - 1))
                    r = np.where(inner, r, cen)
                    live = (gy < y_n) & (gx < x_n)
                    ly, lx = np.nonzero(live)
                    out[zz, y0 + ly, x0 + lx] = r[ly, lx]
                    zm, cen = cen, zp
                    if k == 0 and s < nin:
                        issue(s)
                    if k + 1 + s < nin:
                        issue(k + 1 + s)
    return out


@pytest.mark.parametrize("tile", RING_ROWS)
@pytest.mark.parametrize("shape", [(37, 20, 40), (3, 4, 8), (1, 12, 16),
                                   (70, 9, 132)])
def test_the_ring_schedule_computes_the_plain_versions_bits(tile, shape):
    """Z not a multiple of ZB, Y not of BY, X not of BX, one plane, a
    3x4x8 volume: the model of the kernel gives the plain version's
    float32 bits (0.5 u is exact, and the six neighbours add in the
    oracle's order)."""
    u = np.random.default_rng(80).standard_normal(shape).astype(np.float32)
    got = _ring_model(u, tile, jc.C0_DEFAULT, jc.C1_DEFAULT)
    want = jc.jacobi3d_plain(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("z,y,x,bz", [(36, 10, 24, 4), (40, 9, 32, 8)])
def test_jacobi3d_agrees_with_the_pallas_kernel(dtype, tol, z, y, x, bz):
    """Z not a multiple of the ring rows' ZB, X a multiple of 8 (a ring
    row takes it in either type): the plain version and the dispatching
    wrapper (CPU tensors) against the Pallas kernel in interpret mode,
    at tests/test_torch_kernels.py's tolerances."""
    a = np.random.default_rng(81).standard_normal((z, y, x)) \
        .astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jacobi3d_pallas(jnp.asarray(a, jd), bz=bz,
                                      interpret=True).astype(jnp.float32))
    assert _pick(z=z, y=y, x=x, dtype=dtype) in jc.JACOBI_TILES
    tu = torch.from_numpy(a).to(td)
    for got in (jc.jacobi3d_plain(tu), jc.jacobi3d(tu)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
