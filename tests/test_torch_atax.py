"""atax's own H100 table: the sweep rows (BiCG's `BLAS2_TILES`) and the
ring rows (``atax_ring_kernel``: a persistent block per SM fed by a
ring of bulk-copied row stripes, A read from device memory once).

The ring rows' feasibility and pricing, the static picks they change,
the sweep rows' and BiCG's prices pinned to the values they had before
the ring rows came, and a numpy model of the ring kernel's order of
operations held against the reference's Pallas kernel in interpret mode
at the tolerances of ``tests/test_kernels.py`` (1e-3 float32, 2e-2
bfloat16: both sides accumulate in f32, in different orders).  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.atax import atax_pallas
from repro_torch import tuning_cache as tc
from repro_torch.core.hw import H100_SXM
from repro_torch.kernels import api
from repro_torch.kernels.atax import (ATAX_TILES, BLAS2_TILES, RING,
                                      RING_MAX_N, RING_STAGES, SWEEP, atax,
                                      atax_plain, atax_tiles_cost,
                                      check_ring, ring_refusal,
                                      ring_stages, sweep_pick)
from repro_torch.kernels.matmul import tile_fields

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RING_ROWS = [t for t, f in ATAX_TILES.items() if f[2] == RING]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-3, atol=1e-3)


def _cost(tiles, **sig):
    return atax_tiles_cost(tile_fields(ATAX_TILES, tiles), **sig)


def _pipe(kid, tiles, **sig):
    h = api.get_spec(kid)._hopper[None]
    return h.info(tiles, sig, H100_SXM).pipe


def test_the_table_is_bicgs_rows_then_the_ring_rows():
    names = list(ATAX_TILES)
    assert names[:len(BLAS2_TILES)] == list(BLAS2_TILES)
    for name, (threads, rows) in BLAS2_TILES.items():
        assert ATAX_TILES[name] == (threads, rows, SWEEP)
    assert names[len(BLAS2_TILES):] == RING_ROWS and len(RING_ROWS) >= 2
    assert api.get_spec("atax")._hopper[None].tiles == tuple(ATAX_TILES)
    assert api.get_spec("bicg")._hopper[None].tiles == tuple(BLAS2_TILES)


# (tile, dtype, n, stages or the refusal's words)
RING_CASES = [
    ("ring_t512r2", "float32", 8192, 3),      # 64 KB stripes
    ("ring_t512r2", "bfloat16", 8192, 7),     # 32 KB stripes
    ("ring_t512r1", "float32", 8192, 7),
    ("ring_t1024r2", "bfloat16", 8192, 7),
    ("ring_t512r2", "float32", 512, 16),      # capped at RING_STAGES
    ("ring_t512r2", "bfloat16", 300, "16-byte rows"),
    ("ring_t1024r1", "float32", 1001, "16-byte rows"),
    ("ring_t512r2", "float32", 8196, "wider than"),
    ("ring_t1024r2", "bfloat16", 16384, "wider than"),
]


@pytest.mark.parametrize("tile,dtype,n,want", RING_CASES,
                         ids=[f"{t}-{d}-{n}" for t, d, n, _ in RING_CASES])
def test_ring_rows_take_whole_16_byte_rows_within_their_registers(
        tile, dtype, n, want):
    """A ring row holds as many stripes as fit 227 KB (at most 16); it
    refuses rows that are not whole 16-byte vectors or have more columns
    than its threads keep in registers, and the analysis marks it
    infeasible there."""
    threads, rows, _ = ATAX_TILES[tile]
    eb = 4 if dtype == "float32" else 2
    stages = int(ring_stages(threads, rows, n, eb))
    feasible = _cost([tile], m=64, n=n, dtype=dtype)["feasible"][0]
    if isinstance(want, int):
        assert stages == want and ring_refusal(tile, dtype, n) is None
        assert feasible
    else:
        assert stages == 0 and want in ring_refusal(tile, dtype, n)
        assert not feasible and np.isinf(_pipe("atax", [tile], m=64, n=n,
                                               dtype=dtype)[0])


def test_two_stripes_over_227_kb_are_refused():
    """Where two stripes do not fit a block's shared memory the ring has
    no room to overlap a copy with a read: 0 stages, which the analysis
    reads as infeasible (`atax_tiles_cost`)."""
    # 4 rows x 8192 f32 = 128 KB a stripe (more rows than any row of
    # the table takes)
    assert ring_stages(np.array([512, 512]), np.array([2, 4]), RING_MAX_N,
                       4).tolist() == [3, 0]
    # 2 x 8192 f32 stripes at 3 stages use 192 KB of the 227
    assert int(ring_stages(512, 2, 8192, 4)) * 2 * 8192 * 4 \
        <= H100_SXM.shmem_per_block
    assert int(ring_stages(512, 1, 512, 4)) == RING_STAGES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_ring_row_refuses_operands_off_16_byte_boundaries(dtype):
    td = DTYPES[dtype][1]
    a = torch.zeros(64, 256, dtype=td)
    x = torch.zeros(256, 1, dtype=td)
    check_ring("ring_t512r2", a, x)           # aligned: no error
    off_a = torch.zeros(64 * 256 + 1, dtype=td)[1:].view(64, 256)
    off_x = torch.zeros(257, dtype=td)[1:].view(256, 1)
    for args in ((off_a, x), (a, off_x)):
        with pytest.raises(ValueError, match="16-byte-aligned"):
            check_ring("ring_t512r2", *args)
    ragged = 300 if dtype == "bfloat16" else 301
    with pytest.raises(ValueError, match="16-byte rows"):
        check_ring("ring_t512r2", torch.zeros(8, ragged, dtype=td),
                   torch.zeros(ragged, 1, dtype=td))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_rows_price_a_once_and_the_workspace_by_grid(dtype):
    """At 8192^2 a ring row reads A once whatever the L2 holds, where
    the sweep rows charge a second pass once their stripes in flight
    overflow half the L2; the workspace is one f32 row per block of the
    persistent grid (one block per SM here), written and read once."""
    m = n = 8192
    eb = 4 if dtype == "float32" else 2
    cost = _cost(RING_ROWS, m=m, n=n, dtype=dtype)
    a_bytes = float(m) * n * eb
    grid = cost["blocks"]
    assert (grid == H100_SXM.multiprocessors).all()
    np.testing.assert_array_equal(
        cost["hbm_bytes"], a_bytes + 2.0 * grid * n * 4 + 2.0 * n * eb)
    np.testing.assert_array_equal(cost["smem_bytes"], a_bytes)
    # S - 1 stripes in flight a block
    for tile, got in zip(RING_ROWS, cost["inflight_bytes"]):
        threads, rows, _ = ATAX_TILES[tile]
        s = int(ring_stages(threads, rows, n, eb))
        assert got == (s - 1) * rows * n * eb
    sweep = _cost(list(BLAS2_TILES), m=m, n=n, dtype=dtype)
    assert (sweep["hbm_bytes"] >= 2 * a_bytes).any()
    assert cost["hbm_bytes"].max() <= sweep["hbm_bytes"].min()
    assert (cost["hbm_bytes"] < 1.1 * a_bytes).all()


# (signature, the static pick) of atax under the H100: the ring rows
# take every instance here (moved from tests/test_torch_gemm.py's
# PICKS_BEFORE, where they were t512r2 at 8192^2 and t128r1 at 1024 x
# 512 before atax had ring rows)
ATAX_PICKS = [
    (dict(m=8192, n=8192, dtype="float32"), "ring_t512r2"),
    (dict(m=8192, n=8192, dtype="bfloat16"), "ring_t512r2"),
    (dict(m=1024, n=512, dtype="float32"), "ring_t512r2"),
]


@pytest.mark.parametrize("sig,tile", ATAX_PICKS,
                         ids=["x".join(str(v) for v in s.values())
                              for s, _ in ATAX_PICKS])
def test_the_static_pick_is_a_ring_row(sig, tile):
    p = tc.lookup_or_tune("atax", spec="h100", db=tc.TuningDatabase(), **sig)
    assert p["tile"] == tile and ATAX_TILES[tile][2] == RING


# the parent's shipped picks (h100_sxm.jsonl before atax had ring rows)
# at every pretune instance: the sweep row the ranking puts first
PARENT_PICKS = [
    ((512, 512, "float32"), "t128r1"), ((512, 512, "bfloat16"), "t64r1"),
    ((1024, 1024, "float32"), "t256r2"), ((1024, 1024, "bfloat16"), "t128r1"),
    ((2048, 2048, "float32"), "t512r2"), ((2048, 2048, "bfloat16"), "t256r4"),
    ((4096, 4096, "float32"), "t1024r1"),
    ((4096, 4096, "bfloat16"), "t512r2"),
    ((1024, 512, "float32"), "t128r1"),
]


@pytest.mark.parametrize("sig,tile", PARENT_PICKS,
                         ids=["x".join(map(str, s)) for s, _ in PARENT_PICKS])
def test_sweep_pick_is_the_sweep_rows_first(sig, tile):
    """`sweep_pick`, what a dispatched call launches where a ring row
    cannot take its operands, is the row dispatch picked before the ring
    rows came."""
    assert sweep_pick(*sig) == tile


def test_a_dispatched_ring_tile_on_cpu_tensors_runs_the_plain_version():
    """On CPU tensors the op runs the plain version whatever the tile,
    aligned or not (the card's reroute is tests/test_torch_cuda.py's)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((9, 33)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((34, 1)).astype(np.float32))
    off_x = x[1:]
    assert off_x.data_ptr() % 16
    got = atax(a, off_x, tile="ring_t512r2")
    torch.testing.assert_close(got, atax_plain(a, off_x))


# the sweep rows' and BiCG's H100 prices (seconds, BLAS2_TILES order) as
# the analysis gave them before atax had ring rows
PINNED = {
    ("atax", 8192, 8192, "float32"): [
        0.0006036876220394203, 0.00030584381101971014,
        0.00015692190550985508, 0.00024771389289487673,
        0.00011969142913239131, 0.00019179741844679269,
        0.0001852031056413068, 0.00011194448704283907,
        0.00010392048949156879, 0.00010677985898313758],
    ("atax", 8192, 8192, "bfloat16"): [
        0.0003899554891040969, 0.00019897774455204846,
        0.00010348887227602423, 0.00014086086841726478,
        7.703434017716742e-05, 6.901034262589714e-05,
        0.00010248102325324709, 6.928739808761519e-05,
        6.126340053634491e-05, 6.670508405776444e-05],
    ("atax", 1024, 512, "float32"): [
        1.6018576861879765e-05, 1.2009288430939881e-05,
        1.0004644215469941e-05, 1.1886358842335613e-05,
        1.0294641242517136e-05, 1.0631882424425165e-05,
        1.1886358842335613e-05, 1.1298125470108898e-05,
        1.1130958854457434e-05, 1.531206238047595e-05],
    ("bicg", 8192, 8192, "float32"): [
        0.0006037919579598184, 0.00030589597897990917,
        0.0001569479894899546, 0.00014089999438741404,
        0.00011971099211746594, 0.00011168699456619566,
        0.00010509268176070977, 0.0001119640500279137,
        0.00010394005247664342, 0.00010679942196821221],
    ("bicg", 8192, 8192, "bfloat16"): [
        0.00039000765706429587, 0.00019900382853214795,
        0.00010350191426607398, 8.745391916353342e-05,
        7.446180763985399e-05, 6.643781008858371e-05,
        6.242581131294857e-05, 6.92971795801525e-05,
        6.127318202888222e-05, 6.671486555030176e-05],
    ("bicg", 1024, 512, "float32"): [
        1.602835835441708e-05, 1.2014179177208539e-05,
        1.000708958860427e-05, 1.1896140334872926e-05,
        1.0297901740029573e-05, 1.0636773170693821e-05,
        1.1896140334872926e-05, 1.1304646465133773e-05,
        1.113747984948231e-05, 1.5331625365550576e-05],
}


@pytest.mark.parametrize("key", list(PINNED),
                         ids=["-".join(map(str, k)) for k in PINNED])
def test_the_sweep_rows_and_bicg_keep_their_prices(key):
    kid, m, n, dtype = key
    got = _pipe(kid, list(BLAS2_TILES), m=m, n=n, dtype=dtype)
    np.testing.assert_array_equal(got, np.array(PINNED[key]))


def test_bicg_keeps_its_table_and_picks():
    assert BLAS2_TILES == {
        "t32r1": (32, 1), "t64r1": (64, 1), "t128r1": (128, 1),
        "t128r4": (128, 4), "t256r1": (256, 1), "t256r2": (256, 2),
        "t256r4": (256, 4), "t512r1": (512, 1), "t512r2": (512, 2),
        "t1024r1": (1024, 1)}
    for dtype in ("float32", "bfloat16"):
        p = tc.lookup_or_tune("bicg", spec="h100", db=tc.TuningDatabase(),
                              m=8192, n=8192, dtype=dtype)
        assert p["tile"] == "t512r2"


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _ring_model(a, x, *, rows: int, grid: int, bf16: bool):
    """The ring kernel's order in numpy float32: block b takes stripes
    b, b + grid, ...; per stripe t = A_i . x in f32 (rounded to the
    input type), then its rows add A_i^T t into the block's partial y
    in row order; the partial rows add in block order (colsum_kernel),
    and y is rounded to the input type."""
    m, n = a.shape
    stripes = -(-m // rows)
    ws = np.zeros((grid, n), np.float32)
    for b in range(grid):
        ys = np.zeros(n, np.float32)
        for s in range(b, stripes, grid):
            for r in range(s * rows, min(m, (s + 1) * rows)):
                t = np.float32(np.dot(a[r], x[:, 0]))
                if bf16:
                    t = np.float32(_bf16(np.array([t]))[0])
                ys = ys + a[r] * t
        ws[b] = ys
    y = np.zeros(n, np.float32)
    for b in range(grid):
        y = y + ws[b]
    return (_bf16(y) if bf16 else y)[:, None]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n,rows,grid", [(96, 64, 2, 5), (37, 128, 1, 16),
                                           (130, 256, 2, 132)])
def test_the_ring_order_matches_the_pallas_kernel(dtype, m, n, rows, grid):
    """The ring kernel's arithmetic (t rounded to the input type before
    Aᵀ t, per-block partial rows added in block order) against the
    reference's Pallas kernel in interpret mode, and the plain version
    the card holds the kernel to."""
    rng = np.random.default_rng(71)
    a = rng.standard_normal((m, n)).astype(np.float32) * n ** -0.5
    x = rng.standard_normal((n, 1)).astype(np.float32)
    jd, td = DTYPES[dtype]
    ta, tx = torch.from_numpy(a).to(td), torch.from_numpy(x).to(td)
    a_in, x_in = ta.float().numpy(), tx.float().numpy()
    got = _ring_model(a_in, x_in, rows=rows, grid=grid,
                      bf16=dtype == "bfloat16")
    bm = m if m % 8 else 32
    want = np.asarray(atax_pallas(jnp.asarray(a, jd), jnp.asarray(x, jd),
                                  bm=bm, interpret=True), np.float32)
    np.testing.assert_allclose(got, want, **_tol(dtype))
    np.testing.assert_allclose(got, atax_plain(ta, tx).float().numpy(),
                               **_tol(dtype))
