"""B2 (rms_norm) and B3 (flash attention) on the H100, on the CPU: the
tile tables, their analysis and the kernels' arithmetic.

* The Python tables mirror the C X-macros of ``csrc/attention.cu`` and
  ``csrc/rms_norm.cu``, family fields included.
* Every row is priced finite exactly where its kernel launches: the
  bf16 tensor-core flash rows take bfloat16 with d a multiple of 16 up
  to 256, the 3xTF32 rows float32 with d a multiple of 8 up to 256, the
  blocked tensor-core rows either while K, V and the logits fit shared
  memory, the vector rms rows whole 16-byte vectors, at most THREADS x
  VMAX of them.
* Under the H100 the tensor-core families are picked at the serving
  instances, float32 included; the SIMT rows' predicted times are
  bitwise those before the tensor-core rows (captured then, as
  ``float.hex``) and of a model that prices ``mxu_flops`` at the FP32
  rate.
* The hi + lo bf16 split of P keeps 2^-16 relative error, and a numpy
  model of the tensor-core kernel's tiling (16-row warps, KV tiles, the
  causal skip, online softmax, P split into hi + lo) computes the
  Pallas kernel's function; a numpy model of 3xTF32 (operands rounded
  to tf32 as ``cvt.rna`` rounds them, three products) keeps Q.K^T and
  P.V within 2e-4 of float64 where plain TF32 does not.
* The plain versions agree with the Pallas kernels in interpret mode.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401  (registers every kernel)
from repro.kernels.flash_attention import (blocked_attention_pallas,
                                           flash_attention_pallas)
from repro.kernels.rms_norm import rms_norm_pallas
from repro_torch import kernels
from repro_torch import tuning_cache as tc
from repro_torch.core import hw
from repro_torch.core.predict import (CostModel, default_hopper_model,
                                      static_times_batch)
from repro_torch.kernels import _cuda, api
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rms_norm as rn
from repro_torch.tuning_cache.registry import _model_for

H100 = hw.H100_SXM
FLASH_SERVE = dict(b=4, h=16, sq=64, skv=64, d=256, causal=True,
                   dtype="bfloat16")
JT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _times(kernel_id, sig, model=None):
    """(rows, predicted seconds) of a kernel's whole H100 space at
    ``sig``, ranked as dispatch ranks them."""
    spec = api.get_spec(kernel_id)
    pts = spec.hopper_space(**sig).enumerate()
    cols = {k: np.asarray([p[k] for p in pts]) for k in pts[0]}
    info = spec.hopper_info_batch(cols, H100, **sig)
    return pts, static_times_batch(None, model or _model_for(H100), F=info.F,
                                   pipe=info.pipe, feasible=info.feasible)


def _row(p):
    return f"{p['variant']}/{p['tile']}" if "variant" in p else p["tile"]


def _fp32_mxu_model():
    """The H100 model with ``mxu_flops`` at the FP32 rate (as before the
    tensor-core term)."""
    base = default_hopper_model(H100)
    return CostModel(coeffs=dict(base.coeffs,
                                 mxu_flops=1.0 / H100.fp32_flops),
                     mode=base.mode, name=base.name + "-fp32-mxu")


def _macro_rows(source: str, macro: str):
    """The X(...) rows of ``#define macro(X)`` in a csrc file, as int
    tuples without the index (which must run on from 0)."""
    text = (_cuda.CSRC / source).read_text()
    m = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)", text)
    assert m, (source, macro)
    return [tuple(int(v) for v in r.split(","))
            for r in re.findall(r"X\(([\d,\s]+)\)", m.group(1))]


def test_tables_mirror_the_c_x_macros():
    simt = _macro_rows("attention.cu", "FLASH_TILES")
    mma = _macro_rows("attention.cu", "FLASH_MMA_TILES")
    tf32 = _macro_rows("attention.cu", "FLASH_TF32_TILES")
    rows = simt + mma + tf32
    assert [r[0] for r in rows] == list(range(len(fa.FLASH_TILES)))
    want = [(bq, bkv, nt, fa.SIMT) for _, bq, bkv, nt in simt] + \
        [(bq, bkv, 32 * w, fa.MMA) for _, bq, bkv, w, _ in mma] + \
        [(bq, bkv, 32 * w, fa.TF32) for _, bq, bkv, w, _ in tf32]
    assert list(fa.FLASH_TILES.values()) == want
    assert all(bq * ds == 16 * w for _, bq, _, w, ds in mma + tf32)
    assert [f[3] for f in fa.FLASH_TILES.values()] == sorted(
        f[3] for f in fa.FLASH_TILES.values())
    src = (_cuda.CSRC / "attention.cu").read_text()
    assert f"MMA_DMAX = {fa.MMA_DMAX};" in src
    assert "FLASH_SIMT = 0, FLASH_MMA = 1, FLASH_TF32 = 2" in src
    assert (fa.SIMT, fa.MMA, fa.TF32) == (0, 1, 2)
    # the pricing's shared-S flag and element bytes are the MMA policy's
    for ctype, fam in (("bf16", fa.MMA), ("float", fa.TF32)):
        m = re.search(rf"struct TcStep<{ctype}> {{.*?SHARE_S = (\w+);",
                      src, re.S)
        assert m and (m.group(1) == "true") == fa._TC_UNITS[fam][5]
        assert fa._TC_UNITS[fam][0] == (2 if ctype == "bf16" else 4)

    bsimt = _macro_rows("attention.cu", "BLOCKED_TILES")
    btc = _macro_rows("attention.cu", "BLOCKED_TC_TILES")
    assert [r[0] for r in bsimt + btc] == list(range(len(fa.BLOCKED_TILES)))
    want = [(bq, nt, fa.SIMT) for _, bq, nt in bsimt] + \
        [(bq, 32 * w, fa.TC) for _, bq, w in btc]
    assert list(fa.BLOCKED_TILES.values()) == want
    assert all((16 * w) % bq == 0 and 16 * w // bq in (1, 2, 4)
               for _, bq, w in btc)
    assert "BLOCKED_SIMT = 0, BLOCKED_TC = 1" in src and fa.TC == 1
    assert f"BLOCKED_KT = {fa.BLOCKED_KT};" in src

    warp = _macro_rows("rms_norm.cu", "RMS_TILES")
    vec = _macro_rows("rms_norm.cu", "RMS_VEC_TILES")
    cluster = _macro_rows("rms_norm.cu", "RMS_CLUSTER_TILES")
    assert [r[0] for r in warp + vec + cluster] == list(
        range(len(rn.RMS_TILES)))
    want = [(r, 32 * r, rn.SIMT, 0, 1) for _, r in warp] + \
        [(1, nt, rn.VEC, rn.VMAX, 1) for _, nt in vec] + \
        [(1, nt, rn.CLUSTER, rn.VMAX, c) for _, c, nt in cluster]
    assert list(rn.RMS_TILES.values()) == want
    # within the portable cluster size; the most blocks a row first
    assert all(c in (2, 4, 8) for _, c, _ in cluster)
    assert [c for _, c, _ in cluster] == sorted(
        (c for _, c, _ in cluster), reverse=True)
    src = (_cuda.CSRC / "rms_norm.cu").read_text()
    assert f"RMS_VMAX = {rn.VMAX};" in src
    assert "RMS_SIMT = 0, RMS_VEC = 1, RMS_CLUSTER = 2" in src
    assert (rn.SIMT, rn.VEC, rn.CLUSTER) == (0, 1, 2)


def test_wrappers_take_the_tile_index_from_a_dict_and_count_families():
    assert rn._TILE_INDEX == {t: i for i, t in enumerate(rn.RMS_TILES)}
    assert fa._TILE_INDEX["repro_flash"] == {
        t: i for i, t in enumerate(fa.FLASH_TILES)}
    assert fa._TILE_INDEX["repro_blocked"] == {
        t: i for i, t in enumerate(fa.BLOCKED_TILES)}
    counts = kernels.launch_counts()
    for name in ("rms_norm", "rms_simt", "rms_vec", "flash", "blocked",
                 "flash_simt", "flash_mma", "flash_tf32", "blocked_simt",
                 "blocked_tc"):
        assert name in counts, name
    # one counter a family, in the family's code order
    assert fa._FAMILY_COUNTER == {
        "repro_flash": ("flash_simt", "flash_mma", "flash_tf32"),
        "repro_blocked": ("blocked_simt", "blocked_tc")}


# (sq = skv, d): the last three are K/V lengths at d = 256 around the
# blocked tensor-core rows' shared-memory limit (bf16 up to 128, f32 up
# to 96 at 16 query rows)
ATTN_SHAPES = [(64, 256), (64, 128), (64, 64), (80, 32), (64, 72),
               (64, 272), (64, 8), (96, 256), (128, 256), (256, 256)]


def _smem_fits(p, s, d, dtype):
    """Whether a tensor-core row's shared memory fits a block at sq =
    skv = s, from the kernels' own layouts."""
    eb = 4 if dtype == "float32" else 2
    if p["variant"] == "flash":
        bq, bkv = fa.FLASH_TILES[p["tile"]][:2]
        stages = 2 if s > bkv else 1
        smem = eb * (d + 16 // eb) * (bq + stages * 2 * bkv)
    else:
        bq, skvp = fa.BLOCKED_TILES[p["tile"]][0], -(-s // 16) * 16
        smem = eb * (d + 16 // eb) * (bq + 2 * skvp) \
            + 4 * (bq * (skvp + 8) + bq)
    return smem <= H100.shmem_per_block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", ATTN_SHAPES)
def test_every_flash_row_is_priced_finite_exactly_where_it_launches(
        dtype, causal, s, d):
    """Flash rows of all three families and the blocked rows of both:
    a tensor-core row is finite exactly where its wrapper launches (its
    dtype and head width, and shared memory that fits)."""
    sig = dict(b=2, h=3, sq=s, skv=s, d=d, causal=causal, dtype=dtype)
    pts, t = _times("flash_attention", sig)
    for p, v in zip(pts, t):
        table = fa.FLASH_TILES if p["variant"] == "flash" \
            else fa.BLOCKED_TILES
        fam = table[p["tile"]][-1]
        if p["variant"] == "flash":
            takes = {fa.SIMT: True,
                     fa.MMA: dtype == "bfloat16" and d % 16 == 0
                     and d <= 256,
                     fa.TF32: dtype == "float32" and d % 8 == 0
                     and d <= 256}[fam]
            assert takes == {fa.SIMT: True,
                             fa.MMA: fa.mma_takes(dtype, d),
                             fa.TF32: fa.tf32_takes(dtype, d)}[fam]
        else:
            takes = fam == fa.SIMT or (d <= 256 and d % (
                16 if dtype == "bfloat16" else 8) == 0)
            assert takes == (fam == fa.SIMT or fa.tc_takes(dtype, d))
        if fam == fa.SIMT:
            # the SIMT rows' shared memory grows with d and skv: they
            # are not all feasible past d = 128
            if p["variant"] == "flash" and d <= 128:
                assert np.isfinite(v), (p, v)
            continue
        assert np.isfinite(v) == (takes and _smem_fits(p, s, d, dtype)), \
            (p, v)


RMS_SHAPES = [(4, 3072), (256, 3072), (37, 300), (4, 4096), (1, 64),
              (3, 4100), (2, 16384), (2, 32768), (5, 2052), (4, 24576),
              (4, 24570), (3, 16400), (4, 16392), (2, 65536),
              (1, 131072), (1, 131080)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", RMS_SHAPES)
def test_every_rms_row_is_priced_finite_exactly_where_it_launches(dtype, m,
                                                                  d):
    pts, t = _times("rms_norm", dict(m=m, d=d, dtype=dtype))
    v_elems = 16 // (4 if dtype == "float32" else 2)
    for p, v in zip(pts, t):
        _, threads, family, vmax, blocks = rn.RMS_TILES[p["tile"]]
        takes = family == rn.SIMT or (
            d % v_elems == 0 and d <= blocks * threads * vmax * v_elems)
        assert bool(rn.vec_takes(dtype, d, threads)) == (
            d % v_elems == 0 and d <= threads * rn.VMAX * v_elems)
        if family == rn.CLUSTER:
            assert bool(rn.cluster_takes(dtype, d, threads, blocks)) == takes
        assert np.isfinite(v) == takes, (p, v)


def test_h100_picks_the_new_families_at_the_serve_instances():
    def pick(kid, **sig):
        return tc.lookup_or_tune(kid, spec="h100", db=tc.TuningDatabase(),
                                 **sig)

    def flash_pick(**sig):
        """The flash variant's best row under the same ranking."""
        pts, t = _times("flash_attention", sig)
        rows = [(v, p["tile"]) for p, v in zip(pts, t)
                if p["variant"] == "flash"]
        return min(rows)[1]
    # bf16 at the serve shape: the blocked tensor-core rows, and the
    # bf16 MMA rows within flash
    p = pick("flash_attention", **FLASH_SERVE)
    assert p["variant"] == "blocked"
    assert fa.BLOCKED_TILES[p["tile"]][2] == fa.TC
    assert fa.FLASH_TILES[flash_pick(**FLASH_SERVE)][3] == fa.MMA
    for m in (4, 256):
        p = pick("rms_norm", m=m, d=3072, dtype="bfloat16")
        assert rn.RMS_TILES[p["tile"]][2] == rn.VEC, (m, p)
    # float32 reaches the tensor cores only through 3xTF32: the pick is
    # a TF32 flash row (tied in the model with a blocked tensor-core
    # row, which comes after it), and no bf16 MMA row is feasible;
    # ragged rms rows stay on warps
    f32 = dict(FLASH_SERVE, dtype="float32")
    p = pick("flash_attention", **f32)
    assert p["variant"] == "flash"
    assert fa.FLASH_TILES[p["tile"]][3] == fa.TF32
    assert fa.FLASH_TILES[flash_pick(**f32)][3] == fa.TF32
    pts, t = _times("flash_attention", f32)
    mma = [v for p, v in zip(pts, t) if p["variant"] == "flash"
           and fa.FLASH_TILES[p["tile"]][3] == fa.MMA]
    assert mma and np.isinf(mma).all()
    p = pick("rms_norm", m=37, d=300, dtype="bfloat16")
    assert rn.RMS_TILES[p["tile"]][2] == rn.SIMT


@pytest.mark.parametrize("dtype,v", [("float32", 4), ("bfloat16", 8)])
@pytest.mark.parametrize("d", [3072, 16384, 16392, 24576, 24570, 65536,
                               65544, 131072, 300])
@pytest.mark.parametrize("threads,c", [(128, 8), (256, 8), (256, 4),
                                       (128, 4), (256, 2)])
def test_cluster_rows_take_whole_vectors_up_to_c_blocks_of_registers(
        dtype, v, d, threads, c):
    assert bool(rn.cluster_takes(dtype, d, threads, c)) == (
        d % v == 0 and d <= c * threads * rn.VMAX * v)


def test_cluster_rows_state_their_shared_memory_and_work():
    """Per block: the warps' partial sums and the slice's sum (4 bytes
    each) in shared memory; per row C blocks, each busy over its slice
    of whole vectors; x read and written once, w once."""
    r = np.array(list(rn.RMS_TILES.values()), dtype=np.int64)
    cluster = r[:, 2] == rn.CLUSTER
    for dtype, eb in (("bfloat16", 2), ("float32", 4)):
        c = rn.rms_tiles_cost(r, m=4, d=24576, dtype=dtype)
        nt, blocks = r[cluster, 1], r[cluster, 4]
        np.testing.assert_array_equal(c["smem"][cluster], 4 * (nt // 32) + 4)
        np.testing.assert_array_equal(
            c["busy_threads"][cluster],
            np.minimum(nt, -(-(24576 * eb // 16) // blocks)))
        np.testing.assert_array_equal(c["hbm_bytes"][cluster],
                                      2.0 * 4 * 24576 * eb + 24576 * 4)
        assert (c["trans"][cluster] == 4 * blocks).all()
        np.testing.assert_array_equal(
            c["regs"][cluster], [rn._CLUSTER_REGS[eb, int(n)] for n in nt])


@pytest.mark.parametrize("m,d,dtype,family", [
    (4, 24576, "bfloat16", rn.CLUSTER),   # gemma-7b's d_ff, the long row
    (4, 16392, "bfloat16", rn.CLUSTER),   # one vector past the vec rows
    (4, 16384, "bfloat16", rn.VEC),       # the vec rows' limit
    (4, 8200, "float32", rn.CLUSTER),
    (37, 300, "bfloat16", rn.SIMT),       # ragged: the warp rows' domain
    (4, 24570, "bfloat16", rn.SIMT),
    (4, 3072, "bfloat16", rn.VEC),        # the serve instances
    (256, 3072, "bfloat16", rn.VEC),
    (1, 3072, "bfloat16", rn.VEC),
    (64, 3072, "bfloat16", rn.VEC)])
def test_h100_picks_cluster_rows_for_long_rows_only(m, d, dtype, family):
    p = tc.lookup_or_tune("rms_norm", spec="h100", db=tc.TuningDatabase(),
                          m=m, d=d, dtype=dtype)
    assert rn.RMS_TILES[p["tile"]][2] == family, p
    if family == rn.VEC and d == 3072:
        assert p["tile"] == "vec_t256"


def test_new_rows_state_their_work_on_the_right_units():
    """Tensor-core rows carry QK^T and P.V as tc_flops — bf16: QK^T in
    each of a group's DS warps, (2 DS + 4) d a logit, one MMA a product
    and two for P = hi + lo; 3xTF32: QK^T once per group (its warps
    share S), (12 + 12) d, three MMAs a product at two bf16 FLOPs a TF32
    one — and a K/V stage in flight; vector rows carry the row's bytes
    in flight; the SIMT rows state neither."""
    t = np.array(list(fa.FLASH_TILES.values()), dtype=np.int64)
    for dtype, fam, qk, pv, warps in (("bfloat16", fa.MMA, 2.0, 4.0, None),
                                      ("float32", fa.TF32, 12.0, 12.0, 1)):
        c = fa.flash_tiles_cost(t, **dict(FLASH_SERVE, dtype=dtype))
        sel = t[:, 3] == fam
        simt = t[:, 3] == fa.SIMT
        assert (c["tc_flops"][sel] > 0).all()
        assert (c["tc_flops"][simt] == 0).all()
        assert (c["inflight_bytes"][sel] > 0).all()
        assert (c["inflight_bytes"][simt] == 0).all()
        ds = t[sel, 2] // (2 * t[sel, 0])             # warps per 16 rows
        assert set(ds) == {1, 2, 4}
        assert (c["warp_tc_flops"][sel] > 0).all()
        assert (c["warp_tc_flops"][simt] == 0).all()
        # a warp's chain: its QK^T (all of it, or its 16-column pairs of
        # a shared S) and its 1/DS of P.V, over the longest group's tiles
        for (bq, bkv, nt, _), chain in zip(t[sel], c["warp_tc_flops"][sel]):
            _, longest = fa._group_tiles(int(bq), int(bkv), 64, 64, True)
            w = nt // (2 * bq)
            cols = bkv if warps is None else 16 * -(-bkv // (16 * w))
            assert chain == longest * (qk * cols + pv * bkv / w) * 16 * 256
        ratio = c["tc_flops"][sel] / (
            (qk * (ds if warps is None else warps) + pv) * FLASH_SERVE["d"])
        assert (ratio % (16 * 32) == 0).all()  # whole (group, tile) pairs
    # the blocked tensor-core rows compute S once per group: (qk + pv)
    # d a logit over the columns up to each group's last row
    b = np.array(list(fa.BLOCKED_TILES.values()), dtype=np.int64)
    c = fa.blocked_tiles_cost(b, **FLASH_SERVE)
    tc_rows = b[:, 2] == fa.TC
    bh = FLASH_SERVE["b"] * FLASH_SERVE["h"]
    np.testing.assert_array_equal(
        c["tc_flops"][tc_rows], 6.0 * 16 * (16 + 32 + 48 + 64) * bh * 256)
    assert (c["tc_flops"][~tc_rows] == 0).all()
    assert (c["warp_tc_flops"][~tc_rows] == 0).all()
    assert fa._blocked_groups(16, 64, 64, True) == (160, 160, 64)
    assert fa._blocked_groups(32, 64, 64, False) == (128, 256, 64)
    assert fa._blocked_groups(16, 80, 72, True) == (240, 240, 80)
    # causal skip: at sq = skv = 64 the 16-row warps of a 64-row tile
    # see 1, 1, 1, 1 tiles of 64 or 1, 1, 2, 2 tiles of 32
    assert fa._group_tiles(64, 64, 64, 64, True) == (4, 1.0)
    assert fa._group_tiles(64, 32, 64, 64, True) == (6, 2.0)
    assert fa._group_tiles(16, 32, 64, 64, False) == (8, 2.0)
    assert fa._group_tiles(16, 32, 64, 64, True) == (6, 2.0)
    r = np.array(list(rn.RMS_TILES.values()), dtype=np.int64)
    c = rn.rms_tiles_cost(r, m=4, d=3072, dtype="bfloat16")
    vec = r[:, 2] == rn.VEC
    cluster = r[:, 2] == rn.CLUSTER
    assert (c["inflight_bytes"][vec] == 3072 * 2).all()
    assert (c["inflight_bytes"][r[:, 2] == rn.SIMT] == 0).all()
    assert (c["blocks"][vec] == 4).all()
    # a cluster row: C blocks a row, each a slice's bytes in flight
    np.testing.assert_array_equal(c["inflight_bytes"][cluster],
                                  3072 * 2 / r[cluster, 4])
    np.testing.assert_array_equal(c["blocks"][cluster], 4 * r[cluster, 4])


def test_a_stated_warp_chain_floors_the_row_and_nothing_else():
    from repro_torch.kernels.common import hopper_info_batch
    base = dict(blocks=[64, 64, 640], threads=64, regs=187, smem=80000,
                flops=1e6, tc_flops=1e9, hbm_bytes=8e6,
                inflight_bytes=65536.0, spec=H100)
    plain = hopper_info_batch(**base)
    chain = hopper_info_batch(**base, warp_tc_flops=[0.0, 1e6, 1e6])
    assert chain.pipe[0] == plain.pipe[0]
    floor = 1e6 / H100.mma_warp_flops
    assert chain.pipe[1] == pytest.approx(
        max(plain.pipe[1] - H100.launch_overhead_s, floor)
        + H100.launch_overhead_s)
    waves = -(-640 // (chain.occupancy.active_blocks[2] * 132))
    assert waves > 1
    assert chain.pipe[2] >= waves * floor


# (kernel, signature, the pick before the tensor-core rows, the pick
# now, {row: the SIMT rows' predicted seconds before the tensor-core
# rows, as float.hex}): the serving instances of gemma-smoke and
# gemma-7b (batch 4 and 1 x 64).  The picks move as tensor-core
# families join the tables (the flash bf16 rows, then the blocked and
# 3xTF32 rows); the SIMT rows' prices do not.
MOVED = [
    ('rms_norm', dict(m=256, d=64, dtype='bfloat16'),
     (None, 'r16'), (None, 'r16'), {
         'r1': '0x1.3672576db5915p-18',
         'r2': '0x1.2cedb1456deb8p-18',
         'r4': '0x1.278352bbc0bdcp-18',
         'r8': '0x1.24ce2376ea26ep-18',
         'r16': '0x1.23738bd47edb6p-18',
     }),
    ('rms_norm', dict(m=4, d=64, dtype='bfloat16'),
     (None, 'r4'), (None, 'r4'), {
         'r1': '0x1.37c26e58c8472p-18',
         'r2': '0x1.2cedb1456deb8p-18',
         'r4': '0x1.278352bbc0bdcp-18',
         'r8': '0x1.278352bbc0bdcp-18',
         'r16': '0x1.278352bbc0bdcp-18',
     }),
    ('rms_norm', dict(m=64, d=64, dtype='bfloat16'),
     (None, 'r16'), (None, 'r16'), {
         'r1': '0x1.37c26e58c8472p-18',
         'r2': '0x1.2cedb1456deb8p-18',
         'r4': '0x1.278352bbc0bdcp-18',
         'r8': '0x1.24ce2376ea26ep-18',
         'r16': '0x1.23738bd47edb6p-18',
     }),
    ('rms_norm', dict(m=1, d=64, dtype='bfloat16'),
     (None, 'r1'), (None, 'r1'), {
         'r1': '0x1.37c26e58c8472p-18',
         'r2': '0x1.37c26e58c8472p-18',
         'r4': '0x1.37c26e58c8472p-18',
         'r8': '0x1.37c26e58c8472p-18',
         'r16': '0x1.37c26e58c8472p-18',
     }),
    ('rms_norm', dict(m=256, d=3072, dtype='bfloat16'),
     (None, 'r16'), (None, 'vec_t256'), {
         'r1': '0x1.1d9f1f8f742e3p-15',
         'r2': '0x1.c906753b8c96cp-16',
         'r4': '0x1.880a06c76e715p-16',
         'r8': '0x1.678bcf8d5f5eap-16',
         'r16': '0x1.574cb3f057d54p-16',
     }),
    ('rms_norm', dict(m=4, d=3072, dtype='bfloat16'),
     (None, 'r4'), (None, 'vec_t256'), {
         'r1': '0x1.257fa911e470dp-15',
         'r2': '0x1.c906753b8c96cp-16',
         'r4': '0x1.880a06c76e715p-16',
         'r8': '0x1.880a06c76e715p-16',
         'r16': '0x1.880a06c76e715p-16',
     }),
    ('rms_norm', dict(m=64, d=3072, dtype='bfloat16'),
     (None, 'r16'), (None, 'vec_t256'), {
         'r1': '0x1.257fa911e470dp-15',
         'r2': '0x1.c906753b8c96cp-16',
         'r4': '0x1.880a06c76e715p-16',
         'r8': '0x1.678bcf8d5f5eap-16',
         'r16': '0x1.574cb3f057d54p-16',
     }),
    ('rms_norm', dict(m=1, d=3072, dtype='bfloat16'),
     (None, 'r1'), (None, 'vec_t256'), {
         'r1': '0x1.257fa911e470dp-15',
         'r2': '0x1.257fa911e470dp-15',
         'r4': '0x1.257fa911e470dp-15',
         'r8': '0x1.257fa911e470dp-15',
         'r16': '0x1.257fa911e470dp-15',
     }),
    ('flash_attention', dict(b=4, h=4, sq=64, skv=64, d=32, causal=True, dtype='bfloat16'),
     ('blocked', 'q8'), ('flash', 'mma_q16k64d2'), {
         'flash/q16k32': '0x1.3eac7a695dba1p-16',
         'flash/q16k64': '0x1.8eeb1a0516f22p-16',
         'flash/q32k32': '0x1.2e6d5ecc5630bp-16',
         'flash/q32k64': '0x1.79419fde623b0p-16',
         'flash/q64k64': '0x1.4cdef3899c046p-15',
         'blocked/q8': '0x1.fd59ecd55816cp-17',
         'blocked/q16': '0x1.8eeb1a0516f22p-16',
         'blocked/q32': '0x1.79419fde623b0p-16',
         'blocked/q64': '0x1.4cdef3899c046p-15',
     }),
    ('flash_attention', dict(b=1, h=4, sq=64, skv=64, d=32, causal=True, dtype='bfloat16'),
     ('blocked', 'q8'), ('flash', 'mma_q16k64d2'), {
         'flash/q16k32': '0x1.3eac7a695dba1p-16',
         'flash/q16k64': '0x1.8eeb1a0516f22p-16',
         'flash/q32k32': '0x1.2e6d5ecc5630bp-16',
         'flash/q32k64': '0x1.79419fde623b0p-16',
         'flash/q64k64': '0x1.4cdef3899c046p-15',
         'blocked/q8': '0x1.fd59ecd55816cp-17',
         'blocked/q16': '0x1.8eeb1a0516f22p-16',
         'blocked/q32': '0x1.79419fde623b0p-16',
         'blocked/q64': '0x1.4cdef3899c046p-15',
     }),
    ('flash_attention', dict(b=4, h=16, sq=64, skv=64, d=256, causal=True, dtype='bfloat16'),
     ('flash', 'q32k32'), ('blocked', 'tc_q32w8'), {
         'flash/q16k32': '0x1.f8a91e38ffa77p-14',
         'flash/q16k64': '0x1.4a24adc304e35p-13',
         'flash/q32k32': '0x1.e769f833b2e29p-14',
         'flash/q32k64': '0x1.3e893d2be57b9p-13',
         'flash/q64k64': '0x1.2f82c2305da4ap-12',
         'blocked/q8': '0x1.7f85aba003a10p-13',
         'blocked/q16': '0x1.4a24adc304e35p-13',
         'blocked/q32': '0x1.3e893d2be57b9p-13',
         'blocked/q64': '0x1.2f82c2305da4ap-12',
     }),
    ('flash_attention', dict(b=1, h=16, sq=64, skv=64, d=256, causal=True, dtype='bfloat16'),
     ('blocked', 'q8'), ('blocked', 'tc_q16w4'), {
         'flash/q16k32': '0x1.03f417b6e0faap-13',
         'flash/q16k64': '0x1.5432b7529a32bp-13',
         'flash/q32k32': '0x1.e769f833b2e29p-14',
         'flash/q32k64': '0x1.3e893d2be57b9p-13',
         'flash/q64k64': '0x1.2f82c2305da4ap-12',
         'blocked/q8': '0x1.87e927705e97ep-14',
         'blocked/q16': '0x1.5432b7529a32bp-13',
         'blocked/q32': '0x1.3e893d2be57b9p-13',
         'blocked/q64': '0x1.2f82c2305da4ap-12',
     }),]

# other instances of the old rows (float32, ragged D, long sequences)
OFF_SERVE = [
    ('rms_norm', dict(m=37, d=300, dtype='float32'),
     (None, 'r16'), (None, 'r16'), {
         'r1': '0x1.1e875fe5d6142p-17',
         'r2': '0x1.0278b46bb402cp-17',
         'r4': '0x1.e1abc47861c3ap-18',
         'r8': '0x1.d4fa76e5b3e05p-18',
         'r16': '0x1.af52dd906bbe0p-18',
     }),
    ('flash_attention', dict(b=4, h=16, sq=64, skv=64, d=256, causal=True, dtype='float32'),
     ('flash', 'q32k32'), ('flash', 'tf32_q32k64d4'), {
         'flash/q16k32': '0x1.26576c7ed68c4p-13',
         'flash/q16k64': '0x1.8628aacb30814p-12',
         'flash/q32k32': '0x1.0ec8d4ca3b563p-13',
         'flash/q32k64': '0x1.5f077465f48e4p-13',
         'flash/q64k64': 'inf',
         'blocked/q8': '0x1.dcce9366035dcp-12',
         'blocked/q16': '0x1.8628aacb30814p-12',
         'blocked/q32': '0x1.5f077465f48e4p-13',
         'blocked/q64': '0x1.452c3c57125bcp-12',
     }),
    ('flash_attention', dict(b=2, h=8, sq=1024, skv=1024, d=128, causal=False, dtype='bfloat16'),
     ('flash', 'q32k32'), ('flash', 'mma_q64k32w4'), {
         'flash/q16k32': '0x1.422e01fd20358p-9',
         'flash/q16k64': '0x1.422e01fd20359p-9',
         'flash/q32k32': '0x1.23f386d87d9bfp-10',
         'flash/q32k64': '0x1.2c8487d66b7e6p-9',
         'flash/q64k64': '0x1.18ec97c2e23e6p-9',
         'blocked/q8': 'inf',
         'blocked/q16': 'inf',
         'blocked/q32': 'inf',
         'blocked/q64': 'inf',
     }),]


def _case_id(case):
    kid, sig = case[0], case[1]
    return f"{kid}-{'x'.join(str(v) for v in sig.values())}"


def _hold_old_rows(kernel_id, sig, parent):
    pts, now = _times(kernel_id, sig)
    _, fp32 = _times(kernel_id, sig, _fp32_mxu_model())
    got = {_row(p): v for p, v in zip(pts, now)}
    assert set(parent) <= set(got)
    for row, hexed in parent.items():
        assert got[row] == float.fromhex(hexed), row   # bit for bit
    old = np.array([_row(p) in parent for p in pts])
    np.testing.assert_array_equal(now[old], fp32[old])


@pytest.mark.parametrize("kernel_id,sig,before,after,parent", MOVED,
                         ids=[_case_id(c) for c in MOVED])
def test_attn_norm_h100_picks_and_old_rows_prices(kernel_id, sig, before,
                                                  after, parent):
    p = tc.lookup_or_tune(kernel_id, spec="h100", db=tc.TuningDatabase(),
                          **sig)
    assert (p.get("variant"), p["tile"]) == after
    _hold_old_rows(kernel_id, sig, parent)


@pytest.mark.parametrize("kernel_id,sig,before,after,parent", OFF_SERVE,
                         ids=[_case_id(c) for c in OFF_SERVE])
def test_old_rows_keep_their_prices_off_the_serve_path(kernel_id, sig,
                                                       before, after,
                                                       parent):
    p = tc.lookup_or_tune(kernel_id, spec="h100", db=tc.TuningDatabase(),
                          **sig)
    assert (p.get("variant"), p["tile"]) == after
    _hold_old_rows(kernel_id, sig, parent)


# ---------------------------------------------------------------------------
# the kernels' arithmetic
# ---------------------------------------------------------------------------


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def test_the_hi_lo_split_of_p_keeps_2_to_the_minus_16():
    rng = np.random.default_rng(0)
    p = np.concatenate([
        rng.uniform(0.0, 1.0, 200_000),
        np.exp(-rng.uniform(0.0, 80.0, 200_000)),
        [0.0, 1.0, 0.5, 1.0 - 2.0 ** -24]]).astype(np.float32)
    hi = _bf16(p)
    assert np.array_equal(
        hi, torch.from_numpy(p).to(torch.bfloat16).float().numpy())
    lo = _bf16(p - hi)
    rel = np.abs((hi.astype(np.float64) + lo) - p) / np.maximum(p, 1e-38)
    assert rel.max() <= 2.0 ** -16
    # bf16(P) alone is 2^-9: the split is what keeps P's f32 precision
    assert (np.abs(hi.astype(np.float64) - p) / np.maximum(p, 1e-38)).max() \
        > 2.0 ** -10


def _mma_model(q, k, v, causal: bool, bq: int, bkv: int):
    """numpy model of `flash_mma_kernel` for one (b, h): blocks of bq
    rows, 16-row warps, KV tiles of bkv rows (the causal skip per block
    and per warp), f32 logits of bf16 inputs, online softmax, P as bf16
    hi + lo against bf16 V, O / max(l, 1e-30)."""
    sq, d = q.shape
    skv = k.shape[0]
    out = np.zeros((sq, d), np.float32)
    scale = np.float32(1.0 / math.sqrt(d))
    n_kv = -(-skv // bkv)
    for q0 in range(0, sq, bq):
        tiles = n_kv if not causal else min(
            n_kv, (min(q0 + bq, sq) - 1) // bkv + 1)
        for w0 in range(q0, min(q0 + bq, sq), 16):
            rows = np.arange(w0, w0 + 16)
            qw = np.zeros((16, d), np.float32)
            live = rows < sq
            qw[live] = q[rows[live]]
            m = np.full(16, -1e30, np.float32)
            l = np.zeros(16, np.float32)
            o = np.zeros((16, d), np.float32)
            for t in range(tiles):
                k0 = t * bkv
                if causal and w0 + 15 < k0:
                    continue
                cols = np.arange(k0, k0 + bkv)
                kt = np.zeros((bkv, d), np.float32)
                vt = np.zeros((bkv, d), np.float32)
                kt[cols < skv] = k[cols[cols < skv]]
                vt[cols < skv] = v[cols[cols < skv]]
                s = (qw @ kt.T).astype(np.float32) * scale
                s = np.where(cols[None, :] >= skv, -np.inf, s)
                if causal:
                    s = np.where(rows[:, None] < cols[None, :],
                                 np.float32(-1e30), s)
                mn = np.maximum(m, s.max(axis=1))
                alpha = np.exp(m - mn)
                p = np.exp(s - mn[:, None]).astype(np.float32)
                l = l * alpha + p.sum(axis=1)
                hi = _bf16(p)
                lo = _bf16(p - hi)
                o = o * alpha[:, None] + hi @ vt + lo @ vt
                m = mn
            out[rows[live]] = (o / np.maximum(l, 1e-30)[:, None])[live]
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bkv", [(16, 32), (32, 64), (64, 32)])
def test_the_tensor_core_tiling_computes_the_pallas_flash_kernel(causal, bq,
                                                                  bkv):
    """bf16 inputs (exact in f32), ragged sq against every tile, against
    `flash_attention_pallas` in interpret mode on the same bf16 values
    widened to f32 (its own f32 path) and `attention_plain`."""
    rng = np.random.default_rng(3)
    b, h, s, d = 1, 2, 80, 32
    q, k, v = (_bf16(rng.standard_normal((b, h, s, d)).astype(np.float32))
               for _ in range(3))
    got = np.stack([np.stack([_mma_model(q[i, j], k[i, j], v[i, j], causal,
                                         bq, bkv) for j in range(h)])
                    for i in range(b)])
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, bq=16,
        bkv=16, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    plain = fa.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-5)


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 -> tf32 as ``cvt.rna.tf32.f32`` rounds: to 10 mantissa
    bits, to nearest with ties away from zero, as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_tf32(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_3xtf32(a, b):
    """a . b as the 3xTF32 kernels form it: lo.hi + hi.lo + hi.hi of the
    split operands (each tf32 product exact), summed in float64 and
    rounded once to float32."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    f = lambda x, y: np.matmul(x.astype(np.float64), y.astype(np.float64))
    return (f(al, bh) + f(ah, bl) + f(ah, bh)).astype(np.float32)


def test_the_tf32_split_keeps_2_to_the_minus_21():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(200_000) * 1e3,
                        np.exp(-rng.uniform(0.0, 80.0, 200_000)),
                        [1.0, -1.5, 1.0 + 2.0 ** -11]]).astype(np.float32)
    hi, lo = _split_tf32(x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (lo.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert _tf32(np.float32([1.0 + 2.0 ** -11]))[0] == 1.0 + 2.0 ** -10
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21
    # tf32 alone keeps 2^-11
    assert (np.abs(hi.astype(np.float64) - x) / np.abs(x)).max() > 2.0 ** -13


@pytest.mark.parametrize("b,h,s,d", [(4, 16, 64, 256), (2, 4, 1024, 128)])
def test_3xtf32_keeps_qk_and_pv_within_the_f32_tolerance(b, h, s, d):
    """Q.K^T (scaled) and P.V / l of 3xTF32 against float64 at the
    smoke's f32 shape and a pretune-grid shape: within 2e-4, the f32
    tolerance of the card tests; plain TF32's Q.K^T is not."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((b * h, s, d)).astype(np.float32)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    kt = np.swapaxes(k, 1, 2)
    s64 = np.matmul(q.astype(np.float64), kt.astype(np.float64)) * scale
    np.testing.assert_allclose(_mm_3xtf32(q, kt) * np.float32(scale), s64,
                               rtol=2e-4, atol=2e-4)
    plain = np.matmul(_tf32(q).astype(np.float64),
                      _tf32(kt).astype(np.float64)) * scale
    assert np.abs(plain - s64).max() > 2e-4
    p = np.exp(s64 - s64.max(-1, keepdims=True))
    l = p.sum(-1, keepdims=True)
    o64 = np.matmul(p, v.astype(np.float64)) / l
    np.testing.assert_allclose(_mm_3xtf32(p.astype(np.float32), v) / l, o64,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("variant", ["flash", "blocked"])
def test_attention_plain_agrees_with_the_pallas_kernels(dtype, causal,
                                                        variant):
    rng = np.random.default_rng(11)
    shape = (1, 2, 64, 32)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    jd, td = JT[dtype]
    if variant == "flash":
        want = flash_attention_pallas(*(jnp.asarray(a, jd)
                                        for a in (q, k, v)), causal,
                                      bq=32, bkv=16, interpret=True)
    else:
        want = blocked_attention_pallas(*(jnp.asarray(a, jd)
                                          for a in (q, k, v)), causal,
                                        bq=16, interpret=True)
    got = fa.attention_plain(*(torch.from_numpy(a).to(td)
                               for a in (q, k, v)), causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", [(8, 64), (16, 3072), (37, 304)])
def test_rms_norm_plain_agrees_with_the_pallas_kernel(dtype, m, d):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w = rng.standard_normal((d,)).astype(np.float32)
    jd, td = JT[dtype]
    bm = 8 if m % 8 == 0 else m
    want = rms_norm_pallas(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-6,
                           bm=bm, interpret=True)
    got = rn.rms_norm_plain(torch.from_numpy(x).to(td),
                            torch.from_numpy(w).to(td), 1e-6)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", [(3, 16400), (2, 24576)])
def test_rms_norm_long_rows_agree_with_the_pallas_kernel(dtype, m, d):
    """Rows past the vector rows' limit, which the cluster rows take on
    the card: the plain version and the dispatching wrapper (CPU
    tensors) against the Pallas kernel in interpret mode, at
    tests/test_torch_kernels.py's tolerances."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w = rng.standard_normal((d,)).astype(np.float32)
    jd, td = JT[dtype]
    want = np.asarray(rms_norm_pallas(jnp.asarray(x, jd), jnp.asarray(w, jd),
                                      1e-6, bm=m, interpret=True)
                      .astype(jnp.float32))
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    tx, tw = torch.from_numpy(x).to(td), torch.from_numpy(w).to(td)
    p = tc.lookup_or_tune("rms_norm", spec="h100", db=tc.TuningDatabase(),
                          m=m, d=d, dtype=dtype)
    assert rn.RMS_TILES[p["tile"]][2] == rn.CLUSTER
    for got in (rn.rms_norm_plain(tx, tw, 1e-6), rn.rms_norm(tx, tw, 1e-6)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
