"""B2 (rms_norm) and B3 (flash attention) on the H100, on the CPU: the
tile tables, their analysis and the kernels' arithmetic.

* The Python tables mirror the C X-macros of ``csrc/attention.cu`` and
  ``csrc/rms_norm.cu``, family fields included.
* Every row is priced finite exactly where its kernel launches: the
  tensor-core flash rows take bfloat16 with d a multiple of 16 up to
  256, the vector rms rows whole 16-byte vectors, at most THREADS x
  VMAX of them.
* Under the H100 the new families are picked at the serving instances;
  the old rows' predicted times are bitwise those of the parent tree
  (captured there, as ``float.hex``) and of a model that prices
  ``mxu_flops`` at the FP32 rate.
* The hi + lo bf16 split of P keeps 2^-16 relative error, and a numpy
  model of the tensor-core kernel's tiling (16-row warps, KV tiles, the
  causal skip, online softmax, P split into hi + lo) computes the
  Pallas kernel's function.
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
    rows = simt + mma
    assert [r[0] for r in rows] == list(range(len(fa.FLASH_TILES)))
    want = [(bq, bkv, nt, fa.SIMT) for _, bq, bkv, nt in simt] + \
        [(bq, bkv, 32 * w, fa.MMA) for _, bq, bkv, w, _ in mma]
    assert list(fa.FLASH_TILES.values()) == want
    assert all(bq * ds == 16 * w for _, bq, _, w, ds in mma)
    assert [f[3] for f in fa.FLASH_TILES.values()] == sorted(
        f[3] for f in fa.FLASH_TILES.values())
    src = (_cuda.CSRC / "attention.cu").read_text()
    assert f"MMA_DMAX = {fa.MMA_DMAX};" in src
    assert "FLASH_SIMT = 0, FLASH_MMA = 1" in src and (fa.SIMT, fa.MMA) \
        == (0, 1)

    warp = _macro_rows("rms_norm.cu", "RMS_TILES")
    vec = _macro_rows("rms_norm.cu", "RMS_VEC_TILES")
    assert [r[0] for r in warp + vec] == list(range(len(rn.RMS_TILES)))
    want = [(r, 32 * r, rn.SIMT, 0) for _, r in warp] + \
        [(1, nt, rn.VEC, rn.VMAX) for _, nt in vec]
    assert list(rn.RMS_TILES.values()) == want
    src = (_cuda.CSRC / "rms_norm.cu").read_text()
    assert f"RMS_VMAX = {rn.VMAX};" in src
    assert "RMS_SIMT = 0, RMS_VEC = 1" in src and (rn.SIMT, rn.VEC) == (0, 1)


def test_wrappers_take_the_tile_index_from_a_dict_and_count_families():
    assert rn._TILE_INDEX == {t: i for i, t in enumerate(rn.RMS_TILES)}
    assert fa._TILE_INDEX["repro_flash"] == {
        t: i for i, t in enumerate(fa.FLASH_TILES)}
    counts = kernels.launch_counts()
    for name in ("rms_norm", "rms_simt", "rms_vec", "flash", "blocked",
                 "flash_simt", "flash_mma"):
        assert name in counts, name


ATTN_SHAPES = [(64, 256), (64, 128), (64, 64), (80, 32), (64, 72),
               (64, 272), (64, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", ATTN_SHAPES)
def test_every_flash_row_is_priced_finite_exactly_where_it_launches(
        dtype, causal, s, d):
    sig = dict(b=2, h=3, sq=s, skv=s, d=d, causal=causal, dtype=dtype)
    pts, t = _times("flash_attention", sig)
    for p, v in zip(pts, t):
        if p["variant"] != "flash":
            continue
        mma = fa.FLASH_TILES[p["tile"]][3] == fa.MMA
        takes = not mma or (dtype == "bfloat16" and d % 16 == 0
                            and d <= 256)
        assert takes == (not mma or fa.mma_takes(dtype, d))
        # the SIMT rows' shared memory grows with d: past d = 256 in f32
        # some of them do not fit; the MMA rows' always fits
        if takes and (mma or d <= 128):
            assert np.isfinite(v), (p, v)
        if not takes:
            assert np.isinf(v), (p, v)


RMS_SHAPES = [(4, 3072), (256, 3072), (37, 300), (4, 4096), (1, 64),
              (3, 4100), (2, 16384), (2, 32768), (5, 2052)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d", RMS_SHAPES)
def test_every_rms_row_is_priced_finite_exactly_where_it_launches(dtype, m,
                                                                  d):
    pts, t = _times("rms_norm", dict(m=m, d=d, dtype=dtype))
    v_elems = 16 // (4 if dtype == "float32" else 2)
    for p, v in zip(pts, t):
        _, threads, family, vmax = rn.RMS_TILES[p["tile"]]
        takes = family == rn.SIMT or (d % v_elems == 0
                                      and d <= threads * vmax * v_elems)
        assert bool(rn.vec_takes(dtype, d, threads)) == (
            d % v_elems == 0 and d <= threads * rn.VMAX * v_elems)
        assert np.isfinite(v) == takes, (p, v)


def test_h100_picks_the_new_families_at_the_serve_instances():
    def pick(kid, **sig):
        return tc.lookup_or_tune(kid, spec="h100", db=tc.TuningDatabase(),
                                 **sig)
    p = pick("flash_attention", **FLASH_SERVE)
    assert p["variant"] == "flash"
    assert fa.FLASH_TILES[p["tile"]][3] == fa.MMA
    for m in (4, 256):
        p = pick("rms_norm", m=m, d=3072, dtype="bfloat16")
        assert rn.RMS_TILES[p["tile"]][2] == rn.VEC, (m, p)
    # float32 never reaches a tensor-core row; ragged rows stay on warps
    p = pick("flash_attention", **dict(FLASH_SERVE, dtype="float32"))
    assert fa.FLASH_TILES[p["tile"]][3] == fa.SIMT
    p = pick("rms_norm", m=37, d=300, dtype="bfloat16")
    assert rn.RMS_TILES[p["tile"]][2] == rn.SIMT


def test_new_rows_state_their_work_on_the_right_units():
    """Tensor-core rows carry QK^T (in each of a group's DS warps) and
    the two P.V MMAs as tc_flops ((2 DS + 4) d a logit) and a K/V stage
    in flight; vector rows carry the row's bytes in flight; the old rows
    state neither."""
    t = np.array(list(fa.FLASH_TILES.values()), dtype=np.int64)
    c = fa.flash_tiles_cost(t, **FLASH_SERVE)
    mma = t[:, 3] == fa.MMA
    assert (c["tc_flops"][mma] > 0).all() and (c["tc_flops"][~mma] == 0).all()
    assert (c["inflight_bytes"][mma] > 0).all()
    assert (c["inflight_bytes"][~mma] == 0).all()
    ds = t[mma, 2] // (2 * t[mma, 0])             # warps per 16 rows
    assert set(ds) == {1, 2, 4}
    assert (c["warp_tc_flops"][mma] > 0).all()
    assert (c["warp_tc_flops"][~mma] == 0).all()
    # a warp's chain: its QK^T and its 1/DS of P.V, (2 + 4/DS) d a logit
    one = (t[:, 0] == 64) & (t[:, 1] == 64) & mma
    np.testing.assert_array_equal(
        c["warp_tc_flops"][one], (2.0 + 4.0 / ds[one[mma]]) * 16 * 64 * 256)
    ratio = c["tc_flops"][mma] / ((2.0 * ds + 4.0) * FLASH_SERVE["d"])
    assert (ratio % (16 * 32) == 0).all()     # whole (group, tile) pairs
    # causal skip: at sq = skv = 64 the 16-row warps of a 64-row tile
    # see 1, 1, 1, 1 tiles of 64 or 1, 1, 2, 2 tiles of 32
    assert fa._group_tiles(64, 64, 64, 64, True) == (4, 1.0)
    assert fa._group_tiles(64, 32, 64, 64, True) == (6, 2.0)
    assert fa._group_tiles(16, 32, 64, 64, False) == (8, 2.0)
    assert fa._group_tiles(16, 32, 64, 64, True) == (6, 2.0)
    r = np.array(list(rn.RMS_TILES.values()), dtype=np.int64)
    c = rn.rms_tiles_cost(r, m=4, d=3072, dtype="bfloat16")
    vec = r[:, 2] == rn.VEC
    assert (c["inflight_bytes"][vec] == 3072 * 2).all()
    assert (c["inflight_bytes"][~vec] == 0).all()
    assert (c["blocks"][vec] == 4).all()


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


# (kernel, signature, the parent tree's pick, the pick now, {row: the
# parent tree's predicted seconds as float.hex}): the serving instances
# of gemma-smoke and gemma-7b (batch 4 and 1 x 64).  The first twelve
# were pinned before this change beside the other kernels' picks; the
# picks move here by design, the old rows' prices do not.
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
     ('flash', 'q32k32'), ('flash', 'mma_q32k64d4'), {
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
     ('blocked', 'q8'), ('flash', 'mma_q16k64d4'), {
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
     ('flash', 'q32k32'), ('flash', 'q32k32'), {
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
