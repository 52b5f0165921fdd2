"""The B1 GEMM's H100 tile table and its analysis, on the CPU.

* Every row of `GEMM_TILES` (SIMT, split-K GEMV, TMA + wgmma) is priced
  finite where its kernel takes the shape and infinite where it does
  not: wgmma rows take bfloat16 with K and N multiples of 8 only.
* `lookup_or_tune("matmul", spec="h100")` picks a GEMV row at the
  serving decode shape, a wgmma row at the serving prefill shape, and
  never a wgmma row for float32.
* The tensor-core term (`mxu_flops` priced at the bf16 tensor rate)
  leaves every other kernel's H100 ranking where it was: the picks of
  the serving and Table IV instances are the ones captured before the
  change, and their predicted times are bitwise those of a model that
  still prices ``mxu_flops`` at the FP32 rate.
* The split-K reduction's plain version, fed per-slice products, computes
  the reference Pallas matmul's function (interpret mode).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels  # noqa: F401  (registers every kernel)
from repro.kernels.matmul import matmul_pallas
from repro_torch import tuning_cache as tc
from repro_torch.core import hw
from repro_torch.core.predict import (CostModel, default_hopper_model,
                                      static_times_batch)
from repro_torch.kernels import _cuda, api
from repro_torch.kernels.common import hopper_info_batch
from repro_torch.kernels.matmul import (GEMM_TILES, GEMV, SIMT, WGMMA,
                                        gemm_tiles_cost, splitk_reduce,
                                        splitk_reduce_plain, tile_fields,
                                        wgmma_takes)
from repro_torch.tuning_cache.registry import _model_for

H100 = hw.H100_SXM
DECODE = dict(m=4, n=3072, k=24576, dtype="bfloat16")
PREFILL = dict(m=256, n=3072, k=24576, dtype="bfloat16")


def _times(kernel_id, sig, model=None):
    """(rows, predicted seconds) of a kernel's whole H100 space at
    ``sig``, ranked as dispatch ranks them."""
    spec = api.get_spec(kernel_id)
    pts = spec.hopper_space(**sig).enumerate()
    cols = {k: np.asarray([p[k] for p in pts]) for k in pts[0]}
    info = spec.hopper_info_batch(cols, H100, **sig)
    return pts, static_times_batch(None, model or _model_for(H100), F=info.F,
                                   pipe=info.pipe, feasible=info.feasible)


def test_the_table_is_one_width_and_three_families():
    assert _cuda.TILE_INFO_INTS >= 9
    t = tile_fields(GEMM_TILES, list(GEMM_TILES))
    assert t.shape == (len(GEMM_TILES), 8)
    fam = t[:, 5]
    assert set(fam) == {SIMT, GEMV, WGMMA}
    # the families in table order (the C side's indices run on)
    assert list(fam) == sorted(fam)
    assert (t[fam == SIMT][:, 6:] == 1).all()
    assert (t[fam == WGMMA][:, [0, 2]] == (128, 64)).all()
    assert (t[:, 7] >= 1).all() and (t[fam != SIMT][:, 7] > 1).any()


SHAPES = [(4, 96, 200), (130, 70, 64), (130, 136, 200), (4, 3072, 24576),
          (256, 3072, 24576), (3, 3072, 1003)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_every_row_is_priced_finite_exactly_where_it_launches(dtype, m, n,
                                                              k):
    pts, t = _times("matmul", dict(m=m, n=n, k=k, dtype=dtype))
    for p, v in zip(pts, t):
        fam = GEMM_TILES[p["tile"]][5]
        takes = fam != WGMMA or (dtype == "bfloat16" and k % 8 == 0
                                 and n % 8 == 0)
        assert np.isfinite(v) == takes, (p, v)
        assert takes == (fam != WGMMA or wgmma_takes(dtype, n, k))


def test_split_k_rows_pay_their_partials_and_the_reduce_launch():
    rows = ["gemv_m4s1", "gemv_m4s16", "wgmma_n256s1", "wgmma_n256s5"]
    c = gemm_tiles_cost(tile_fields(GEMM_TILES, rows), out_bytes=2,
                        **DECODE)
    assert list(c["launches"]) == [1, 2, 1, 2]
    part = 2.0 * 4 * 3072 * 4
    assert c["hbm_bytes"][1] - c["hbm_bytes"][0] == pytest.approx(16 * part)
    assert c["hbm_bytes"][3] - c["hbm_bytes"][2] == pytest.approx(5 * part)
    # wgmma rows carry their MMAs at the tensor-core rate, not FP32
    assert (c["tc_flops"][2:] > 0).all() and (c["flops"][2:] == 0).all()
    assert (c["tc_flops"][:2] == 0).all() and (c["flops"][:2] > 0).all()
    assert (c["inflight_bytes"] > 0).all()


def test_h100_picks_gemv_at_decode_and_wgmma_at_prefill():
    def pick(sig):
        return tc.lookup_or_tune("matmul", spec="h100",
                                 db=tc.TuningDatabase(), **sig)["tile"]
    assert GEMM_TILES[pick(DECODE)][5] == GEMV
    assert GEMM_TILES[pick(dict(DECODE, m=1))][5] == GEMV
    assert GEMM_TILES[pick(PREFILL)][5] == WGMMA
    for m in (1, 4, 64, 256):
        for n, k in ((3072, 24576), (64, 256), (512, 512)):
            got = pick(dict(m=m, n=n, k=k, dtype="float32"))
            assert GEMM_TILES[got][5] != WGMMA, (m, n, k, got)


def test_the_split_variant_and_mega_rank_the_same_rows():
    """`mlp_matmul`'s split variant ranks the whole GEMM table with f32
    outputs (wgmma rows included for bf16, excluded for f32), and the
    mega space under the H100 picks what matmul picks."""
    from repro_torch.kernels.megamatmul import mega_matmul_spec
    for dtype in ("bfloat16", "float32"):
        sig = dict(m=4, d=3072, f=24576, act="gelu", dtype=dtype)
        pts, t = _times("mlp_matmul", sig)
        split = {p["tile"]: v for p, v in zip(pts, t)
                 if p["variant"] == "split"}
        assert set(split) == set(GEMM_TILES)
        for tile, v in split.items():
            wg = GEMM_TILES[tile][5] == WGMMA
            assert np.isfinite(v) == (not wg or dtype == "bfloat16")
    spec = mega_matmul_spec(register=True)
    try:
        for sig in (DECODE, PREFILL):
            assert tc.lookup_or_tune("mega_matmul", spec="h100",
                                     db=tc.TuningDatabase(), **sig) == \
                tc.lookup_or_tune("matmul", spec="h100",
                                  db=tc.TuningDatabase(), **sig)
    finally:
        api.unregister("mega_matmul")


# (kernel, signature, variant, tile): the H100 picks of every other
# kernel's Table IV / extension instances, captured before the
# tensor-core term.  The rms_norm and flash_attention serving instances
# moved to tests/test_torch_attn_norm.py, whose tile tables gained
# tensor-core and vector rows that change those picks by design; the
# jacobi3d table gained TMA ring rows, which take 256^3 by design (the
# plane rows' own ranking is tests/test_torch_jacobi.py's), and so did
# the stencil2d table, whose ring rows take every grid here (the march
# rows' picks are tests/test_torch_stencil.py's), and atax's, whose
# ring rows read A once and take its three instances here by design
# (moved to tests/test_torch_atax.py with their new picks).
PICKS_BEFORE = [
    ("matvec", dict(m=8192, n=8192, dtype="float32"), None, "r2w1"),
    ("matvec", dict(m=8192, n=8192, dtype="bfloat16"), None, "r1w1"),
    ("bicg", dict(m=8192, n=8192, dtype="float32"), None, "t512r2"),
    ("bicg", dict(m=8192, n=8192, dtype="bfloat16"), None, "t512r2"),
    ("jacobi3d", dict(z=256, y=256, x=256, dtype="float32"), None,
     "ring_x128y8z32s6"),
    ("stencil2d", dict(y=512, x=512, dtype="float32"), None,
     "ring_x64y16r126s6"),
    ("stencil2d", dict(y=1024, x=1024, dtype="float32"), None,
     "ring_x64y16r126s6"),
    ("stencil2d", dict(y=2048, x=2048, dtype="float32"), None,
     "ring_x128y16r126s6"),
    ("stencil2d", dict(y=1024, x=1024, dtype="bfloat16"), None,
     "ring_x64y16r126s6"),
    ("stencil2d", dict(y=8192, x=8192, dtype="float32"), None,
     "ring_x128y16r126s6"),
    ("stencil2d", dict(y=8192, x=8192, dtype="bfloat16"), None,
     "ring_x128y16r126s6"),
]


def _fp32_mxu_model():
    """The H100 model as it was before the tensor-core term: mxu_flops
    at the FP32 rate."""
    base = default_hopper_model(H100)
    return CostModel(coeffs=dict(base.coeffs,
                                 mxu_flops=1.0 / H100.fp32_flops),
                     mode=base.mode, name=base.name + "-fp32-mxu")


def test_the_tensor_core_rate_prices_mxu_flops():
    model = default_hopper_model(H100)
    assert model.coeffs["mxu_flops"] == 1.0 / H100.bf16_tensor_flops
    assert model.coeffs["vpu_flops"] == 1.0 / H100.fp32_flops


@pytest.mark.parametrize("kernel_id,sig,variant,tile", PICKS_BEFORE,
                         ids=[f"{k}-{'x'.join(str(v) for v in s.values())}"
                              for k, s, _, _ in PICKS_BEFORE])
def test_other_kernels_keep_their_h100_ranking(kernel_id, sig, variant,
                                               tile):
    p = tc.lookup_or_tune(kernel_id, spec="h100", db=tc.TuningDatabase(),
                          **sig)
    assert (p.get("variant"), p["tile"]) == (variant, tile)
    pts, now = _times(kernel_id, sig)
    _, before = _times(kernel_id, sig, _fp32_mxu_model())
    np.testing.assert_array_equal(now, before)


@pytest.mark.parametrize("m", [4, 256])
def test_the_gated_mlps_own_variants_keep_their_prices(m):
    """The SIMT rows of fused and stream carry no tensor-core flops:
    their predicted times are bitwise those of the FP32-priced model.
    (The gated wgmma rows state tensor-core flops by design.)"""
    from repro_torch.kernels.mlp_matmul import GATED_TILES, STREAM_TILES
    table = {"fused": GATED_TILES, "stream": STREAM_TILES}
    sig = dict(m=m, d=3072, f=24576, act="gelu", dtype="bfloat16")
    pts, now = _times("mlp_matmul", sig)
    _, before = _times("mlp_matmul", sig, _fp32_mxu_model())
    own = np.array([p["variant"] != "split"
                    and table[p["variant"]][p["tile"]][5] == SIMT
                    for p in pts])
    assert own.sum() == 11
    np.testing.assert_array_equal(now[own], before[own])


def test_stated_bytes_in_flight_and_the_feasible_mask():
    """Rows that state no bytes in flight are priced as before the
    argument existed; a row that does is priced by Little's law over the
    card; the explicit mask makes a row infinite."""
    base = dict(blocks=[12, 192, 192], threads=256, regs=64, smem=4096,
                flops=1e9, hbm_bytes=151e6, spec=H100)
    plain = hopper_info_batch(**base)
    stated = hopper_info_batch(**base, inflight_bytes=[0.0, 0.0, 65536.0],
                               feasible=[True, False, True])
    assert stated.pipe[0] == plain.pipe[0]
    assert np.isinf(stated.pipe[1]) and not stated.feasible[1]
    bw = 151e6 / H100.hbm_bw + H100.launch_overhead_s
    assert stated.pipe[2] == pytest.approx(bw)
    assert stated.pipe[2] < plain.pipe[2]
    tc_row = hopper_info_batch(**dict(base, flops=0.0), tc_flops=1e12)
    assert tc_row.F[0, 0] == 1e12 and tc_row.F[0, 1] == 0.0


def test_h100_spec_carries_the_loaded_latency_in_bytes():
    assert H100.latency_bytes == 64 * 1024
    assert dataclasses.replace(H100).latency_bytes == H100.latency_bytes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [1, 4, 5])
def test_split_k_reduction_matches_the_pallas_matmul(dtype, split):
    """Per-slice f32 products summed by the reduction's plain version (the
    CPU side of `splitk_reduce`) compute the reference's matmul."""
    m, n, k = 6, 40, 200
    rng = np.random.default_rng(7)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ta, tb = torch.from_numpy(a).to(td), torch.from_numpy(b).to(td)
    kc = -(-k // split)
    ws = torch.stack([ta[:, s:s + kc].float() @ tb[s:s + kc].float()
                      for s in range(0, k, kc)])
    got = splitk_reduce(ws, td)
    assert torch.equal(got, splitk_reduce_plain(ws, td))
    want = matmul_pallas(jnp.asarray(a, jd), jnp.asarray(b, jd), bm=2,
                         bn=8, bk=8, interpret=True)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(
        got.float(), torch.from_numpy(np.array(want.astype(jnp.float32))),
        rtol=tol, atol=tol)


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.matmul import matmul_cuda, splitk_reduce_cuda
    a = torch.zeros((4, 64), dtype=torch.bfloat16)
    b = torch.zeros((64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        matmul_cuda(a, b, tile="wgmma_n128s1")
    with pytest.raises(ValueError):
        splitk_reduce_cuda(torch.zeros((2, 4, 64)), torch.bfloat16)
