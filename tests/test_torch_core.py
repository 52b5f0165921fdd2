"""Parity of the port's numpy layers with the reference's, bit for bit.

`repro_torch.core` (hw, occupancy, predict, search) and the batched
static analysis of the four serving-path kernels must give exactly the
reference's outputs on the same inputs — the cases of
``test_core_faithful.py`` and ``test_batch_analysis.py`` — so the port's
rankings, cache keys and winners under the TPU and Table I targets are
the reference's.  Also pins the H100 target's resolution and its
Eqs. 1-5 numbers.
"""
import dataclasses

import numpy as np
import pytest

import repro.kernels  # noqa: F401  (registers the reference kernels)
import repro_torch.kernels  # noqa: F401
from repro import tuning_cache as ref_tc
from repro.core import hw as ref_hw
from repro.core import occupancy as ref_occ
from repro.core import predict as ref_pred
from repro.core import search as ref_search
from repro.core.target import use_target as ref_use_target
from repro.tuning_cache.keys import fingerprint_spec as ref_fp
from repro.tuning_cache.registry import rank_space as ref_rank
from repro_torch import tuning_cache as tc
from repro_torch.core import hw, occupancy, predict, search
from repro_torch.core.target import use_target
from repro_torch.tuning_cache.keys import fingerprint_spec
from repro_torch.tuning_cache.registry import rank_space

_TPU_NAMES = sorted(ref_hw.TPU_TABLE)
_GPU_NAMES = sorted(ref_hw.GPU_TABLE)
_SPELLINGS = ["TPU v5 lite", "TPU v5", "tpu_v6e", "kepler_k20",
              "Fermi-M2050", "maxwell m40", "v4"]


@pytest.mark.parametrize("name", _TPU_NAMES + _GPU_NAMES + _SPELLINGS)
def test_resolve_target_and_fingerprint_match_reference(name):
    ref = ref_hw.resolve_target(name)
    got = hw.resolve_target(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert fingerprint_spec(got) == ref_fp(ref)


@pytest.mark.parametrize("name", ["h100", "h100-sxm", "H100_SXM", "hopper",
                                  "NVIDIA H100 80GB HBM3"])
def test_h100_names_resolve_to_the_hopper_spec(name):
    spec = hw.resolve_target(name)
    assert spec is hw.H100_SXM
    assert isinstance(spec, hw.HopperSpec)
    assert fingerprint_spec(spec).startswith("h100-sxm@")
    assert fingerprint_spec(spec) not in {
        fingerprint_spec(s) for s in list(hw.TPU_TABLE.values())
        + list(hw.GPU_TABLE.values())}


def test_h100_limits_are_the_published_ones():
    s = hw.H100_SXM
    assert (s.multiprocessors, s.shmem_per_block, s.shmem_per_mp) == \
        (132, 232448, 233472)
    assert (s.regs_per_block, s.regs_per_thread, s.threads_per_mp,
            s.blocks_per_mp, s.threads_per_block) == \
        (65536, 255, 2048, 32, 1024)
    assert s.hbm_bw == 3.35e12 and s.fp32_flops == 67e12
    # 132 SMs x 128 FP32 lanes x 2 FLOPs x boost clock = the datasheet rate
    assert abs(132 * 128 * 2 * s.gpu_clock_mhz * 1e6 / s.fp32_flops
               - 1) < 0.01


@pytest.mark.parametrize("threads,regs,smem,want_blocks", [
    (256, 32, 0, 8),           # warp slots: 64 / 8 warps
    (256, 128, 0, 2),          # registers: 65536 / (128 * 256)
    (128, 32, 100 * 1024, 2),  # shared memory: 228 KB / 100 KB
    (256, 32, 232449, 0),      # over the 227 KB per-block opt-in
    (256, 256, 0, 0),          # over 255 registers per thread
])
def test_h100_occupancy_eqs_1_to_5(threads, regs, smem, want_blocks):
    occ = occupancy.cuda_occupancy(threads, regs, smem, hw.H100_SXM)
    assert occ.active_blocks == want_blocks


_OCC_CASES = [(256, 32, 0), (1024, 255, 0), (256, 300, 0), (64, 16, 49152),
              (128, 63, 16384), (32, 0, 0), (0, 0, 0), (512, 64, 4096)]


@pytest.mark.parametrize("gpu", _GPU_NAMES[:3])
@pytest.mark.parametrize("t,r,s", _OCC_CASES)
def test_cuda_occupancy_matches_reference(gpu, t, r, s):
    ref = ref_occ.cuda_occupancy(t, r, s, ref_hw.resolve_target(gpu))
    got = occupancy.cuda_occupancy(t, r, s, hw.resolve_target(gpu))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("gpu", ["m2050", "k20", "m40"])
def test_cuda_occupancy_batch_and_suggestions_match_reference(gpu):
    rg, pg = ref_hw.resolve_target(gpu), hw.resolve_target(gpu)
    t = np.arange(32, 1025, 32)
    for r, s in [(16, 0), (63, 1024), (200, 49152), (32, 8192)]:
        ref = ref_occ.cuda_occupancy_batch(t, r, s, rg)
        got = occupancy.cuda_occupancy_batch(t, r, s, pg)
        for f in dataclasses.fields(ref):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(ref, f.name))
        assert occupancy.suggest_cuda_params(r, s, pg) == \
            ref_occ.suggest_cuda_params(r, s, rg)


@pytest.mark.parametrize("tpu", ["tpu-v5e", "tpu-v4", "tpu-v5p", "tpu-v6e"])
def test_tpu_occupancy_and_block_suggestions_match_reference(tpu):
    rs, ps = ref_hw.resolve_target(tpu), hw.resolve_target(tpu)
    args = ([128 * 256 * 2, 256 * 128 * 2], [128 * 128 * 4], 2.0 * 128 ** 3)
    kw = dict(grid_steps=64, scratch_bytes=65536,
              block_shapes=[(128, 256), (256, 128), (128, 128)])
    asdict = dataclasses.asdict
    assert asdict(ref_occ.tpu_occupancy(*args, spec=rs, **kw)) == \
        asdict(occupancy.tpu_occupancy(*args, spec=ps, **kw))
    ref = ref_occ.suggest_block_shapes(1024, 512, 2048, spec=rs)
    got = occupancy.suggest_block_shapes(1024, 512, 2048, spec=ps)
    assert [(c, asdict(o)) for c, o in got] == \
        [(c, asdict(o)) for c, o in ref]


@pytest.mark.parametrize("target", ["tpu-v5e", "tpu-v5p", "k20", "m40"])
def test_cost_models_match_reference(target):
    rs, ps = ref_hw.resolve_target(target), hw.resolve_target(target)
    if isinstance(ps, hw.GpuSpec):
        ref, got = ref_pred.default_cuda_model(rs), \
            predict.default_cuda_model(ps)
    else:
        ref, got = ref_pred.default_tpu_model(rs, mode="max"), \
            predict.default_tpu_model(ps, mode="max")
    assert got.coeffs == ref.coeffs and got.mode == ref.mode
    assert got.fingerprint() == ref.fingerprint()
    F = np.random.default_rng(0).uniform(0, 1e9, size=(50, 7))
    np.testing.assert_array_equal(got.time_batch(F=F), ref.time_batch(F=F))
    pipe = np.random.default_rng(1).uniform(0, 1e-3, 50)
    feas = np.random.default_rng(2).uniform(size=50) > 0.2
    np.testing.assert_array_equal(
        predict.static_times_batch(None, got, F=F, pipe=pipe, feasible=feas),
        ref_pred.static_times_batch(None, ref, F=F, pipe=pipe,
                                    feasible=feas))


def test_eq6_and_rank_metrics_match_reference():
    for gpu in ("m2050", "k20", "m40"):
        assert predict.cuda_eq6_time(192.0, 32.0, 5.0, 7.0,
                                     hw.resolve_target(gpu)) == \
            ref_pred.cuda_eq6_time(192.0, 32.0, 5.0, 7.0,
                                   ref_hw.resolve_target(gpu))
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=40), rng.normal(size=40)
    assert predict.spearman(a, b) == ref_pred.spearman(a, b)


def _spaces(mod):
    cons = mod.Constraint(lambda c: (c["a"] * c["b"]) <= 256, name="cap")
    return [mod.SearchSpace({"a": (8, 16, 32, 64), "b": (1, 2, 4, 8, 16)}),
            mod.SearchSpace({"a": (8, 16, 32, 64), "b": (1, 2, 4, 8, 16)},
                            constraints=(cons,)),
            mod.SearchSpace({"v": ("x", "y"), "a": (1, 2, 3)})]


@pytest.mark.parametrize("i", range(3))
def test_search_space_enumeration_matches_reference(i):
    ref, got = _spaces(ref_search)[i], _spaces(search)[i]
    assert got.enumerate() == ref.enumerate()
    for chunk in (1, 3, 7, 1000):
        for lr, lg in zip(ref.iter_lattice(chunk), got.iter_lattice(chunk)):
            np.testing.assert_array_equal(lg.indices, lr.indices)
            np.testing.assert_array_equal(lg.offsets, lr.offsets)
    lat, rlat = got.enumerate_lattice(), ref.enumerate_lattice()
    assert [lat.params_at(i) for i in range(lat.size)] == \
        [rlat.params_at(i) for i in range(rlat.size)]


# test_batch_analysis.py's cases, restricted to the four kernels the port
# serves through
CASES = [
    ("matmul", dict(m=512, n=256, k=1024, dtype="float32")),
    ("matmul", dict(m=512, n=512, k=512, dtype="bfloat16")),
    ("flash_attention", dict(b=2, h=4, sq=1024, skv=1024, d=128,
                             causal=True, dtype="float32")),
    ("flash_attention", dict(b=1, h=8, sq=2048, skv=512, d=128,
                             causal=False, dtype="bfloat16")),
    ("rms_norm", dict(m=4096, d=2048, dtype="bfloat16")),
    ("mlp_matmul", dict(m=512, d=1024, f=4096, act="silu",
                        dtype="float32")),
    ("mlp_matmul", dict(m=256, d=512, f=2048, act="gelu",
                        dtype="bfloat16")),
]
_IDS = [f"{k}-{'-'.join(str(v) for v in s.values())}" for k, s in CASES]


@pytest.mark.parametrize("target", ["tpu-v5e", "tpu-v6e", "kepler_k20"])
@pytest.mark.parametrize("kernel_id,sig", CASES, ids=_IDS)
def test_batch_analysis_and_rank_match_reference(kernel_id, sig, target):
    with ref_use_target(target):
        ref = ref_tc.get_problem(kernel_id, **sig)
        ref_lat = ref.space.enumerate_lattice()
        ref_b = ref.static_info_batch(ref_lat.columns)
    with use_target(target):
        got = tc.get_problem(kernel_id, **sig)
        lat = got.space.enumerate_lattice()
        b = got.static_info_batch(lat.columns)
    assert got.space.enumerate() == ref.space.enumerate()
    np.testing.assert_array_equal(b.F, ref_b.F)
    np.testing.assert_array_equal(b.pipe, ref_b.pipe)
    np.testing.assert_array_equal(b.feasible, ref_b.feasible)
    rs, ps = ref_hw.resolve_target(target), hw.resolve_target(target)
    if isinstance(ps, hw.GpuSpec):
        rm, pm = ref_pred.default_cuda_model(rs), \
            predict.default_cuda_model(ps)
    else:
        rm, pm = ref_pred.default_tpu_model(rs, mode="max"), \
            predict.default_tpu_model(ps, mode="max")
    assert rank_space(got, pm) == ref_rank(ref, rm)
