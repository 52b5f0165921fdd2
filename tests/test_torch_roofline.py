"""The port's roofline against the reference's, and its H100 terms.

Under every TPU of `TPU_TABLE` the port's `roofline_from_artifacts`
gives the reference's terms bit for bit — from HLO text, from a given
mix, from a ``cost_analysis`` dict — and both refuse a Table I GPU.
Under the H100 (`HopperSpec`) the terms are checked by hand arithmetic:
each class at its own rate, device bytes at the HBM rate, and collective
bytes over NVLink 4's 18 links at 50 GB/s each (the datasheet's 900
GB/s), per card of a module over several cards.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.core import roofline as ref_roofline
from repro.core.mix import InstructionMix as RefMix
from repro_torch.core import roofline
from repro_torch.core.hw import H100_SXM, TPU_TABLE
from repro_torch.core.mix import InstructionMix, mix_from_graph, trace_fn

TPUS = sorted({spec.name for spec in TPU_TABLE.values()})


def _dots(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    out, _ = jax.lax.scan(body, x, None, length=3)
    return jax.nn.softmax(out).sum()


@pytest.fixture(scope="module")
def compiled():
    f32 = jnp.float32
    c = jax.jit(_dots).lower(jax.ShapeDtypeStruct((64, 128), f32),
                             jax.ShapeDtypeStruct((128, 128), f32)).compile()
    cost = c.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return c.as_text(), dict(cost)


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("tpu", TPUS)
def test_tpu_terms_from_hlo_match_the_reference(compiled, tpu, chips):
    text, cost = compiled
    kw = dict(name="dots", cost=cost, hlo_text=text, chips=chips,
              model_flops=6.0e6, note="x")
    got = roofline.roofline_from_artifacts(spec=tpu, **kw)
    want = ref_roofline.roofline_from_artifacts(spec=tpu, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert roofline.format_roofline_row(got) == \
        ref_roofline.format_roofline_row(want)
    assert got.json() == want.json()


@pytest.mark.parametrize("global_", [False, True])
@pytest.mark.parametrize("tpu", TPUS)
def test_tpu_terms_from_cost_match_the_reference(compiled, tpu, global_):
    _, cost = compiled
    kw = dict(name="cost", cost=cost, hlo_text=None, chips=2,
              model_flops=1.0e6, flops_are_global=global_)
    got = roofline.roofline_from_artifacts(spec=tpu, **kw)
    want = ref_roofline.roofline_from_artifacts(spec=tpu, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("tpu", TPUS)
def test_tpu_terms_from_a_mix_match_the_reference(tpu):
    fields = dict(mxu_flops=3e12, vpu_flops=2e10, trans_flops=5e9,
                  hbm_bytes=7e10, mem_ops=1e9)
    got = roofline.roofline_from_artifacts(
        "mix", {}, None, 1, 2e12, spec=tpu, mix=InstructionMix(**fields))
    want = ref_roofline.roofline_from_artifacts(
        "mix", {}, None, 1, 2e12, spec=tpu, mix=RefMix(**fields))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_a_table_one_gpu_is_refused_as_by_the_reference():
    for mod in (roofline, ref_roofline):
        with pytest.raises(TypeError, match="needs a TpuSpec"):
            mod.roofline_from_artifacts("g", {}, None, 1, 1.0,
                                        spec="kepler-k20")


def test_h100_terms_by_hand():
    mix = InstructionMix(mxu_flops=4.0e12, vpu_flops=6.0e10,
                         trans_flops=3.0e9, hbm_bytes=1.7e10)
    r = roofline.roofline_from_artifacts("h100", {}, None, 1, 2.0e12,
                                         spec="h100", mix=mix)
    h = H100_SXM
    t_c = 4.0e12 / 989e12 + 6.0e10 / 67e12 + 3.0e9 / (16 * 132 * 1980e6)
    t_m = 1.7e10 / 3.35e12
    assert (h.bf16_tensor_flops, h.fp32_flops, h.hbm_bw) == (989e12, 67e12,
                                                            3.35e12)
    assert r.t_compute == pytest.approx(t_c, rel=1e-12)
    assert r.t_memory == pytest.approx(t_m, rel=1e-12)
    assert r.t_collective == 0.0 and r.collective_bytes == 0.0
    assert r.dominant == ("compute" if t_c > t_m else "memory")
    assert r.roofline_frac == pytest.approx(2.0e12 / 989e12
                                            / max(t_c, t_m), rel=1e-12)
    assert r.useful_ratio == pytest.approx(2.0e12 / 4.0e12, rel=1e-12)


def test_h100_terms_from_a_cost_dict_and_hlo(compiled):
    text, cost = compiled
    r = roofline.roofline_from_artifacts("c", {"flops": 9.89e11,
                                               "bytes accessed": 3.35e9},
                                         None, 1, 0.0, spec=H100_SXM)
    assert r.t_compute == pytest.approx(1e-3, rel=1e-12)
    assert r.t_memory == pytest.approx(1e-3, rel=1e-12)
    r = roofline.roofline_from_artifacts("t", cost, text, 1, 0.0,
                                         spec=H100_SXM)
    want = ref_roofline.roofline_from_artifacts("t", cost, text, 1, 0.0,
                                                spec="tpu-v5e")
    # the same loop-aware module mix, priced at the H100's rates
    assert r.hlo_flops == want.hlo_flops and r.hlo_bytes == want.hlo_bytes
    assert r.t_memory == pytest.approx(r.hlo_bytes / 3.35e12, rel=1e-12)


def test_h100_takes_the_dict_a_torch_trace_yields():
    import torch
    a, b = torch.zeros(64, 96), torch.zeros(96, 32)
    graph = trace_fn(lambda x, y: torch.tanh(x @ y), a, b)
    cost = graph.cost_analysis()
    assert cost["flops"] == 2 * 64 * 96 * 32 + 0.0
    assert cost["transcendentals"] == 64 * 32
    r = roofline.roofline_from_artifacts("t", cost, None, 1, 0.0,
                                         spec=H100_SXM)
    assert r.t_compute == pytest.approx(cost["flops"] / 989e12, rel=1e-12)
    m = mix_from_graph(graph)
    r2 = roofline.roofline_from_artifacts("t", {}, None, 1, 0.0,
                                          spec=H100_SXM, mix=m)
    assert r2.t_memory == pytest.approx(m.hbm_bytes / 3.35e12, rel=1e-12)


@pytest.mark.parametrize("what", ["chips", "collectives"])
def test_h100_refuses_a_collective_term(compiled, what):
    text = """\
HloModule c

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

ENTRY %main (x: f32[1024]) -> f32[1024] {
  %x = f32[1024] parameter(0)
  ROOT %ar = f32[1024] all-reduce(%x), replica_groups={{0,1}}, to_apply=%add
}
"""
    # the test's name predates the H100's collective term: a module over
    # several cards, or one carrying collective bytes, is now priced
    if what == "chips":
        r = roofline.roofline_from_artifacts(
            "x", {"flops": 4e12, "bytes accessed": 2e9}, None, 2, 8e12,
            spec=H100_SXM)
        assert r.t_collective == 0.0
        assert r.t_compute == 4e12 / 989e12
        assert r.useful_ratio == 8e12 / (4e12 * 2)
        assert r.roofline_frac == pytest.approx(
            (8e12 / 2 / 989e12) / max(r.t_compute, r.t_memory), rel=1e-12)
    else:
        r = roofline.roofline_from_artifacts("x", {}, text, 1, 0.0,
                                             spec=H100_SXM)
        assert r.collective_bytes > 0
        assert r.t_collective == r.collective_bytes / (18 * 50e9)
        assert r.collectives_by_kind == {"all-reduce": r.collective_bytes}
        r4 = roofline.roofline_from_artifacts("x", {}, text, 1, 0.0,
                                              spec=H100_SXM, ici_links=4)
        assert r4.t_collective == r.collective_bytes / (4 * 50e9)
