"""The port's extraction tier against the reference's, on HLO text.

`repro_torch.core.hlo`, the HLO half of `repro_torch.core.mix` and
`repro_torch.core.pipeline.stream_from_hlo` read text and need no JAX,
so on the same text they must give the reference's numbers bit for bit.
The fixtures are modules `repro`'s JAX compiles on the CPU (a
``fori_loop`` of known bound, nested ``scan``s, dots with contracting
dims, an elementwise fusion, a ``cond``, softmax after a dot) and
hand-written modules: a while loop whose bound is the compare feeding
its ROOT, collectives with ``-start``/``-done`` pairs inside and outside
a loop, and repeated ``op_name`` metadata (a remat signal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

from repro.core import hlo as ref_hlo
from repro.core import mix as ref_mix
from repro.core import pipeline as ref_pipeline
from repro_torch.core import hlo, mix, pipeline


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile()


def _fori(x):
    return jax.lax.fori_loop(0, 9, lambda i, c: jnp.tanh(c) * 1.5, x)


def _nested_scan(x):
    def outer(c, _):
        def inner(d, _):
            return jnp.sin(d) * 1.5, None
        d, _ = jax.lax.scan(inner, c, None, length=3)
        return d, None
    out, _ = jax.lax.scan(outer, x, None, length=5)
    return out.sum()


def _dots(a, b, c):
    return jnp.einsum("bik,bkj->bij", a, b) @ c


def _fusion(x, y):
    return jnp.exp(x * 2.0 + y) - jnp.log1p(jnp.abs(y))


def _cond(p, x):
    return jax.lax.cond(p > 0, lambda v: jnp.tanh(v) @ v,
                        lambda v: v * 2.0, x)


def _softmax(x, w):
    return jax.nn.softmax(jnp.dot(x, w)).sum()


def _scan_matmul(x, w):
    def body(c, _):
        return jnp.tanh(c @ w), None
    out, _ = jax.lax.scan(body, x, None, length=7)
    return out.sum()


f32 = jnp.float32
S = jax.ShapeDtypeStruct
COMPILED = {
    "fori": (_fori, (S((32, 128), f32),)),
    "nested_scan": (_nested_scan, (S((8, 128), f32),)),
    "dots": (_dots, (S((4, 16, 64), f32), S((4, 64, 32), f32),
                     S((32, 48), f32))),
    "fusion": (_fusion, (S((64, 256), f32), S((64, 256), f32))),
    "cond": (_cond, (S((), f32), S((64, 64), f32))),
    "softmax": (_softmax, (S((32, 64), f32), S((64, 128), f32))),
    "scan_matmul": (_scan_matmul, (S((128, 128), f32),
                                   S((128, 128), f32))),
}

_LOOP = """\
HloModule trip_exact

%cond (p.0: (s32[], f32[64])) -> pred[] {
  %p.0 = (s32[], f32[64]) parameter(0)
  %iv = s32[] get-tuple-element(%p.0), index=0
  %limit = s32[] constant(16)
  %junk = s32[] constant(999)
  ROOT %lt = pred[] compare(%iv, %limit), direction=LT
}

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

%body (p.1: (s32[], f32[64])) -> (s32[], f32[64]) {
  %p.1 = (s32[], f32[64]) parameter(0)
  %iv.1 = s32[] get-tuple-element(%p.1), index=0
  %one = s32[] constant(1)
  %next = s32[] add(%iv.1, %one)
  %x = f32[64] get-tuple-element(%p.1), index=1
  %t = f32[64] tanh(%x), metadata={op_name="jit(f)/tanh"}
  %r = f32[64] all-reduce(%t), replica_groups={{0,1,2,3}}, to_apply=%add
  ROOT %tup = (s32[], f32[64]) tuple(%next, %r)
}

ENTRY %main (a: f32[64]) -> f32[64] {
  %a = f32[64] parameter(0)
  %init = s32[] constant(0)
  %tup.0 = (s32[], f32[64]) tuple(%init, %a)
  %w = (s32[], f32[64]) while(%tup.0), condition=%cond, body=%body
  ROOT %out = f32[64] get-tuple-element(%w), index=1
}
"""

_COLLECTIVES = """\
HloModule coll

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

ENTRY %main (x: f32[1024], y: bf16[64,128], w: bf16[128,256]) -> (f32[1024], bf16[256,256]) {
  %x = f32[1024] parameter(0)
  %y = bf16[64,128] parameter(1)
  %w = bf16[128,256] parameter(2)
  %ar = f32[1024] all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add, metadata={op_name="jit(f)/psum"}
  %ags = (bf16[64,128], bf16[256,128]) all-gather-start(%y), replica_groups={{0,1,2,3}}, dimensions={0}
  %agd = bf16[256,128] all-gather-done(%ags)
  %d = bf16[256,256] dot(%agd, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(f)/dot"}
  %d2 = bf16[256,256] dot(%agd, %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}, metadata={op_name="jit(f)/dot"}
  %sum = bf16[256,256] add(%d, %d2)
  %rs = f32[256] reduce-scatter(%ar), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %cp = f32[1024] collective-permute(%ar), source_target_pairs={{0,1},{1,2}}, metadata={op_name="jit(f)/psum"}
  ROOT %t = (f32[1024], bf16[256,256]) tuple(%cp, %sum)
}
"""

HAND = {"loop": _LOOP,
        "loop_le": _LOOP.replace("direction=LT", "direction=LE"),
        "loop_unknown": _LOOP.replace(
            "ROOT %lt = pred[] compare(%iv, %limit), direction=LT",
            "ROOT %lt = pred[] compare(%iv, %iv), direction=LT"),
        "collectives": _COLLECTIVES}


@pytest.fixture(scope="module")
def texts():
    out = dict(HAND)
    for name, (fn, args) in COMPILED.items():
        out[name] = _compile(fn, *args).as_text()
    return out


FIXTURES = list(COMPILED) + list(HAND)


def _fields(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) \
        else obj


@pytest.mark.parametrize("name", FIXTURES)
def test_parse_hlo_structure_matches(texts, name):
    got, want = hlo.parse_hlo(texts[name]), ref_hlo.parse_hlo(texts[name])
    assert got.entry == want.entry
    assert got.multipliers == want.multipliers
    assert got.unknown_loops == want.unknown_loops
    assert got.fusion_internal == want.fusion_internal
    assert list(got.computations) == list(want.computations)
    for cname, comp in want.computations.items():
        mine = got.computations[cname]
        assert mine.symbols == comp.symbols
        assert [(i.name, i.opcode, i.ret_shapes, i.operands, i.callees,
                 i.line) for i in mine.instructions] == \
            [(i.name, i.opcode, i.ret_shapes, i.operands, i.callees, i.line)
             for i in comp.instructions]
        for i in comp.instructions:
            for o in i.operands:
                assert mine.resolved_bytes(o) == comp.resolved_bytes(o)


@pytest.mark.parametrize("name", FIXTURES)
def test_module_mix_every_field_matches(texts, name):
    got = hlo.module_mix(texts[name]).as_dict()
    assert got == ref_hlo.module_mix(texts[name]).as_dict()


@pytest.mark.parametrize("name", FIXTURES)
def test_collective_stats_match(texts, name):
    got = hlo.collective_stats(texts[name])
    want = ref_hlo.collective_stats(texts[name])
    assert got.by_kind_bytes == want.by_kind_bytes
    assert got.by_kind_count == want.by_kind_count
    assert got.total_bytes == want.total_bytes
    assert got.total_count == want.total_count
    assert [_fields(o) for o in got.ops] == [_fields(o) for o in want.ops]


@pytest.mark.parametrize("loop_aware", [True, False])
@pytest.mark.parametrize("name", FIXTURES)
def test_op_census_matches(texts, name, loop_aware):
    assert hlo.op_census(texts[name], loop_aware=loop_aware) == \
        ref_hlo.op_census(texts[name], loop_aware=loop_aware)


@pytest.mark.parametrize("name", FIXTURES)
def test_remat_duplication_matches(texts, name):
    assert hlo.remat_duplication(texts[name]) == \
        ref_hlo.remat_duplication(texts[name])


@pytest.mark.parametrize("name", FIXTURES)
def test_analyze_hlo_matches(texts, name):
    got, want = hlo.analyze_hlo(texts[name]), ref_hlo.analyze_hlo(
        texts[name])
    assert got.census == want.census
    assert got.mix.as_dict() == want.mix.as_dict()
    assert got.remat_dups == want.remat_dups
    assert got.n_instructions == want.n_instructions
    assert got.duplicated_instructions == want.duplicated_instructions
    assert got.collectives.by_kind_bytes == want.collectives.by_kind_bytes


@pytest.mark.parametrize("name", FIXTURES)
def test_mix_from_hlo_text_matches(texts, name):
    assert mix.mix_from_hlo_text(texts[name]).as_dict() == \
        ref_mix.mix_from_hlo_text(texts[name]).as_dict()


@pytest.mark.parametrize("name", list(COMPILED))
def test_mix_from_cost_analysis_matches(name):
    fn, args = COMPILED[name]
    cost = _compile(fn, *args).cost_analysis()
    if isinstance(cost, (list, tuple)):       # older jax: one per device
        cost = cost[0]
    got = mix.mix_from_cost_analysis(dict(cost)).as_dict()
    assert got == ref_mix.mix_from_cost_analysis(dict(cost)).as_dict()
    assert got["mxu_flops"] == float(cost.get("flops", 0.0) or 0.0)


@pytest.mark.parametrize("cost", [None, {}, {"flops": 3.0},
                                  {"bytes accessed": 8.0,
                                   "transcendentals": 2.0}])
def test_mix_from_cost_analysis_edge_dicts(cost):
    assert mix.mix_from_cost_analysis(cost).as_dict() == \
        ref_mix.mix_from_cost_analysis(cost).as_dict()


@pytest.mark.parametrize("name", FIXTURES)
def test_stream_from_hlo_ops_match(texts, name):
    got = pipeline.stream_from_hlo(texts[name])
    want = ref_pipeline.stream_from_hlo(texts[name])
    assert [dataclasses.astuple(o) for o in got.ops] == \
        [dataclasses.astuple(o) for o in want.ops]
    assert (got.iterations, got.concurrency) == (want.iterations,
                                                 want.concurrency)


def test_loop_fixtures_exercise_what_they_name(texts):
    # the hand fixtures reach the trip-count paths they are named for
    assert hlo.module_mix(texts["loop"]).trans_flops == 16 * 64
    assert hlo.module_mix(texts["loop_le"]).trans_flops == 17 * 64
    unknown = hlo.parse_hlo(texts["loop_unknown"])
    assert unknown.unknown_loops == 1
    stats = hlo.collective_stats(texts["loop"])
    assert stats.by_kind_count == {"all-reduce": 16.0}
    coll = hlo.collective_stats(texts["collectives"])
    # the all-gather's -start/-done pair counts once, at its result
    assert coll.by_kind_count["all-gather"] == 1.0
    assert set(coll.by_kind_count) == {"all-reduce", "all-gather",
                                       "reduce-scatter",
                                       "collective-permute"}
    assert hlo.remat_duplication(texts["collectives"]) == {
        "jit(f)/psum": 2, "jit(f)/dot": 2}
