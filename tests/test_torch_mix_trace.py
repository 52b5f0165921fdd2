"""`mix_of_fn` on a torch call against the reference's on the same layer.

The reference walks a jaxpr (`repro.core.mix.mix_of_fn`); the port
records the aten ops a call dispatches on ``meta`` tensors
(`repro_torch.core.mix.trace_fn`) and classifies them with the same
categories (`mix_from_graph`).  On one dense block of gemma's smoke
config, fed the same numpy parameters, the matrix flops and the
transcendentals are equal; the other classes agree within the ratios of
`RATIO`, because the two IRs spell the same layer differently:

* ``reg_ops`` (6x): the jaxpr broadcasts every operand explicitly and
  casts at other places; torch broadcasts inside its elementwise ops
  and spells ``einsum`` as views around ``bmm`` (counted once each);
* ``vmem_bytes`` (2.5x): it follows the register and elementwise traffic;
* ``ctrl_ops`` (2x): selects and the unknown primitives' fallback;
* ``hbm_bytes``, ``mem_ops`` (1.25x): concatenation, slices and copies;
* ``vpu_flops`` (1.01x): softmax and the activation composites.

A trace allocates nothing and launches nothing, and a tuned op is one
leaf carrying its kernel's 2*M*N*K matrix flops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401
from repro.configs import get_smoke as ref_get_smoke
from repro.core.mix import mix_of_fn as ref_mix_of_fn
from repro.distributed.sharding import Sharder as RefSharder
from repro.models import Param as RefParam
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro_torch import kernels
from repro_torch import tuning_cache as tc
from repro_torch.configs import get_smoke
from repro_torch.core.hw import H100_SXM
from repro_torch.core.mix import (TorchGraph, mix_from_graph, mix_of_fn,
                                  trace_fn)
from repro_torch.distributed import make_serve_fns
from repro_torch.distributed.sharding import Sharder
from repro_torch.kernels import api, ops
from repro_torch.models import build_model, from_numpy_tree
from repro_torch.models import transformer
from repro_torch.models.layers import use_tuned_layers

RATIO = {"vpu_flops": 1.01, "hbm_bytes": 1.25, "mem_ops": 1.25,
         "vmem_bytes": 2.5, "ctrl_ops": 2.0, "reg_ops": 6.0}


@pytest.fixture(autouse=True)
def fresh_db():
    # leaves rank their picks: keep those records out of the process db
    tc.set_default_db(tc.TuningDatabase())
    yield
    tc.reset_default_db()


def _block_mixes(dtype):
    rcfg = dataclasses.replace(ref_get_smoke("gemma-7b"), dtype=dtype)
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    blk = jax.tree.map(lambda p: RefParam(p.value[0], p.dims[1:]),
                       params["blocks"],
                       is_leaf=lambda x: isinstance(x, RefParam))
    h = np.random.default_rng(0).standard_normal(
        (2, 16, rcfg.d_model)).astype(np.float32)
    want = ref_mix_of_fn(
        lambda b, x: ref_transformer._block_apply(b, x, None, rcfg,
                                                  RefSharder(None),
                                                  False)[0],
        blk, jnp.asarray(h, dtype))
    cfg = dataclasses.replace(get_smoke("gemma-7b"), dtype=dtype)
    tree = jax.tree.map(lambda p: (np.asarray(p.value, np.float32), p.dims),
                        params, is_leaf=lambda x: isinstance(x, RefParam))
    pt = from_numpy_tree(tree, dtype=getattr(torch, dtype), device="cpu")
    got = mix_of_fn(
        lambda b, x: transformer._block_apply(b, x, cfg, Sharder(None))[0],
        transformer._unstack(pt["blocks"], cfg.n_layers)[0],
        torch.from_numpy(h).to(getattr(torch, dtype)))
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_block_mix_matches_the_reference(dtype):
    got, want = _block_mixes(dtype)
    assert got.mxu_flops == want.mxu_flops
    assert got.trans_flops == want.trans_flops
    for field, ratio in RATIO.items():
        a, b = getattr(got, field), getattr(want, field)
        assert b / ratio <= a <= b * ratio, (field, a, b)


def test_a_trace_allocates_and_launches_nothing():
    before = kernels.launch_counts()
    stats = api.dispatch_stats()
    x = torch.ones(4, 1 << 20)
    # a real (1M x 1M) float32 operand would be 4 TB: on meta it is free
    graph = trace_fn(lambda a: (a @ torch.ones(1 << 20, 1 << 20)).sum()
                     + ops.rms_norm(a, torch.ones(1 << 20)).sum(), x)
    names = [o.name for o in graph.ops]
    assert "mm" in names and "rms_norm" in names
    assert kernels.launch_counts() == before
    after = api.dispatch_stats()
    assert after["total"] == stats["total"]
    assert after["collected"] == stats["collected"] + 1
    leaf = next(o for o in graph.ops if o.kernel == "rms_norm")
    # the leaf ran none of its plain version's ops
    assert names.count("rsqrt") == 0 and names.count("mean") == 0
    assert dict(leaf.signature) == dict(m=4, d=1 << 20, dtype="float32")


@pytest.mark.parametrize("m", [256, 64])
def test_a_tuned_op_leaf_carries_its_matrix_flops(m):
    n = k = 3072
    a = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    b = torch.empty(k, n, dtype=torch.bfloat16, device="meta")
    graph = trace_fn(ops.matmul, a, b)
    (leaf,) = [o for o in graph.ops if o.kernel is not None]
    assert leaf.kernel == "matmul"
    mix = mix_from_graph(graph, spec=H100_SXM)
    # the H100 pick for bf16 at these shapes is a TMA + wgmma row: its
    # tensor-core flops are the product's, no tile padding
    assert mix.mxu_flops == 2.0 * m * n * k
    assert mix.hbm_bytes >= 2.0 * (m * k + k * n + m * n)
    assert mix.ctrl_ops >= 1.0          # the launch


def test_a_leaf_needs_the_h100_analysis():
    graph = trace_fn(ops.matmul, torch.empty(8, 8, device="meta"),
                     torch.empty(8, 8, device="meta"))
    with pytest.raises(TypeError, match="H100"):
        mix_from_graph(graph, spec="tpu-v5e")


def test_a_smoke_decode_step_reads_every_weight_once():
    cfg = get_smoke("gemma-7b")
    model = build_model(cfg)
    params = model.init(seed=0, device="meta")
    prefill, decode = make_serve_fns(model)
    tokens = torch.zeros((2, 16), dtype=torch.long, device="meta")
    with use_tuned_layers():
        with api.collect_dispatches():
            _, cache = prefill(params, {"tokens": tokens})
        graph = trace_fn(decode, params, cache,
                         torch.zeros((2, 1), dtype=torch.long,
                                     device="meta"))
    leaves = {o.kernel for o in graph.ops if o.kernel is not None}
    assert leaves == {"rms_norm", "mlp_matmul", "matmul"}
    mix = mix_from_graph(graph)
    weights = sum(p.value.numel() * p.value.element_size()
                  for name, p in _params(params) if name != "embed")
    assert mix.hbm_bytes >= weights
    assert mix.mxu_flops + mix.vpu_flops > 0


def _params(tree, prefix=""):
    from repro_torch.models.params import Param
    for k, v in tree.items():
        if isinstance(v, Param):
            yield prefix + k, v
        else:
            yield from _params(v, prefix + k + ".")


def test_graph_records_are_plain_data():
    graph = trace_fn(lambda x: torch.softmax(x, -1), torch.zeros(3, 5))
    assert isinstance(graph, TorchGraph)
    (op,) = [o for o in graph.ops if o.name == "_softmax"]
    assert op.inputs == (((3, 5), "float32"),)
    assert op.outputs == (((3, 5), "float32"),)
    mix = mix_from_graph(graph)
    assert (mix.trans_flops, mix.vpu_flops) == (15.0, 60.0)
