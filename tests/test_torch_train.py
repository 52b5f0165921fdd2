"""The port's training path against the reference's (ROADMAP A8a).

The reference initialises the parameters (``model.init``, f32 masters);
they cross to the port through numpy (`from_numpy_tree`, float32), and
both packages see the same `TokenStream` batches (and, for whisper, the
same bf16 frames from a numpy seed).  Everything runs in float32 on the
CPU.  Tolerances:

* ``lm_loss`` / ``encdec_loss`` of all ten smoke configs: loss, nll and
  aux within 1e-5 relative;
* gradients against ``jax.grad`` (one config per family): each leaf
  within 1e-5 of its own largest entry (plus 1e-7 absolute);
* ``make_train_step``, three steps at microbatches 1 and 2 (AdamW at
  peak lr 1e-3): metrics within 1e-5 relative, every parameter within
  1e-4 absolute — a tenth of one step of the learning rate, so a sign
  that AdamW's normalisation amplifies would show;
* remat ``none`` / ``full`` / ``dots``: the same loss and gradients bit
  for bit (remat recomputes, it does not reorder);
* the state carried over after two reference steps, then one step in
  each package: the train-step tolerances;
* ``logical_spec``, ``recommended_microbatches``, ``batch_shapes``,
  ``abstract_params``, ``model_flops`` and ``supports_shape``: exactly
  the reference's, over every config on the (16, 16) and (2, 16, 16)
  production meshes (a stand-in with ``axis_names`` and ``devices``).

A training step under tuned layers raises in both packages: the
reference's Pallas kernels have no backward, and neither have the
port's CUDA kernels.  On a mesh the step is held to the reference's in
`test_torch_mesh.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.distributed import TrainStepConfig as RefStepConfig
from repro.distributed import make_train_step as ref_make_train_step
from repro.distributed.sharding import Sharder as RefSharder
from repro.distributed.sharding import logical_spec as ref_logical_spec
from repro.distributed import sharding as ref_sharding
from repro.distributed.train import \
    recommended_microbatches as ref_recommended
from repro.models import LM_SHAPES as REF_SHAPES
from repro.models import Param as RefParam
from repro.models import batch_shapes as ref_batch_shapes
from repro.models import build_model as ref_build_model
from repro.models.layers import use_tuned_layers as ref_use_tuned
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_adamw as ref_init_adamw
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.data import DataConfig, TokenStream
from repro_torch.distributed import (TrainStepConfig, make_train_step,
                                     recommended_microbatches)
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import Sharder, logical_spec
from repro_torch.models import (LM_SHAPES, Param, batch_shapes, build_model,
                                from_numpy_tree)
from repro_torch.models.layers import use_tuned_layers
from repro_torch.models.params import tree_leaves, tree_param_count
from repro_torch.optim import AdamWConfig, init_adamw

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
PARAM_ATOL = 1e-4
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
FAMILIES = ["gemma-7b", "qwen2-moe-a2.7b", "mamba2-1.3b", "hymba-1.5b",
            "whisper-tiny"]
BATCH, SEQ = 4, 32


def configs(arch):
    """(reference config, port config): the smoke config in float32."""
    return (dataclasses.replace(ref_get_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke(arch), dtype="float32"))


def ref_tree(tree):
    """A reference tree with (numpy array, dims) Param leaves and numpy
    arrays elsewhere."""
    return jax.tree.map(
        lambda p: (np.asarray(p.value), p.dims)
        if isinstance(p, RefParam) else np.asarray(p), tree,
        is_leaf=lambda x: isinstance(x, RefParam))


def batches(cfg, steps, batch=BATCH, seq=SEQ):
    """(reference batch, port batch) per step: the same TokenStream
    tokens and, for a frames front end, the same bf16 frames."""
    stream = TokenStream(DataConfig(vocab=cfg.vocab, global_batch=batch,
                                    seq_len=seq))
    out = []
    for s in range(steps):
        toks = stream.make_batch(s)["tokens"]
        ref, port = {"tokens": jnp.asarray(toks)}, \
            {"tokens": torch.from_numpy(toks)}
        if cfg.frontend == "frames":
            fr = np.random.default_rng(100 + s).standard_normal(
                (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
            ref["frames"] = jnp.asarray(fr).astype(jnp.bfloat16)
            port["frames"] = torch.from_numpy(fr).to(torch.bfloat16)
        out.append((ref, port))
    return out


def setup(arch):
    """Both models and the same f32 initial parameters."""
    rc, c = configs(arch)
    rm, m = ref_build_model(rc), build_model(c)
    rp = rm.init(jax.random.PRNGKey(0))
    return rm, m, rp, from_numpy_tree(ref_tree(rp), device="cpu")


def assert_params_close(port, ref, atol=PARAM_ATOL):
    leaves = list(tree_leaves(port))
    ref_leaves = jax.tree.leaves(ref)
    assert len(leaves) == len(ref_leaves)
    for (path, leaf), r in zip(leaves, ref_leaves):
        got = leaf.value if isinstance(leaf, Param) else leaf
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(r),
                                   rtol=0, atol=atol, err_msg=str(path))


def assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_forward_matches_the_reference(arch):
    rm, m, rp, p = setup(arch)
    (rb, b), = batches(m.cfg, 1)
    want_loss, want = jax.jit(
        lambda q, x: rm.loss(q, x, RefSharder()))(rp, rb)
    with torch.no_grad():
        loss, got = m.loss(p, b, Sharder())
    assert set(got) == set(want) == {"nll", "aux", "loss"}
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def port_grads(m, p, b):
    leaves = [leaf.value for _, leaf in tree_leaves(p)]
    for v in leaves:
        v.requires_grad_(True)
    loss, _ = m.loss(p, b, Sharder())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for v in leaves:
        v.requires_grad_(False)
    return [torch.zeros_like(v) if g is None else g
            for v, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_match_jax_grad(arch):
    rm, m, rp, p = setup(arch)
    (rb, b), = batches(m.cfg, 1)
    want = jax.jit(jax.grad(
        lambda q, x: rm.loss(q, x, RefSharder())[0]))(rp, rb)
    got = port_grads(m, p, b)
    names = [path for path, _ in tree_leaves(p)]
    ref_leaves = jax.tree.leaves(want)
    assert len(got) == len(ref_leaves)
    for name, g, r in zip(names, got, ref_leaves):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=GRAD_RTOL * scale + GRAD_ATOL,
                                   err_msg=str(name))


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-moe-a2.7b",
                                  "whisper-tiny"])
def test_remat_none_full_dots_agree_bit_for_bit(arch):
    _, c = configs(arch)
    (_, b), = batches(c, 1)
    out = {}
    for remat in ("none", "full", "dots"):
        m = build_model(dataclasses.replace(c, remat=remat))
        p = m.init(seed=0, device="cpu", param_dtype=torch.float32)
        loss, _ = m.loss(p, b, Sharder())
        out[remat] = (loss.detach(), port_grads(m, p, b))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for g, g0 in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, g0), remat


def test_remat_is_skipped_without_grad():
    """Serving (no grad) runs the layers as they are: no checkpoint
    wrapper, so no recompute."""
    from repro_torch.models.transformer import remat
    c = configs("gemma-7b")[1]
    fn = lambda h: h
    assert remat(fn, dataclasses.replace(c, remat="none")) is fn
    with torch.no_grad():
        assert remat(fn, c) is fn
    assert remat(fn, c) is not fn
    with pytest.raises(ValueError, match="remat"):
        remat(fn, dataclasses.replace(c, remat="some"))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-moe-a2.7b"])
def test_three_train_steps_match_the_reference(arch, microbatches):
    rm, m, rp, p = setup(arch)
    ro, o = ref_init_adamw(rp), init_adamw(p)
    ref_step = jax.jit(ref_make_train_step(
        rm, RefAdamWConfig(**OPT),
        step_cfg=RefStepConfig(microbatches=microbatches)))
    step = make_train_step(m, AdamWConfig(**OPT),
                           step_cfg=TrainStepConfig(
                               microbatches=microbatches))
    for rb, b in batches(m.cfg, 3):
        rp, ro, want = ref_step(rp, ro, rb)
        p, o, got = step(p, o, b)
        assert_metrics_close(got, want)
    assert_params_close(p, rp)
    assert_params_close(o["m"], ro["m"])
    assert int(o["count"]) == int(ro["count"]) == 3
    assert o["count"].dtype == torch.int32


def test_microbatched_loss_is_the_last_microbatchs_as_in_the_reference():
    """The reference's metrics dict puts the microbatches' mean first and
    then the last microbatch's metrics, whose "loss" replaces it; the
    port builds the same dict."""
    _, m, _, p = setup("gemma-7b")
    (_, b), = batches(m.cfg, 1)
    step = make_train_step(m, AdamWConfig(**OPT),
                           step_cfg=TrainStepConfig(microbatches=2))
    with torch.no_grad():
        last, _ = m.loss(p, {"tokens": b["tokens"][2:]}, Sharder())
    _, _, got = step(p, init_adamw(p), b)
    assert float(got["loss"]) == pytest.approx(float(last), rel=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        step(p, init_adamw(p), {"tokens": b["tokens"][:3]})


def test_state_carried_over_after_two_reference_steps():
    """Two reference steps, the whole state (params, m, v, count) carried
    over through numpy, then one step in each package."""
    rm, m, rp, _ = setup("hymba-1.5b")
    ro = ref_init_adamw(rp)
    ref_step = jax.jit(ref_make_train_step(rm, RefAdamWConfig(**OPT)))
    data = batches(m.cfg, 3)
    for rb, _ in data[:2]:
        rp, ro, _ = ref_step(rp, ro, rb)
    p = from_numpy_tree(ref_tree(rp), device="cpu")
    o = from_numpy_tree(ref_tree(ro), device="cpu")
    assert o["count"].dtype == torch.int32 and int(o["count"]) == 2
    assert all(leaf.dtype == torch.float32
               for _, leaf in tree_leaves(o["v"]))
    rb, b = data[2]
    rp, ro, want = ref_step(rp, ro, rb)
    p, o, got = make_train_step(m, AdamWConfig(**OPT))(p, o, b)
    assert_metrics_close(got, want)
    assert_params_close(p, rp)
    assert_params_close(o["v"], ro["v"])


def test_a_train_step_under_tuned_layers_raises_in_both_packages():
    rm, m, rp, p = setup("gemma-7b")
    (rb, b), = batches(m.cfg, 1)
    with ref_use_tuned(True), pytest.raises(AssertionError):
        ref_make_train_step(rm, RefAdamWConfig(**OPT))(
            rp, ref_init_adamw(rp), rb)
    step = make_train_step(m, AdamWConfig(**OPT))
    with use_tuned_layers(True):
        with pytest.raises(RuntimeError, match="no backward"):
            make_train_step(m, AdamWConfig(**OPT))
        with pytest.raises(RuntimeError, match="no backward"):
            step(p, init_adamw(p), b)


def test_a_mesh_and_pod_compression_wait_for_a8b():
    # the name predates the mesh slice: a step builds on a mesh (run on
    # one: test_torch_mesh.py), a Sharder binds its rules there, and
    # compress_pod_grads without a mesh leaves the step as it is, as in
    # the reference (compression needs a ``pod`` dim)
    rm, m, rp, p = setup("gemma-7b")
    assert callable(make_train_step(m, AdamWConfig(),
                                    mesh=MeshStandIn((16, 16))))
    shd = Sharder(MeshStandIn((16, 16)))
    assert shd.weight_sharding(("embed", "mlp"), (32, 64)).spec == \
        ("data", "model")
    (rb, b), = batches(m.cfg, 1)
    plain = make_train_step(m, AdamWConfig(**OPT))
    comp = make_train_step(m, AdamWConfig(**OPT),
                           step_cfg=TrainStepConfig(compress_pod_grads=True))
    q = from_numpy_tree(ref_tree(rp), device="cpu")
    _, opt_a, ma = plain(p, init_adamw(p), b)
    _, opt_b, mb = comp(q, init_adamw(q), b)
    assert "ef" not in opt_b
    assert float(ma["loss"]) == float(mb["loss"])
    assert float(ma["grad_norm"]) == float(mb["grad_norm"])


# ---------------------------------------------------------------------------
# arithmetic shared with the reference: sharding specs, microbatch depth,
# shapes and accounting
# ---------------------------------------------------------------------------


class MeshStandIn:
    """What `logical_spec` and `recommended_microbatches` read of a
    mesh: its axis names and its devices' shape."""

    def __init__(self, shape):
        self.axis_names = (("pod", "data", "model") if len(shape) == 3
                           else ("data", "model"))
        self.devices = np.empty(shape)


MESHES = [(16, 16), (2, 16, 16)]


def test_rule_tables_are_the_reference_values():
    for name in ("WEIGHT_RULES", "ACT_RULES", "ACT_RULES_SP", "CACHE_RULES",
                 "CACHE_RULES_SEQSHARD"):
        assert getattr(sharding, name) == getattr(ref_sharding, name), name


def _dims_and_shapes(tree, is_ref):
    if is_ref:
        leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
            x, RefParam))
        return [(p.dims, tuple(p.value.shape), str(p.value.dtype))
                for p in leaves]
    return [(leaf.dims, tuple(leaf.value.shape),
             str(leaf.value.dtype).replace("torch.", ""))
            for _, leaf in tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_specs_and_abstract_params_match(arch):
    ref_model = ref_build_model(ref_get_config(arch))
    model = build_model(get_config(arch))
    want = _dims_and_shapes(ref_model.abstract_params(), True)
    got = _dims_and_shapes(model.abstract_params(), False)
    assert got == want
    assert tree_param_count(model.abstract_params()) == \
        sum(int(np.prod(s)) for _, s, _ in want)
    for shape in MESHES:
        mesh = MeshStandIn(shape)
        for rules in ("WEIGHT_RULES", "ACT_RULES", "CACHE_RULES"):
            for dims, shp, _ in want:
                assert logical_spec(dims, shp, getattr(sharding, rules),
                                    mesh) == tuple(ref_logical_spec(
                                        dims, shp,
                                        getattr(ref_sharding, rules), mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_shapes_and_accounting_match(arch):
    assert ARCHS == REF_ARCHS
    ref_model = ref_build_model(ref_get_config(arch))
    model = build_model(get_config(arch))
    for name, shape in LM_SHAPES.items():
        ref_shape = REF_SHAPES[name]
        for mesh in [None] + [MeshStandIn(s) for s in MESHES]:
            for budget in (4e9, 1e8):
                assert recommended_microbatches(
                    model.cfg, shape, mesh, budget) == ref_recommended(
                        ref_model.cfg, ref_shape, mesh, budget)
        assert model.model_flops(shape) == ref_model.model_flops(ref_shape)
        assert model.supports_shape(shape) == \
            ref_model.supports_shape(ref_shape)
        want = ref_batch_shapes(ref_model.cfg, ref_shape)
        got = batch_shapes(model.cfg, shape)
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())


def test_abstract_cache_is_on_meta():
    model = build_model(get_config("gemma-7b"))
    cache = model.abstract_cache(4, 128)
    assert cache["k"].device.type == "meta"
    assert tuple(cache["k"].shape) == (28, 4, 128, 16, 256)
