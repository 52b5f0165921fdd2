"""The port's AdamW (`repro_torch.optim`) against the reference's, on
the same numpy inputs, in float32.

* ``schedule`` over the warmup, the cosine decay and past both: within
  1e-7 relative (one f32 rounding of the cosine);
* ``global_norm`` of a random Param tree: within 1e-6 relative (the
  leaves in the same order, each leaf's sum in its own order);
* one and three ``adamw_update`` steps on a random Param tree, with the
  global-norm clip active and inactive: parameters and moments within
  1e-6 relative + 1e-7 absolute, ``count`` exact, the metrics within
  1e-6 relative.

The plain versions the card's comparison holds the kernels to
(`global_norm_plain`, `adamw_update_plain`, and `update_with_norm`'s
plain route given the reference's own norm) are held to the reference
at the same tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Param as RefParam
from repro.optim import AdamWConfig as RefConfig
from repro.optim import adamw_update as ref_update
from repro.optim import global_norm as ref_global_norm
from repro.optim import init_adamw as ref_init
from repro.optim import schedule as ref_schedule
from repro_torch.models import Param
from repro_torch.models.params import tree_leaves
from repro_torch.optim import (AdamWConfig, adamw_update, global_norm,
                               init_adamw, schedule)
from repro_torch.optim.adamw import (adamw_update_plain, global_norm_plain,
                                     update_with_norm)

CFG = dict(peak_lr=1e-2, warmup_steps=10, decay_steps=100, weight_decay=0.1,
           clip_norm=1.0)
# insertion order differs from the sorted flatten order on purpose
SHAPES = {"w": {"z": (8, 16), "a": (16,)}, "b": (4, 3, 5),
          "emb": (32, 8)}


def random_tree(seed, scale=1.0):
    """(port tree, reference tree) of Params with the same values."""
    rng = np.random.default_rng(seed)

    def make(node, path=()):
        if isinstance(node, dict):
            pairs = {k: make(v, path + (k,)) for k, v in node.items()}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        a = (rng.standard_normal(node) * scale).astype(np.float32)
        dims = tuple(f"d{i}" for i in range(len(node)))
        return (Param(torch.from_numpy(a.copy()), dims),
                RefParam(jnp.asarray(a), dims))
    return make(SHAPES)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 101, 1000])
def test_schedule_matches(step):
    got = schedule(AdamWConfig(**CFG), torch.tensor(step, dtype=torch.int32))
    want = ref_schedule(RefConfig(**CFG), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)


def test_schedule_shape():
    cfg = AdamWConfig(**CFG)
    lr = [float(schedule(cfg, torch.tensor(s))) for s in range(0, 120)]
    assert lr[0] == 0.0 and lr[10] == pytest.approx(1e-2)
    assert all(a < b for a, b in zip(lr[:10], lr[1:11]))      # warmup
    assert all(a >= b for a, b in zip(lr[10:100], lr[11:101]))  # decay
    assert lr[100] == lr[119] == pytest.approx(1e-3)          # floor


@pytest.mark.parametrize("seed", [0, 1])
def test_global_norm_matches(seed):
    port, ref = random_tree(seed)
    np.testing.assert_allclose(float(global_norm(port)),
                               float(ref_global_norm(ref)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_global_norm_plain_matches(seed):
    port, ref = random_tree(seed)
    np.testing.assert_allclose(float(global_norm_plain(port)),
                               float(ref_global_norm(ref)), rtol=1e-6)


def test_flatten_order_is_the_references():
    port, ref = random_tree(0)
    got = [leaf.value.numpy() for _, leaf in tree_leaves(port)]
    want = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _against_reference(update, steps, grad_scale):
    """``steps`` updates by ``update(params, grads, state, cfg,
    ref_metrics)`` and by the reference's, from the same trees."""
    params, ref_params = random_tree(0)
    state, ref_state = init_adamw(params), ref_init(ref_params)
    for s in range(steps):
        grads, ref_grads = random_tree(10 + s, grad_scale)
        ref_params, ref_state, ref_m = ref_update(
            ref_params, ref_grads, ref_state, RefConfig(**CFG))
        params, state, m = update(params, grads, state, AdamWConfig(**CFG),
                                  ref_m)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-6, err_msg=k)
        clipped = float(ref_m["grad_norm"]) > CFG["clip_norm"]
        assert clipped == (grad_scale > 1)
    assert int(state["count"]) == int(ref_state["count"]) == steps
    for got, want in ((params, ref_params), (state["m"], ref_state["m"]),
                      (state["v"], ref_state["v"])):
        for (path, leaf), r in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert leaf.dtype == torch.float32
            np.testing.assert_allclose(leaf.value.numpy(), np.asarray(r),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=str(path))


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["no_clip", "clip"])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches(steps, grad_scale):
    _against_reference(lambda p, g, s, c, _: adamw_update(p, g, s, c),
                       steps, grad_scale)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["no_clip", "clip"])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_plain_matches(steps, grad_scale):
    _against_reference(lambda p, g, s, c, _: adamw_update_plain(p, g, s, c),
                       steps, grad_scale)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["no_clip", "clip"])
def test_the_plain_update_from_the_reference_s_norm_matches(grad_scale):
    """`update_with_norm`'s plain route, handed the reference's norm —
    the form in which the card holds the kernels to it."""
    _against_reference(
        lambda p, g, s, c, ref_m: update_with_norm(
            p, g, s, c, torch.tensor(float(ref_m["grad_norm"])),
            kernels=False),
        3, grad_scale)


def test_the_update_is_in_place():
    params, _ = random_tree(0)
    state = init_adamw(params)
    before = params["emb"].value
    grads, _ = random_tree(1)
    out, state2, _ = adamw_update(params, grads, state, AdamWConfig(**CFG))
    assert out["emb"].value is before and state2 is state
    assert state["m"]["emb"].dims == params["emb"].dims
