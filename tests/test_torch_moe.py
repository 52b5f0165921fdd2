"""The port's MoE layer (``models/moe.py``) against the reference's.

* ``moe_layer`` on the same inputs and parameters (numpy seed, crossed
  with `from_numpy_tree`): flat and grouped dispatch, ``pad_to``, a
  shared expert, and capacity drops: the largest error within 1e-5 of
  the output's largest magnitude in float32, 2e-2 in bfloat16 (a few
  bf16 steps: the two frameworks round the experts' activations at
  different places); the auxiliary loss within 1e-6.
* The routing steps are the reference's exactly: ``lax.top_k``'s order
  on ties (the lower index first), `_rank_in_expert`'s positions, and so
  the kept masks where capacity drops rows.
* The layer reads nothing back to the host: it runs on ``meta``
  tensors (graph enumeration), with capacity from shapes only.
* qwen2-moe and moonshot smoke served against the reference
  (``test_torch_families.check_against_reference``: float32 1e-4 and
  identical greedy tokens; bfloat16 5e-2 up to a near tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import Sharder as RefSharder
from repro.models import moe as ref_moe
from repro_torch.distributed.sharding import Sharder
from repro_torch.models import from_numpy_tree, moe
from test_torch_families import check_against_reference, ref_tree

D, F, E, K = 16, 32, 6, 2


def _layers(e=E, n_shared=1, pad_to=0, dtype=torch.float32, seed=0):
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), D, F, e,
                         n_shared=n_shared, pad_to=pad_to)
    return p, from_numpy_tree(ref_tree(p), dtype=dtype, device="cpu")


CASES = {
    "flat": dict(),
    "grouped": dict(dispatch="grouped"),
    "pad_to": dict(pad_to=8),
    "no-shared": dict(n_shared=0),
    "drops": dict(capacity_factor=0.25, s=128),
    "drops-grouped": dict(capacity_factor=0.25, s=128, dispatch="grouped"),
}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_layer_matches_the_reference(case, dtype, tol):
    kw = dict(CASES[case])
    s = kw.pop("s", 24)
    cf = kw.pop("capacity_factor", 1.25)
    pad_to = kw.pop("pad_to", 0)
    ref_p, p = _layers(n_shared=kw.pop("n_shared", 1), pad_to=pad_to,
                       dtype=getattr(torch, dtype))
    x = np.random.default_rng(1).standard_normal((2, s, D)) \
        .astype(np.float32)
    args = dict(n_experts=E, top_k=K, capacity_factor=cf, act="silu_glu",
                pad_to=pad_to, **kw)
    want, want_aux = ref_moe.moe_layer(
        ref_p, jnp.asarray(x, dtype), shd=RefSharder(None), **args)
    got, aux = moe.moe_layer(p, torch.from_numpy(x).to(getattr(torch, dtype)),
                             shd=Sharder(), **args)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, s, D)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_capacity_drops_keep_the_reference_rows():
    """With capacity below demand, the same routed rows are kept: the
    within-expert positions are the reference's, so are the masks."""
    rng = np.random.default_rng(2)
    t = 256
    cap = moe.moe_capacity(t, E, K, 0.25)
    assert cap == ref_moe.moe_capacity(t, E, K, 0.25) == 32
    flat_e = rng.integers(0, E, t * K)
    want = np.asarray(ref_moe._rank_in_expert(jnp.asarray(flat_e), t * K,
                                              E))
    got = moe._rank_in_expert(torch.from_numpy(flat_e), t * K, E).numpy()
    np.testing.assert_array_equal(got, want)
    keep = got < cap
    assert 0 < keep.sum() < t * K          # some rows dropped, some kept
    for c, f in [(1, 1.25), (100, 1.25), (4096, 1.0), (7, 3.0)]:
        assert moe.moe_capacity(c, 60, 4, f) == \
            ref_moe.moe_capacity(c, 60, 4, f)


def test_top_k_breaks_ties_like_lax_top_k():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    for k in (1, 2, 3):
        want_p, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_p, got_i = moe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_the_layer_runs_on_meta_tensors():
    """Graph enumeration traces MoE layers on meta: no value is read."""
    _, p = _layers()
    meta = {k: v for k, v in p.items()}
    from repro_torch.models.params import Param, map_params
    meta = map_params(lambda q: Param(q.value.to("meta"), q.dims), meta)
    x = torch.empty((3, 40, D), device="meta")
    for dispatch in ("flat", "grouped"):
        y, aux = moe.moe_layer(meta, x, n_experts=E, top_k=K,
                               capacity_factor=1.25, act="silu_glu",
                               shd=Sharder(), dispatch=dispatch)
        assert y.device.type == "meta" and y.shape == x.shape
        assert aux.shape == ()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_moe_configs_match_the_reference(arch, dtype, monkeypatch):
    check_against_reference(arch, dtype, monkeypatch)
