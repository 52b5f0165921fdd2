"""The port's SSD block (``models/ssd.py``) and the hybrid family against
the reference's.

* `_ssd_chunked` on the same inputs: outputs and the state after every
  chunk, with and without zero-``dt`` tail padding, within 1e-4
  (float32: the port carries chunk states left to right where the
  reference runs an associative scan — the same products, associated
  differently).
* ``ssd_block(return_state=True)``: the output and the decode handoff
  (SSM state, conv tail — also for a prompt as short as the tail), and
  ``ssd_decode`` from that state, within 1e-4.
* The port's own prefill-then-decode against its forward (the
  reference's tolerance for the chunked scan against the recurrence,
  5e-3 in float32).
* hymba smoke with a prompt longer than its ``decode_cache_cap`` (64):
  the ring fill (the last 64 positions rolled by ``s % 64``) equals the
  reference's cache, and decode from it gives the reference's logits
  (float32, 1e-4).
* mamba2 and hymba smoke served against the reference
  (``test_torch_families.check_against_reference``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.distributed.sharding import Sharder as RefSharder
from repro.models import build_model as ref_build_model
from repro.models import ssd as ref_ssd
from repro_torch.configs import get_smoke
from repro_torch.distributed.sharding import Sharder
from repro_torch.models import build_model, from_numpy_tree, ssd
from test_torch_families import check_against_reference, ref_tree

TOL = dict(rtol=1e-4, atol=1e-4)


def _block(chunk: int, seed: int = 2):
    cfg = ref_ssd.SsdConfig(d_model=16, ssm_state=8, expand=2, head_dim=8,
                            chunk=chunk)
    p = ref_ssd.init_ssd(jax.random.PRNGKey(seed), cfg)
    port_cfg = ssd.SsdConfig(**dataclasses.asdict(cfg))
    return cfg, p, port_cfg, from_numpy_tree(ref_tree(p), device="cpu")


def _x(t: int, seed: int = 3):
    return (np.random.default_rng(seed).standard_normal((2, t, 16)) * 0.5
            ).astype(np.float32)


# (t, chunk): whole chunks, a padded tail, one short chunk, five chunks
# with a padded tail
@pytest.mark.parametrize("t,chunk", [(16, 4), (20, 8), (7, 16), (37, 8)])
def test_ssd_chunked_matches_the_reference(t, chunk):
    cfg, ref_p, port_cfg, p = _block(chunk)
    x = _x(t)
    z, xbc, dt = ref_ssd._split_in(ref_p, jnp.asarray(x), cfg)
    xbc = ref_ssd._causal_conv(xbc, ref_p["conv_w"].value,
                               ref_p["conv_b"].value, cfg.ssm_conv)
    di, n = cfg.d_inner, cfg.ssm_state
    xh = xbc[..., :di].reshape(2, t, cfg.n_heads, cfg.head_dim)
    a = -jnp.exp(ref_p["a_log"].value)
    dtp = jax.nn.softplus(dt + ref_p["dt_bias"].value)
    args = (xh, dtp, a, xbc[..., di:di + n], xbc[..., di + n:])
    want, (want_a, want_s) = ref_ssd._ssd_chunked(*args, cfg)
    got, (got_a, got_s) = ssd._ssd_chunked(
        *(torch.from_numpy(np.array(v)) for v in args), port_cfg)
    assert got.shape == (2, t, cfg.n_heads, cfg.head_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


@pytest.mark.parametrize("t", [17, 3])
def test_ssd_block_state_and_decode_match_the_reference(t):
    cfg, ref_p, port_cfg, p = _block(8)
    x = _x(t + 1)
    want, want_st = ref_ssd.ssd_block(ref_p, jnp.asarray(x[:, :t]), cfg,
                                      RefSharder(None), return_state=True)
    got, st = ssd.ssd_block(p, torch.from_numpy(x[:, :t]), port_cfg,
                            Sharder(), return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert st["conv"].shape == (2, cfg.ssm_conv - 1, cfg.conv_dim)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(want_st[k]),
                                   **TOL)
    want_y, want_next = ref_ssd.ssd_decode(ref_p, jnp.asarray(x[:, t:]),
                                           want_st, cfg, RefSharder(None))
    got_y, nxt = ssd.ssd_decode(p, torch.from_numpy(x[:, t:]), st,
                                port_cfg, Sharder())
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(nxt[k].numpy(), np.asarray(want_next[k]),
                                   **TOL)


def test_ssd_prefill_then_decode_matches_the_forward():
    _, _, cfg, p = _block(8, seed=3)
    x = torch.from_numpy(_x(17, seed=3))
    full = ssd.ssd_block(p, x, cfg, Sharder())
    _, state = ssd.ssd_block(p, x[:, :16], cfg, Sharder(),
                             return_state=True)
    y, _ = ssd.ssd_decode(p, x[:, 16:17], state, cfg, Sharder())
    np.testing.assert_allclose(y.numpy(), full[:, 16:17].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_hybrid_ring_cache_decode_matches_the_reference():
    """A prompt past hymba-smoke's 64-slot cap: the ring holds the last
    64 positions rolled by s % 64; four decode steps from it wrap the
    ring and keep the reference's logits."""
    ref_cfg = dataclasses.replace(ref_get_smoke("hymba-1.5b"),
                                  dtype="float32")
    cfg = dataclasses.replace(get_smoke("hymba-1.5b"), dtype="float32")
    assert cfg.decode_cache_cap == 64
    s = 80
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = from_numpy_tree(ref_tree(ref_params), device="cpu")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (2, s + 4))
    shd, ref_shd = Sharder(), RefSharder(None)
    want, ref_cache = jax.jit(lambda p, t: ref_model.prefill(
        p, {"tokens": t}, ref_shd))(ref_params, jnp.asarray(prompt[:, :s]))
    with torch.inference_mode():
        got, cache = model.prefill(params, {"tokens": torch.from_numpy(
            prompt[:, :s])}, shd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["k"].shape[2] == 64 and cache["pos"] == s
    for k in ("k", "v", "ssm", "conv"):
        np.testing.assert_allclose(cache[k].numpy(),
                                   np.asarray(ref_cache[k]), **TOL)
    step = jax.jit(lambda p, c, t: ref_model.decode_step(p, c, t, ref_shd))
    for i in range(s, s + 4):
        want, ref_cache = step(ref_params, ref_cache,
                               jnp.asarray(prompt[:, i:i + 1]))
        with torch.inference_mode():
            got, cache = model.decode_step(
                params, cache, torch.from_numpy(prompt[:, i:i + 1]), shd)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(),
                               np.asarray(ref_cache["k"]), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_and_hybrid_configs_match_the_reference(arch, dtype):
    check_against_reference(arch, dtype)
