"""The port's encoder-decoder (``models/encdec.py``, whisper-tiny)
against the reference's.

* ``encode`` (bidirectional attention through the tuned op, so the
  flash kernel's non-causal form) on the same frames and parameters,
  with tuned layers on both sides, within 1e-4 in float32.
* Prefill's caches (self K/V, cross K/V) and one decode step (causal
  self-attention over the cache, cross-attention over the encoder's
  K/V) within 1e-4, with a cache longer than the prompt.
* ``conv_frontend`` ("SAME" padding, stride 1 then 2, tanh GELU) within
  1e-5, at an even and an odd frame count.
* whisper smoke served against the reference
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
from repro.models import Param as RefParam
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_ed
from repro.models.layers import use_tuned_layers as ref_use_tuned
from repro_torch.configs import get_smoke
from repro_torch.distributed.sharding import Sharder
from repro_torch.models import Param, build_model, encdec, from_numpy_tree
from repro_torch.models.layers import use_tuned_layers
from test_torch_families import check_against_reference, inputs, ref_tree

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def whisper():
    ref_cfg = dataclasses.replace(ref_get_smoke("whisper-tiny"),
                                  dtype="float32")
    cfg = dataclasses.replace(get_smoke("whisper-tiny"), dtype="float32")
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    params = from_numpy_tree(ref_tree(ref_params), device="cpu")
    ref_batch, batch = inputs(cfg, prompt_len=12)
    return ref_cfg, ref_params, ref_batch, cfg, params, batch


def test_encode_matches_the_reference(whisper):
    ref_cfg, ref_params, ref_batch, cfg, params, batch = whisper
    with ref_use_tuned():
        want = jax.jit(lambda p, f: ref_ed.encode(
            p, f, ref_cfg, RefSharder(None)))(ref_params, ref_batch["frames"])
    with torch.inference_mode(), use_tuned_layers():
        got = encdec.encode(params, batch["frames"], cfg, Sharder())
    assert got.shape == (2, cfg.enc_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_caches_and_decode_step_match_the_reference(whisper):
    ref_cfg, ref_params, ref_batch, cfg, params, batch = whisper
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    shd, ref_shd = Sharder(), RefSharder(None)
    tok = np.array([[3], [7]])
    with ref_use_tuned():
        want, ref_cache = jax.jit(lambda p, b: ref_model.prefill(
            p, b, ref_shd, max_len=16))(ref_params, ref_batch)
        want_step, ref_cache = jax.jit(lambda p, c, t: ref_model.decode_step(
            p, c, t, ref_shd))(ref_params, ref_cache, jnp.asarray(tok))
    with torch.inference_mode(), use_tuned_layers():
        got, cache = model.prefill(params, batch, shd, max_len=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert cache["k"].shape == (cfg.n_layers, 2, 16, cfg.n_kv, cfg.hd)
        assert cache["ek"].shape == (cfg.n_layers, 2, cfg.enc_seq, cfg.n_kv,
                                     cfg.hd)
        got_step, cache = model.decode_step(params, cache,
                                            torch.from_numpy(tok), shd)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step),
                               **TOL)
    assert cache["pos"] == int(ref_cache["pos"]) == 13
    for k in ("k", "v", "ek", "ev"):
        np.testing.assert_allclose(cache[k].numpy(),
                                   np.asarray(ref_cache[k]), **TOL)


@pytest.mark.parametrize("t", [16, 15])
def test_conv_frontend_matches_the_reference(t):
    rng = np.random.default_rng(6)
    w = {"conv1": rng.standard_normal((3, 8, 12)).astype(np.float32) * 0.3,
         "conv2": rng.standard_normal((3, 12, 12)).astype(np.float32) * 0.3}
    mel = rng.standard_normal((2, t, 8)).astype(np.float32)
    want = ref_ed.conv_frontend(
        {k: RefParam(jnp.asarray(v), (None,) * 3) for k, v in w.items()},
        jnp.asarray(mel))
    got = encdec.conv_frontend(
        {k: Param(torch.from_numpy(v), (None,) * 3) for k, v in w.items()},
        torch.from_numpy(mel))
    assert got.shape == want.shape == (2, (t + 1) // 2, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_matches_the_reference(dtype):
    check_against_reference("whisper-tiny", dtype)
