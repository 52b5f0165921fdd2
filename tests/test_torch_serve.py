"""The port's serving path against the reference's, on gemma-smoke.

The reference initializes the parameters (``model.init``); they cross
to the port through numpy (`from_numpy_tree`).  With tuned layers on
both sides — the reference running its Pallas kernels in interpret
mode, the port its kernels' plain versions on the CPU — prefill logits
agree within tolerance and greedy tokens over 8 decode steps are
identical; the graph pretune enumerates the reference's 7 instances
with its winners; the port's serve entry point passes its frozen-
dispatch gate.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401
from repro import tuning_cache as ref_tc
from repro.configs import get_smoke as ref_get_smoke
from repro.core.autotuner import GraphTuner as RefGraphTuner
from repro.distributed import make_serve_fns as ref_make_serve_fns
from repro.models import Param as RefParam
from repro.models import build_model as ref_build_model
from repro.models.layers import use_tuned_layers as ref_use_tuned
from repro_torch import tuning_cache as tc
from repro_torch.configs import get_smoke
from repro_torch.core.autotuner import GraphTuner
from repro_torch.core.target import use_target
from repro_torch.distributed import make_serve_fns
from repro_torch.models import build_model, from_numpy_tree
from repro_torch.models.layers import use_tuned_layers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = 8


def _reference_run(cfg, tokens):
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prefill, decode = ref_make_serve_fns(model)
    with ref_use_tuned():
        logits, cache = jax.jit(prefill)(params, {"tokens": tokens})
        first = np.asarray(logits, np.float32)
        step = jax.jit(decode)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out = [tok]
        for _ in range(GEN):
            logits, cache = step(params, cache, tok)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            out.append(tok)
    toks = np.concatenate([np.asarray(t) for t in out], axis=1)
    tree = jax.tree.map(lambda p: (np.asarray(p.value), p.dims), params,
                        is_leaf=lambda x: isinstance(x, RefParam))
    return tree, first, toks


def _port_run(cfg, tree, tokens):
    model = build_model(cfg)
    params = from_numpy_tree(tree, dtype=getattr(torch, cfg.dtype),
                             device="cpu")
    prefill, decode = make_serve_fns(model)
    with torch.inference_mode(), use_tuned_layers():
        logits, cache = prefill(params, {"tokens": tokens})
        first = logits.float().numpy()
        tok = logits[:, -1:].argmax(-1)
        out = [tok]
        for _ in range(GEN):
            logits, cache = decode(params, cache, tok)
            tok = logits[:, -1:].argmax(-1)
            out.append(tok)
    return first, torch.cat(out, 1).numpy()


# (dtype, logits tolerance): float32 agrees to float associativity; in
# bfloat16 the two frameworks round activations at different places
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_prefill_logits_and_greedy_tokens_match_reference(dtype, tol):
    ref_cfg = dataclasses.replace(ref_get_smoke("gemma-7b"), dtype=dtype)
    cfg = dataclasses.replace(get_smoke("gemma-7b"), dtype=dtype)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    tree, ref_logits, ref_toks = _reference_run(
        ref_cfg, jnp.asarray(prompt, jnp.int32))
    logits, toks = _port_run(cfg, tree, torch.from_numpy(prompt))
    assert logits.shape == ref_logits.shape == (2, 16, cfg.vocab)
    np.testing.assert_allclose(logits, ref_logits, rtol=tol, atol=tol)
    np.testing.assert_array_equal(toks, ref_toks)


def test_from_numpy_tree_keeps_layouts_and_gains_in_f32():
    cfg = ref_get_smoke("gemma-7b")
    params = ref_build_model(cfg).init(jax.random.PRNGKey(1))
    tree = jax.tree.map(lambda p: (np.asarray(p.value), p.dims), params,
                        is_leaf=lambda x: isinstance(x, RefParam))
    got = from_numpy_tree(tree, dtype=torch.bfloat16, device="cpu")
    blk = got["blocks"]
    assert tuple(blk["attn"]["wq"].shape) == (2, 64, 4, 32)
    assert blk["attn"]["wq"].dims == ("layers", "embed", "heads",
                                      "head_dim")
    assert tuple(blk["attn"]["wo"].shape) == (2, 4, 32, 64)
    assert blk["mlp"]["w_gate"].dtype == torch.bfloat16
    assert blk["ln1"].dtype == torch.float32
    assert got["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        blk["mlp"]["w_gate"].value.float().numpy(),
        np.asarray(params["blocks"]["mlp"]["w_gate"].value
                   .astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("batch,prompt_len", [(2, 64), (4, 32)])
def test_graph_pretune_gives_the_reference_instances_and_winners(
        batch, prompt_len):
    ref_rep = RefGraphTuner.tune_config(
        ref_get_smoke("gemma-7b"), batch=batch, prompt_len=prompt_len,
        spec="tpu-v5e", db=ref_tc.TuningDatabase())
    rep = GraphTuner.tune_config(
        get_smoke("gemma-7b"), batch=batch, prompt_len=prompt_len,
        spec="tpu-v5e", db=tc.TuningDatabase())
    assert len(rep["instances"]) == len(ref_rep["instances"]) == 7
    assert rep["instances"] == ref_rep["instances"]
    # the eager port dispatches per layer and step; the reference traces
    # the layer scan once — compare instances, not totals
    assert rep["dispatches"] > ref_rep["dispatches"]


def test_h100_pretune_freezes_every_serve_dispatch():
    """Under the H100 target the whole smoke serving path dispatches
    from the frozen tables with zero runtime tunes (CPU tensors run the
    plain versions; the dispatch path is the card's)."""
    from repro_torch.kernels import api
    cfg = get_smoke("gemma-7b")
    tc.set_default_db(tc.TuningDatabase())
    try:
        with use_target("h100"):
            rep = GraphTuner.tune_config(cfg, batch=2, prompt_len=16)
            assert all("tile" in i["params"] for i in rep["instances"])
            tc.thaw()
            tc.freeze()
            n0 = len(tc.get_default_db())
            model = build_model(cfg)
            params = model.init(seed=0, device="cpu")
            prefill, decode = make_serve_fns(model)
            api.reset_dispatch_stats()
            with torch.inference_mode(), use_tuned_layers():
                _, cache = prefill(params, {"tokens": torch.zeros(
                    (2, 16), dtype=torch.long)})
                decode(params, cache, torch.zeros((2, 1), dtype=torch.long))
            st = api.dispatch_stats()
            assert st["frozen"] == st["total"] == rep["dispatches"]
            assert len(tc.get_default_db()) == n0
    finally:
        tc.reset_default_db()


def test_serve_cli_on_cpu_passes_the_frozen_gate():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma-7b", "--smoke", "--device", "cpu", "--tuned-ops",
         "--pretune", "--assert-frozen", "--gen", "4"],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "--assert-frozen OK" in out.stdout
