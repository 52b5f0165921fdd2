"""The port's ten archs against the reference's (ROADMAP A7).

* ``ARCHS`` and every config (published and smoke) are the reference's,
  value for value, and so is every family's parameter layout.
* The four other dense smoke configs (starcoder2-3b/7b: non-gated GELU,
  QKV bias, GQA; qwen1.5-110b: QKV bias, GQA 8:2; chameleon-34b:
  QK-norm) served under tuned layers against the reference's serving
  path — the reference running its Pallas kernels in interpret mode,
  the port its kernels' plain versions on the CPU — with the parameters
  crossing through numpy (`from_numpy_tree`).  The rule, shared with
  ``test_torch_moe``, ``test_torch_ssd`` and ``test_torch_encdec``
  (`check_against_reference`):

  - float32: prefill logits within 1e-4 and the 8 greedy tokens
    identical;
  - bfloat16: the two frameworks round activations at different places,
    so prefill logits agree within the family's bf16 tolerance
    (`BF16_TOL`), and greedy tokens agree up to the first decode step
    whose reference top-2 logit gap is within twice that tolerance (a
    near tie, after which the two greedy paths may part).  In a MoE
    config a prompt position may route differently where the router
    sits on a near tie; each sequence's logits are held up to its first
    position past the tolerance, which must be such a tie.
* ``GraphTuner.tune_config`` under ``tpu-v5e`` gives the reference's
  instances, in order, with its winners, for every smoke config.
* The port's own prefill-then-decode equals its forward, per family
  (the counterpart of the reference's ``test_moe_ssd.py``
  ``test_prefill_decode_matches_forward``), at its tolerances.
* The serve entry point passes its frozen gate for every arch on the
  CPU; under the H100 target every full-width config's attention picks
  are rows the kernels take (no ValueError at launch).
"""
import contextvars
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401
from repro import tuning_cache as ref_tc
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.core.autotuner import GraphTuner as RefGraphTuner
from repro.distributed import make_serve_fns as ref_make_serve_fns
from repro.models import Param as RefParam
from repro.models import build_model as ref_build_model
from repro.models.layers import use_tuned_layers as ref_use_tuned
from repro_torch import tuning_cache as tc
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core.autotuner import GraphTuner
from repro_torch.distributed import make_serve_fns
from repro_torch.distributed.sharding import Sharder
from repro_torch.models import ModelConfig, build_model, from_numpy_tree
from repro_torch.models.layers import use_tuned_layers
from repro_torch.models.transformer import lm_logits

GEN = 8
NEW = [a for a in ARCHS if a != "gemma-7b"]   # gemma: test_torch_serve
DENSE = ["starcoder2-3b", "qwen1.5-110b", "starcoder2-7b", "chameleon-34b"]
F32_TOL = 1e-4
# bf16 logits tolerance by family: the SSD's chunked scan and the
# hybrid's two normed heads round in more places than a dense layer
BF16_TOL = {"dense": 5e-2, "moe": 5e-2, "encdec": 5e-2, "ssm": 1.5e-1,
            "hybrid": 1.5e-1}


def ref_tree(params):
    """The reference's parameter tree as (numpy array, dims) leaves."""
    return jax.tree.map(lambda p: (np.asarray(p.value), p.dims), params,
                        is_leaf=lambda x: isinstance(x, RefParam))


def inputs(cfg, batch: int = 2, prompt_len: int = 16, seed: int = 0):
    """(reference batch, port batch): the same prompt (and, for a frames
    frontend, the same bf16 frame embeddings) from a numpy seed."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len))
    ref = {"tokens": jnp.asarray(prompt, jnp.int32)}
    port = {"tokens": torch.from_numpy(prompt)}
    if cfg.frontend == "frames":
        fr = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model))
        ref["frames"] = jnp.asarray(fr, jnp.bfloat16)
        port["frames"] = torch.from_numpy(fr).to(torch.bfloat16)
    return ref, port


def reference_serve(cfg, batch):
    """The reference's jitted prefill + GEN greedy decode steps under
    tuned layers -> (tree, prefill logits, per-step logits, tokens)."""
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    prefill, decode = ref_make_serve_fns(model)
    with ref_use_tuned():
        logits, cache = jax.jit(prefill)(params, batch)
        first = np.asarray(logits, np.float32)
        step = jax.jit(decode)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out, steps = [tok], []
        for _ in range(GEN):
            logits, cache = step(params, cache, tok)
            steps.append(np.asarray(logits[:, -1], np.float32))
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            out.append(tok)
    toks = np.concatenate([np.asarray(t) for t in out], axis=1)
    return ref_tree(params), first, steps, toks


def port_serve(cfg, tree, batch):
    """The port's prefill + GEN greedy decode steps under tuned layers
    on the CPU -> (prefill logits, per-step logits, tokens)."""
    params = from_numpy_tree(tree, dtype=getattr(torch, cfg.dtype),
                             device="cpu")
    prefill, decode = make_serve_fns(build_model(cfg))
    with torch.inference_mode(), use_tuned_layers():
        logits, cache = prefill(params, batch)
        first = logits.float().numpy()
        tok = logits[:, -1:].argmax(-1)
        out, steps = [tok], []
        for _ in range(GEN):
            logits, cache = decode(params, cache, tok)
            steps.append(logits[:, -1].float().numpy())
            tok = logits[:, -1:].argmax(-1)
            out.append(tok)
    return first, steps, torch.cat(out, 1).numpy()


def record_router_margins(monkeypatch):
    """Record, per call of the port's MoE top-k, each token's router
    margin: the k-th largest probability less the (k+1)-th."""
    from repro_torch.models import moe
    margins = []
    top_k = moe._top_k

    def recording(probs, k):
        vals, idx = top_k(probs, probs.shape[-1])
        margins.append((vals[..., k - 1] - vals[..., k]).float())
        return vals[..., :k], idx[..., :k]

    monkeypatch.setattr(moe, "_top_k", recording)
    return margins


def check_against_reference(arch: str, dtype: str, monkeypatch=None):
    """Serve ``arch``'s smoke config in ``dtype`` in both packages and
    hold the port to the rule of this module's docstring."""
    ref_cfg = dataclasses.replace(ref_get_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke(arch), dtype=dtype)
    ref_batch, batch = inputs(cfg)
    tree, ref_first, ref_steps, ref_toks = reference_serve(ref_cfg,
                                                           ref_batch)
    margins = (record_router_margins(monkeypatch)
               if cfg.family == "moe" and monkeypatch else None)
    first, steps, toks = port_serve(cfg, tree, batch)
    assert first.shape == ref_first.shape == (2, 16, cfg.vocab)
    assert np.isfinite(first).all()
    if dtype == "float32":
        np.testing.assert_allclose(first, ref_first, rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_array_equal(toks, ref_toks)
        return
    tol = BF16_TOL[cfg.family]
    err = np.abs(first - ref_first).max(-1)                 # (B, S)
    if margins is not None:
        # prefill's MoE layers: each position's smallest margin
        n_moe = cfg.n_layers - cfg.first_dense_layers
        margin = torch.stack(margins[:n_moe]).amin(0).numpy()
        for b in range(err.shape[0]):
            bad = np.nonzero(err[b] > tol)[0]
            if bad.size:
                p = bad[0]
                assert margin[b, p] < 2.0 ** -8, (b, p, margin[b, p])
                err[b, p:] = 0.0
    assert err.max() <= tol, err.max()
    for step, (got, want) in enumerate(zip(steps, ref_steps)):
        np.testing.assert_array_equal(toks[:, :step + 1],
                                      ref_toks[:, :step + 1])
        top2 = np.sort(want, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() <= 2 * tol:
            return                      # a near tie: the paths may part
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(toks, ref_toks)


# ---------------------------------------------------------------------------
# the registry of configs
# ---------------------------------------------------------------------------


def test_archs_are_the_reference_ten_in_its_order():
    assert ARCHS == REF_ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_values(arch):
    for port_get, ref_get in ((get_config, ref_get_config),
                              (get_smoke, ref_get_smoke)):
        got, want = port_get(arch), ref_get(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.num_params() == want.num_params()
        assert got.num_active_params() == want.num_active_params()


def _layout(tree, prefix=""):
    """{path: (shape, dims)} of a Param tree (either package's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layout(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (tuple(v.value.shape), v.dims)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_the_reference_layout(arch):
    """Every family's parameter tree, published and smoke: the
    reference's paths, shapes and dims (made on meta: nothing is
    allocated at full width)."""
    for get, ref_get in ((get_config, ref_get_config),
                         (get_smoke, ref_get_smoke)):
        want = _layout(ref_build_model(ref_get(arch)).abstract_params())
        got = _layout(build_model(get(arch)).init(device="meta"))
        assert got == want


def test_stack_dims_prepends_the_stacking_dim():
    from repro.models.params import stack_dims as ref_stack_dims
    from repro_torch.models import Param, stack_dims
    tree = {"w": Param(torch.zeros(3, 4, 5), ("embed", "mlp")),
            "blk": {"g": Param(torch.ones(3, 4), ("embed",))}}
    got = stack_dims(tree)
    want = ref_stack_dims({"w": RefParam(np.zeros((3, 4, 5)),
                                         ("embed", "mlp")),
                           "blk": {"g": RefParam(np.ones((3, 4)),
                                                 ("embed",))}})
    assert got["w"].dims == want["w"].dims == ("layers", "embed", "mlp")
    assert got["blk"]["g"].dims == want["blk"]["g"].dims
    assert got["w"].value is tree["w"].value
    assert stack_dims(tree, "enc")["w"].dims[0] == "enc"


# ---------------------------------------------------------------------------
# the dense configs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_match_the_reference(arch, dtype):
    check_against_reference(arch, dtype)


# ---------------------------------------------------------------------------
# graph pretune: the reference's instances and winners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_graph_pretune_gives_the_reference_instances(arch):
    ref_rep = RefGraphTuner.tune_config(
        ref_get_smoke(arch), batch=2, prompt_len=32, spec="tpu-v5e",
        db=ref_tc.TuningDatabase())
    rep = GraphTuner.tune_config(
        get_smoke(arch), batch=2, prompt_len=32, spec="tpu-v5e",
        db=tc.TuningDatabase())
    assert rep["instances"] == ref_rep["instances"]
    assert all(i["params"] for i in rep["instances"])
    kernels = {i["kernel"] for i in rep["instances"]}
    assert "rms_norm" in kernels
    # the tuned attention reaches every family whose layers run full
    # attention: the hybrid's windows and the SSM's none keep it plain
    fam = get_smoke(arch).family
    assert ("flash_attention" in kernels) == (fam in ("dense", "moe",
                                                      "encdec"))
    gated = get_smoke(arch).act.endswith("_glu")
    assert ("mlp_matmul" in kernels) == (gated and fam != "ssm")


# ---------------------------------------------------------------------------
# the port's prefill-then-decode against its own forward
# ---------------------------------------------------------------------------

FAMILIES = {
    "dense": ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                         n_heads=4, n_kv=2, d_ff=64, vocab=128),
    "dense-kvrep": ModelConfig(name="t", family="dense", n_layers=2,
                               d_model=32, n_heads=4, n_kv=2, d_ff=64,
                               vocab=128, kv_repeat=2),
    "moe": ModelConfig(name="t", family="moe", n_layers=2, d_model=32,
                       n_heads=4, n_kv=2, d_ff=64, d_ff_expert=32,
                       n_experts=4, top_k=2, n_shared=1, vocab=128,
                       capacity_factor=4.0, pad_experts_to=8),
    "moe-grouped": ModelConfig(name="t", family="moe", n_layers=2,
                               d_model=32, n_heads=4, n_kv=2, d_ff=64,
                               d_ff_expert=32, n_experts=4, top_k=2,
                               vocab=128, capacity_factor=4.0,
                               moe_dispatch="grouped"),
    "moe-prefix": ModelConfig(name="t", family="moe", n_layers=3,
                              d_model=32, n_heads=4, n_kv=2, d_ff=48,
                              d_ff_expert=32, n_experts=4, top_k=2,
                              n_shared=1, first_dense_layers=1, vocab=128,
                              capacity_factor=4.0),
    "ssm": ModelConfig(name="t", family="ssm", n_layers=2, d_model=32,
                       n_heads=1, n_kv=1, d_ff=0, vocab=128, ssm_state=8,
                       ssm_head_dim=8, ssm_chunk=8, head_dim=8),
    "hybrid": ModelConfig(name="t", family="hybrid", n_layers=3,
                          d_model=32, n_heads=4, n_kv=2, d_ff=64, vocab=128,
                          ssm_state=8, ssm_head_dim=8, ssm_chunk=8,
                          swa_window=8, decode_cache_cap=64),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_then_decode_matches_the_forward(family):
    """logits(decode @ pos s | prefill[:s]) == logits(forward)[s], in the
    reference's test's bf16 and at its tolerances (dense 2e-2; the
    chunked scan against the recurrence 5e-2 / 8e-2)."""
    cfg = FAMILIES[family]
    model = build_model(cfg)
    params = model.init(seed=4, device="cpu")
    s = 24
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (2, s + 1)))
    shd = Sharder()
    with torch.inference_mode():
        full, _aux = lm_logits(params, tokens, cfg, shd)
        _, cache = model.prefill(params, {"tokens": tokens[:, :s]}, shd,
                                 max_len=s + 1)
        logits, cache = model.decode_step(params, cache,
                                          tokens[:, s:s + 1], shd)
    assert cache["pos"] == s + 1
    tol = (dict(rtol=2e-2, atol=2e-2) if family.startswith("dense")
           else dict(rtol=5e-2, atol=8e-2))
    np.testing.assert_allclose(logits[:, 0].float().numpy(),
                               full[:, s].float().numpy(), **tol)


# ---------------------------------------------------------------------------
# the entry point, and the H100's picks at full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu_passes_the_frozen_gate(arch, capsys):
    from repro_torch.launch import serve
    tc.set_default_db(tc.TuningDatabase())
    try:
        # the entry point turns tuned layers on for its context: run it
        # in a copy so the switch does not outlive the test
        rep = contextvars.copy_context().run(serve.main, [
            "--arch", arch, "--smoke", "--device", "cpu", "--tuned-ops",
            "--pretune", "--assert-frozen", "--batch", "2",
            "--prompt-len", "16", "--gen", "2"])
    finally:
        tc.thaw()
        tc.reset_default_db()
    assert "--assert-frozen OK" in capsys.readouterr().out
    assert rep["logits_finite"] and rep["runtime_tunes"] == 0
    st = rep["dispatch"]
    assert st["frozen"] == st["total"] > 0
    assert np.array(rep["tokens"]).shape == (2, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_h100_picks_at_full_width_are_taken_by_the_kernels(arch):
    """Under the H100 every attention, matmul and gated-MLP instance of
    the published config's serving path (the chip smoke's first request,
    4 x 64) gets a row whose launch-time checks pass on operands of the
    instance's shape: a pick the kernel refused would be a fault of the
    analysis' feasibility."""
    from repro_torch.core.target import use_target
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import mlp_matmul as mlp
    cfg = get_config(arch)
    with use_target("h100"):
        rep = GraphTuner.tune_config(cfg, batch=4, prompt_len=64,
                                     db=tc.TuningDatabase())
    kinds = {i["kernel"] for i in rep["instances"]}
    assert ("flash_attention" in kinds) == (cfg.family in ("dense", "moe",
                                                           "encdec"))
    for inst in rep["instances"]:
        sig, p = inst["signature"], inst["params"]
        dt = getattr(torch, sig["dtype"])
        e = lambda *shape: torch.empty(shape, dtype=dt)
        if inst["kernel"] == "flash_attention":
            fn = ("repro_flash" if p["variant"] == "flash"
                  else "repro_blocked")
            q, k = e(1, 1, sig["sq"], sig["d"]), e(1, 1, sig["skv"], sig["d"])
            fa._refuse("flash_attention", fn, p["tile"], q, k, k,
                       sig["skv"], sig["d"])
        elif inst["kernel"] == "matmul":
            mm._refuse("matmul", p["tile"], e(sig["m"], sig["k"]),
                       e(sig["k"], sig["n"]))
        elif inst["kernel"] == "mlp_matmul" and p["variant"] != "split":
            tiles = {"fused": mlp.GATED_TILES,
                     "stream": mlp.STREAM_TILES}[p["variant"]]
            w = e(sig["d"], sig["f"])
            mlp._refuse("mlp_matmul", tiles, p["tile"], e(sig["m"], sig["d"]),
                        w, w)
    if cfg.family == "encdec":
        assert any(i["kernel"] == "flash_attention"
                   and not i["signature"]["causal"]
                   and i["signature"]["sq"] == cfg.enc_seq
                   for i in rep["instances"])
