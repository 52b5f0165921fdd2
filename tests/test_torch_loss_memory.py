"""The next-token loss without whole float32 copies of the logits, and
the trace's account of what holds a step's memory peak.

* `transformer.next_token_nll` (`_TokenNLL`: the logsumexp and the
  target's logit chunk by chunk over rows in float32, the gradient written
  straight into the logits' type) against the plain float32 logsumexp
  form, and the port's `lm_loss` / `encdec_loss` against the
  reference's (value and gradient), with the chunk cut small so that
  many chunks run;
* on a two-rank gloo mesh, with the vocab sharded over the model dim
  (it divides) and whole (it does not), against the same plain form;
* `core.mix.LiveBytes` names the storages alive at the peak, each with
  the op that made it;
* a whisper-tiny-shaped train step, cut small, traced on ``meta``
  tensors (`launch.dryrun.lower_train_step`): its peak falls by at
  least the float32 copies of the logits the plain form makes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worlds as worlds
from repro.configs import get_smoke as ref_get_smoke
from repro.distributed.sharding import Sharder as RefSharder
from repro.models import Param as RefParam
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.mix import live_bytes, trace_meta_fn
from repro_torch.distributed.sharding import Sharder
from repro_torch.launch.dryrun import lower_train_step
from repro_torch.launch.mesh import spawn_world
from repro_torch.models import build_model, from_numpy_tree, transformer
from repro_torch.models.params import tree_leaves

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7


def plain_nll(logits, tokens):
    """The reference's form in torch: f32 logsumexp over the whole
    ``logits[:, :-1]`` minus the target's logit."""
    lf = logits[:, :-1].float()
    t = tokens[:, 1:].long()
    return (torch.logsumexp(lf, -1)
            - lf.gather(-1, t[..., None])[..., 0]).mean()


def seeded(b, s, v, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((b, s, v))).astype(dtype)
    tokens = rng.integers(0, v, (b, s)).astype(np.int64)
    return logits, tokens


@pytest.mark.parametrize("vocab", [48, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_loss_matches_the_plain_float32_form(monkeypatch, vocab,
                                                     dtype):
    # five rows a chunk: 3 x 12 rows end in a short chunk, and chunks
    # span two batch rows
    monkeypatch.setattr(transformer, "NLL_CHUNK_BYTES", 4 * vocab * 5)
    logits_np, tokens_np = seeded(3, 12, vocab)
    x = torch.from_numpy(logits_np).to(dtype).requires_grad_(True)
    tokens = torch.from_numpy(tokens_np)
    got = transformer.next_token_nll(x, tokens)
    got.backward()
    got_grad, x.grad = x.grad, None
    want = plain_nll(x, tokens)
    want.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=LOSS_RTOL)
    assert got_grad.dtype == dtype and got_grad.shape == x.shape
    assert not got_grad[:, -1].any()
    scale = float(x.grad.float().abs().max())
    np.testing.assert_allclose(got_grad.float().numpy(),
                               x.grad.float().numpy(), rtol=0,
                               atol=GRAD_RTOL * scale + GRAD_ATOL)


def _ref_tree(tree):
    return jax.tree.map(
        lambda p: (np.asarray(p.value), p.dims)
        if isinstance(p, RefParam) else np.asarray(p), tree,
        is_leaf=lambda x: isinstance(x, RefParam))


@pytest.mark.parametrize("arch", ["gemma-7b", "whisper-tiny"])
def test_lm_and_encdec_loss_match_the_reference_in_small_chunks(
        monkeypatch, arch):
    """gemma's `lm_loss` and whisper's `encdec_loss` (float32 smoke
    configs), value and every parameter's gradient, against the
    reference's jitted loss and ``jax.grad``."""
    rc = dataclasses.replace(ref_get_smoke(arch), dtype="float32")
    c = dataclasses.replace(get_smoke(arch), dtype="float32")
    monkeypatch.setattr(transformer, "NLL_CHUNK_BYTES", 4 * c.vocab * 5)
    rm, m = ref_build_model(rc), build_model(c)
    rp = rm.init(jax.random.PRNGKey(0))
    p = from_numpy_tree(_ref_tree(rp), device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, c.vocab, (2, 24)).astype(np.int32)
    rb, b = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if c.frontend == "frames":
        fr = rng.standard_normal((2, c.enc_seq, c.d_model)).astype(np.float32)
        rb["frames"] = jnp.asarray(fr).astype(jnp.bfloat16)
        b["frames"] = torch.from_numpy(fr).to(torch.bfloat16)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda q, x: rm.loss(q, x, RefSharder())[0]))(rp, rb)
    leaves = [leaf.value for _, leaf in tree_leaves(p)]
    for v in leaves:
        v.requires_grad_(True)
    loss, _ = m.loss(p, b, Sharder())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=LOSS_RTOL)
    ref_leaves = jax.tree.leaves(want_grads)
    assert len(ref_leaves) == len(grads)
    for (path, _), g, r in zip(tree_leaves(p), grads, ref_leaves):
        r = np.asarray(r)
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=GRAD_RTOL * float(
            np.abs(r).max()) + GRAD_ATOL, err_msg=str(path))


@pytest.mark.parametrize("vocab,layout", [(48, "vocab"), (37, "whole")])
def test_the_loss_on_a_two_rank_mesh_matches_the_plain_form(vocab, layout):
    """Vocab shards (48 over two model ranks: the logsumexp's max and
    sum reduced over them, each rank's targets picked in its range) and
    a whole vocab (37: each rank's loss on its own copy)."""
    logits_np, tokens_np = seeded(2, 9, vocab, seed=3)
    (l0, g0, comm), (l1, g1, _) = spawn_world(
        worlds.loss_case, 2, logits_np, tokens_np, layout, 4 * vocab * 2,
        timeout=worlds.WORLD_TIMEOUT)
    x = torch.from_numpy(logits_np).requires_grad_(True)
    want = plain_nll(x, torch.from_numpy(tokens_np))
    want.backward()
    scale = float(x.grad.abs().max())
    for loss, grad in ((l0, g0), (l1, g1)):
        np.testing.assert_allclose(loss, float(want.detach()),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(grad, x.grad.numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale + GRAD_ATOL)
    # the vocab's shards reduce a max and a sum a position: the logits
    # are never gathered
    assert not [k for k in comm if "all_gather" in k], comm


def test_live_bytes_names_the_storages_held_at_the_peak():
    """Three temporaries of 256, 128 and 64 bytes alive together make the
    peak; one of 192 bytes freed before them is not at it."""
    x = torch.ones(16, device="meta")

    def step(x):
        early = x.repeat(3)                  # 192 B, freed before the peak
        s = early.sum()
        del early
        a = x.repeat(4)                      # 256 B
        b = torch.cat([x, x])                # 128 B
        c = x * 2                            # 64 B
        return s + a.sum() + b.sum() + c.sum()

    with live_bytes(keep=[x]) as live:
        trace_meta_fn(step, x)
    top = live.at_peak(3)
    assert [(t["op"], t["bytes"], t["shape"], t["dtype"]) for t in top] == [
        ("repeat", 256, [64], "float32"), ("cat", 128, [32], "float32"),
        ("mul", 64, [16], "float32")]
    assert live.peak >= 448 and live.peak < 448 + 192


def test_a_whisper_shaped_step_no_longer_holds_float32_logits(monkeypatch):
    """whisper-tiny's widths cut to one layer a stack, 4 x 2048 tokens
    (``meta`` tensors: nothing is allocated):
    the traced step's peak with the plain float32 form of the loss
    against the chunked loss.  The plain form holds float32 copies of
    the logits (the cast, its exp, the gather's gradient); the chunked
    one holds none at its peak."""
    cfg = dataclasses.replace(get_config("whisper-tiny"), n_layers=1,
                              enc_layers=1)
    b, s = 4, 2048
    f32 = b * (s - 1) * cfg.vocab * 4
    now = lower_train_step(cfg, b, s)
    monkeypatch.setattr(transformer, "next_token_nll", plain_nll)
    monkeypatch.setattr("repro_torch.models.encdec.next_token_nll",
                        plain_nll)
    before = lower_train_step(cfg, b, s)
    assert now.memory["argument_bytes"] == before.memory["argument_bytes"]
    assert before.memory["temp_bytes"] - now.memory["temp_bytes"] >= 2 * f32
    wide = [t for t in before.peak_storages if t["dtype"] == "float32"
            and t["shape"][-1] == cfg.vocab]
    assert len(wide) >= 2 and all(t["bytes"] == f32 for t in wide)
    assert not [t for t in now.peak_storages if t["dtype"] == "float32"
                and t["shape"][-1] == cfg.vocab and t["bytes"] >= f32]
