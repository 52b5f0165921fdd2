"""The judgement's two sides on the CPU at test size (`perfbench.tiny`):
the control in the program's place, and each fault a cell can have
planted underneath the timed path, come out not correct."""
import io

import pytest
import torch

from perfbench import tiny
from perfbench.harness import load_cell, run, setup
from perfbench.reference.model import Reference

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, seed=SEED):
    return run(cell, seed, 0.01, trace, root=root, device="cpu",
               log=io.StringIO())


def _control(root, cell, seed):
    """The control in the program's place: the reference with float8
    weights chooses the tokens at the same prompts and steps."""
    c = load_cell(cell, root)
    st = setup(c, seed, torch.device("cpu"))
    traffic = c.kind.Traffic(c.mix, c.check, seed, st.prog)
    traffic.setup()
    traffic.window(0.01)
    traffic.release()
    with torch.inference_mode():
        got = traffic.judge(Reference(c.model, st.weights),
                            control=Reference(c.model, st.weights,
                                              quant="fp8"))
    return {k: got[k] > v for k, v in c.check["limits"].items()}


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_the_control_is_not_correct(root, cell, seed):
    assert any(_control(root, cell, seed).values())


def _altered(fn):
    """The served token altered where it is produced: every logit row
    rolled by one token."""
    def f(params, *args):
        logits, cache = fn(params, *args)
        return torch.roll(logits, 1, -1), cache
    return f


def _half_prefill(fn):
    """Half of the batch left out: the rest's answers served for it."""
    def f(params, batch):
        t = batch["tokens"]
        if t.device.type == "meta":
            return fn(params, batch)
        h = t.shape[0] // 2
        logits, cache = fn(params, {"tokens": t[:h]})
        return logits[torch.arange(t.shape[0]) % h], cache
    return f


def _half_decode(fn):
    def f(params, cache, tok):
        if tok.device.type == "meta":
            return fn(params, cache, tok)
        h = tok.shape[0] // 2
        part = {k: v[:, :h] if torch.is_tensor(v) else v
                for k, v in cache.items()}
        logits, new = fn(params, part, tok[:h])
        return logits[torch.arange(tok.shape[0]) % h], \
            {**cache, "pos": new["pos"]}
    return f


def _unchanged(fn):
    """A step that returns its state unchanged: the cache as it came in
    and the same position."""
    def f(params, cache, tok):
        kept = {k: v.clone() if torch.is_tensor(v) else v
                for k, v in cache.items()}
        logits, new = fn(params, cache, tok)
        for k, v in kept.items():
            if torch.is_tensor(v):
                new[k].copy_(v)
        return logits, {**new, "pos": kept["pos"]}
    return f


FAULTS = [("tiny-dense.prefill", "altered", _altered, None),
          ("tiny-dense.prefill", "half", _half_prefill, None),
          ("tiny-moe.prefill", "altered", _altered, None),
          ("tiny-moe.prefill", "half", _half_prefill, None),
          ("tiny-dense.decode", "altered", None, _altered),
          ("tiny-dense.decode", "half", None, _half_decode),
          ("tiny-dense.decode", "unchanged", None, _unchanged)]


@pytest.mark.parametrize("cell,fault,pre,dec", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _, _ in FAULTS])
def test_a_fault_underneath_is_not_correct(root, monkeypatch, cell, fault,
                                           pre, dec):
    import repro_torch.distributed as dist
    make = dist.make_serve_fns

    def planted(model, *args, **kw):
        p, d = make(model, *args, **kw)
        return (pre(p) if pre else p), (dec(d) if dec else d)
    monkeypatch.setattr(dist, "make_serve_fns", planted)
    assert _run(root, cell)["correct"] is False
