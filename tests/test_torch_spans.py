"""The serving path's spans (`repro_torch.runtime.spans`) on the CPU:
off they record nothing and change no logit; on, by `spans.enable()` or
under the torch profiler, one prefill and one decode step of a dense and
an MoE smoke model give the span tree of the model's layers and kernel
ops, with self times, dispatch times and profiler ranges; and
``launch.serve --trace`` writes the record."""
import contextvars
import json

import pytest
import torch

from repro_torch import tuning_cache as tc
from repro_torch.configs import get_smoke
from repro_torch.distributed import make_serve_fns
from repro_torch.kernels import api
from repro_torch.models import build_model
from repro_torch.models.layers import use_tuned_layers
from repro_torch.runtime import spans

ARCHS = ("gemma-7b", "qwen2-moe-a2.7b")
MOE = ("model.moe.route", "model.moe.dispatch", "model.moe.experts",
       "model.moe.combine", "model.moe.shared")


@pytest.fixture(autouse=True)
def record():
    spans.disable()
    spans.reset()
    tc.set_default_db(tc.TuningDatabase())
    api.reset_dispatch_stats()
    try:
        yield spans
    finally:
        spans.disable()
        spans.reset()
        tc.thaw()
        tc.reset_default_db()
        api.reset_dispatch_stats()


def _serve(arch):
    """One prefill of 2 x 12 tokens and one decode step, tuned layers on;
    returns (config, [prefill logits, decode logits])."""
    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    prefill, decode = make_serve_fns(model)
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode(), use_tuned_layers(True):
        logits, cache = prefill(params, {"tokens": tokens})
        first = logits
        logits, _ = decode(params, cache, logits[:, -1:].argmax(-1))
    return cfg, [first, logits]


@pytest.mark.parametrize("arch", ARCHS)
def test_off_records_nothing_and_changes_no_logit(arch):
    _, off = _serve(arch)
    assert spans.records() == [] and not spans.active()
    assert spans.summary()["dispatch"]["calls"] == 0
    spans.enable()
    _, on = _serve(arch)
    assert spans.records()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def _children(recs):
    kids = {}
    for r in recs:
        kids.setdefault(r["parent"], []).append(r)
    return kids


def _check_tree(cfg, recs):
    by_id = {r["id"]: r for r in recs}
    kids = _children(recs)
    roots = kids[None]
    assert [r["name"] for r in roots] == ["serve.prefill", "serve.decode"]
    for r in recs:
        if r["parent"] is not None:
            parent = by_id[r["parent"]]
            assert r["call"] == parent["call"]
            assert parent["host_start_ns"] <= r["host_start_ns"] \
                <= r["host_end_ns"] <= parent["host_end_ns"]
        if r["name"].startswith("kernels."):
            assert by_id[r["parent"]]["name"].startswith("model.")
    attn = {"serve.prefill": "model.attention",
            "serve.decode": "model.attention_decode"}
    moe = cfg.family == "moe"
    for root in roots:
        assert root["call"] == root["id"]
        names = [k["name"] for k in kids[root["id"]]]
        blocks = [k for k in kids[root["id"]] if k["name"] == "model.block"]
        assert [b["attrs"] for b in blocks] == [{"layer": i}
                                               for i in range(cfg.n_layers)]
        assert names.count("model.embed") == names.count("model.head") == 1
        assert names.count("model.fill_cache") \
            == (root["name"] == "serve.prefill")
        for b in blocks:
            inner = [k["name"] for k in kids[b["id"]]
                     if not k["name"].startswith("kernels.")]
            assert inner == [attn[root["name"]]] + (list(MOE) if moe
                                                    else ["model.mlp"])


@pytest.mark.parametrize("arch", ARCHS)
def test_the_span_tree_of_a_prefill_and_a_decode_step(arch):
    spans.enable()
    cfg, _ = _serve(arch)
    _check_tree(cfg, spans.records())


@pytest.mark.parametrize("arch", ARCHS)
def test_the_profiler_turns_the_spans_on_and_holds_each_as_a_range(arch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert spans.active()
        cfg, _ = _serve(arch)
    assert not spans.active()
    recs = spans.records()
    _check_tree(cfg, recs)
    ranges = {}
    for e in prof.events():
        if e.name.startswith(spans.PREFIX):
            ranges[e.name] = ranges.get(e.name, 0) + 1
            # not a user range: on the card those take the kernels of
            # any user range around them (a caller's around an op)
            assert not e.is_user_annotation
    want = {}
    for r in recs:
        want[spans.PREFIX + r["name"]] = want.get(spans.PREFIX + r["name"],
                                                  0) + 1
    assert ranges == want


def test_self_times_are_the_span_less_its_children():
    spans.enable()
    _serve("qwen2-moe-a2.7b")
    recs = spans.records()
    kids = _children(recs)
    host = lambda r: (r["host_end_ns"] - r["host_start_ns"]) / 1e6
    want = {}
    for r in recs:
        self_ms = host(r) - sum(host(k) for k in kids.get(r["id"], []))
        assert self_ms >= 0
        want[r["name"]] = want.get(r["name"], 0.0) + self_ms
    summ = spans.summary()
    assert summ["device"] == "cpu"
    for name, e in summ["spans"].items():
        assert e["host_self_ms"] == pytest.approx(want[name], abs=1e-9)
        assert e["host_ms"] == pytest.approx(sum(e["host_ms_each"]))
        assert e["count"] == len(e["host_ms_each"])
        assert e["device_ms"] is None and e["device_ms_each"] == []


def test_no_cuda_event_is_made_on_the_cpu(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event on the CPU")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    spans.enable()
    _serve("gemma-7b")
    assert spans.summary()["device"] == "cpu"
    assert all(r["device_ms"] is None for r in spans.records())


def test_each_registry_call_counts_its_dispatch_time():
    spans.enable()
    _serve("qwen2-moe-a2.7b")
    summ = spans.summary()
    kernels = sum(e["count"] for n, e in summ["spans"].items()
                  if n.startswith("kernels."))
    d = summ["dispatch"]
    assert d["calls"] == kernels == d["tiers"]["total"] > 0
    assert d["ns"] > 0
    assert d["tiers"] == api.dispatch_stats()


def test_serve_writes_the_record_with_trace(tmp_path, capsys):
    from repro_torch.launch import serve
    path = tmp_path / "spans.json"
    # the entry point turns tuned layers on for its context: run it in a
    # copy so the switch does not outlive the test
    contextvars.copy_context().run(serve.main, [
        "--arch", "qwen2-moe-a2.7b", "--smoke", "--device", "cpu",
        "--tuned-ops", "--pretune", "--batch", "2", "--prompt-len", "16",
        "--gen", "3", "--trace", str(path)])
    out = capsys.readouterr().out
    assert not spans.active()
    got = json.loads(path.read_text())
    names = [r["name"] for r in got["records"] if r["parent"] is None]
    assert names == ["serve.prefill"] + ["serve.decode"] * 3
    summ = got["summary"]
    assert summ["spans"]["model.block"]["count"] \
        == 4 * get_smoke("qwen2-moe-a2.7b").n_layers
    for name, e in summ["spans"].items():
        assert f"[serve]   {name} {e['count']} " in out
    assert summ["dispatch"]["calls"] > 0 and "us a call" in out
