"""The readers of the program's spans (`perfbench.span_readers`): on the
CPU at test size (`perfbench.tiny`), and on a made-up record of a card."""
import io
import sys

import pytest

from perfbench import tiny
from perfbench.harness import FOLDER, ROOT, _module, run

SEED = 2**31 + 91
NEW = {"attn_decode_share.decode", "host_step_ms.decode",
       "dispatch_us.decode", "moe_shuffle_share.prefill"}


@pytest.fixture(autouse=True)
def _record():
    from repro_torch.runtime import spans
    spans.disable()
    spans.reset()
    yield spans
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("bench"))


def _read(name, run_ns=None):
    return _module(ROOT / FOLDER / "metrics" / f"{name}.py").read(run_ns)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_traced_tiny_run_reads_what_the_cpu_has(root, cell):
    """Off the card only the dispatch time reads, in the decode cell
    that lists it."""
    r = run(cell, SEED, 0.01, True, root=root, device="cpu",
            log=io.StringIO())
    assert r["correct"] is True
    got = NEW & set(r["metrics"])
    if cell == "tiny-dense.decode":
        assert got == {"dispatch_us.decode"}
        assert r["metrics"]["dispatch_us.decode"]["value"] > 0
        assert r["metrics"]["dispatch_us.decode"]["unit"] == "us"
    else:
        assert got == set()


def _made_up(device="cuda"):
    each = lambda n, dev: {"count": n, "host_ms": 0.0, "host_self_ms": 0.0,
                           "device_ms": dev, "device_self_ms": None,
                           "host_ms_each": [], "device_ms_each": []}
    spans = {"serve.decode": dict(each(3, 240.0),
                                  host_ms_each=[12.0, 30.0, 9.0]),
             "model.attention_decode": each(36, 180.0),
             "serve.prefill": each(2, 500.0),
             "model.moe.route": each(48, 20.0),
             "model.moe.dispatch": each(48, 35.0),
             "model.moe.experts": each(48, 200.0),
             "model.moe.combine": each(48, 45.0)}
    return {"device": device, "spans": spans,
            "dispatch": {"ns": 3_000_000, "calls": 250, "tiers": {}}}


def test_each_reader_on_a_made_up_record_of_a_card(_record, monkeypatch):
    monkeypatch.setattr(_record, "summary", _made_up)
    assert _read("attn_decode_share.decode") == pytest.approx(75.0)
    assert _read("host_step_ms.decode") == pytest.approx(12.0)
    assert _read("dispatch_us.decode") == pytest.approx(12.0)
    assert _read("moe_shuffle_share.prefill") == pytest.approx(20.0)


def test_a_record_off_the_card_reads_only_the_dispatch_time(_record,
                                                            monkeypatch):
    monkeypatch.setattr(_record, "summary", lambda: _made_up("cpu"))
    assert [_read(n) for n in sorted(NEW)] == [None, 12.0, None, None]


def test_a_record_without_the_spans_reads_none(_record, monkeypatch):
    s = _made_up()
    del s["spans"]["serve.decode"], s["spans"]["model.moe.route"]
    s["dispatch"] = {"ns": 0, "calls": 0, "tiers": {}}
    monkeypatch.setattr(_record, "summary", lambda: s)
    assert [_read(n) for n in sorted(NEW)] == [None] * 4


def test_a_program_without_spans_reads_none(monkeypatch):
    """What the benchmark reads from a program that has no span
    recorder, as a parent commit may not."""
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    assert [_read(n) for n in sorted(NEW)] == [None] * 4
