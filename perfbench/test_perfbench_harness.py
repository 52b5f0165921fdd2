"""The harness on the CPU at test size (`perfbench.tiny`): what it finds
by name, the result's last line, and what a run imports."""
import contextlib
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import tiny
from perfbench.harness import run

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("bench"))


def _run(root, cell, trace=False, seed=SEED):
    return run(cell, seed, 0.01, trace, root=root, device="cpu",
               log=io.StringIO())


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_result_line_keys_and_order(root, cell):
    r = _run(root, cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    # the gaps between tokens come from the card's events: none here
    assert set(r["metrics"]) == want - {"itl_p95_ms"} and "setup_s" in want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    (name, c), = r["checks"].items()
    assert name in ("gap_max", "gap_mean") and c["value"] <= c["limit"]


def test_traced_result_has_the_per_layer_metrics(root):
    r = _run(root, "tiny-dense.prefill", trace=True)
    assert list(r)[-2:] == ["breakdown", "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: only what needs none is read
    assert set(r["metrics"]) == {"pretune_ms", "frozen_share.prefill",
                                 "mfu.prefill"}
    assert r["metrics"]["frozen_share.prefill"]["value"] == 100.0
    assert {"busy_s", "window_s"} <= set(r["device"])


def test_dropped_in_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as
    files and entries, with no edit to any file already there."""
    root = tiny.tree(tmp_path)
    folder = root / "perfbench"
    m = dict(tiny.MODELS["tiny-dense"], name="tiny-wide", n_heads=8,
             n_kv=8, d_ff=192)
    (folder / "configs" / "tiny-wide.json").write_text(
        json.dumps({"model": m}))
    (folder / "traffic" / "tiny-mixed.json").write_text(json.dumps(
        {"kind": "prefill_batches", "batch": 3, "block": [[8, 1], [48, 1]]}))
    (folder / "workloads" / "tiny-wide.mixed.json").write_text(json.dumps(
        {"sample": {"longest_rows": 1, "other_rows": 1},
         "limits": {"gap_max": 0.2}}))
    (folder / "metrics" / "batches_done.py").write_text(
        '"""Batches the window completed."""\n\n\n'
        'def read(run):\n    return run.window["batches"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-wide", "source": "test size",
                             "file": "perfbench/configs/tiny-wide.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "tiny-wide.mixed",
                               "config": "tiny-wide",
                               "traffic": "tiny-mixed", "chips": 1,
                               "why": "t"})
    bench["end_to_end"].append({"name": "batches_done", "unit": "batches",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny-wide.mixed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = _run(root, "tiny-wide.mixed")
    assert r["correct"] is True
    n = r["metrics"]["batches_done"]["value"]
    assert n >= 2 and n % 2 == 0 and r["attempted"] == 3 * n
    assert "batches_done" not in _run(root, "tiny-dense.prefill")["metrics"]


def test_run_py_prints_the_result_last(root, monkeypatch, capsys):
    """``run.py``'s own output: the result's JSON on the last line of
    standard output, each compared number beside its limit on the last
    lines of standard error."""
    from perfbench import harness
    from perfbench import run as entry
    real = harness.run
    monkeypatch.setattr(entry, "ROOT", root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run", lambda *a, **k: real(
        *a, **{**k, "root": root, "device": "cpu"}))
    # another test of this worker may have loaded JAX: what the run loads
    # is judged (a whole run's process: the test below)
    before = set(entry.forbidden_modules())
    loaded = entry.forbidden_modules
    monkeypatch.setattr(entry, "forbidden_modules",
                        lambda: sorted(set(loaded()) - before))
    shutil.copytree(ROOT / "src", root / "src",
                    ignore=shutil.ignore_patterns("__pycache__", "repro"))
    assert entry.main(["--workload", "tiny-dense.decode", "--seed", "3",
                       "--seconds", "0.01", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] is True and list(r)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check gap_max ")


def test_run_py_refuses_without_a_card_or_the_program(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                        "--workload", "qwen110b-d12.prefill-long", "--seed",
                        "1", "--seconds", "1"], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    # a directory with BENCHMARK.json and the benchmark's folder only
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen110b-d12.prefill-long", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True,
                       cwd=tmp_path, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


_IMPORTS = r"""
import io, sys
from pathlib import Path
sys.path[:0] = [{src!r}, {root!r}]
{body}
names = {{m.split(".")[0] for m in sys.modules}}
print(sorted(names & {{"jax", "jaxlib", "flax", "repro", "repro_torch"}}))
"""


def _loaded(body):
    code = _IMPORTS.format(src=str(ROOT / "src"), root=str(ROOT), body=body)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole run's process, ``repro_torch`` and all, compared by whole
    top-level names: ``repro_torch`` is not ``repro``."""
    tiny.tree(tmp_path)
    body = (f"import perfbench.run\nfrom perfbench.harness import run\n"
            f"run('tiny-moe.prefill', 1, 0.01, True, root=Path("
            f"{str(tmp_path)!r}), device='cpu', log=io.StringIO())")
    assert _loaded(body) == "['repro_torch']"


def test_the_reference_imports_nothing_of_the_program():
    body = ("import perfbench.reference.model, perfbench.weights, "
            "perfbench.work")
    assert _loaded(body) == "[]"
