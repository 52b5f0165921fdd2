"""One run of one cell: set the program up as its serving launcher does,
drive the cell's traffic through it for a window, read the cell's
metrics, and judge what the window served against the plain reference.

Everything a cell is made of is found by name under the benchmark's
folder: its configuration (``BENCHMARK.json``'s ``configs[].file``), its
traffic mix (``traffic/<traffic>.json``) and that mix's generator
(``traffic/<kind>.py``), its check (``workloads/<cell>.json``) and each
metric's reader (``metrics/<metric>.py``, a ``read(run)`` that returns a
number or None).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Dict, List, Optional

__all__ = ["ROOT", "load_cell", "run", "Prog"]

ROOT = Path(__file__).resolve().parent.parent
FOLDER = "perfbench"


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no such file")
    name = "perfbench_dyn_" + "_".join(path.relative_to(
        path.parents[1]).with_suffix("").parts).replace(".", "_").replace(
            "-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    folder = root / FOLDER
    mix = _json(folder / "traffic" / f"{w['traffic']}.json")

    def applies(metric):
        return workload in metric.get("workloads", [workload])
    return SimpleNamespace(
        name=workload, workload=w, model=_json(root / config["file"])["model"],
        mix=mix, check=_json(folder / "workloads" / f"{workload}.json"),
        kind=_module(folder / "traffic" / f"{mix['kind']}.py"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        folder=folder)


class Prog:
    """The program under test as the window drives it: its serving
    functions over the benchmark's weights, in inference mode."""

    def __init__(self, m: Dict, device, params, prefill, decode_step):
        self.m, self.device, self.params = m, device, params
        self._prefill, self._decode = prefill, decode_step

    def prefill(self, tokens):
        import torch
        with torch.inference_mode():
            return self._prefill(self.params, {"tokens": tokens})

    def decode_step(self, cache, token):
        import torch
        with torch.inference_mode():
            return self._decode(self.params, cache, token)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _model_config(m: Dict):
    from repro_torch.models.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in m.items() if k in fields})


def _params(meta, weights: Dict, path: str = ""):
    """The program's parameter tree over the benchmark's weights: each
    leaf of the program's (``meta``) tree takes the weight at its path,
    whose shape and type it must have."""
    from repro_torch.models.params import Param
    if isinstance(meta, Param):
        w = weights.get(path)
        if w is None or tuple(w.shape) != tuple(meta.value.shape) \
                or w.dtype != meta.value.dtype:
            have = None if w is None else (tuple(w.shape), w.dtype)
            raise ValueError(f"{path}: the program wants "
                             f"{tuple(meta.value.shape)} {meta.value.dtype}, "
                             f"the benchmark made {have}")
        return Param(w, meta.dims)
    return {k: _params(v, weights, f"{path}.{k}" if path else k)
            for k, v in meta.items()}


def _leaves(tree, path: str = "") -> List[str]:
    if hasattr(tree, "dims"):
        return [path]
    return [p for k, v in tree.items()
            for p in _leaves(v, f"{path}.{k}" if path else k)]


def setup(cell: SimpleNamespace, seed: int, device) -> SimpleNamespace:
    """The serving set-up of `repro_torch.launch.serve.main`, in its order:
    the default tuning database (warm with the shipped records), a
    graph pretune of every shape the traffic sends, thaw and freeze,
    tuned layers on, the model and its serving functions; then the
    benchmark's weights in the program's tree."""
    from repro_torch import tuning_cache
    from repro_torch.core.autotuner import GraphTuner
    from repro_torch.distributed import make_serve_fns
    from repro_torch.models import build_model
    from repro_torch.models.layers import set_tuned_layers

    from perfbench.weights import make_weights

    db = tuning_cache.get_default_db()
    cfg = _model_config(cell.model)
    t0 = time.perf_counter()
    instances = set()
    for batch, length in cell.kind.shapes(cell.mix):
        rep = GraphTuner.tune_config(cfg, batch=batch, prompt_len=length,
                                     db=db)
        instances |= {(i["kernel"], tuple(sorted(i["signature"].items())),
                       tuple(sorted((i["params"] or {}).items())))
                      for i in rep["instances"]}
    tuning_cache.thaw()
    frozen = tuning_cache.freeze()
    pretune_s = time.perf_counter() - t0
    set_tuned_layers(True)
    model = build_model(cfg)
    meta = model.init(device="meta")
    weights = make_weights(cell.model, seed, device)
    extra = set(weights) - set(_leaves(meta))
    if extra:
        raise ValueError(f"weights the program does not take: {sorted(extra)}")
    prefill, decode_step = make_serve_fns(model)
    prog = Prog(cell.model, device, _params(meta, weights), prefill,
                decode_step)
    return SimpleNamespace(prog=prog, weights=weights, pretune_s=pretune_s,
                           instances=sorted(instances), frozen=frozen)


def _read(cell, metrics: List[Dict], run_ns) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = _module(cell.folder / "metrics" / f"{m['name']}.py").read(run_ns)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        root: Path = ROOT, device: str = "cuda",
        t_start: Optional[float] = None, log=sys.stderr) -> Dict[str, Any]:
    """One run; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from repro_torch.kernels import api as kernel_api
    from perfbench.reference.model import Reference
    from perfbench.trace import profile

    # the reference's float32 products stay float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cell = load_cell(workload, root)
    st = setup(cell, seed, dev)
    traffic = cell.kind.Traffic(cell.mix, cell.check, seed, st.prog)
    traffic.setup()
    st.prog.sync()
    setup_s = time.perf_counter() - t_start
    print(f"[perfbench] {workload}: seed {seed}, set-up {setup_s:.3f} s, "
          f"pretune {st.pretune_s * 1e3:.1f} ms, {len(st.instances)} "
          f"instances, {st.frozen} frozen entries", file=log, flush=True)
    kernel_api.reset_dispatch_stats()
    window = traffic.window(seconds)
    dispatch = kernel_api.dispatch_stats()
    waits = sorted(r["ttft_s"] * 1e3 for r in window["requests"]
                   if "ttft_s" in r) or sorted(window.get("itl_ms", []))
    print(f"[perfbench] window {window['window_s']:.3f} s, "
          f"{len(window['requests'])} requests, {window['batches']} "
          f"batches; ms to a token: median "
          f"{waits[len(waits) // 2] if waits else None}, longest "
          f"{waits[-1] if waits else None}; dispatch {dispatch}",
          file=log, flush=True)
    prof = None
    if trace:
        prof = profile(traffic.stretch, st.prog.sync)
        print(f"[perfbench] profile: busy {prof['busy_s']:.4f} of "
              f"{prof['wall_s']:.4f} s; library kernels "
              f"{prof['library_kernels_in_spans']} of "
              f"{prof['library_kernels']} inside op spans; spans "
              f"{prof['span_kernel_s']}; uncounted {prof['uncounted']}",
              file=log, flush=True)
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": 1,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                      if dev.type == "cuda" else 0)}
    if prof is not None:
        dev_info.update(busy_s=prof["busy_s"], window_s=prof["wall_s"])
    run_ns = SimpleNamespace(m=cell.model, mix=cell.mix, setup_s=setup_s,
                             pretune_s=st.pretune_s, window=window,
                             dispatch=dispatch, profile=prof)
    metrics = _read(cell, cell.per_layer if trace else cell.end_to_end,
                    run_ns)

    # the judgement, once the window is closed and the program's state
    # is freed: the reference over the benchmark's weights
    traffic.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = traffic.judge(Reference(cell.model, st.weights))
    limits = cell.check["limits"]
    checks = {k: {"value": float(got[k]), "limit": float(v)}
              for k, v in limits.items()}
    correct = got["positions"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    print(f"[perfbench] reference check {time.perf_counter() - t0:.3f} s: "
          f"{got}", file=log, flush=True)
    result: Dict[str, Any] = {
        "correct": bool(correct),
        "attempted": len(window["requests"]),
        "failed": 0, "metrics": metrics, "device": dev_info}
    if prof is not None:
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    return result
