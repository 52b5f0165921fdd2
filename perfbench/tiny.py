"""Test-size copies of the benchmark's cells, for the CPU tests: the
same traffic kinds, checks and metric readers at sizes a test run
holds, in a tree of their own (``tree``) that the harness reads as it
reads the repository's."""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Optional

FOLDER = Path(__file__).resolve().parent

MODELS = {
    "tiny-dense": {"name": "tiny-dense", "family": "dense", "n_layers": 2,
                   "d_model": 128, "n_heads": 4, "n_kv": 2, "d_ff": 256,
                   "vocab": 1024, "act": "silu_glu", "qkv_bias": True,
                   "rope_theta": 10000.0, "norm_eps": 1e-6,
                   "dtype": "bfloat16"},
    "tiny-moe": {"name": "tiny-moe", "family": "moe", "n_layers": 2,
                 "d_model": 128, "n_heads": 4, "n_kv": 4, "d_ff": 256,
                 "d_ff_expert": 64, "n_experts": 8, "top_k": 2,
                 "n_shared": 2, "capacity_factor": 1.25, "vocab": 1024,
                 "act": "silu_glu", "qkv_bias": True, "rope_theta": 10000.0,
                 "norm_eps": 1e-6, "dtype": "bfloat16"},
}
TRAFFIC = {
    "tiny-prefill": {"kind": "prefill_batches", "batch": 2,
                     "block": [[32, 2], [64, 1]]},
    "tiny-prefill-b4": {"kind": "prefill_batches", "batch": 4,
                        "block": [[32, 2], [64, 1]]},
    "tiny-decode": {"kind": "decode_stream", "batch": 3, "prompt": 24,
                    "request_tokens": 16, "warm_steps": 2},
}
# each test cell stands for a cell of the repository's BENCHMARK.json:
# (config, traffic, its check at this size, the cell it stands for)
CELLS = {
    "tiny-dense.prefill": ("tiny-dense", "tiny-prefill",
                           {"sample": {"longest_rows": 1, "other_rows": 2},
                            "limits": {"gap_max": 0.08}},
                           "qwen110b-d12.prefill-long"),
    "tiny-moe.prefill": ("tiny-moe", "tiny-prefill-b4",
                         {"sample": {"longest_rows": 4, "other_rows": 0},
                          "limits": {"gap_mean": 0.04}},
                         "qwen-moe.prefill-long"),
    "tiny-dense.decode": ("tiny-dense", "tiny-decode",
                          {"sample": {"rows": 3},
                           "limits": {"gap_max": 0.08}},
                          "qwen110b-d12.decode-ctx2k"),
}


def _dump(path: Path, obj: Dict) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def tree(dest: Path, limits: Optional[Dict[str, Dict]] = None) -> Path:
    """A root at ``dest``: a copy of the benchmark's folder beside a
    ``BENCHMARK.json`` whose cells are `CELLS` and whose metrics are the
    repository's, each listed for the test cells that stand for its
    cells.  ``limits`` overrides a cell's limits."""
    shutil.copytree(FOLDER, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((FOLDER.parent / "BENCHMARK.json").read_text())
    folder = dest / "perfbench"
    for name, m in MODELS.items():
        _dump(folder / "configs" / f"{name}.json", {"model": m})
    for name, mix in TRAFFIC.items():
        _dump(folder / "traffic" / f"{name}.json", mix)
    stands = {}
    for cell, (config, traffic, check, real) in CELLS.items():
        check = dict(check, limits=(limits or {}).get(cell, check["limits"]))
        _dump(folder / "workloads" / f"{cell}.json", check)
        stands.setdefault(real, []).append(cell)
    bench["configs"] = [{"name": n, "source": "test size",
                         "file": f"perfbench/configs/{n}.json",
                         "reduced": [], "why": "test size"} for n in MODELS]
    bench["workloads"] = [{"name": c, "config": cfg, "traffic": t,
                           "chips": 1, "why": "test size"}
                          for c, (cfg, t, _, _) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c for w in m["workloads"]
                              for c in stands.get(w, [])]
    _dump(dest / "BENCHMARK.json", bench)
    return dest
