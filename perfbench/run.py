"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  The
last line of standard output is the run's result as one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number the
judgement compared, beside its limit, also the last lines on standard
error).  Without a card, or without the port's package beside this
folder, it exits non-zero and prints no result.  The kernel library
builds at first use into the checkout's ``build/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the JAX package and JAX itself must not be loaded by what runs here
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"[perfbench] no src/repro_torch under {ROOT}: the program "
              f"under test is missing", file=sys.stderr)
        return 2
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # one allocator arena that grows, for batches of many shapes
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    from perfbench.harness import load_cell
    chips = int(load_cell(args.workload, ROOT).workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[perfbench] needs {chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    from perfbench.harness import run
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"[perfbench] loaded in this process: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
