"""The readings a cell's limits are set from, at the cell's own size:

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 3]

For each seed, one process-local run of the cell's traffic (a short
window at the cell's own load, long enough to finish its longest
requests) and the judged numbers of what the program served; for each
control seed the same prompts and steps judged with the control in the
program's place: the reference with every product's weight rounded to
float8 (`reference.model.Reference`, ``quant="fp8"``), one step below the
configuration's bfloat16.  One JSON line a reading.  Needs a card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _readings(cell, seed: int, seconds: float, sides):
    """One seed's run of the cell's traffic, judged once a side: the
    program's served tokens, the control's or the witness's choices."""
    import torch

    from perfbench.harness import setup
    from perfbench.reference.model import Reference

    st = setup(cell, seed, torch.device("cuda"))
    traffic = cell.kind.Traffic(cell.mix, cell.check, seed, st.prog)
    traffic.setup()
    traffic.window(seconds)
    traffic.release()
    torch.cuda.empty_cache()
    ref = Reference(cell.model, st.weights)
    quant = {"control": "fp8", "bf16 witness": "bf16"}
    out = []
    with torch.inference_mode():
        for side in sides:
            other = (Reference(cell.model, st.weights, quant=quant[side])
                     if side in quant else None)
            got = traffic.judge(ref, control=other)
            if ref.routed:
                got["dropped_share"] = ref.dropped / ref.routed
            out.append((side, got))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--witness", action="store_true",
                    help="also judge the bf16 witness's choices on every "
                         "seed (`Reference`, quant='bf16')")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from perfbench.harness import load_cell

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    cell = load_cell(args.workload, ROOT)
    for seed in seeds + [s for s in controls if s not in seeds]:
        sides = (["program"] if seed in seeds else []) \
            + (["control"] if seed in controls else []) \
            + (["bf16 witness"] if args.witness else [])
        for side, got in _readings(cell, seed, args.seconds, sides):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **got}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
