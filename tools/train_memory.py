#!/usr/bin/env python3
"""One training step's device memory on the card beside the trace's
prediction of it.

    PYTHONPATH=src python tools/train_memory.py [--src DIR]

Builds the arch of `STEP` at its published width and depth (random
float32 master weights from seed 0) on the card, and runs one unmeshed
train step (`repro_torch.distributed.make_train_step`, one microbatch,
the config's compute type and remat) on `STEP`'s batch x sequence
tokens drawn from a numpy seed (and seeded frames for an
encoder-decoder).  Prints
``torch.cuda.max_memory_allocated()`` over the step — the parameters,
AdamW's moments and the batch, resident before it, included — beside
the trace's prediction for the same step on ``meta`` tensors
(`repro_torch.launch.dryrun.lower_train_step`: arguments plus
temporaries) and the storages it names at its peak.  A step that runs
out of device memory prints ``OOM``.  ``--src`` imports the package from
another checkout's ``src`` (a parent commit's, which may lack the
prediction).  `chip_smoke.py`'s ``[memory]`` phase runs the same step."""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

# (arch, batch, seq): whisper-tiny's per-device batch of ``train_4k`` on
# the 16 x 16 mesh
STEP = ("whisper-tiny", 16, 4096)


def measure(cfg, batch: int, seq: int) -> Dict:
    """One train step of ``cfg`` on the card: {"peak_bytes",
    "before_bytes", "loss"}, or {"oom": True, ...} where it does not
    fit."""
    import torch
    from repro_torch.distributed import TrainStepConfig, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_adamw

    model = build_model(cfg)
    params = model.init(seed=0, device="cuda", param_dtype=torch.float32)
    opt = init_adamw(params)
    rng = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, seq)).astype(np.int32)).cuda()}
    if cfg.frontend == "frames":
        b["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(
                "cuda", getattr(torch, cfg.dtype))
    step = make_train_step(model, AdamWConfig(),
                           step_cfg=TrainStepConfig(microbatches=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = {"before_bytes": int(before)}
    try:
        params, opt, metrics = step(params, opt, b)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        out.update(oom=True, error=str(e).splitlines()[0][:300],
                   peak_bytes=int(torch.cuda.max_memory_allocated()))
        return out
    finally:
        del params, opt, b
    out.update(oom=False, loss=loss,
               peak_bytes=int(torch.cuda.max_memory_allocated()))
    torch.cuda.empty_cache()
    return out


def predict(cfg, batch: int, seq: int) -> Optional[Dict]:
    """The trace's arguments, temporaries and named peak storages for
    the same step, or None where the package has no such trace."""
    try:
        from repro_torch.launch.dryrun import lower_train_step
    except ImportError:
        return None
    low = lower_train_step(cfg, batch, seq)
    return {"argument_bytes": low.memory["argument_bytes"],
            "temp_bytes": low.memory["temp_bytes"],
            "peak_bytes": low.memory["argument_bytes"]
            + low.memory["temp_bytes"],
            "peak_storages": low.peak_storages}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this src directory")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_memory: no CUDA device")
    from repro_torch.configs import get_config
    arch, batch, seq = STEP
    cfg = get_config(arch)
    pred = predict(cfg, batch, seq)
    got = measure(cfg, batch, seq)
    rep = {"arch": arch, "batch": batch, "seq": seq, "measured": got,
           "predicted": pred}
    peak = "OOM" if got["oom"] else f"{got['peak_bytes'] / 1e9:.3f} GB"
    line = (f"[memory] {arch} {batch} x {seq}, one unmeshed "
            f"train step: torch.cuda.max_memory_allocated {peak}")
    if pred is not None:
        line += f" | trace {pred['peak_bytes'] / 1e9:.3f} GB"
        if not got["oom"]:
            line += f", measured / trace {got['peak_bytes'] / pred['peak_bytes']:.3f}"
    print(line, flush=True)
    print(json.dumps(rep), flush=True)
    return rep


if __name__ == "__main__":
    main()
