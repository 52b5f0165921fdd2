"""Quickstart: tune a CUDA-paper kernel statically, then check it.

    python -m repro_torch.examples.quickstart [--smoke] [--device cpu]

The paper's headline capability: near-optimal launch parameters with
ZERO kernel executions — plus the tuning database: the second identical
tune is a pure cache hit — then held against hybrid and empirical
search, which time the kernel (``--smoke`` skips them).

It runs on the CUDA card by default and tunes for the target the card
is (the H100's compiled tile table); without a card it raises unless
``--device cpu`` is given, which tunes for the process-default target
and times the plain PyTorch versions on the CPU.  atax at 1024 x 512
float32 (the reference quickstart's size) is 2 MB: on the card it sits
in the 50 MB L2, so its measured times are L2 times, not device-memory
times.
"""
from __future__ import annotations

import argparse

from repro_torch import tuning_cache
from repro_torch.core import KernelTuner, default_target
from repro_torch.kernels import make_tunable_atax, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="skip the hybrid/empirical sweeps")
    ap.add_argument("--device", default=None,
                    help="torch device for the timed runs (default: the "
                    "CUDA card; 'cpu' times the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    target = default_target()
    print(f"device {device}, target {target.name}")
    # atax (paper Table IV): y = A^T (A x), fused single-pass kernel.
    kernel = make_tunable_atax(m=1024, n=512, dtype="float32",
                               device=device)
    tuner = KernelTuner(kernel, repeats=3)

    print("== static mode (the paper's contribution: no executions) ==")
    rep = tuner.tune(mode="static")
    print(rep.summary())
    print(f"   suggested params: {rep.best_params}")
    print(f"   predicted time:   {rep.best_predicted_s*1e6:.1f} us")
    print(f"   search-space reduction: "
          f"{rep.search_space_reduction:.1%}")

    print("\n== same tune again: served from the tuning database ==")
    rep_c = KernelTuner(make_tunable_atax(m=1024, n=512, dtype="float32",
                                          device=device),
                        repeats=3).tune(mode="static")
    stats = tuning_cache.get_default_db().stats.as_dict()
    print(f"   from_cache={rep_c.from_cache} params={rep_c.best_params} "
          f"db stats={stats}")
    assert rep_c.from_cache and rep_c.best_params == rep.best_params

    if args.smoke:
        print("\n(--smoke: skipping the hybrid/empirical sweeps)")
        return {"static": rep}

    print("\n== hybrid mode (static shortlist, measure top-2) ==")
    rep_h = tuner.tune(mode="hybrid", empirical_budget=2)
    print(rep_h.summary())

    print("\n== empirical exhaustive (what the paper avoids) ==")
    rep_e = tuner.tune(mode="empirical")
    print(rep_e.summary())
    print(f"   measured best: {rep_e.best_params} "
          f"({rep_e.best_measured_s*1e6:.1f} us"
          + (", operands in L2)" if device.type == "cuda" else ")"))

    meas = {tuple(sorted(r["params"].items())): r["measured_s"]
            for r in rep_e.table}
    static_s = meas.get(tuple(sorted(rep.best_params.items())))
    if static_s is not None:
        print(f"   static pick measured: {rep.best_params} "
              f"({static_s*1e6:.1f} us), regret "
              f"{static_s / rep_e.best_measured_s:.3f}x")
    agree = rep.best_params == rep_e.best_params
    print(f"\nstatic pick == empirical optimum: {agree}")
    if rep_e.spearman_static_vs_measured is not None:
        print(f"rank correlation (static vs measured): "
              f"{rep_e.spearman_static_vs_measured:.3f}")
    return {"static": rep, "hybrid": rep_h, "empirical": rep_e}


if __name__ == "__main__":
    main()
