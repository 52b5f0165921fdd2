"""Autotuning deep-dive: every Orio search strategy against the static
pruner on the blocked matmul, plus Eq. 6 coefficient calibration.

    python -m repro_torch.examples.autotune_kernel [--device cpu]

On the CUDA card (the default) the space is the GEMM's compiled tile
table, every evaluation times a kernel with `KernelTuner`'s own CUDA
events, and the calibration refits the H100 roofline model
(`default_hopper_model`) to those times.  With ``--device cpu`` the
space is the reference's TPU block space under the process-default
target, the plain version is timed on the CPU, and the calibration
refits `default_tpu_model` — CPU times, a demonstration of the
workflow, not a device measurement.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (ExhaustiveSearch, GeneticSearch, KernelTuner,
                              NelderMeadSearch, RandomSearch,
                              SimulatedAnnealing, calibrate,
                              default_hopper_model, default_tpu_model)
from repro_torch.core.autotuner import _median_time
from repro_torch.kernels import make_tunable_matmul, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device for the timed runs (default: the "
                    "CUDA card; 'cpu' times the plain version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kernel = make_tunable_matmul(m=512, n=512, k=512, device=device)
    tuner = KernelTuner(kernel, repeats=2)
    budget = 8

    print(f"target {tuner.spec.name}, device {device}: space "
          f"{kernel.space.size} configurations; empirical budget "
          f"{budget}\n")
    print("strategy              evals  best(us)  reduction")
    rows = {}
    for name, strat in [
        ("exhaustive", ExhaustiveSearch()),
        ("random", RandomSearch(seed=0)),
        ("simulated-anneal", SimulatedAnnealing(seed=0)),
        ("genetic", GeneticSearch(seed=0, pop=4)),
        ("nelder-mead", NelderMeadSearch(seed=0)),
    ]:
        rep = tuner.tune(mode="empirical", strategy=strat,
                         empirical_budget=(None if name == "exhaustive"
                                           else budget))
        rows[name] = rep
        print(f"{name:<20s} {rep.empirical_evals:>5d} "
              f"{rep.best_measured_s*1e6:>9.1f} "
              f"{rep.search_space_reduction:>9.1%}  -> {rep.best_params}")

    rep_s = tuner.tune(mode="static")
    rows["static"] = rep_s
    print(f"{'STATIC (paper)':<20s} {0:>5d} {'n/a':>9s} "
          f"{rep_s.search_space_reduction:>9.1%}  -> {rep_s.best_params}")

    # --- calibration (paper §VII: models informed by prior benchmarks) --
    print("\ncalibrating Eq. 6 coefficients on this device's timings...")
    pts = kernel.space.enumerate()
    mixes = [tuner._info(p).mix for p in pts]
    inputs = kernel.make_inputs()
    times = [_median_time(kernel.build(p), inputs, 2) for p in pts]
    base = (default_hopper_model(tuner.spec) if tuner.hopper
            else default_tpu_model(mode="sum"))
    fit = calibrate(mixes, times, base=base, mode="sum")
    eb = np.mean([abs(base.time(m) - t) / t for m, t in zip(mixes, times)])
    ef = np.mean([abs(fit.time(m) - t) / t for m, t in zip(mixes, times)])
    print(f"mean relative error: default ({base.name})={eb:.2f} "
          f"calibrated={ef:.2f}")
    rows["calibration"] = dict(default=float(eb), calibrated=float(ef),
                               base=base.name)
    return rows


if __name__ == "__main__":
    main()
