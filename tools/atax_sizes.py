"""atax on the card at every instance of its pretune grid (512^2 to
4096^2 in float32 and bfloat16, and 1024 x 512 float32): the static
pick under the H100 (a ring row), the sweep row the ranking puts first
(`kernels.atax.sweep_pick`: the pick before atax had ring rows) and
every other row of the table, each held against the plain version and
timed in events time per call (`chip_smoke.time_ms`); the two picks
also in device time per call (`chip_smoke.device_us`, `torch.profiler`).
One line an instance, then the rows as JSON:

    python3 tools/atax_sizes.py [--json FILE]
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main(argv):
    import torch
    import chip_smoke
    from repro_torch import tuning_cache as tc
    from repro_torch.kernels import api
    from repro_torch.kernels import atax as ax

    dev = torch.device("cuda")
    spec = api.get_spec("atax")
    rows = []
    for sig in spec.pretune:
        sig = dict(sig)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        a, x = spec.make_inputs(gen, **sig)
        want = ax.atax_plain(a, x).float()
        static = tc.lookup_or_tune("atax", spec="h100",
                                   db=tc.TuningDatabase(), **sig)["tile"]
        before = ax.sweep_pick(sig["m"], sig["n"], sig["dtype"])
        tol = 2e-2 if sig["dtype"] == "bfloat16" else 1e-3
        ms, err = {}, 0.0
        for tile in ax.ATAX_TILES:
            got = ax.atax_cuda(a, x, tile=tile).float()
            err = max(err, (got - want).abs().max().item())
            ms[tile] = chip_smoke.time_ms(
                lambda t=tile: ax.atax_cuda(a, x, tile=t))
        if err > tol * (1 + want.abs().max().item()):
            chip_smoke.fail(f"atax {sig}: max|err| {err:.3g} past {tol}")
        best = min(ms, key=ms.get)
        sweep_best = min((t for t in ms if ax.ATAX_TILES[t][2] == ax.SWEEP),
                         key=ms.get)
        dev_us = {t: chip_smoke.device_us(
            lambda t=t: ax.atax_cuda(a, x, tile=t)) for t in (static, before)}
        row = dict(sig=sig, static=static, before=before, best=best,
                   sweep_best=sweep_best, ms=ms, device_us=dev_us,
                   max_abs_err=err)
        rows.append(row)
        print(f"[atax] {sig['m']}x{sig['n']} {sig['dtype']}: static "
              f"{static} {1e3 * ms[static]:.2f} us ({dev_us[static]:.2f} "
              f"device), before {before} {1e3 * ms[before]:.2f} us "
              f"({dev_us[before]:.2f} device), static / before "
              f"{ms[static] / ms[before]:.3f}x; best {best} "
              f"{1e3 * ms[best]:.2f} us (static regret "
              f"{ms[static] / ms[best]:.3f}x), best sweep {sweep_best} "
              f"{1e3 * ms[sweep_best]:.2f} us; max|err| {err:.3g}",
              flush=True)
        del a, x, want
    print(chip_smoke.card_line(), flush=True)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
