#!/usr/bin/env python3
"""The pipeline tier's picks read against the times of a chip_smoke log.

    PYTHONPATH=src python tools/pipeline_regret.py LOG [--sass DUMP ...]

For every instance that ``chip_smoke.py``'s ``[ranking]``, ``[tuner]``
and ``[extend]`` phases time row by row in LOG (the measured time of
each feasible H100 row), ranks the same rows on this machine's CPU with
``lookup_or_tune(model="pipeline")`` and with the default (eq6, the H100
roofline) model, and prints each pick's regret on LOG's times and the
Spearman of the pipeline's predicted times over the rows.  Run against
an earlier run's log, it predicts what the next run's pipeline lines
will read.  With ``--sass DUMP ...`` (``cuobjdump -res-usage -sass`` of
the port's library and extensions, as `repro_torch.kernels._cuda.
disassemble` writes them, plain or gzipped) the H100 rows are ranked by
their SASS streams
(`repro_torch.core.sass.use_sass`), as ``[extract]`` ranks them; where
LOG prints a row's device time (``device us:``) its regret on device
time is printed too.  Needs no card.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

import repro_torch.kernels  # noqa: F401  (registers every kernel)
from repro_torch import tuning_cache as tc
from repro_torch.core.predict import spearman
from repro_torch.core.sass import parse_sass, use_sass
from repro_torch.kernels import api

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import _pipeline_rank  # noqa: E402  (the same ranking)

# [ranking]'s instances, in the order chip_smoke times them
D, F = 3072, 24576
RANKING = [("matmul", dict(m=256, n=D, k=F, dtype="bfloat16")),
           ("rms_norm", dict(m=256, d=D, dtype="bfloat16")),
           ("matmul", dict(m=4, n=D, k=F, dtype="bfloat16")),
           ("rms_norm", dict(m=4, d=D, dtype="bfloat16")),
           ("rms_norm", dict(m=4, d=24576, dtype="bfloat16"))] + [
    ("mlp_matmul", dict(m=m, d=D, f=F, act="gelu", dtype="bfloat16"))
    for m in (256, 4, 64, 1)] + [
    ("flash_attention", dict(b=b, h=h, sq=s, skv=s, d=hd, causal=True,
                             dtype=dt))
    for b, h, s, hd, dt in ((4, 16, 64, 256, "bfloat16"),
                            (1, 16, 64, 256, "bfloat16"),
                            (4, 16, 64, 256, "float32"),
                            (1, 16, 1024, 128, "bfloat16"),
                            (2, 4, 1024, 128, "float32"))]
CASE = re.compile(r"\[(tuner|extend)\] (\w+) (\d+)x(\d+)(?:x(\d+))? "
                  r"(\w+): space")


def _measured(line: str) -> Dict[str, float]:
    """{row: measured ms} of a chip_smoke 'name pred/meas; ...' line."""
    body = line.split("   ", 1)[1]
    body = body[len("pred/meas ms: "):] \
        if body.startswith("pred/meas ms: ") else body
    out = {}
    for part in body.split("; "):
        name, pm = part.rsplit(" ", 1)
        out[name] = float(pm.split("/")[1])
    return out


def _case_sig(kid: str, m: re.Match) -> dict:
    a, b, c, dt = int(m.group(3)), int(m.group(4)), m.group(5), m.group(6)
    if kid in ("matvec", "atax", "bicg"):
        return dict(m=a, n=b, dtype=dt)
    if kid == "jacobi3d":
        return dict(z=a, y=b, x=int(c), dtype=dt)
    if kid == "matmul":
        return dict(m=a, n=b, k=int(c), dtype=dt)
    return dict(y=a, x=b, dtype=dt)          # stencil2d


def _device(lines: List[str], i: int) -> Optional[Dict[str, float]]:
    """{row: device us} of the [ranking] instance whose head is line i,
    where the log prints its device times."""
    for ln in lines[i + 2:i + 12]:
        if ln.startswith("[ranking]   device us: "):
            body = ln[len("[ranking]   device us: "):]
            return {part.rsplit(" ", 1)[0]: float(part.rsplit(" ", 1)[1])
                    for part in body.split("; ")}
        if "feasible rows" in ln:
            return None
    return None


def cases(lines: List[str]) -> List[Tuple[str, str, dict, Dict[str, float],
                                          Optional[Dict[str, float]]]]:
    """(phase, kernel, signature, {row: measured ms}, {row: device us} or
    None) of every timed instance in a chip_smoke log."""
    heads = [i for i, ln in enumerate(lines)
             if ln.startswith("[ranking] ") and "feasible rows" in ln
             and "on device" not in ln]
    if len(heads) != len(RANKING):
        raise SystemExit(f"{len(heads)} [ranking] instances in the log, "
                         f"expected {len(RANKING)}")
    out = [("ranking", kid, sig, _measured(lines[i + 1]), _device(lines, i))
           for (kid, sig), i in zip(RANKING, heads)]
    for i, ln in enumerate(lines):
        m = CASE.match(ln)
        if m:
            kid = m.group(2)
            out.append((m.group(1), kid, _case_sig(kid, m), {
                f"{kid}/{t}": v for t, v in _measured(lines[i + 1]).items()},
                None))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("log", help="a chip_smoke.py output")
    ap.add_argument("--sass", nargs="+", default=(),
                    help="disassemblies of the port's library and its "
                    "extensions (rank the H100 rows by their SASS "
                    "streams)")
    args = ap.parse_args(argv)
    with open(args.log, encoding="utf-8") as f:
        lines = f.read().splitlines()
    scope = contextlib.nullcontext()
    if args.sass:
        funcs = {}
        for path in args.sass:
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                funcs.update(parse_sass(f.read()))
        scope = use_sass(funcs)
    with scope:
        _report(lines)


def _report(lines: List[str]) -> None:
    for phase, kid, sig, meas, dev in cases(lines):
        spec = api.get_spec(kid)
        names = list(meas)
        pts = [dict(zip(("variant", "tile"), n.split("/")))
               if spec.variant_ids() else {"tile": n.split("/")[1]}
               for n in names]
        ptimes, ppick = _pipeline_rank(kid, sig, pts)
        label = lambda p: f"{p.get('variant', kid)}/{p['tile']}"
        pipe = label(ppick)
        eq6 = label(tc.lookup_or_tune(kid, spec="h100",
                                      db=tc.TuningDatabase(), **sig))
        best = min(meas.values())
        print(f"[{phase}] {kid} {sig}: pipeline {pipe} regret "
              f"{meas[pipe] / best:.3f}x spearman "
              f"{spearman(ptimes, [meas[n] for n in names]):.2f} | eq6 "
              f"{eq6} regret {meas[eq6] / best:.3f}x")
        if dev is not None:
            low = min(dev.values())
            print(f"[{phase}]   on device time: pipeline {pipe} regret "
                  f"{dev[pipe] / low:.3f}x spearman "
                  f"{spearman(ptimes, [dev[n] for n in names]):.2f} | eq6 "
                  f"{eq6} regret {dev[eq6] / low:.3f}x")


if __name__ == "__main__":
    main()
