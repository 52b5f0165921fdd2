#!/usr/bin/env python3
"""Per-device work of the port's meshed steps against the reference's
compiled SPMD program, cell by cell.

    PYTHONPATH=src python tools/mesh_work.py [--archs a,b] \
        [--shapes train_4k,decode_32k] [--layers N] [--multi-pod] \
        [--json OUT]

For each (arch, shape) cell on the production mesh (pod256, or pod512
with ``--multi-pod``), the port's record comes from
`repro_torch.launch.dryrun.dryrun_cell` (a fake process group, meta
DTensors, the traced per-device program) and the reference's from its
own ``repro.launch.dryrun.dryrun_cell`` compiled in a subprocess on
host devices.  Two patches are made inside that subprocess, none in the
reference's files: ``make_production_mesh`` builds its mesh with
``AxisType.Auto`` axes (under jax 0.9 the reference's own builds
Explicit axes, on which whisper's cell fails), and with ``--layers N``
``get_config`` returns the config cut to N layers (both stacks of an
encoder-decoder), the same cut the port's side takes through
``dryrun_cell(cfg=)``.  Both records' ``flops`` are the per-device
mix's ``mxu_flops``.

Prints one line per cell: port and reference flops per device, their
ratio, each over ``model_flops / chips``, collective bytes of both, and
the port's ``memory_analysis`` peak (arguments + temporaries).  The
reference compiles take most of the time: about 10-60 s a cell at two
layers on a CPU, minutes at full depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "mamba2-1.3b",
         "hymba-1.5b", "starcoder2-3b", "gemma-7b", "whisper-tiny")
SHAPES = ("train_4k", "decode_32k")

REF_SCRIPT = r"""
import os, sys, json, dataclasses, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import AxisType
import repro.configs
import repro.launch.mesh as rmesh
from repro.launch import dryrun as rdry

spec = json.loads(sys.argv[1])

def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

rmesh.make_production_mesh = auto_mesh
_get = repro.configs.get_config

def cut_config(arch):
    cfg = _get(arch)
    n = spec["layers"]
    if n:
        kw = {"n_layers": n}
        if getattr(cfg, "enc_layers", 0):
            kw["enc_layers"] = n
        cfg = dataclasses.replace(cfg, **kw)
    return cfg

repro.configs.get_config = cut_config
out = []
for arch, shape in spec["cells"]:
    t0 = time.time()
    try:
        rec = rdry.dryrun_cell(arch, shape, spec["multi_pod"])
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "status": "error",
               "error": repr(e)[:400]}
    rec["wall_s"] = round(time.time() - t0, 1)
    out.append(rec)
json.dump(out, sys.stdout)
"""


def cut_config(arch: str, layers: int):
    """The port's config of ``arch`` cut to ``layers`` layers (both
    stacks of an encoder-decoder); 0 keeps the published depth."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if not layers:
        return cfg
    kw = {"n_layers": layers}
    if getattr(cfg, "enc_layers", 0):
        kw["enc_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def start_reference(cells: Sequence[Tuple[str, str]], layers: int,
                    multi_pod: bool = False) -> subprocess.Popen:
    """The reference's dry-run of ``cells`` in a subprocess (JAX on host
    devices); read its records with `reference_records`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    spec = json.dumps({"cells": [list(c) for c in cells],
                       "layers": layers, "multi_pod": multi_pod})
    return subprocess.Popen([sys.executable, "-c", REF_SCRIPT, spec],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def reference_records(proc: subprocess.Popen,
                      timeout: Optional[float] = None) -> Dict:
    """{(arch, shape): record} from a `start_reference` subprocess."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"reference dry-run failed:\n{err[-3000:]}")
    return {(r["arch"], r["shape"]): r for r in json.loads(out)}


def port_record(arch: str, shape: str, layers: int,
                multi_pod: bool = False) -> Dict:
    from repro_torch.launch import dryrun
    return dryrun.dryrun_cell(arch, shape, multi_pod,
                              cfg=cut_config(arch, layers))


def peak_bytes(rec: Dict) -> Optional[int]:
    """Arguments plus temporaries of a record's ``memory_analysis``."""
    mem = rec.get("memory_analysis") or {}
    if mem.get("argument_bytes") is None or mem.get("temp_bytes") is None:
        return None
    return mem["argument_bytes"] + mem["temp_bytes"]


def row(port: Dict, ref: Dict) -> Dict:
    """The comparison of one cell's two records."""
    out = {"arch": port["arch"], "shape": port["shape"],
           "port_status": port["status"], "ref_status": ref.get("status")}
    if port["status"] != "ok" or ref.get("status") != "ok":
        out["error"] = port.get("error") or ref.get("error")
        return out
    per = port["model_flops"] / port["chips"]
    out.update(
        port_flops=port["flops"], ref_flops=ref["flops"],
        ratio=port["flops"] / ref["flops"],
        port_over_model=port["flops"] / per,
        ref_over_model=ref["flops"] / per,
        port_coll=port["collective_bytes"], ref_coll=ref["collective_bytes"],
        port_peak=peak_bytes(port), ref_peak=peak_bytes(ref),
        arg_bytes=port["arg_bytes_per_device"])
    return out


def measure(archs: Sequence[str], shapes: Sequence[str], layers: int,
            multi_pod: bool = False) -> List[Dict]:
    cells = [(a, s) for a in archs for s in shapes]
    proc = start_reference(cells, layers, multi_pod)
    try:
        ports = {}
        for a, s in cells:
            try:
                ports[a, s] = port_record(a, s, layers, multi_pod)
            except Exception as e:  # noqa: BLE001  (recorded, printed)
                ports[a, s] = {"arch": a, "shape": s, "status": "error",
                               "error": repr(e)[:400]}
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    refs = reference_records(proc)
    return [row(ports[c], refs[c]) for c in cells]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--layers", type=int, default=2,
                    help="depth cut of both packages; 0 = published")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None, help="write the rows here")
    args = ap.parse_args(argv)
    rows = measure(args.archs.split(","), args.shapes.split(","),
                   args.layers, args.multi_pod)
    fmt = lambda v: "-" if v is None else f"{v:.4g}"
    print("arch shape port_flops ref_flops port/ref port/(mf/chips) "
          "ref/(mf/chips) port_coll ref_coll port_peak ref_peak")
    for r in rows:
        if "ratio" not in r:
            print(r["arch"], r["shape"], "port", r["port_status"], "ref",
                  r["ref_status"], (r.get("error") or "")[:200])
            continue
        print(r["arch"], r["shape"], *(fmt(r[k]) for k in (
            "port_flops", "ref_flops", "ratio", "port_over_model",
            "ref_over_model", "port_coll", "ref_coll", "port_peak",
            "ref_peak")), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
