#!/usr/bin/env python3
"""Per-device work of the port's meshed steps against the reference's
compiled SPMD program, cell by cell.

    PYTHONPATH=src python tools/mesh_work.py [--archs a,b] \
        [--shapes train_4k,decode_32k] [--layers N] [--multi-pod] \
        [--json OUT] [--ref-cache FILE] [--storages]

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
``dryrun_cell(cfg=)``; and the reference's ``collective_stats`` also
records, for each collective, its result's elements, whether the
program holds each in bfloat16, and whether every user keeps only its
device's slice (`program_collectives` counts them as the program moves
them).  Both records' ``flops`` are the per-device mix's ``mxu_flops``.

Prints one line per cell: port and reference flops per device, their
ratio, each over ``model_flops / chips``, collective bytes of both and
their ratio, both memory peaks (arguments + temporaries) and their two
parts; then both sides' collective bytes and counts by kind, and with
``--storages`` the port's storages held at its peak.  The reference
compiles take most of the time: about 10-60 s a cell at two layers on a
CPU, minutes at full depth; ``--ref-cache`` keeps their records, keyed
by a hash of this tool and the reference's sources.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
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

import re
import repro.core.hlo as rhlo
_stats = rhlo.collective_stats
_IOTA = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_CHAIN = ("bitcast", "copy", "reshape", "transpose")
last = {}


def _dtype(comp, name):
    shapes = comp.symbols.get(name) or [("", ())]
    return shapes[0][0]


def _bf16_value(mod, comp, name, depth=4):
    # a value the program holds in bfloat16 that the CPU compile widened:
    # a convert from bf16 (or a round trip through it), directly or at
    # the root of a fusion, through layout-only ops
    ins = comp.by_name.get(name)
    while ins is not None and depth > 0 and ins.opcode in _CHAIN:
        ins, depth = comp.by_name.get(ins.operands[0]), depth - 1
    if ins is None:
        return False
    if ins.opcode == "fusion":
        inner = mod.computations.get(ins.callees[0]) if ins.callees \
            else None
        root = next((i for i in reversed(inner.instructions)
                     if i.line.lstrip().startswith("ROOT")), None) \
            if inner else None
        return root is not None and _bf16_value(mod, inner, root.name,
                                                depth)
    if ins.opcode != "convert":
        return False
    src = comp.by_name.get(ins.operands[0])
    return _dtype(comp, ins.operands[0]) == "bf16" or (
        src is not None and src.opcode == "convert"
        and src.ret_shapes[0][0] == "bf16")


def _sliced_by_partition(comp, name):
    # every user of the value takes the partition id: each device keeps
    # its own slice (an all-reduce so used is a reduce-scatter split in
    # two by the CPU compile)
    users = [i for i in comp.instructions if name in i.operands]
    if not users:
        return False
    for u in users:
        if u.opcode == "get-tuple-element":
            return False
        if not any((comp.by_name.get(o) is not None
                    and comp.by_name[o].opcode == "partition-id")
                   for o in u.operands):
            return False
    return True


def _elements(mod, comp, ins):
    # per element of the result: dtype, elements, held in bf16, sliced
    gtes = {}
    for i in comp.instructions:
        if i.opcode == "get-tuple-element" and ins.name in i.operands:
            m = re.search(r"index=(\d+)", i.line)
            gtes.setdefault(int(m.group(1)) if m else 0, []).append(i.name)
    promoted = "_promoted" in ins.line
    out = []
    for k, (dt, shape) in enumerate(ins.ret_shapes):
        opnd = ins.operands[k] if k < len(ins.operands) else None
        bf16 = dt == "f32" and (promoted or (
            opnd is not None and _bf16_value(mod, comp, opnd)))
        sliced = False
        if ins.opcode == "all-reduce":
            names = gtes.get(k, []) if len(ins.ret_shapes) > 1 \
                else [ins.name]
            sliced = bool(names) and all(_sliced_by_partition(comp, n)
                                         for n in names)
        n = 1
        for d in shape:
            n *= d
        out.append([dt, n, bf16, sliced])
    return out


def collective_stats(mod):
    # each collective of the compiled module as the reference counts it,
    # with what the tool needs to count it as the program it stands for
    # (one entry per instruction, in the reference's own order)
    st = _stats(mod)
    lines = []
    for cname, comp in mod.computations.items():
        if mod.multipliers.get(cname, 0.0) <= 0:
            continue
        for ins in comp.instructions:
            if rhlo._base_collective(ins.opcode) is not None:
                m = rhlo._OPNAME_RE.search(ins.line)
                g = _IOTA.search(ins.line)
                lines.append((ins.opcode, _elements(mod, comp, ins),
                              m.group(1) if m else "",
                              int(g.group(2)) if g else None))
    last["ops"] = [dict(kind=c.kind, bytes=c.bytes_out, mult=c.executions,
                        group=iota or c.group_size,
                        computation=c.computation, opcode=op,
                        elements=elems, op_name=name)
                   for c, (op, elems, name, iota) in zip(st.ops, lines)]
    last["unknown_loops"] = mod.unknown_loops
    return st

rhlo.collective_stats = collective_stats
out = []
for arch, shape in spec["cells"]:
    t0 = time.time()
    last.clear()
    try:
        rec = rdry.dryrun_cell(arch, shape, spec["multi_pod"])
        rec["collective_ops"] = last.get("ops", [])
        rec["hlo_unknown_loops"] = last.get("unknown_loops")
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


_WIDTH = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
          "bf16": 2, "f16": 2, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
          "pred": 1}


def program_collectives(ref: Dict, skip=()) -> Tuple[Dict[str, float],
                                                     Dict[str, float]]:
    """The reference's collectives (bytes and counts by kind, loop-aware)
    counted as its program moves them, not as the CPU compile widened
    them: a value the program holds in bfloat16 (a collective fed by a
    conversion from bf16, or an all-reduce whose reduction XLA promoted)
    at 2 bytes an element, where the CPU's collectives carry it in f32;
    and an all-reduce whose every user keeps only its device's slice (by
    the partition id) as the reduce-scatter it stands for, its output
    the slice.  Each op's output bytes, times its loop multiplier, as
    ``collective_stats`` counts them.  Ops named in ``skip`` (`BY_DESIGN`
    entries) are left out."""
    by_kind: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    for op in ref.get("collective_ops") or []:
        if skip and _matches(op, skip):
            continue
        sliced = [e[3] for e in op["elements"]]
        kind = "reduce-scatter" if sliced and all(sliced) else op["kind"]
        for dt, n, bf16, cut in op["elements"]:
            b = n * (2 if bf16 else _WIDTH.get(dt, 4))
            if cut:
                b /= max(op["group"] or 1, 1)
            k = "reduce-scatter" if cut else op["kind"]
            by_kind[k] = by_kind.get(k, 0.0) + b * op["mult"]
        counts[kind] = counts.get(kind, 0.0) + op["mult"]
    return by_kind, counts


# Collectives of the reference's compiled program that the port's step
# does not have by design, cell by cell: (kind, a pattern of the op's
# op_name, what the port does instead).  `row` also reports the
# reference's bytes without them (``ref_coll_kept``).
BY_DESIGN: Dict[Tuple[str, str], Tuple[Tuple[str, str, str], ...]] = {}
_DP = ("all-reduce", r"bhqs,bshd->bqhd/dot_general$",
       "the attention backward's dP (float32, a query chunk of "
       "[batch, heads, 1024, seq]) all-reduced over the head_dim shards "
       "of heads the model dim does not divide; the port runs the core "
       "on whole heads and has no such sum")
for _arch in ("hymba-1.5b", "starcoder2-3b", "starcoder2-7b"):
    BY_DESIGN[_arch, "train_4k"] = (_DP,)
BY_DESIGN["qwen2-moe-a2.7b", "train_4k"] = (
    ("all-reduce", r"scatter-add$",
     "every rank's tokens scattered into the whole (experts x capacity) "
     "buffer and the buffer all-reduced; the port gathers the tokens "
     "and each rank fills only its own part of the buffer"),
    ("all-gather", r"closed_call/(checkpoint/)?(rematted_computation/)?"
     r"reshape$", "the same buffer gathered whole"))
for _arch in ("qwen1.5-110b", "chameleon-34b"):
    BY_DESIGN[_arch, "decode_32k"] = (
        ("all-gather", r"broadcast_in_dim$",
         "each layer's whole K/V cache gathered (the repeat of 8 KV "
         "heads to 64); the port's core reads its cache shard and "
         "all-reduces the scores"),)


def _matches(op: Dict, named) -> bool:
    import re
    return any(op["kind"] == kind and re.search(pat, op["op_name"] or "")
               for kind, pat, _ in named)


def memory_split(rec: Dict) -> Tuple[Optional[int], Optional[int]]:
    """(argument bytes, temp bytes) of a record's ``memory_analysis``."""
    mem = rec.get("memory_analysis") or {}
    return mem.get("argument_bytes"), mem.get("temp_bytes")


def peak_bytes(rec: Dict) -> Optional[int]:
    """Arguments plus temporaries of a record's ``memory_analysis``."""
    args, temp = memory_split(rec)
    if args is None or temp is None:
        return None
    return args + temp


def row(port: Dict, ref: Dict) -> Dict:
    """The comparison of one cell's two records."""
    out = {"arch": port["arch"], "shape": port["shape"],
           "port_status": port["status"], "ref_status": ref.get("status")}
    if port["status"] != "ok" or ref.get("status") != "ok":
        out["error"] = port.get("error") or ref.get("error")
        return out
    per = port["model_flops"] / port["chips"]
    (port_args, port_temp), (ref_args, ref_temp) = (memory_split(port),
                                                    memory_split(ref))
    ref_kind, ref_counts = program_collectives(ref)
    ref_coll = sum(ref_kind.values())
    named = BY_DESIGN.get((port["arch"], port["shape"]), ())
    kept = sum(program_collectives(ref, named)[0].values())
    out.update(
        port_flops=port["flops"], ref_flops=ref["flops"],
        ratio=port["flops"] / ref["flops"],
        port_over_model=port["flops"] / per,
        ref_over_model=ref["flops"] / per,
        port_coll=port["collective_bytes"], ref_coll=ref_coll,
        ref_coll_cpu=ref["collective_bytes"], ref_coll_kept=kept,
        coll_ratio_kept=port["collective_bytes"] / kept if kept else None,
        by_design=[why for _, _, why in named],
        coll_ratio=(port["collective_bytes"] / ref_coll if ref_coll
                    else None),
        port_coll_by_kind=port["collectives_by_kind"],
        ref_coll_by_kind=ref_kind,
        port_coll_counts=port["collective_counts"],
        ref_coll_counts=ref_counts,
        port_peak=peak_bytes(port), ref_peak=peak_bytes(ref),
        port_args=port_args, port_temp=port_temp,
        ref_args=ref_args, ref_temp=ref_temp,
        peak_storages=port.get("peak_storages") or [],
        arg_bytes=port["arg_bytes_per_device"])
    return out


@functools.lru_cache(maxsize=None)
def _sources() -> str:
    """A hash of the files that make a reference record: this tool (its
    patches and counting) and the reference package's sources."""
    import glob
    import hashlib
    h = hashlib.sha256()
    for path in [os.path.abspath(__file__)] + sorted(glob.glob(
            os.path.join(REPO, "src", "repro", "**", "*.py"),
            recursive=True)):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _cache_key(arch: str, shape: str, layers: int, multi_pod: bool) -> str:
    return (f"{arch}|{shape}|{layers}|{'pod512' if multi_pod else 'pod256'}"
            f"|{_sources()}")


def measure(archs: Sequence[str], shapes: Sequence[str], layers: int,
            multi_pod: bool = False,
            ref_cache: Optional[str] = None) -> List[Dict]:
    """One `row` a cell.  ``ref_cache`` (a JSON file) keeps the
    reference's records across runs: cells found there, made by the
    same tool and reference sources (`_sources`), are not compiled
    again, and the ones compiled now are added to it."""
    cells = [(a, s) for a in archs for s in shapes]
    cached: Dict = {}
    if ref_cache and os.path.exists(ref_cache):
        with open(ref_cache) as f:
            cached = json.load(f)
    todo = [c for c in cells
            if _cache_key(*c, layers, multi_pod) not in cached]
    proc = start_reference(todo, layers, multi_pod) if todo else None
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
    if proc is not None:
        for c, rec in reference_records(proc).items():
            cached[_cache_key(*c, layers, multi_pod)] = rec
        if ref_cache:
            with open(ref_cache, "w") as f:
                json.dump(cached, f)
    return [row(ports[c], cached[_cache_key(*c, layers, multi_pod)])
            for c in cells]


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.4g}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--layers", type=int, default=2,
                    help="depth cut of both packages; 0 = published")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--ref-cache", default=None,
                    help="JSON file of the reference's records, reused "
                         "and extended across runs")
    ap.add_argument("--storages", action="store_true",
                    help="print the port's storages alive at its peak")
    args = ap.parse_args(argv)
    rows = measure(args.archs.split(","), args.shapes.split(","),
                   args.layers, args.multi_pod, args.ref_cache)
    cols = ("port_flops", "ref_flops", "ratio", "port_over_model",
            "ref_over_model", "port_coll", "ref_coll", "coll_ratio",
            "port_peak", "ref_peak", "port_args", "ref_args", "port_temp",
            "ref_temp")
    print("arch shape " + " ".join(cols))
    for r in rows:
        if "ratio" not in r:
            print(r["arch"], r["shape"], "port", r["port_status"], "ref",
                  r["ref_status"], (r.get("error") or "")[:200])
            continue
        print(r["arch"], r["shape"], *(_fmt(r[k]) for k in cols),
              flush=True)
        for kind in sorted(set(r["port_coll_by_kind"])
                           | set(r["ref_coll_by_kind"])):
            print(f"  {kind}: port {_fmt(r['port_coll_by_kind'].get(kind))}"
                  f" B in {_fmt(r['port_coll_counts'].get(kind))}, "
                  f"reference {_fmt(r['ref_coll_by_kind'].get(kind))} B "
                  f"in {_fmt(r['ref_coll_counts'].get(kind))}")
        if args.storages:
            for st in r["peak_storages"]:
                print(f"  peak: {st['bytes']:.4g} B {st['op']} "
                      f"{st['dtype']}{st['shape']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
