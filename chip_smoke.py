#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. build   — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
             for sm_90a (one nvcc per source, in parallel) and print each
             compiled instantiation's registers beside the analysis'
             declared estimate;
2. kernels — every kernel wrapper on the card at the shapes the serving
             path gives it (the matmul at decode, M = 4, on its split-K
             GEMV pick and at prefill, M = 256, on its TMA + wgmma pick,
             and the split-K reduction; rms_norm on its row-in-register
             pick, and on a row too long for it (4 x 24576, gemma-7b's
             d_ff) on its thread-block-cluster pick; attention's
             tensor-core families on their dispatch picks: flash bf16
             (mma.sync) at batch 4, flash float32 (3xTF32) and blocked
             (whole-KV tensor-core rows, bf16) at their serve shapes; the
             older families on the rows the analysis ranks first among
             them: rms_norm's warp rows on the long row and on a ragged
             one (4 x 24570, their own domain), flash and blocked on
             their SIMT rows; the gated MLP's wgmma rows at prefill,
             M = 256, and at decode, its whole-D GEMV rows at M = 4 and
             1 with a bitwise repeat, its SIMT rows and split, each
             beside the four-call torch composite),
             held against its plain PyTorch version (float32 attention
             at 2e-4, the rest at 2e-2), and timed beside that version,
             its roofline bound and, where one PyTorch call computes the
             same function, that call, with the host time per call of
             matmul, rms_norm and the attention wrappers and the device
             time per launch (`torch.profiler`) of rms_norm, the
             attention kernels and their library calls; then
             every feasible (variant, tile) of the serving instances
             (the gated MLP at all four: M = 256, 4, 64, 1),
             of rms_norm's long row, of float32 attention at the serve
             shape and of two long-sequence instances, timed beside the
             H100 analysis' prediction (rank correlation, the static
             pick's regret, each attention instance labelled in or out
             of the sample the analysis' fitted constant came from), and
             beside it the pipeline tier's pick (``model="pipeline"``),
             regret and Spearman (a finding, not a gate; `[tuner]` and
             `[extend]` print the same for their cases);
2c. pretuned — the shipped pretuned databases: ``python -m
             repro_torch.tuning_cache pretune --verify --all-targets`` in
             a fresh process (all seven files regenerate bit for bit,
             with the census of the models that ranked them), then each
             of ``h100_sxm.jsonl``'s 86 records launched on the card at
             its signature with its params and held against the plain
             version (the distinct tiles per kernel printed);
3. check   — gemma-smoke in float32: prefill logits and 8 greedy tokens
             of the tuned CUDA path against the plain path on the CPU;
4. serve   — the serving path: gemma-7b at full width and depth
             (random weights from a seed) served through
             ``repro_torch.launch.serve --tuned-ops --pretune
             --assert-frozen`` for two requests (4 x 64 prompt tokens, 32
             generated; 1 x 64, 8 generated), with every launch counter
             set to 0 before and read after;
4b. deploy — the shipped-database path: ``pretune --config gemma-7b
             --target h100-sxm`` into a database and ``export`` to JSONL
             (fresh processes), then gemma-7b served 4 x 64 + 32 with
             ``--tuning-db`` that JSONL and no ``--pretune``: no rank,
             every dispatch frozen, ``[serve]``'s greedy tokens, the
             time to the first token beside ``[serve]``'s;
4c. service — a remote tuner: ``python -m repro_torch.tuning_cache
             serve`` in a subprocess warmed with that JSONL, gemma-7b
             served 1 x 64 + 8 with ``--tuning-server`` from a cold
             dispatch state (every unique instance answered by the
             service, zero local ranks), then against a server that
             drops every request (the client degrades to local ranks);
             both with ``[serve]``'s tokens, params and kernels;
             launch counters set to 0 before and read after each path;
5. profile — `torch.profiler` over a few decode steps of the first
             request's shape: device time by kernel, idle share, and
             the device time per launch of the B1, B2, B3 and B5 kernels
             (decode steps, then one prefill for attention);
6. tuner   — the tuning path, the paper's own experiment: `KernelTuner`
             over the Table IV kernels (matvec, atax, BiCG at 8192 x 8192
             in float32 and bfloat16, jacobi3d at 256^3 float32) and the
             decode down-projection GEMM, in static (asserted to launch
             nothing, then served from the database), hybrid and
             empirical mode (jacobi3d's plane rows also ranked on their
             own), and the quickstart; launch counters set to 0 before
             and read after;
7. dispatch — each Table IV op, and rms_norm on the long row, through
             ``ops`` after ``freeze()``: every dispatch frozen, no runtime
             tune, every kernel launched (rms_norm's on its cluster
             rows); launch counters set to 0 before and read after;
8. extend  — the kernel API's extension path: stencil2d (found by
             discovery in ``kernels/``) through ``ops.stencil2d`` under the
             H100 at its pretune grid, 8192^2 f32/bf16 (fatal unless the
             analysis picks a TMA ring row there) and a ragged 1000 x 1003
             grid (a march row), `KernelTuner` on it at 8192^2 f32 and
             bf16 (static, hybrid, exhaustive), the examples
             ``custom_kernel`` (saxpy2d, declared in its own file),
             ``annotated_tuning`` and ``autotune_kernel``, and the
             mega-space matmul factory (2048^3 bf16, timed beside its
             bound and ``torch.matmul``, and on device time beside
             ``torch.matmul``'s); launch counters set to 0 before and read
             after.  Then both extension kernels are held against
             their plain versions at 8192^2 f32/bf16 and timed (stencil2d
             on its ring pick and on the march row the analysis ranks
             first among its own, each beside its device time, the bound,
             the plain version and the conv2d composite; saxpy2d beside
             ``torch.add``, both on device time), and the 4.2M-point mega
             space is ranked under tpu-v5e (host work).

Phase 2 also holds the Table IV kernels against their plain versions at
the tuner's sizes (above the 50 MB L2), jacobi3d on its static pick (a
TMA ring row) and on the plane row the analysis ranks first among its
own.  Every row of phases 2 and 2b launches the tile dispatch picks
(`lookup_or_tune` under the H100).  The
last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``; the line before them is the JSON
``{"kernels": [...]}`` of every ported kernel, each with its launches on
the path that launches it.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published peaks of one H100 SXM (NVIDIA datasheet, dense): device
# memory rate, and the arithmetic rate per operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# (kernel, source in the repo, the TPU kernel it replaces)
KERNELS = {
    "matmul": ("src/repro_torch/kernels/csrc/gemm.cu",
               "src/repro/kernels/matmul.py:34"),
    "matmul_prefill": ("src/repro_torch/kernels/csrc/gemm.cu",
                       "src/repro/kernels/matmul.py:34"),
    "splitk_reduce": ("src/repro_torch/kernels/csrc/gemm.cu",
                      "src/repro/kernels/matmul.py:34"),
    "rms_norm": ("src/repro_torch/kernels/csrc/rms_norm.cu",
                 "src/repro/kernels/rms_norm.py:30"),
    "flash": ("src/repro_torch/kernels/csrc/attention.cu",
              "src/repro/kernels/flash_attention.py:49"),
    "flash_tf32": ("src/repro_torch/kernels/csrc/attention.cu",
                   "src/repro/kernels/flash_attention.py:49"),
    "flash_simt": ("src/repro_torch/kernels/csrc/attention.cu",
                   "src/repro/kernels/flash_attention.py:49"),
    "rms_cluster": ("src/repro_torch/kernels/csrc/rms_norm.cu",
                    "src/repro/kernels/rms_norm.py:30"),
    "rms_simt": ("src/repro_torch/kernels/csrc/rms_norm.cu",
                 "src/repro/kernels/rms_norm.py:30"),
    "rms_simt_ragged": ("src/repro_torch/kernels/csrc/rms_norm.cu",
                        "src/repro/kernels/rms_norm.py:30"),
    "blocked_tc": ("src/repro_torch/kernels/csrc/attention.cu",
                   "src/repro/kernels/flash_attention.py:122"),
    "blocked_simt": ("src/repro_torch/kernels/csrc/attention.cu",
                     "src/repro/kernels/flash_attention.py:122"),
    "fused": ("src/repro_torch/kernels/csrc/gemm.cu",
              "src/repro/kernels/mlp_matmul.py:54"),
    "fused_simt": ("src/repro_torch/kernels/csrc/gemm.cu",
                   "src/repro/kernels/mlp_matmul.py:54"),
    "stream": ("src/repro_torch/kernels/csrc/gemm.cu",
               "src/repro/kernels/mlp_matmul.py:132"),
    "stream_simt": ("src/repro_torch/kernels/csrc/gemm.cu",
                    "src/repro/kernels/mlp_matmul.py:132"),
    "split": ("src/repro_torch/kernels/csrc/gemm.cu",
              "src/repro/kernels/mlp_matmul.py:192"),
    "matvec": ("src/repro_torch/kernels/csrc/blas2.cu",
               "src/repro/kernels/matvec.py:31"),
    "atax": ("src/repro_torch/kernels/csrc/blas2.cu",
             "src/repro/kernels/atax.py:32"),
    "bicg": ("src/repro_torch/kernels/csrc/blas2.cu",
             "src/repro/kernels/bicg.py:29"),
    "jacobi3d": ("src/repro_torch/kernels/csrc/jacobi3d.cu",
                 "src/repro/kernels/jacobi3d.py:37"),
    "jacobi_plane": ("src/repro_torch/kernels/csrc/jacobi3d.cu",
                     "src/repro/kernels/jacobi3d.py:37"),
    "stencil2d": ("src/repro_torch/kernels/csrc/stencil2d.cu",
                  "src/repro/kernels/stencil2d.py:51"),
    "stencil2d_march": ("src/repro_torch/kernels/csrc/stencil2d.cu",
                        "src/repro/kernels/stencil2d.py:51"),
    "saxpy2d": ("src/repro_torch/examples/saxpy2d.cu",
                "examples/custom_kernel.py:34"),
}
SERVE_KERNELS = ("matmul", "matmul_prefill", "splitk_reduce", "rms_norm",
                 "flash", "flash_tf32", "flash_simt", "rms_simt",
                 "rms_simt_ragged", "blocked_tc", "blocked_simt", "fused",
                 "fused_simt", "stream", "stream_simt", "split")
# the launch counter of a kernel listed under another name: the prefill
# matmul row is the wgmma family's GEMM kernel (matmul and the split
# MLP's passes), the flash row its bf16 tensor-core family's kernel, the
# rms_norm row its vector rows' kernel, the jacobi3d row its ring rows'
# kernel, the stencil2d row its ring rows' kernel, the fused and stream
# rows their Hopper families' kernels (gated wgmma, whole-D gated GEMV)
# and the *_simt rows their SIMT kernels; the other attention, rms_norm,
# jacobi3d and stencil2d rows are one family each, counted by their
# wrappers under the row's name
COUNTER = {"matmul_prefill": "gemm_wgmma", "flash": "flash_mma",
           "rms_norm": "rms_vec", "rms_simt_ragged": "rms_simt",
           "jacobi3d": "jacobi_ring", "stencil2d": "stencil2d_ring",
           "fused": "gated_wgmma",
           "fused_simt": "gated_simt", "stream": "stream_gemv",
           "stream_simt": "stream_simt"}
TABLE4 = ("matvec", "atax", "bicg", "jacobi3d")
# rms_norm's long row: gemma-7b's d_ff, past the vector rows' 16384
RMS_LONG = dict(m=4, d=24576, dtype="bfloat16")
EXTEND = ("stencil2d", "saxpy2d")

# The Table IV kernels' sizes on the card: every operand above the 50 MB
# L2, so times are device-memory times; and the tolerances of
# tests/test_kernels.py (float32; bfloat16 is 2e-2).
TABLE4_SHAPES = {"matvec": dict(m=8192, n=8192), "atax": dict(m=8192, n=8192),
                 "bicg": dict(m=8192, n=8192),
                 "jacobi3d": dict(z=256, y=256, x=256)}
TABLE4_TOL = {"matvec": 2e-4, "atax": 1e-3, "bicg": 1e-3, "jacobi3d": 1e-5}

# the main path's requests: (batch, prompt_len, gen)
REQUESTS = ((4, 64, 32), (1, 64, 8))


def fail(msg: str) -> None:
    print(f"[smoke] FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 2, budget_ms: float = 25.0) -> float:
    """Mean device time of ``fn()`` (CUDA events) over as many calls as
    fill ``budget_ms`` (5 to 500), after ``warmup`` calls."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def run(n):
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n

    for _ in range(warmup):
        fn()
    once = run(1)
    return run(int(min(500, max(5, budget_ms / max(once, 1e-3)))))


def bound(nbytes: float, flops: float, dtype: str):
    """Least time for the work: inputs read once and outputs written once
    at the HBM rate, against the operations at the type's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def device_us(fn, calls: int = 100, tries: int = 4) -> float:
    """Device time per call of ``fn()`` in microseconds: the self device
    time `torch.profiler` records over ``calls`` back-to-back calls (every
    kernel the call launches), over ``calls``.  A profile whose kernel
    count is not a whole number a call has lost records and would read
    short: it is taken again, at most ``tries`` times.  If none was
    whole, the fullest profile that kept nine tenths of its k launches a
    call is read per recorded launch (its time x k / its launches);
    else fatal."""
    import torch
    fn()
    torch.cuda.synchronize()
    fullest = (0, 0.0)
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)), ev.count)
                for ev in prof.key_averages()]
        kernels = sum(n for t, n in rows if t > 0)
        total = sum(t for t, _ in rows)
        if kernels and kernels % calls == 0:
            return total / calls
        print(f"[smoke] the profiler recorded {kernels} kernels over "
              f"{calls} calls: profiling again", flush=True)
        fullest = max(fullest, (kernels, total))
    kernels, total = fullest
    k = round(kernels / calls)
    if k >= 1 and kernels >= 0.9 * k * calls:
        print(f"[smoke] read per recorded launch: {kernels} kernels of "
              f"{k * calls}", flush=True)
        return total * k / kernels
    fail(f"the profiler recorded {kernels} kernels over {calls} calls, "
         f"{tries} times: device time not measured")


def host_us(fn, calls: int = 200) -> float:
    """Host time per call of ``fn()`` in microseconds (enqueue only: no
    synchronize inside the window)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    import numpy as np
    import ctypes
    from repro_torch.examples import custom_kernel
    from repro_torch.kernels import _cuda, api, stencil2d
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import mlp_matmul as mlp
    t0 = time.perf_counter()
    # the library and the two extensions, each nvcc started at once
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(f) for f in (_cuda.library, stencil2d.extension,
                                       custom_kernel.extension)]
        lib, st_lib, sx_lib = (f.result() for f in futs)
    logs = {"library": _cuda.build_log()}
    logs.update({n: _cuda.build_log(n) for n in EXTEND})
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    for what, log in logs.items():
        print(f"[build]   {what}: nvcc {log.get('build_s', 0.0):.1f} s, "
              f"cached={log.get('cached')} -> {log.get('path')}")
        for name, text in log.get("ptxas", {}).items():
            spills = [l.strip() for l in text.splitlines()
                      if "spill" in l and "0 bytes spill stores, 0 bytes "
                      "spill loads" not in l]
            if spills:
                print(f"[build] {name}: spills: {spills[:4]}")
    sig = {"matmul": dict(m=4, n=3072, k=24576, dtype="bfloat16"),
           "rms_norm": dict(m=4, d=3072, dtype="bfloat16"),
           "flash_attention": dict(b=4, h=16, sq=64, skv=64, d=256,
                                   causal=True, dtype="bfloat16"),
           "mlp_matmul": dict(m=4, d=3072, f=24576, act="gelu",
                              dtype="bfloat16")}
    sig.update({k: dict(v, dtype="float32")
                for k, v in TABLE4_SHAPES.items()})
    kinds = {("matmul", None): 0, ("mlp_matmul", "fused"): 1,
             ("mlp_matmul", "stream"): 2, ("mlp_matmul", "split"): 0,
             ("rms_norm", None): 3, ("flash_attention", "flash"): 4,
             ("flash_attention", "blocked"): 5, ("matvec", None): 6,
             ("atax", None): 7, ("bicg", None): 8, ("jacobi3d", None): 9}
    regs, smem, thr = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    print("[build] kernel/variant tile: declared regs | compiled numRegs "
          "f32, bf16 | static smem")
    for (kid, vid), kind in kinds.items():
        spec = api.get_spec(kid)
        h = spec._hopper[vid]
        declared = np.broadcast_to(np.asarray(h.analysis(
            {api.TILE_AXIS: np.asarray(h.tiles)}, **sig[kid])["regs"]),
            (len(h.tiles),))
        for i, tile in enumerate(h.tiles):
            got = []
            for dt in (0, 1):
                if (dt == 0 and (
                        (kind == 0 and mm.GEMM_TILES[tile][5] == mm.WGMMA)
                        or (kind == 1
                            and mlp.GATED_TILES[tile][5] == mm.WGMMA)
                        or (kind == 4 and fa.FLASH_TILES[tile][3] == fa.MMA))
                        or dt == 1 and kind == 4
                        and fa.FLASH_TILES[tile][3] == fa.TF32):
                    got.append("-")         # one element type only
                    continue
                rc = lib.repro_kernel_attrs(kind, i, dt, ctypes.byref(regs),
                                            ctypes.byref(smem),
                                            ctypes.byref(thr))
                if rc != 0:
                    fail(f"cudaFuncGetAttributes({kid}/{vid} {tile}): {rc}")
                got.append(regs.value)
            print(f"[build]   {kid}/{vid or kid} {tile}: "
                  f"{int(declared[i])} | {got[0]}, {got[1]} | "
                  f"{smem.value} B")
    ext_sig = {"stencil2d": dict(y=8192, x=8192),
               "saxpy2d": dict(m=8192, n=8192)}
    print("[build] extension tile: declared regs f32, bf16 | compiled "
          "numRegs f32, bf16 | static smem")
    for kid, elib in (("stencil2d", st_lib), ("saxpy2d", sx_lib)):
        h = api.get_spec(kid)._hopper[None]
        declared = [np.broadcast_to(np.asarray(h.analysis(
            {api.TILE_AXIS: np.asarray(h.tiles)}, **ext_sig[kid],
            dtype=dt)["regs"]), (len(h.tiles),))
            for dt in ("float32", "bfloat16")]
        attrs = getattr(elib, f"{kid}_attrs")
        for i, tile in enumerate(h.tiles):
            got = []
            for dt in (0, 1):
                rc = attrs(i, dt, ctypes.byref(regs), ctypes.byref(smem),
                           ctypes.byref(thr))
                if rc != 0:
                    fail(f"cudaFuncGetAttributes({kid} {tile}): {rc}")
                got.append(regs.value)
            print(f"[build]   {kid} (extension) {tile}: "
                  f"{int(declared[0][i])}, {int(declared[1][i])} "
                  f"| {got[0]}, {got[1]} | {smem.value} B")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _static_times(info):
    """Predicted times of H100 rows as dispatch ranks them
    (`static_times_batch` with the model `lookup_or_tune` uses): the
    model time floored by the wave-stretched time, +inf if infeasible."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.predict import static_times_batch
    from repro_torch.tuning_cache.registry import _model_for
    return static_times_batch(None, _model_for(H100_SXM), F=info.F,
                              pipe=info.pipe, feasible=info.feasible)


def _pipeline_rank(kid: str, sig, pts):
    """The pipeline tier on H100 rows ``pts`` of ``kid`` at ``sig``: each
    row's predicted seconds (the scoreboard over the Hopper ISA table,
    +inf where infeasible) and the row `lookup_or_tune(model="pipeline")`
    picks, ranked into a fresh database."""
    from repro_torch import tuning_cache as tc
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels import api
    from repro_torch.tuning_cache.registry import _model_for
    spec = api.get_spec(kid)
    model = _model_for(H100_SXM, "pipeline")
    times = [model.time_info(spec.hopper_static_info(p, H100_SXM, **sig))
             for p in pts]
    pick = tc.lookup_or_tune(kid, spec="h100", model="pipeline",
                             db=tc.TuningDatabase(), **sig)
    return times, pick


def _dispatch_tile(kid: str, vid, sig):
    """The tile the serving path launches for implementation ``vid``:
    dispatch's own pick (`lookup_or_tune` under the H100, into a fresh
    database) when it picks ``vid``; for a variant dispatch does not
    pick at ``sig``, that variant's best tile under the same ranking."""
    import numpy as np
    from repro_torch import tuning_cache as tc
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels import api
    p = tc.lookup_or_tune(kid, spec="h100", db=tc.TuningDatabase(), **sig)
    if p.get("variant") == vid:
        return p[api.TILE_AXIS]
    h = api.get_spec(kid)._hopper[vid]
    return h.tiles[int(np.argmin(_static_times(h.info(h.tiles, sig,
                                                      H100_SXM))))]


def _family_tile(kid: str, vid, sig, family_of) -> str:
    """The row the H100 ranking puts first among the rows of variant
    ``vid`` for which ``family_of(tile)`` is true: how an older family
    is held where dispatch picks a newer one."""
    import numpy as np
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels import api
    h = api.get_spec(kid)._hopper[vid]
    tiles = [t for t in h.tiles if family_of(t)]
    return tiles[int(np.argmin(_static_times(h.info(tiles, sig,
                                                    H100_SXM))))]


def phase_kernels(dev):
    """Returns {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, shape}}."""
    import torch
    import torch.nn.functional as F
    from repro_torch import tuning_cache as tc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import mlp_matmul as mlp
    from repro_torch.kernels import rms_norm as rn

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf)

    d, f, h, hd, s = 3072, 24576, 16, 256, 64
    results = {}

    def record(name, got, want, fn, plain, lib_fn, nbytes, flops,
               shape, peak="bfloat16", device=False, tol=2e-2,
               composite=None):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        try:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=tol, atol=tol)
        except AssertionError as e:
            fail(f"{name} at {shape} disagrees with its plain version: "
                 f"{str(e).splitlines()[0:4]}")
        b_ms, b_by = bound(nbytes, flops, peak)
        row = dict(max_abs_err=err, ms=time_ms(fn),
                   plain_ms=time_ms(plain),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=(time_ms(lib_fn)
                               if lib_fn is not None else None),
                   shape=shape, tile=shape.rpartition("tile ")[2])
        results[name] = row
        print(f"[kernels] {name} {shape}: max|err| {err:.3g} "
              f"(max|ref| {ref:.3g}, tol {tol:g} abs + {tol:g} rel) | kernel "
              f"{row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
              f"bound {b_ms:.4f} ms ({b_by}) | library "
              + (f"{row['library_ms']:.4f} ms" if lib_fn else "none"),
              flush=True)
        if device:
            row["device_us"] = device_us(fn)
            if lib_fn is not None:
                row["library_device_us"] = device_us(lib_fn)
            row["host_us"] = host_us(fn)
            print(f"[kernels]   {name}: device {row['device_us']:.2f} us "
                  f"per launch"
                  + (f" (library {row['library_device_us']:.2f} us per "
                     f"call)" if lib_fn is not None else "")
                  + f", host {row['host_us']:.1f} us per wrapper call "
                  f"(enqueue only)", flush=True)
        if composite is not None:
            # several PyTorch calls computing the same function: a
            # yardstick beside the kernel, not a library call
            what, comp = composite
            row["composite_ms"] = time_ms(comp)
            row["composite_device_us"] = device_us(comp)
            print(f"[kernels]   {name}: torch composite ({what}) "
                  f"{row['composite_ms']:.4f} ms, device "
                  f"{row['composite_device_us']:.2f} us per call",
                  flush=True)

    # decode-step matmul (down-projection): (4, 24576) . (24576, 3072)
    a, w = randn(4, f), randn(f, d, scale=f ** -0.5)
    tile = _dispatch_tile("matmul", None,
                          dict(m=4, n=d, k=f, dtype="bfloat16"))
    got = mm.matmul_cuda(a, w, tile=tile)
    record("matmul", got, mm.matmul_plain(a, w),
           lambda: mm.matmul_cuda(a, w, tile=tile),
           lambda: mm.matmul_plain(a, w), lambda: torch.matmul(a, w),
           2.0 * (4 * f + f * d + 4 * d), 2.0 * 4 * f * d,
           f"(4x{f}).({f}x{d}) bf16 tile {tile}")

    # RMSNorm at decode, (4, 3072), and at prefill, (256, 3072)
    for name, m in (("rms_norm", 4), ("rms_norm_prefill", 256)):
        x = randn(m, d)
        g = torch.randn(d, generator=gen, device=dev)
        gb = g.to(bf)
        tile = _dispatch_tile("rms_norm", None,
                              dict(m=m, d=d, dtype="bfloat16"))
        record(name, rn.rms_norm_cuda(x, g, tile=tile),
               rn.rms_norm_plain(x, g),
               lambda: rn.rms_norm_cuda(x, g, tile=tile),
               lambda: rn.rms_norm_plain(x, g),
               lambda: F.rms_norm(x, (d,), gb, 1e-6),
               2.0 * 2 * m * d + 4.0 * d, 4.0 * m * d,
               f"({m}x{d}) bf16 tile {tile}", device=True)

    # a row too long for the vector rows, (4, 24576) bf16 (gemma-7b's
    # d_ff): dispatch's pick, a cluster row, held bit for bit against a
    # second call; then the warp-per-row rows on the same row (the
    # analysis' first among them) and on a ragged row, (4, 24570), where
    # dispatch picks them
    m, dl = RMS_LONG["m"], RMS_LONG["d"]
    for name, d_row, family in (("rms_cluster", dl, rn.CLUSTER),
                                ("rms_simt", dl, rn.SIMT),
                                ("rms_simt_ragged", dl - 6, rn.SIMT)):
        x = randn(m, d_row)
        g = torch.randn(d_row, generator=gen, device=dev)
        sig = dict(m=m, d=d_row, dtype="bfloat16")
        tile = (_dispatch_tile("rms_norm", None, sig) if name != "rms_simt"
                else _family_tile("rms_norm", None, sig,
                                  lambda t: rn.RMS_TILES[t][2] == rn.SIMT))
        if rn.RMS_TILES[tile][2] != family:
            fail(f"rms_norm ({m}x{d_row}) bf16: {tile} is not of the "
                 f"family the {name} row holds")
        got = rn.rms_norm_cuda(x, g, tile=tile)
        if name == "rms_cluster":
            again = rn.rms_norm_cuda(x, g, tile=tile)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"rms_norm tile {tile}: two calls differ in their "
                     f"bits")
        record(name, got, rn.rms_norm_plain(x, g),
               lambda: rn.rms_norm_cuda(x, g, tile=tile),
               lambda: rn.rms_norm_plain(x, g),
               lambda: F.rms_norm(x, (d_row,), g.to(bf), 1e-6),
               2.0 * 2 * m * d_row + 4.0 * d_row, 4.0 * m * d_row,
               f"({m}x{d_row}) bf16 tile {tile}"
               + (" bitwise repeat ok" if name == "rms_cluster" else ""),
               device=True)

    # prefill attention at the serve shapes: flash's bf16 tensor-core
    # rows at batch 4, the blocked tensor-core rows at batch 1, each on
    # its variant's dispatch tile; flash's 3xTF32 rows at batch 4 in
    # float32; then the SIMT rows of both tables, each on the row the
    # analysis ranks first among them (float32 flash, bf16 blocked)
    fam = {"flash": lambda t: fa.FLASH_TILES[t][3],
           "blocked": lambda t: fa.BLOCKED_TILES[t][2]}
    launch = {"flash": fa.flash_cuda, "blocked": fa.blocked_cuda}
    for name, vid, b, dtype, family in (
            ("flash", "flash", 4, bf, fa.MMA),
            ("blocked_tc", "blocked", 1, bf, fa.TC),
            ("flash_tf32", "flash", 4, torch.float32, fa.TF32),
            ("flash_simt", "flash", 4, torch.float32, fa.SIMT),
            ("blocked_simt", "blocked", 1, bf, fa.SIMT)):
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        q, k, v = ((torch.randn((b, h, s, hd), generator=gen, device=dev)
                    ).to(dtype) for _ in range(3))
        sig = dict(b=b, h=h, sq=s, skv=s, d=hd, causal=True, dtype=dt)
        if family == fa.SIMT:
            tile = _family_tile("flash_attention", vid, sig,
                                lambda t: fam[vid](t) == fa.SIMT)
        else:
            tile = _dispatch_tile("flash_attention", vid, sig)
        if fam[vid](tile) != family:
            fail(f"{name} {dt}: the {vid} pick {tile} is not of the "
                 f"family this row holds")
        fn = launch[vid]
        pairs = b * h * s * (s + 1) / 2          # unmasked (row, col)
        eb = 4 if dt == "float32" else 2
        record(name, fn(q, k, v, True, tile=tile),
               fa.attention_plain(q, k, v, True),
               lambda: fn(q, k, v, True, tile=tile),
               lambda: fa.attention_plain(q, k, v, True),
               lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True),
               eb * 4.0 * b * h * s * hd, 4.0 * pairs * hd,
               f"({b}x{h}x{s}x{hd}) causal {dt} tile {tile}", peak=dt,
               device=True, tol=2e-4 if dt == "float32" else 2e-2)

    # the gated MLP's front half, gelu, bf16: (M, 3072).(3072, 24576) x2
    # at serving's decode (M = 4, 1) and prefill (M = 256).  The Hopper
    # rows on the dispatch pick at their serving shapes (wgmma gated
    # tiles at prefill and held at decode too, the whole-D GEMV at both
    # decodes, its bits checked against a second call); the SIMT rows
    # and split on the row the analysis ranks first among them; each
    # beside the four-call torch composite at its shape
    wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    family = {"fused": lambda t: mlp.GATED_TILES[t][5],
              "stream": lambda t: mlp.STREAM_TILES[t][5],
              "split": lambda t: None}
    launch = {"fused": mlp.fused_cuda, "stream": mlp.stream_cuda,
              "split": mlp.split_cuda}
    xs = {m: randn(m, d) for m in (256, 4, 1)}
    for name, vid, fam_want, m, picked in (
            ("fused", "fused", mm.WGMMA, 256, True),
            ("fused_decode", "fused", mm.WGMMA, 4, False),
            ("fused_simt", "fused", mm.SIMT, 4, False),
            ("fused_simt_prefill", "fused", mm.SIMT, 256, False),
            ("stream", "stream", mm.GEMV, 4, True),
            ("stream_m1", "stream", mm.GEMV, 1, True),
            ("stream_simt", "stream", mm.SIMT, 4, False),
            ("split", "split", None, 4, False),
            ("split_prefill", "split", None, 256, False)):
        x = xs[m]
        sig = dict(m=m, d=d, f=f, act="gelu", dtype="bfloat16")
        if picked:
            tile = _dispatch_tile("mlp_matmul", vid, sig)
            chosen = tc.lookup_or_tune("mlp_matmul", spec="h100",
                                       db=tc.TuningDatabase(), **sig)
            if (chosen["variant"], chosen["tile"]) != (vid, tile):
                fail(f"mlp_matmul {sig}: dispatch picks {chosen}, not "
                     f"the {vid} row this line holds")
        else:
            tile = _family_tile("mlp_matmul", vid, sig,
                                lambda t: family[vid](t) == fam_want)
        if family[vid](tile) != fam_want:
            fail(f"mlp_matmul {sig}: {vid}/{tile} is not of the family "
                 f"the {name} row holds")
        fn = launch[vid]
        got = fn(x, wg, wu, "gelu", tile=tile)
        repeat = ""
        if vid == "stream" and fam_want == mm.GEMV:
            again = fn(x, wg, wu, "gelu", tile=tile)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"mlp_matmul_stream tile {tile}: two calls differ in "
                     f"their bits")
            repeat = " bitwise repeat ok"
        record(name, got, mlp.mlp_plain(x, wg, wu, "gelu"),
               lambda: fn(x, wg, wu, "gelu", tile=tile),
               lambda: mlp.mlp_plain(x, wg, wu, "gelu"), None,
               2.0 * (m * d + 2 * d * f + m * f), 2.0 * 2 * m * d * f,
               f"({m}x{d}).({d}x{f}) x2 gelu bf16 tile {vid}/{tile}"
               + repeat, device=True,
               composite=("two matmuls + gelu + product, 4 calls",
                          lambda: F.gelu(x @ wg, approximate="tanh")
                          * (x @ wu)))
    # prefill matmul (down-projection of 4 x 64 tokens):
    # (256, 24576) . (24576, 3072)
    a = randn(256, f)
    tile = _dispatch_tile("matmul", None,
                          dict(m=256, n=d, k=f, dtype="bfloat16"))
    record("matmul_prefill", mm.matmul_cuda(a, w, tile=tile),
           mm.matmul_plain(a, w), lambda: mm.matmul_cuda(a, w, tile=tile),
           lambda: mm.matmul_plain(a, w), lambda: torch.matmul(a, w),
           2.0 * (256 * f + f * d + 256 * d), 2.0 * 256 * f * d,
           f"(256x{f}).({f}x{d}) bf16 tile {tile}")

    # the split-K reduction at the decode tile's workspace:
    # [SPLIT, 4, 3072] f32 -> (4, 3072) bf16
    split = mm.GEMM_TILES[results["matmul"]["tile"]][7]
    if split == 1:
        split = 16
    ws = torch.randn((split, 4, d), generator=gen, device=dev)
    got = mm.splitk_reduce_cuda(ws, bf)
    torch.cuda.synchronize()
    if not torch.equal(got, mm.splitk_reduce_plain(ws, bf)):
        fail("splitk_reduce differs in its bits from the plain version "
             "(the same f32 sums in the same order)")
    record("splitk_reduce", got, mm.splitk_reduce_plain(ws, bf),
           lambda: mm.splitk_reduce_cuda(ws, bf),
           lambda: mm.splitk_reduce_plain(ws, bf),
           lambda: torch.sum(ws, 0),
           4.0 * split * 4 * d + 2.0 * 4 * d, float(split - 1) * 4 * d,
           f"[{split}x4x{d}] f32 -> (4x{d}) bf16, library torch.sum "
           f"(f32 out)", peak="float32")

    # host cost of one matmul call (tensor maps encoded per wgmma call)
    for m in (4, 256):
        a = randn(m, f)
        tile = _dispatch_tile("matmul", None,
                              dict(m=m, n=d, k=f, dtype="bfloat16"))
        us = host_us(lambda: mm.matmul_cuda(a, w, tile=tile))
        print(f"[kernels] matmul host time per call, M={m} tile {tile}: "
              f"{us:.1f} us (enqueue only, no sync)")
    return results


def phase_table4(dev):
    """The Table IV kernels at TABLE4_SHAPES, float32 and bfloat16
    (jacobi3d float32): each held against its plain version on the same
    seeded inputs (`make_inputs`), atax and BiCG run twice and compared
    bit for bit, then timed beside the plain version, the bound and the
    library call.  Each row launches the tile that the tuning path picks
    (`lookup_or_tune` under the H100), jacobi3d's a ring row; jacobi3d
    also on the plane row the analysis ranks first among them.  Returns
    the float32 rows."""
    import torch
    from repro_torch import tuning_cache as tc
    from repro_torch.kernels import api
    from repro_torch.kernels import atax as ax
    from repro_torch.kernels import bicg as bc
    from repro_torch.kernels import jacobi3d as jc
    from repro_torch.kernels import matvec as mv

    launch = {"matvec": (mv.matvec_cuda, mv.matvec_plain),
              "atax": (ax.atax_cuda, ax.atax_plain),
              "bicg": (bc.bicg_cuda, bc.bicg_plain),
              "jacobi3d": (jc.jacobi3d_cuda, jc.jacobi3d_plain)}
    library = {"matvec": lambda a, x: torch.matmul(a, x),
               "atax": lambda a, x: torch.linalg.multi_dot([a.T, a, x])}
    composite = {"bicg": lambda a, p, r: (a @ p, a.T @ r)}
    results = {}
    for kid in TABLE4:
        for dtype in (("float32",) if kid == "jacobi3d"
                      else ("float32", "bfloat16")):
            sig = dict(TABLE4_SHAPES[kid], dtype=dtype)
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            args = api.get_spec(kid).make_inputs(gen, **sig)
            tile = tc.lookup_or_tune(kid, spec="h100",
                                     db=tc.TuningDatabase(),
                                     **sig)[api.TILE_AXIS]
            if kid == "jacobi3d" and jc.JACOBI_TILES[tile][3] != jc.RING:
                fail(f"jacobi3d {sig}: the static pick {tile} is not a "
                     f"ring row")
            results.update(_table4_row(kid, sig, dtype, tile, args,
                                       launch[kid], library.get(kid),
                                       composite.get(kid)))
            if kid == "jacobi3d":
                plane = _family_tile(
                    kid, None, sig,
                    lambda t: jc.JACOBI_TILES[t][3] == jc.PLANE)
                results["jacobi_plane"] = _table4_row(
                    kid, sig, dtype, plane, args, launch[kid], None,
                    None)[kid]
            del args
    torch.cuda.empty_cache()
    return results


def _table4_row(kid, sig, dtype, tile, args, launch, lib, comp):
    """One Table IV kernel at ``sig`` on ``tile``: held against its
    plain version (atax and BiCG also bit for bit against a second
    run), timed beside it, the bound and ``lib``; {kid: row} for
    float32, else {}."""
    import torch
    from repro_torch.core.hw import dtype_bytes
    fn, plain = launch
    got, want = fn(*args, tile=tile), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = TABLE4_TOL[kid] if dtype == "float32" else 2e-2
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    for g, w in zip(got, want):
        try:
            torch.testing.assert_close(g.float(), w.float(),
                                       rtol=tol, atol=tol)
        except AssertionError as e:
            fail(f"{kid} {dtype} tile {tile} disagrees with its "
                 f"plain version: {str(e).splitlines()[0:4]}")
    if kid in ("atax", "bicg"):
        again = fn(*args, tile=tile)
        again = again if isinstance(again, tuple) else (again,)
        torch.cuda.synchronize()
        if not all(torch.equal(g, h) for g, h in zip(got, again)):
            fail(f"{kid} {dtype}: two runs differ in their bits")
    eb = dtype_bytes(dtype)
    if kid == "jacobi3d":
        pts = sig["z"] * sig["y"] * sig["x"]
        nbytes, flops = 2.0 * pts * eb, 8.0 * pts
    else:
        m, n = sig["m"], sig["n"]
        vec = {"matvec": n + m, "atax": 2 * n, "bicg": 2 * (n + m)}
        nbytes = (float(m) * n + vec[kid]) * eb
        flops = (2.0 if kid == "matvec" else 4.0) * m * n
    b_ms, b_by = bound(nbytes, flops, dtype)
    row = dict(max_abs_err=err,
               ms=time_ms(lambda: fn(*args, tile=tile)),
               plain_ms=time_ms(lambda: plain(*args)),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=(time_ms(lambda: lib(*args))
                           if lib is not None else None),
               shape=f"{sig} tile {tile}")
    extra = ""
    if comp is not None:
        extra = (f" | torch composite (2 matmuls) "
                 f"{time_ms(lambda: comp(*args)):.4f} ms")
    if kid == "jacobi3d":
        row["device_us"] = device_us(lambda: fn(*args, tile=tile), calls=50)
        extra = f" | device {row['device_us']:.2f} us per launch"
    print(f"[kernels] {kid} {dtype} "
          f"{'x'.join(str(v) for v in TABLE4_SHAPES[kid].values())} "
          f"tile {tile}: max|err| {err:.3g} (tol {tol:g} abs + rel)"
          f"{' bitwise repeat ok' if kid in ('atax', 'bicg') else ''}"
          f" | "
          f"kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} "
          f"ms | bound {b_ms:.4f} ms ({b_by}) | library "
          + (f"{row['library_ms']:.4f} ms" if lib else "none")
          + extra, flush=True)
    return {kid: row} if dtype == "float32" else {}


# ---------------------------------------------------------------------------
# phase 2b: the static ranking against measured times
# ---------------------------------------------------------------------------


# kernels whose rows run shorter than a wrapper call's host time: their
# [ranking] also sets device time per launch (torch.profiler) beside the
# predictions, since back-to-back calls time the host there
DEVICE_RANKED = ("rms_norm", "flash_attention")


def phase_ranking(dev):
    """Time every feasible (variant, tile) of the main path's instances
    and set the H100 analysis' predicted times beside them, ranked as
    dispatch ranks them: Spearman rank correlation, the static pick (the
    row dispatch launches), the measured best, and the pick's regret
    (its time over the best's); for DEVICE_RANKED kernels the same on
    device time per launch."""
    import numpy as np
    import torch
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.predict import spearman
    from repro_torch import tuning_cache as tc
    from repro_torch.kernels import api
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import mlp_matmul as mlp
    from repro_torch.kernels import rms_norm as rn

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bf = torch.bfloat16
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev)
                                   * scale).to(bf)
    d, f = 3072, 24576
    launch = {
        ("matmul", None): lambda t, a, w: mm.matmul_cuda(a, w, tile=t),
        ("rms_norm", None): lambda t, x, g: rn.rms_norm_cuda(x, g, tile=t),
        ("flash_attention", "flash"):
            lambda t, q, k, v: fa.flash_cuda(q, k, v, True, tile=t),
        ("flash_attention", "blocked"):
            lambda t, q, k, v: fa.blocked_cuda(q, k, v, True, tile=t),
        ("mlp_matmul", "fused"):
            lambda t, x, g, u: mlp.fused_cuda(x, g, u, "gelu", tile=t),
        ("mlp_matmul", "stream"):
            lambda t, x, g, u: mlp.stream_cuda(x, g, u, "gelu", tile=t),
        ("mlp_matmul", "split"):
            lambda t, x, g, u: mlp.split_cuda(x, g, u, "gelu", tile=t),
    }
    cases = []
    for m in (256, 4):
        cases.append(("matmul", dict(m=m, n=d, k=f, dtype="bfloat16"),
                      (randn(m, f), randn(f, d, scale=f ** -0.5))))
        cases.append(("rms_norm", dict(m=m, d=d, dtype="bfloat16"),
                      (randn(m, d), torch.ones(d, device=dev))))
        if m == 4:
            # the long row: the warp rows against the cluster rows
            cases.append(("rms_norm", dict(RMS_LONG), (
                randn(RMS_LONG["m"], RMS_LONG["d"]),
                torch.ones(RMS_LONG["d"], device=dev))))
    # the gated MLP at serving's four instances: decode at batch 4 and
    # 1, prefill of 4 x 64 and 1 x 64 tokens, on one pair of weights
    wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    for m in (256, 4, 64, 1):
        cases.append(("mlp_matmul", dict(m=m, d=d, f=f, act="gelu",
                                         dtype="bfloat16"),
                      (randn(m, d), wg, wu)))
    # the serve's two prefill instances (the tensor-core rows' chain
    # constant, HopperSpec.mma_warp_flops, was fitted at the first and
    # the second shares its d and sq: in sample), float32 at the serve
    # shape (the 3xTF32 rows: no constant fitted to them), and two the
    # constant was not fitted to, d = 128 over 16 KV tiles, bf16 and
    # float32 (a pretune-grid row)
    sample = {}
    for b, h, s, hd, dt, label in (
            (4, 16, 64, 256, "bfloat16", "in sample (the fit's shape)"),
            (1, 16, 64, 256, "bfloat16", "in sample (the fit's d, sq)"),
            (4, 16, 64, 256, "float32", "TF32 rows out of sample"),
            (1, 16, 1024, 128, "bfloat16", "out of sample"),
            (2, 4, 1024, 128, "float32", "out of sample")):
        sig = dict(b=b, h=h, sq=s, skv=s, d=hd, causal=True, dtype=dt)
        tdt = torch.float32 if dt == "float32" else bf
        cases.append(("flash_attention", sig, tuple(
            torch.randn((b, h, s, hd), generator=gen, device=dev).to(tdt)
            for _ in range(3))))
        sample[repr(sig)] = label
    rows_out = []
    for kid, sig, args in cases:
        spec = api.get_spec(kid)
        pts = spec.hopper_space(**sig).enumerate()
        cols = {k: np.asarray([p[k] for p in pts]) for k in pts[0]}
        info = spec.hopper_info_batch(cols, H100_SXM, **sig)
        pred, meas, dev_ms, names, rows = [], [], [], [], []
        for p, t_pred in zip(pts, _static_times(info)):
            if not np.isfinite(t_pred):
                continue
            rows.append(p)
            fn = launch[(kid, p.get("variant"))]
            meas.append(time_ms(lambda: fn(p["tile"], *args), warmup=1))
            if kid in DEVICE_RANKED:
                dev_ms.append(device_us(lambda: fn(p["tile"], *args),
                                        calls=50) / 1e3)
            pred.append(float(t_pred) * 1e3)
            names.append(f"{p.get('variant', kid)}/{p['tile']}")
        pick = int(np.argmin(pred))
        chosen = tc.lookup_or_tune(kid, spec="h100", db=tc.TuningDatabase(),
                                   **sig)
        picked = f"{chosen.get('variant', kid)}/{chosen['tile']}"
        if names[pick] != picked:
            fail(f"{kid} {sig}: the ranking's pick {names[pick]} is not "
                 f"dispatch's {chosen}")
        best = int(np.argmin(meas))
        rho = spearman(pred, meas) if len(pred) > 2 else float("nan")
        regret = meas[pick] / meas[best]
        rows_out.append(dict(kernel=kid, sig=sig, rho=rho, regret=regret,
                             pick=names[pick], best=names[best]))
        shape = {k: v for k, v in sig.items() if k not in ("act",
                                                              "causal")}
        if repr(sig) in sample:
            shape["sample"] = sample[repr(sig)]
        print(f"[ranking] {kid} {shape}: {len(pred)} feasible rows, "
              f"spearman {rho:.2f}; pick {names[pick]} "
              f"pred {pred[pick]:.4f} ms meas {meas[pick]:.4f} ms; best "
              f"{names[best]} meas {meas[best]:.4f} ms; regret "
              f"{regret:.2f}x", flush=True)
        print("[ranking]   " + "; ".join(
            f"{n} {p:.4f}/{m:.4f}" for n, p, m in zip(names, pred, meas)))
        # the pipeline tier on the same rows (a finding, not a gate)
        ptimes, ppick = _pipeline_rank(kid, sig, rows)
        pname = f"{ppick.get('variant', kid)}/{ppick['tile']}"
        if pname not in names:
            fail(f"{kid} {sig}: the pipeline tier picked {pname}, which "
                 f"the H100 analysis marks infeasible")
        pi = names.index(pname)
        prho = spearman(ptimes, meas) if len(pred) > 2 else float("nan")
        rows_out[-1].update(pipe_pick=pname, pipe_regret=meas[pi] / meas[best],
                            pipe_rho=prho)
        print(f"[ranking] {kid} {shape} pipeline tier: pick {pname} pred "
              f"{ptimes[pi] * 1e3:.4f} ms meas {meas[pi]:.4f} ms, regret "
              f"{meas[pi] / meas[best]:.2f}x, spearman {prho:.2f} (eq6: "
              f"pick {names[pick]}, regret {regret:.2f}x, spearman "
              f"{rho:.2f})", flush=True)
        print("[ranking]   pipeline pred ms: " + "; ".join(
            f"{n} {1e3 * t:.4f}" for n, t in zip(names, ptimes)))
        if kid == "flash_attention":
            q, k, v = args
            lib_us = device_us(lambda: torch.nn.functional
                               .scaled_dot_product_attention(
                                   q, k, v, is_causal=True), calls=50)
            rows_out[-1]["library_device_us"] = lib_us
            print(f"[ranking] {kid} {shape}: SDPA {lib_us:.2f} us device "
                  f"time per call (the yardstick)", flush=True)
        if dev_ms:
            best = int(np.argmin(dev_ms))
            rho = spearman(pred, dev_ms) if len(pred) > 2 else float("nan")
            rows_out[-1].update(device_rho=rho,
                                device_regret=dev_ms[pick] / dev_ms[best],
                                device_best=names[best])
            print(f"[ranking] {kid} {shape} on device time per launch: "
                  f"spearman {rho:.2f}; pick {names[pick]} "
                  f"{1e3 * dev_ms[pick]:.2f} us; best {names[best]} "
                  f"{1e3 * dev_ms[best]:.2f} us; regret "
                  f"{dev_ms[pick] / dev_ms[best]:.2f}x; pipeline tier pick "
                  f"{pname} {1e3 * dev_ms[pi]:.2f} us, regret "
                  f"{dev_ms[pi] / dev_ms[best]:.2f}x, spearman "
                  f"{spearman(ptimes, dev_ms) if len(pred) > 2 else 0:.2f}",
                  flush=True)
            print("[ranking]   device us: " + "; ".join(
                f"{n} {1e3 * m:.2f}" for n, m in zip(names, dev_ms)))
    return rows_out


# ---------------------------------------------------------------------------
# phase 3: small-input check against the plain path on the CPU
# ---------------------------------------------------------------------------


def phase_check(dev):
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.target import use_target
    from repro_torch.distributed import make_serve_fns
    from repro_torch.models import build_model, map_params
    from repro_torch.models.layers import use_tuned_layers
    from repro_torch.models.params import Param

    cfg = dataclasses.replace(get_smoke("gemma-7b"), dtype="float32")
    model = build_model(cfg)
    p_cpu = model.init(seed=0, device="cpu")
    p_dev = map_params(lambda p: Param(p.value.to(dev), p.dims), p_cpu)
    prefill, decode = make_serve_fns(model)
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(0))

    def run(params, toks):
        logits, cache = prefill(params, {"tokens": toks})
        first = logits
        tok = logits[:, -1:].argmax(-1)
        out = [tok]
        for _ in range(8):
            logits, cache = decode(params, cache, tok)
            tok = logits[:, -1:].argmax(-1)
            out.append(tok)
        return first, torch.cat(out, 1)

    with torch.inference_mode(), use_tuned_layers(), use_target("h100"):
        l_dev, t_dev = run(p_dev, tokens.to(dev))
        l_cpu, t_cpu = run(p_cpu, tokens)
    err = (l_dev.float().cpu() - l_cpu.float()).abs().max().item()
    ok = torch.isfinite(l_dev).all().item() and err <= 2e-3
    same = torch.equal(t_dev.cpu(), t_cpu)
    print(f"[check] gemma-smoke f32, tuned CUDA path vs plain CPU path: "
          f"prefill logits max|err| {err:.3g} (tol 2e-3), greedy tokens "
          f"identical over 8 steps: {same}")
    if not ok or not same:
        fail("the card's tuned path disagrees with the plain path")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def phase_serve():
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config("gemma-7b")
    print(f"[serve] gemma-7b at full width: d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.n_layers} of {cfg.n_layers} layers (no depth "
          f"cut), {cfg.dtype} weights from seed 0")
    reports = []
    kernels.reset_launch_counts()           # the main path starts here
    for batch, plen, gen in REQUESTS:
        t0 = time.perf_counter()
        rep = serve.main(["--arch", "gemma-7b", "--batch", str(batch),
                          "--prompt-len", str(plen), "--gen", str(gen),
                          "--tuned-ops", "--pretune", "--assert-frozen"],
                         cfg=cfg)
        torch.cuda.empty_cache()
        if not rep["logits_finite"]:
            fail(f"non-finite logits serving {batch}x{plen}")
        toks = torch.tensor(rep["tokens"])
        if toks.shape != (batch, gen + 1) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            fail(f"bad tokens shape/range {tuple(toks.shape)}")
        print(f"[serve] request {batch}x{plen}+{gen}: prefill "
              f"{rep['prefill_ms']:.1f} ms, {rep['ms_per_token']:.2f} "
              f"ms/token, wall {time.perf_counter() - t0:.1f} s; first "
              f"tokens {rep['tokens'][0][:8]}", flush=True)
        reports.append(rep)
    launches = kernels.launch_counts()       # ... and ends here
    print(f"[serve] main-path launches: {launches}")
    return reports, launches


# ---------------------------------------------------------------------------
# phase 4b-4d: the tuning cache's deployment tiers
# ---------------------------------------------------------------------------

# each kernel's float32 tolerance on the shipped H100 picks: its own
# phase's (the Table IV and extension kernels', float32 attention's),
# the card tests' 2e-4 for the others; bfloat16 2e-2.  Inputs: the
# Table IV and extension kernels' own make_inputs, the rest drawn as
# their [kernels] rows draw them
PRETUNED_F32_TOL = {"matmul": 2e-4, "rms_norm": 2e-4,
                    "flash_attention": 2e-4, "mlp_matmul": 2e-4,
                    "stencil2d": 1e-5, **TABLE4_TOL}


def _tool(*args, timeout: float = 600) -> str:
    """Run ``python -m repro_torch.tuning_cache ARGS`` from the checkout;
    fatal on a non-zero exit.  Returns its standard output."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.tuning_cache",
                          *args], capture_output=True, text=True,
                         timeout=timeout, env=dict(os.environ, PYTHONPATH=SRC))
    if out.returncode != 0:
        fail(f"tuning_cache {' '.join(args)} exited {out.returncode}: "
             f"{(out.stdout + out.stderr)[-2000:]}")
    return out.stdout


def _pretuned_call(dev, kid: str, sig: dict, params: dict):
    """Launch ``kid`` on the card at ``sig`` with a record's ``params``
    and return (kernel output, plain output)."""
    import torch
    from repro_torch.kernels import api
    from repro_torch.kernels import atax as ax
    from repro_torch.kernels import bicg as bc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import jacobi3d as jc
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import mlp_matmul as mlp
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.kernels import stencil2d as st

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    dt = getattr(torch, sig["dtype"])
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev)
                                   * scale).to(dt)
    tile, vid = params["tile"], params.get("variant")
    if kid == "matmul":
        # the [kernels] phase's operands: B scaled by k^-1/2, so a dot's
        # terms do not grow with k (as the card tests draw them)
        a, b = randn(sig["m"], sig["k"]), randn(sig["k"], sig["n"],
                                                scale=sig["k"] ** -0.5)
        return mm.matmul_cuda(a, b, tile=tile), mm.matmul_plain(a, b)
    if kid == "rms_norm":
        args = (randn(sig["m"], sig["d"]),
                1 + 0.1 * torch.randn(sig["d"], generator=gen, device=dev))
        return rn.rms_norm_cuda(*args, tile=tile), rn.rms_norm_plain(*args)
    if kid == "flash_attention":
        b, h, d = sig["b"], sig["h"], sig["d"]
        q, k, v = (randn(b, h, sig["sq"], d), randn(b, h, sig["skv"], d),
                   randn(b, h, sig["skv"], d))
        fn = fa.flash_cuda if vid == "flash" else fa.blocked_cuda
        return (fn(q, k, v, sig["causal"], tile=tile),
                fa.attention_plain(q, k, v, sig["causal"]))
    if kid == "mlp_matmul":
        m, d, f = sig["m"], sig["d"], sig["f"]
        args = (randn(m, d), randn(d, f, scale=d ** -0.5),
                randn(d, f, scale=d ** -0.5), sig["act"])
        fn = {"fused": mlp.fused_cuda, "stream": mlp.stream_cuda,
              "split": mlp.split_cuda}[vid]
        return fn(*args, tile=tile), mlp.mlp_plain(*args)
    cuda, plain = {"matvec": (mv.matvec_cuda, mv.matvec_plain),
                   "atax": (ax.atax_cuda, ax.atax_plain),
                   "bicg": (bc.bicg_cuda, bc.bicg_plain),
                   "jacobi3d": (jc.jacobi3d_cuda, jc.jacobi3d_plain),
                   "stencil2d": (st.stencil2d_cuda, st.stencil2d_plain)}[kid]
    args = api.get_spec(kid).make_inputs(gen, **sig)
    return cuda(*args, tile=tile), plain(*args)


def phase_pretuned(dev):
    """The shipped pretuned databases: ``pretune --verify --all-targets``
    in a fresh process (every file regenerates bit for bit), then every
    record of ``h100_sxm.jsonl`` launched on the card at its signature
    with its params and held against the plain version, with the launch
    counters set to 0 before and read after."""
    import json as _json
    import torch
    from repro_torch import kernels
    from repro_torch import tuning_cache as tc
    from repro_torch.tuning_cache.cli import SHIPPED_TARGETS

    t0 = time.perf_counter()
    out = _tool("pretune", "--verify", "--all-targets")
    lines = [ln for ln in out.splitlines() if " verify " in ln]
    for ln in lines:
        print(f"[pretuned] {ln}", flush=True)
    if len(lines) != len(SHIPPED_TARGETS) or not all(
            ": OK (models: " in ln for ln in lines):
        fail(f"pretune --verify: {len(lines)} lines, not all OK")
    print(f"[pretuned] pretune --verify --all-targets: "
          f"{len(SHIPPED_TARGETS)} files OK in "
          f"{time.perf_counter() - t0:.1f} s (a fresh process)", flush=True)

    db = tc.TuningDatabase()
    n = db.warm_jsonl(tc.pretuned_path("h100-sxm"))
    if n != len(db) or n == 0:
        fail(f"h100_sxm.jsonl warmed {n} records into {len(db)}")
    kernels.reset_launch_counts()           # the shipped picks start here
    tiles, worst = {}, {}
    t0 = time.perf_counter()
    for rec in db.records():
        kid = rec.key.kernel_id
        sig = {k: v for k, v in _json.loads(rec.key.signature).items()
               if k not in ("model", "hopper", "variants")}
        got, want = _pretuned_call(dev, kid, sig, rec.params)
        torch.cuda.synchronize()
        tol = PRETUNED_F32_TOL[kid] if sig["dtype"] == "float32" else 2e-2
        # bicg returns two vectors
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            try:
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
            except AssertionError as e:
                fail(f"[pretuned] {kid} {sig} {rec.params} disagrees with "
                     f"its plain version: {str(e).splitlines()[0:4]}")
            err = (g.float() - w.float()).abs().max().item()
            worst[kid] = max(worst.get(kid, 0.0), err)
        tiles.setdefault(kid, set()).add(
            f"{rec.params.get('variant', kid)}/{rec.params['tile']}")
        del got, want
    launches = kernels.launch_counts()       # ... and end here
    torch.cuda.empty_cache()
    print(f"[pretuned] h100_sxm.jsonl: {n} records launched on the card "
          f"and held against their plain versions in "
          f"{time.perf_counter() - t0:.1f} s; distinct tiles per kernel: "
          + ", ".join(f"{k} {len(v)}" for k, v in sorted(tiles.items())),
          flush=True)
    for k in sorted(tiles):
        print(f"[pretuned]   {k}: max|err| {worst[k]:.3g}; "
              f"{sorted(tiles[k])}")
    print(f"[pretuned] launches: { {k: v for k, v in launches.items() if v} }")
    # each pick's wrapper counts under its variant's name (flash, blocked,
    # fused, stream, split) or the kernel's
    never = {t.split("/")[0] for v in tiles.values() for t in v
             if launches.get(t.split("/")[0], 0) == 0}
    if never:
        fail(f"shipped picks' kernels never launched: {sorted(never)}")
    return launches


def _served_records(db):
    """{digest: params} of ``db``'s records that the shipped H100 file
    does not hold: what a serve added."""
    from repro_torch import tuning_cache as tc
    shipped = tc.TuningDatabase()
    shipped.warm_jsonl(tc.pretuned_path("h100-sxm"))
    keep = {r.key.digest for r in shipped.records()}
    return {r.key.digest: dict(r.params) for r in db.records()
            if r.key.digest not in keep}


def _serve_request(cfg, batch: int, plen: int, gen: int, *extra):
    """One request through ``repro_torch.launch.serve`` with the launch
    counters set to 0 before and read after.  Returns (report,
    launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve
    kernels.reset_launch_counts()           # the path starts here
    rep = serve.main(["--arch", "gemma-7b", "--batch", str(batch),
                      "--prompt-len", str(plen), "--gen", str(gen),
                      "--tuned-ops", *extra], cfg=cfg)
    launches = kernels.launch_counts()       # ... and ends here
    torch.cuda.empty_cache()
    if not rep["logits_finite"] or not rep["device"].startswith("cuda"):
        fail(f"serve {batch}x{plen}+{gen} {extra}: device {rep['device']}, "
             f"finite logits {rep['logits_finite']}")
    return rep, launches


def _fresh_default_db():
    """Clear the dispatch memo and drop the default database, so the next
    dispatches are truly cold (the shipped H100 file warms anew)."""
    from repro_torch import tuning_cache as tc
    tc.clear_dispatch_memo()
    tc.reset_default_db()


def phase_deploy(reports, serve_launches, workdir: str):
    """The shipped-database path at full width: ``pretune --config
    gemma-7b`` for the H100 into a database in a fresh process, exported
    to JSONL, then gemma-7b served 4 x 64 + 32 with ``--tuning-db`` that
    JSONL and no ``--pretune``: fatal unless the serving process ranks
    nothing, every dispatch is frozen, the greedy tokens equal
    ``[serve]``'s and the same kernels launch.  Returns (JSONL, launches)."""
    from repro_torch import tuning_cache as tc
    from repro_torch.configs import get_config

    batch, plen, gen = REQUESTS[0]
    dbdir = os.path.join(workdir, "db")
    jsonl = os.path.join(workdir, "gemma7b_h100.jsonl")
    t0 = time.perf_counter()
    out = _tool("--db", dbdir, "pretune", "--config", "gemma-7b",
                "--target", "h100-sxm", "--batch", str(batch),
                "--prompt-len", str(plen))
    print(f"[deploy] {out.strip().splitlines()[0]} (a fresh process, "
          f"{time.perf_counter() - t0:.1f} s wall)", flush=True)
    print(f"[deploy] {_tool('--db', dbdir, 'export', '--out', jsonl).strip()}",
          flush=True)
    _fresh_default_db()
    rep, launches = _serve_request(get_config("gemma-7b"), batch, plen, gen,
                                   "--tuning-db", jsonl, "--assert-frozen")
    st, db = rep["dispatch"], tc.get_default_db()
    ranks = db.stats.tunes
    print(f"[deploy] serve {batch}x{plen}+{gen} --tuning-db (no --pretune): "
          f"{st['frozen']}/{st['total']} frozen, {ranks} ranks, "
          f"{rep['runtime_tunes']} runtime tunes; first token "
          f"{rep['first_token_s']:.2f} s after start against [serve]'s "
          f"{reports[0]['first_token_s']:.2f} s (its graph pretune "
          f"included); prefill {rep['prefill_ms']:.1f} ms, "
          f"{rep['ms_per_token']:.2f} ms/token", flush=True)
    if ranks or rep["runtime_tunes"] or st["frozen"] != st["total"]:
        fail(f"[deploy] the serving process ranked or dispatched live: "
             f"{st}, ranks {ranks}")
    if rep["tokens"] != reports[0]["tokens"]:
        fail("[deploy] greedy tokens differ from [serve]'s")
    print(f"[deploy] greedy tokens equal [serve]'s {batch}x{plen}+{gen} "
          f"request ({batch} x {gen + 1})")
    ran = {k for k, v in launches.items() if v}
    if ran != {k for k, v in serve_launches.items() if v}:
        fail(f"[deploy] launched {sorted(ran)}, [serve] "
             f"{sorted(k for k, v in serve_launches.items() if v)}")
    print(f"[deploy] launches: { {k: v for k, v in launches.items() if v} }")
    return jsonl, launches


def _start_server(jsonl: str, *fault):
    """``python -m repro_torch.tuning_cache serve --port 0 --warm-jsonl``
    in a subprocess; returns (process, URL) from its ready line."""
    import select
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tuning_cache", "serve",
         "--port", "0", "--warm-jsonl", jsonl, *fault],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=SRC))
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        line = proc.stdout.readline()
        if not line:
            break
        if "listening on " in line:
            print(f"[service] {line.strip()}", flush=True)
            return proc, line.split("listening on ")[1].split()[0]
    proc.kill()
    proc.wait(timeout=30)
    fail(f"the tuning server did not start (exit {proc.returncode})")


def phase_service(reports, jsonl: str):
    """A remote tuner: the tuning server in a subprocess warmed with
    ``[deploy]``'s JSONL, gemma-7b served 1 x 64 + 8 with
    ``--tuning-server`` and no ``--pretune`` from a cold dispatch state
    (every unique instance must come from the service, zero local
    ranks), then again against a server that drops every request (the
    client must degrade to local ranks).  Both runs must give
    ``[serve]``'s greedy tokens, on the card, through the same kernels
    with the same params.  Returns the launches of the first run."""
    from repro_torch import tuning_cache as tc
    from repro_torch.configs import get_config
    from repro_torch.tuning_cache import registry

    cfg = get_config("gemma-7b")
    batch, plen, gen = REQUESTS[1]
    runs = {}
    for label, fault in (("served", ()),
                         ("degraded", ("--fault", "drop@server.request"))):
        proc, url = _start_server(jsonl, *fault)
        try:
            _fresh_default_db()
            t0 = time.perf_counter()
            rep, launches = _serve_request(cfg, batch, plen, gen,
                                           "--tuning-server", url)
            wall = time.perf_counter() - t0
            client = tc.service_client()
            cs = client.stats.as_dict()
            remote = client.remote_stats() if label == "served" else None
            db = tc.get_default_db()
            unique = len(registry.dispatch_memo_keys())
            runs[label] = (rep, launches, _served_records(db))
            print(f"[service] {label}: serve {batch}x{plen}+{gen} "
                  f"--tuning-server in {wall:.1f} s, {unique} unique "
                  f"instances, local ranks {db.stats.tunes}, client "
                  f"{cs}, breaker {client.breaker.state}"
                  + (f"; server {remote['server']}, db {remote['db']}; "
                     f"{cs['requests'] / max(unique, 1):.2f} lookup round "
                     f"trips per unique instance ({cs['attempts']} HTTP "
                     f"exchanges, one the start-up health probe)"
                     if remote else ""), flush=True)
        finally:
            tc.configure_service(None)
            proc.kill()
            proc.wait(timeout=30)
            proc.stdout.close()
        if rep["tokens"] != reports[1]["tokens"]:
            fail(f"[service] {label}: greedy tokens differ from [serve]'s")
        if label == "served" and (cs["hits"] != unique or db.stats.tunes
                                  or cs["failures"] or not unique
                                  or rep["dispatch"]["frozen"]):
            fail(f"[service] not every unique instance came from the "
                 f"service: {cs}, local ranks {db.stats.tunes}")
        if label == "degraded" and (cs["hits"] or not cs["failures"]
                                    or not cs["degraded"]
                                    or db.stats.tunes != unique):
            fail(f"[service] the fault run did not degrade to local ranks: "
                 f"{cs}, local ranks {db.stats.tunes} of {unique}")
    (_, l_s, p_s), (_, l_d, p_d) = runs["served"], runs["degraded"]
    if p_s != p_d or l_s != l_d:
        fail(f"[service] the degraded run changed the params or kernels: "
             f"{p_s} vs {p_d}, {l_s} vs {l_d}")
    print(f"[service] both runs: greedy tokens equal [serve]'s "
          f"{batch}x{plen}+{gen} request, the same {len(p_s)} params and "
          f"the same launches on the card: "
          f"{ {k: v for k, v in l_s.items() if v} }", flush=True)
    return l_s


def phase_profile(dev, batch: int = 4, prompt_len: int = 64,
                  steps: int = 4):
    """Where a decode step's time goes: `torch.profiler` over ``steps``
    steps of the first request's shape (after the main path, whose
    frozen tables serve it), device time by kernel name and the share
    of the window the device sat idle."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_serve_fns
    from repro_torch.models import build_model
    from repro_torch.models.layers import use_tuned_layers

    cfg = get_config("gemma-7b")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    prefill, decode = make_serve_fns(model)
    tokens = torch.zeros((batch, prompt_len), dtype=torch.long, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), use_tuned_layers():
        _, cache = prefill(params, {"tokens": tokens})
        tok = tokens[:, :1]
        _, cache = decode(params, cache, tok)        # warm
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                _, cache = decode(params, cache, tok)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print("[profile] the profiler recorded no device time")
        return
    print(f"[profile] decode batch {batch}: {steps} steps in {wall_ms:.1f} "
          f"ms wall ({wall_ms / steps:.2f} ms/step), device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    for ms, key, n in rows[:12]:
        print(f"[profile]   {ms / steps:8.3f} ms/step  {100 * ms / busy:5.1f}%"
              f"  x{n // steps:<4d} {key[:90]}")
    _per_launch("decode", rows, steps)
    # prefill runs the attention kernels: one profiled prefill
    with torch.inference_mode(), use_tuned_layers():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    print(f"[profile] prefill batch {batch} x {prompt_len}: {wall_ms:.1f} "
          f"ms wall, device busy {busy:.1f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}")
    for ms, key, n in rows[:8]:
        print(f"[profile]   {ms:8.3f} ms  {100 * ms / busy:5.1f}%  x{n:<4d} "
              f"{key[:90]}")
    _per_launch("prefill", rows, 1)
    del params, cache
    torch.cuda.empty_cache()


# the kernels of B1 (GEMV, wgmma, split-K reduce), B2 (warp-per-row,
# vector and cluster rms_norm), B3 (SIMT, bf16 and 3xTF32 tensor-core
# flash; SIMT and tensor-core blocked) and B5 (SIMT and wgmma gated
# tiles, SIMT and GEMV stream rows) by the names `torch.profiler` gives
# them
PROFILED = {"B1": ("gemv_kernel", "wgmma_kernel", "splitk_reduce_kernel"),
            "B2": ("rms_kernel", "rms_vec_kernel", "rms_cluster_kernel"),
            "B3": ("flash_kernel", "flash_mma_kernel", "flash_tf32_kernel",
                   "blocked_kernel", "blocked_tc_kernel"),
            "B5": ("gated_kernel", "gated_wgmma_kernel", "stream_kernel",
                   "stream_gemv_kernel")}


def _device_rows(prof):
    """(device ms, kernel name, launches) of a profile, largest first."""
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt > 0:
            rows.append((dt / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows


def _per_launch(what: str, rows, steps: int) -> None:
    """The port's kernels' device time per launch in a profile."""
    for ms, key, n in rows:
        for tag, names in PROFILED.items():
            # whole names: gemv_kernel is not stream_gemv_kernel
            if any(re.search(rf"(?<!\w){k}<", key) for k in names):
                print(f"[profile]   {what} {tag} {key[:60]}: x{n // steps} "
                      f"per step, {1e3 * ms / n:.2f} us device time per "
                      f"launch")


# ---------------------------------------------------------------------------
# phase 6: the tuning path (the paper's experiment on the card)
# ---------------------------------------------------------------------------

def tune_case(tag: str, kid: str, sig: dict) -> dict:
    """`KernelTuner` on one instance of ``kid``'s factory: static
    (asserted to launch nothing), static again (asserted to come from
    the database), hybrid (the static shortlist's best 4 timed) and
    empirical exhaustive.  Prints the space size, the static pick and
    its measured time, the measured best, the regret, Spearman of
    predicted against measured, the search-space reduction, the static
    rank time and the evaluations."""
    from repro_torch import kernels
    from repro_torch import tuning_cache as tc
    from repro_torch.core import KernelTuner

    factory = kernels.TUNABLE_FACTORIES[kid]
    db = tc.TuningDatabase()

    def tuner():
        return KernelTuner(factory(**sig, seed=0), repeats=5,
                           keep_frac=0.5, db=db)
    t = tuner()
    if not t.hopper:
        fail(f"{kid}: the tuner did not target the card ({t.spec.name})")
    before = kernels.launch_counts()
    st = t.tune("static")
    if kernels.launch_counts() != before:
        fail(f"{kid}: a static tune launched kernels")
    again = tuner().tune("static")
    if not again.from_cache or again.best_params != st.best_params \
            or kernels.launch_counts() != before:
        fail(f"{kid}: the repeated static tune was not a cache hit")
    hy = t.tune("hybrid", empirical_budget=4)
    t0 = time.perf_counter()
    em = t.tune("empirical")
    em_wall = time.perf_counter() - t0
    meas = {r["params"]["tile"]: r["measured_s"] for r in em.table}
    pred = {r["params"]["tile"]: r["predicted_s"] for r in em.table}
    pick = st.best_params["tile"]
    best = em.best_params["tile"]
    regret = meas[pick] / em.best_measured_s
    shape = "x".join(str(v) for k, v in sig.items() if k != "dtype")
    print(f"[{tag}] {kid} {shape} {sig['dtype']}: space "
          f"{st.space_size}, static pick {pick} (pred "
          f"{st.best_predicted_s * 1e3:.4f} ms, meas "
          f"{meas[pick] * 1e3:.4f} ms), measured best {best} "
          f"{em.best_measured_s * 1e3:.4f} ms, regret {regret:.3f}x, "
          f"spearman {em.spearman_static_vs_measured:.3f}, reduction "
          f"{st.search_space_reduction:.3f}, static rank "
          f"{st.static_rank_time_s * 1e3:.2f} ms, static launches 0, "
          f"cache hit {again.from_cache}; hybrid {hy.empirical_evals} "
          f"evals -> {hy.best_params['tile']} "
          f"{hy.best_measured_s * 1e3:.4f} ms; empirical "
          f"{em.empirical_evals} evals in {em_wall * 1e3:.1f} ms wall; "
          f"{st.boundedness}", flush=True)
    print(f"[{tag}]   pred/meas ms: " + "; ".join(
        f"{k} {pred[k] * 1e3:.4f}/{meas[k] * 1e3:.4f}" for k in meas))
    # the pipeline tier over the same rows (a finding, not a gate)
    from repro_torch.core.predict import spearman
    ptimes, ppick = _pipeline_rank(kid, sig, [{"tile": t} for t in meas])
    ppick = ppick["tile"]
    if ppick not in meas:
        fail(f"{kid}: the pipeline tier picked {ppick}, which the tuner "
             f"did not time")
    prho = spearman(ptimes, [meas[t] for t in meas])
    pregret = meas[ppick] / em.best_measured_s
    print(f"[{tag}]   pipeline tier: pick {ppick} (pred "
          f"{ptimes[list(meas).index(ppick)] * 1e3:.4f} ms, meas "
          f"{meas[ppick] * 1e3:.4f} ms), regret {pregret:.3f}x, spearman "
          f"{prho:.3f} (eq6: pick {pick}, regret {regret:.3f}x, spearman "
          f"{em.spearman_static_vs_measured:.3f})", flush=True)
    return dict(kernel=kid, sig=sig, space=st.space_size, pick=pick,
                pipe_pick=ppick, pipe_regret=pregret, pipe_rho=prho,
                pred=pred, meas=meas, pick_ms=meas[pick] * 1e3, best=best,
                best_ms=em.best_measured_s * 1e3, regret=regret,
                rho=em.spearman_static_vs_measured,
                hybrid_pick=hy.best_params["tile"],
                hybrid_ms=hy.best_measured_s * 1e3)


TUNER_CASES = [(k, dict(TABLE4_SHAPES[k], dtype=dt)) for k in TABLE4
               for dt in (("float32",) if k == "jacobi3d"
                          else ("float32", "bfloat16"))] \
    + [("matmul", dict(m=4, n=3072, k=24576, dtype="bfloat16"))]


def _rank_own(what: str, r: dict, keep) -> None:
    """Spearman, static pick, measured best and regret of a `tune_case`
    row's tiles for which ``keep(tile)`` is true, ranked on their own."""
    from repro_torch.core.predict import spearman
    own = [t for t in r["meas"] if keep(t)]
    pick = min(own, key=lambda t: r["pred"][t])
    best = min(own, key=lambda t: r["meas"][t])
    rho = spearman([r["pred"][t] for t in own], [r["meas"][t] for t in own])
    print(f"[tuner]   {what}: {len(own)} rows, spearman {rho:.3f}; static "
          f"pick {pick} {r['meas'][pick] * 1e3:.4f} ms, measured best "
          f"{best} {r['meas'][best] * 1e3:.4f} ms, regret "
          f"{r['meas'][pick] / r['meas'][best]:.3f}x", flush=True)


def phase_tuner():
    """`tune_case` on each TUNER_CASES instance (jacobi3d's plane rows
    also ranked on their own), then the quickstart in process."""
    from repro_torch import kernels
    from repro_torch.examples import quickstart
    from repro_torch.kernels import jacobi3d as jc

    kernels.reset_launch_counts()           # the tuning path starts here
    rows = [tune_case("tuner", kid, sig) for kid, sig in TUNER_CASES]
    for r in rows:
        if r["kernel"] == "jacobi3d":
            _rank_own("jacobi3d plane rows alone", r, lambda t: (
                jc.JACOBI_TILES[t][3] == jc.PLANE))
    print("[tuner] quickstart (atax 1024 x 512 float32, in L2):", flush=True)
    quickstart.main([])
    launches = kernels.launch_counts()       # ... and ends here
    print(f"[tuner] tuning-path launches: {launches}")
    return rows, launches


# ---------------------------------------------------------------------------
# phase 7: frozen dispatch of the Table IV ops
# ---------------------------------------------------------------------------


def phase_dispatch(dev):
    """Each Table IV op and rms_norm on its long row through ``ops``
    after ``freeze()``, with every launch counter set to 0 before and
    read after: fatal unless every dispatch is frozen, none tunes at run
    time, each op launches its kernel and rms_norm its cluster rows.
    Returns the launch counts."""
    import torch
    from repro_torch import kernels
    from repro_torch import tuning_cache as tc
    from repro_torch.kernels import api, ops
    from repro_torch.kernels import atax as ax
    from repro_torch.kernels import bicg as bc
    from repro_torch.kernels import jacobi3d as jc
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import rms_norm as rn

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    a = torch.randn((4096, 4096), generator=gen, device=dev) / 64
    x = torch.randn((4096, 1), generator=gen, device=dev)
    r = torch.randn((4096, 1), generator=gen, device=dev)
    u = torch.randn((128, 128, 128), generator=gen, device=dev)
    xl = torch.randn((RMS_LONG["m"], RMS_LONG["d"]), generator=gen,
                     device=dev).to(torch.bfloat16)
    gl = torch.randn(RMS_LONG["d"], generator=gen, device=dev)
    calls = {"matvec": ((a, x), mv.matvec_plain, 2e-4),
             "atax": ((a, x), ax.atax_plain, 1e-3),
             "bicg": ((a, x, r), bc.bicg_plain, 1e-3),
             "jacobi3d": ((u,), jc.jacobi3d_plain, 1e-5),
             "rms_norm": ((xl, gl), rn.rms_norm_plain, 2e-2)}
    tc.thaw()
    for kid, (args, _, _) in calls.items():
        tc.lookup_or_tune(kid, **api.get_spec(kid).extract_signature(*args))
    tc.freeze()
    api.reset_dispatch_stats()
    tunes = tc.get_default_db().stats.tunes
    kernels.reset_launch_counts()
    for kid, (args, plain, tol) in calls.items():
        got = getattr(ops, kid)(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    st = api.dispatch_stats()
    launches = kernels.launch_counts()
    shown = TABLE4 + ("jacobi_plane", "jacobi_ring", "rms_cluster")
    print(f"[dispatch] Table IV ops and rms_norm {RMS_LONG} after "
          f"freeze(): {st}, runtime tunes "
          f"{tc.get_default_db().stats.tunes - tunes}, launches "
          f"{ {k: launches[k] for k in shown} }")
    if st["frozen"] != st["total"] or st["total"] != len(calls):
        fail(f"dispatch not all frozen: {st}")
    if tc.get_default_db().stats.tunes != tunes:
        fail("a frozen dispatch tuned at run time")
    if any(launches[k] == 0 for k in TABLE4 + ("rms_cluster",)):
        fail(f"an op did not launch its kernel: {launches}")
    tc.thaw()
    return launches


# ---------------------------------------------------------------------------
# phase 8: the kernel API's extension path
# ---------------------------------------------------------------------------

# ops.stencil2d's instances: the reference's pretune grid, then 8192^2
# (268 MB in and out in f32, above the 50 MB L2), where the analysis
# must pick a ring row, and a grid whose rows are not whole 16-byte
# vectors (the march rows' domain)
STENCIL_SIGS = [dict(y=512, x=512, dtype="float32"),
                dict(y=1024, x=1024, dtype="float32"),
                dict(y=2048, x=2048, dtype="float32"),
                dict(y=1024, x=1024, dtype="bfloat16"),
                dict(y=8192, x=8192, dtype="float32"),
                dict(y=8192, x=8192, dtype="bfloat16"),
                dict(y=1000, x=1003, dtype="float32")]
# float32 tolerances: the Jacobi sweeps' 1e-5; saxpy2d's f32 result is
# one rounding of an exact 2a plus b (1e-6); bfloat16 2e-2 for both
EXT_TOL = {"stencil2d": 1e-5, "saxpy2d": 1e-6}


def _hold(kid: str, got, want, dtype: str, what: str) -> float:
    """Max abs error of ``got`` against the plain version; fatal beyond
    the kernel's tolerance."""
    import torch
    torch.cuda.synchronize()
    tol = EXT_TOL[kid] if dtype == "float32" else 2e-2
    try:
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    except AssertionError as e:
        fail(f"{kid} {what} disagrees with its plain version: "
             f"{str(e).splitlines()[0:4]}")
    return (got.float() - want.float()).abs().max().item()


def phase_extend(dev, card: str):
    """The extension path through the entry points a user calls, with
    every launch counter set to 0 before and read after: stencil2d
    through ``ops`` (cold H100 rank, then launch) at STENCIL_SIGS, each
    output held against the plain version; `KernelTuner` on stencil2d
    at 8192^2 f32 and bf16; the three examples' ``main``; the
    mega-space matmul registered, dispatched under the H100 and
    unregistered.  Fatal if a dispatch fell back, a static tune
    launched a kernel or the analysis did not pick a ring row at
    8192^2."""
    import torch
    from repro_torch import kernels
    from repro_torch import tuning_cache as tc
    from repro_torch.core.target import use_target
    from repro_torch.examples import (annotated_tuning, autotune_kernel,
                                      custom_kernel)
    from repro_torch.kernels import api, ops
    from repro_torch.kernels.matmul import matmul_plain
    from repro_torch.kernels import stencil2d as st
    from repro_torch.kernels.megamatmul import mega_matmul_spec

    print(f"[extend] card: {card}", flush=True)
    api.reset_dispatch_stats()
    kernels.reset_launch_counts()           # the extension path starts here
    spec = api.get_spec("stencil2d")
    with use_target("h100"):
        for sig in STENCIL_SIGS:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            (u,) = spec.make_inputs(gen, **sig)
            t0 = time.perf_counter()
            got = ops.stencil2d(u)              # cold rank, then launch
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            tile = tc.lookup_or_tune("stencil2d", **sig)[api.TILE_AXIS]
            shape = f"{sig['y']}x{sig['x']} {sig['dtype']}"
            family = ("ring" if st.STENCIL_TILES[tile][3] == st.RING
                      else "march")
            if sig["y"] == 8192 and family != "ring":
                fail(f"stencil2d {shape}: the H100 analysis picked the "
                     f"march row {tile}, not a ring row")
            err = _hold("stencil2d", got, st.stencil2d_plain(u),
                        sig["dtype"], f"{shape} tile {tile}")
            tol = EXT_TOL["stencil2d"] if sig["dtype"] == "float32" else 2e-2
            print(f"[extend] ops.stencil2d {shape}: tile {tile} ({family} "
                  f"row; cold H100 rank + first launch {wall:.1f} ms "
                  f"wall), max|err| {err:.3g} (tol {tol:g})", flush=True)
            del u, got
    for dtype in ("float32", "bfloat16"):
        r = tune_case("extend", "stencil2d",
                      dict(y=8192, x=8192, dtype=dtype))
        _rank_own("stencil2d march rows alone", r,
                  lambda t: st.STENCIL_TILES[t][3] == st.MARCH)

    print("[extend] examples/custom_kernel.main([]) (saxpy2d, declared in "
          "its own file):", flush=True)
    rep = custom_kernel.main([])
    if "hybrid" not in rep:
        fail("custom_kernel skipped its hybrid tune")

    print("[extend] examples/annotated_tuning.main([]):", flush=True)
    before = kernels.launch_counts()
    rep = annotated_tuning.main([])
    p = rep.best_params
    if (p["bm"], p["bn"], p["bk"]) not in annotated_tuning.TILE_OF:
        fail(f"the annotated static pick {p} is not a compiled GEMM tile")
    if kernels.launch_counts() != before:
        fail("the annotated static tune launched kernels")

    print("[extend] examples/autotune_kernel.main([]):", flush=True)
    autotune_kernel.main([])

    mega = mega_matmul_spec(register=True)
    try:
        sig = dict(m=2048, n=2048, k=2048, dtype="bfloat16")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        a, b = mega.make_inputs(gen, **sig)
        b = b * sig["k"] ** -0.5
        chosen = tc.lookup_or_tune("mega_matmul", spec="h100",
                                   db=tc.TuningDatabase(), **sig)
        with use_target("h100"):
            got = ops.mega_matmul(a, b)
        torch.cuda.synchronize()
        want = matmul_plain(a, b)
        try:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2e-2, atol=2e-2)
        except AssertionError as e:
            fail(f"mega_matmul disagrees with the plain GEMM: "
                 f"{str(e).splitlines()[0:4]}")
        err = (got.float() - want.float()).abs().max().item()
        with use_target("h100"):
            ms = time_ms(lambda: ops.mega_matmul(a, b))
            dev_us = device_us(lambda: ops.mega_matmul(a, b), calls=50)
        lib_ms = time_ms(lambda: torch.matmul(a, b))
        lib_us = device_us(lambda: torch.matmul(a, b), calls=50)
        b_ms, b_by = bound(2.0 * 3 * 2048 ** 2, 2.0 * 2048 ** 3, "bfloat16")
        print(f"[extend] mega_matmul 2048^3 bf16 under h100: space = the "
              f"GEMM tile table, pick {chosen}, launched through "
              f"ops.mega_matmul, max|err| {err:.3g} (tol 2e-2 abs + rel) | "
              f"kernel (dispatch + launch) {ms:.4f} ms, device "
              f"{dev_us:.2f} us per call | bound {b_ms:.4f} ms ({b_by}) | "
              f"torch.matmul {lib_ms:.4f} ms, device {lib_us:.2f} us per "
              f"call ({dev_us / lib_us:.2f}x)", flush=True)
    finally:
        api.unregister("mega_matmul")
    launches = kernels.launch_counts()       # ... and ends here
    stats = api.dispatch_stats()
    print(f"[extend] extension-path launches: {launches}; dispatch {stats}")
    if stats["fallback"] != 0:
        fail(f"a dispatch on the extension path fell back: {stats}")
    return launches


def phase_extend_kernels(dev) -> dict:
    """stencil2d and saxpy2d held against their plain versions at 8192^2
    f32 and bf16 and timed: stencil2d on its tile dispatch pick (a ring
    row) and on the march row the analysis ranks first among its own,
    each beside its device time per launch, the bound, the plain
    version and the conv2d composite; saxpy2d on its pick beside
    ``torch.add``, both also on device time.  Then the 4.2M-point mega
    space ranked under tpu-v5e in a fresh process (host work).  Returns
    the float32 rows (stencil2d: the ring pick; stencil2d_march)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import tuning_cache as tc
    from repro_torch.core.hw import dtype_bytes
    from repro_torch.examples import custom_kernel as ck
    from repro_torch.kernels import api
    from repro_torch.kernels import stencil2d as st

    rows = {}
    for kid in EXTEND:
        for dtype in ("float32", "bfloat16"):
            sig = (dict(y=8192, x=8192, dtype=dtype) if kid == "stencil2d"
                   else dict(m=8192, n=8192, dtype=dtype))
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            args = api.get_spec(kid).make_inputs(gen, **sig)
            tiles = {kid: tc.lookup_or_tune(
                kid, spec="h100", db=tc.TuningDatabase(),
                **sig)[api.TILE_AXIS]}
            fn, plain = ((st.stencil2d_cuda, st.stencil2d_plain)
                         if kid == "stencil2d"
                         else (ck.saxpy2d_cuda, ck.saxpy2d_plain))
            pts, eb = 8192.0 * 8192, dtype_bytes(dtype)
            nbytes, flops = ((2 * pts * eb, 6 * pts) if kid == "stencil2d"
                             else (3 * pts * eb, 2 * pts))
            b_ms, b_by = bound(nbytes, flops, dtype)
            base = dict(plain_ms=time_ms(lambda: plain(*args)),
                        bound_ms=b_ms, bound_by=b_by, library_ms=None)
            if kid == "stencil2d":
                tiles["stencil2d_march"] = _family_tile(
                    kid, None, sig, lambda t: st.STENCIL_TILES[t][3]
                    == st.MARCH)
                (u,) = args
                c0, c1 = st.C0_DEFAULT, st.C1_DEFAULT
                w = torch.tensor([[0.0, c1, 0.0], [c1, c0, c1],
                                  [0.0, c1, 0.0]], device=dev,
                                 dtype=u.dtype).view(1, 1, 3, 3)

                def composite():
                    out = u.clone()
                    out[1:-1, 1:-1] = F.conv2d(u[None, None], w)[0, 0]
                    return out
                c_err = (composite().float()
                         - plain(u).float()).abs().max().item()
                base.update(composite_ms=time_ms(composite),
                            composite_device_us=device_us(composite,
                                                          calls=50))
                other = (f"torch composite (conv2d + boundary copy, 3 "
                         f"calls) {base['composite_ms']:.4f} ms, device "
                         f"{base['composite_device_us']:.2f} us, max|err| "
                         f"{c_err:.3g}")
            else:
                def lib(a, b):
                    return torch.add(b, a, alpha=2.0)
                base.update(library_ms=time_ms(lambda: lib(*args)),
                            library_device_us=device_us(
                                lambda: lib(*args), calls=50))
                other = (f"library torch.add(b, a, alpha=2) "
                         f"{base['library_ms']:.4f} ms, device "
                         f"{base['library_device_us']:.2f} us")
            tol = EXT_TOL[kid] if dtype == "float32" else 2e-2
            for name, tile in tiles.items():
                err = _hold(kid, fn(*args, tile=tile), plain(*args), dtype,
                            f"8192x8192 {dtype} tile {tile}")
                row = dict(base, max_abs_err=err,
                           ms=time_ms(lambda: fn(*args, tile=tile)),
                           device_us=device_us(lambda: fn(*args, tile=tile),
                                               calls=50),
                           shape=f"8192x8192 {dtype} tile {tile}")
                print(f"[extend] {name} {row['shape']}: max|err| {err:.3g} "
                      f"(tol {tol:g} abs + rel) | kernel {row['ms']:.4f} "
                      f"ms, device {row['device_us']:.2f} us per launch | "
                      f"bound {b_ms:.4f} ms ({b_by}), "
                      f"{b_ms / row['ms'] * 100:.0f} % | plain "
                      f"{row['plain_ms']:.4f} ms | {other}", flush=True)
                if dtype == "float32":
                    rows[name] = row
            del args
    torch.cuda.empty_cache()

    code = (
        "import json, resource, sys, time, tracemalloc\n"
        f"sys.path.insert(0, {SRC!r})\n"
        "from repro_torch.core.target import use_target\n"
        "from repro_torch.kernels.megamatmul import mega_matmul_spec\n"
        "from repro_torch.tuning_cache.registry import _model_for, "
        "rank_space\n"
        "sig = dict(m=6144, n=6144, k=6144, dtype='float32')\n"
        "with use_target('tpu-v5e') as s:\n"
        "    prob = mega_matmul_spec().problem(**sig)\n"
        "    model = _model_for(s)\n"
        "    r0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "    t0 = time.perf_counter()\n"
        "    p, t, n = rank_space(prob, model)\n"
        "    wall = time.perf_counter() - t0\n"
        "    r1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "    tracemalloc.start()\n"
        "    rank_space(prob, model)\n"
        "    traced = tracemalloc.get_traced_memory()[1]\n"
        "print(json.dumps(dict(params=p, predicted_s=t, rows=n, "
        "size=prob.space.size, wall_s=wall, extra_rss_mb=(r1 - r0) / "
        "1024, traced_mb=traced / 2 ** 20)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"mega-space rank failed: {out.stderr[-2000:]}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"[extend] mega_matmul 6144^3 f32 under tpu-v5e (host work, a "
          f"fresh process): {r['size']} lattice points, {r['rows']} scored "
          f"after constraint pushdown, winner {r['params']} predicted "
          f"{r['predicted_s'] * 1e3:.4f} ms, rank wall {r['wall_s']:.2f} s, "
          f"peak extra RSS {r['extra_rss_mb']:.0f} MB over the imports' "
          f"high-water mark, peak traced allocations of a second rank "
          f"{r['traced_mb']:.0f} MB", flush=True)
    return rows


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "kernels",
                                      "csrc")):
        print("[smoke] src/repro_torch not found beside chip_smoke.py: run "
              "it from a checkout of the repository", flush=True)
        sys.exit(2)
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: nothing to measure", flush=True)
        sys.exit(3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"[smoke] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t_all = time.perf_counter()
    phase_build()
    rows = phase_kernels(dev)
    rows.update(phase_table4(dev))
    pretuned_launches = phase_pretuned(dev)
    phase_ranking(dev)
    phase_check(dev)
    reports, launches = phase_serve()
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        jsonl, deploy_launches = phase_deploy(reports, launches, work)
        service_launches = phase_service(reports, jsonl)
    phase_profile(dev)
    _, tuner_launches = phase_tuner()
    dispatch_launches = phase_dispatch(dev)
    ext_launches = phase_extend(dev, card)
    rows.update(phase_extend_kernels(dev))

    from repro_torch.kernels import mlp_matmul as mlp
    counter = {"fused": (mlp.GATED_TILES, mlp._GATED_COUNTER),
               "stream": (mlp.STREAM_TILES, mlp._STREAM_COUNTER)}
    selected = {}
    for rep in reports:
        for inst in rep["instances"]:
            p = inst["params"]
            selected[p.get("variant", inst["kernel"])] = True
            if inst["kernel"] == "mlp_matmul" and p["variant"] in counter:
                # the family the pick launches
                table, names = counter[p["variant"]]
                selected[names[table[p["tile"]][5]]] = True
    missing = [k for k in selected if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels picked for the main path never launched: {missing}")
    for op, names in (("matmul", ("matmul",)),
                      ("the decode matmul's GEMV tiles", ("gemm_gemv",)),
                      ("the prefill matmul's wgmma tiles", ("gemm_wgmma",)),
                      ("split-K", ("splitk_reduce",)),
                      ("rms_norm", ("rms_norm",)),
                      ("rms_norm's vector rows", ("rms_vec",)),
                      ("flash_attention", ("flash", "blocked")),
                      ("attention's tensor-core rows",
                       ("flash_mma", "flash_tf32", "blocked_tc")),
                      ("mlp_matmul", ("fused", "stream", "split"))):
        if not any(launches[n] for n in names):
            fail(f"{op}: no CUDA kernel launched on the main path")
    rms = {k: launches[k] for k in ("rms_simt", "rms_vec", "rms_cluster")}
    print(f"[smoke] rms_norm on the main path by family: {rms}")
    gated = {k: launches[k] for k in ("gated_simt", "gated_wgmma",
                                      "stream_simt", "stream_gemv",
                                      "split")}
    print(f"[smoke] mlp_matmul on the main path by family: {gated}")

    ran = lambda c: sorted(k for k, v in c.items() if v)
    print(f"[smoke] kernels launched by the deployment tiers' paths: "
          f"[pretuned] {ran(pretuned_launches)}; [deploy] "
          f"{ran(deploy_launches)}; [service] {ran(service_launches)}")
    missing = [k for k in TABLE4 + ("jacobi_plane", "jacobi_ring")
               if tuner_launches.get(k, 0) == 0]
    if missing:
        fail(f"Table IV kernels never launched on the tuning path: "
             f"{missing}")
    missing = [k for k in EXTEND + ("stencil2d_ring", "stencil2d_march")
               if ext_launches.get(k, 0) == 0]
    if missing:
        fail(f"extension kernels never launched on the extension path: "
             f"{missing}")

    # each kernel's launches on the path that launches it
    paths = {n: ("serve", launches) for n in SERVE_KERNELS}
    paths.update({n: ("tuner", tuner_launches)
                  for n in TABLE4 + ("jacobi_plane",)})
    paths["rms_cluster"] = ("dispatch", dispatch_launches)
    paths.update({n: ("extend", ext_launches)
                  for n in EXTEND + ("stencil2d_march",)})

    def entry(name):
        src, replaces = KERNELS[name]
        r = rows[name]
        path, counts = paths[name]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": counts[COUNTER.get(name, name)],
                "path": path,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **{k: r[k] for k in ("device_us", "library_device_us",
                                     "composite_ms", "composite_device_us")
                   if k in r}}

    for n in KERNELS:
        path, counts = paths[n]
        c = counts[COUNTER.get(n, n)]
        status = "launched" if c else (
            "not picked by the H100 analysis for any instance")
        print(f"[smoke] kernel {n}: {status} on the {path} path"
              f" ({c} launches), err {rows[n]['max_abs_err']:.3g}"
              f" ok at {rows[n]['shape']}, {rows[n]['ms']:.4f} ms vs bound "
              f"{rows[n]['bound_ms']:.4f} ms")
    print(f"[smoke] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [entry(n) for n in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
