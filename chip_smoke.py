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
3. check   — every arch's smoke config (gemma-smoke first) in float32:
             prefill logits (2e-3) and 8 greedy tokens of the tuned CUDA
             path against the plain path on the CPU, the MoE configs
             with their smallest top-k router margin;
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
4d. families — the other model families at published width, each
             through ``serve --tuned-ops --pretune --assert-frozen``
             with the launch counters set to 0 before and read after:
             qwen2-moe-a2.7b at its full depth (24 layers, 60 experts
             top-4 + 4 shared) for the two requests, then
             `torch.profiler` over a few of its decode steps (device
             busy time per step beside the experts' byte floor, idle
             share, time by kernel); each other config for 2 x 64 + 8,
             depth cut only to keep its weights within 40 GB
             (moonshot 24 of 48 layers, chameleon 24 of 48, qwen1.5-110b
             12 of 80), whisper-tiny with its stub frames; then every
             unique (kernel, signature) of the ten configs' serving
             paths launched on its H100 pick, held against its plain
             version (bf16 2e-2, f32 2e-4) and timed beside it, its
             bound and its one-call library equivalent (whisper's
             non-causal encoder attention among them);
5. profile — `torch.profiler` over a few decode steps of the first
             request's shape: device time by kernel, idle share, and
             the device time per launch of the B1, B2, B3 and B5 kernels
             (decode steps, then one prefill for attention); then the
             device time per launch of matvec, atax and BiCG at the
             tuner's sizes on their tuning-path picks;
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
             ``annotated_tuning``, ``autotune_kernel`` and, last,
             ``serve_lm`` at its config's bfloat16 (graph pretune,
             freeze, tuned serving with every dispatch frozen and no
             runtime tune, the plain fallback fed the tuned tokens: its
             logits within 2e-2 + 2e-2 x the row's largest at every
             step, and its greedy choice equal to the tuned stream's
             or, where they part, a tie within that tolerance), and the
             mega-space matmul factory (2048^3 bf16, timed beside its
             bound and ``torch.matmul``, and on device time beside
             ``torch.matmul``'s); launch counters set to 0 before and read
             after.  Then both extension kernels are held against
             their plain versions at 8192^2 f32/bf16 and timed (stencil2d
             on its ring pick and on the march row the analysis ranks
             first among its own, each beside its device time, the bound,
             the plain version and the conv2d composite; saxpy2d beside
             ``torch.add``, both on device time), and the 4.2M-point mega
             space is ranked under tpu-v5e (host work);
9. extract — the extraction tier on the port's own binaries, building
             and launching nothing: ``cuobjdump -res-usage -sass`` of the
             library and both extensions (`kernels._cuda.disassemble`);
             (a) every KERNELS row's SASS functions with registers,
             spills, instructions and the census of the main loop, fatal
             where a row names no function; (b) issued instructions per
             HBM byte and the issue bound beside the bytes bound and
             [profile]'s device time on the decode instances and
             prefill's two wgmma kernels; (c) [ranking]'s GEMM,
             rms_norm, gated-MLP and serve-shape attention instances
             ranked by the pipeline tier on SASS streams
             (`core.sass.use_sass`) against the same run's times, beside
             eq6 and the feature-row pipeline; (d) one gemma-7b decode
             step and prefill of 4 x 64 + 32 traced on ``meta`` tensors
             (`core.mix.trace_fn`), priced by the H100 roofline beside
             [profile]'s device busy time and the bytes floor, fatal if
             the step reads less than one copy of the weights;
10. train  — the training path (`repro_torch.launch.train`; plain
             PyTorch under autograd, the tuned kernels having no
             backward): gemma-smoke, qwen2-moe-smoke and whisper-smoke in
             float32, three `make_train_step` steps (2 microbatches,
             remat full) on the card against the CPU from the same
             parameters and batches (losses 1e-5 relative, parameters
             1e-4); gemma-7b at its published width, 4 of 28 layers
             (2.68 B parameters: f32 masters, gradients and two moments
             at 16 B a parameter fit 80 GB at 4 layers, not at 28),
             ``launch.train.main`` for 8 steps of 8 x 256 tokens in bf16
             over f32 masters, every loss and grad norm finite, ms/step,
             tokens/s and peak memory beside the floor (the model FLOPs
             with remat's recompute at the bf16 peak, plus 32 B a
             parameter of optimizer traffic at 3.35 TB/s); gemma-smoke in
             bf16 through ``--checkpoint-dir`` with a fault after the
             first checkpoint, whose final parameters must equal an
             uninterrupted run's bit for bit; the tuning registry's
             launch counters set to 0 before and read after (0 tuned
             kernel launches).  Every update on the card runs the
             optimizer's two kernels (``kernels/csrc/optim.cu``, counted
             by ``optim.adamw.LAUNCHES``): gemma-7b's run must launch
             exactly two a leaf a step; from its trained state they are
             held against the plain version on the card (the global
             norm within 1e-6 relative; one update of every leaf from
             the same state and norm: m, v and p bit for bit), their
             device time per launch read off the profile, timed over
             one step's leaves beside their bytes bound, the plain
             version, ``torch.dot`` and ``torch._fused_adamw_``, and
             ``adamw_update`` timed alone on both routes;
11. mesh   — the device mesh (`launch.mesh`, DTensor): (a) an NCCL
             world of every visible card, one process each, on a
             (data, model) = (1, cards) mesh: gemma-7b at published
             width, 4 of 28 layers, and qwen2-moe-a2.7b at published
             width, 2 of 24 layers, each 3 steps of 8 x 256 tokens
             through ``launch.train.main --mesh-shape``, held to the
             unmeshed step on the same card (`mesh_verdict`: on one
             card losses and grad norms 1e-5 relative, final parameters
             1e-4; on a mesh of more than one card, where partial
             products sum in another order, each arch runs twice: in
             float32 with TF32 off, the gate, losses 1e-5 and grad
             norms 1e-3 relative, then in the config's bf16, every loss
             and grad norm finite, losses 1e-2 relative, grad norms
             and the parameters' error recorded; an MoE's chained gates
             hold its first two steps, its third is recorded: routing
             flips compound; and every step of the float32 run held
             from one shared state — rank 0's unmeshed state before
             it, kept in rank 0's host memory and scattered onto the
             mesh —
             losses 1e-5, grad norms 1e-3 and each leaf's parameters
             after the update 1e-2 of the unmeshed update's norm, every
             step of every arch), with the census of leaf
             placements, the collectives by kind of one step counted
             after the timed steps (``CommDebugMode``; the timed steps
             run under no dispatch mode), ms/step (wall and host)
             beside the unmeshed one — on one card (10 steps, two
             runs a side, meshed, unmeshed, unmeshed, meshed) the
             meshed host ms/step within 1.25x and wall within 1.15x —,
             peak memory, and gemma-7b's bf16 step profiled (wall and
             host ms, device busy and idle share, host time by op
             class); each rank sets its launch counters to 0
             before each run and reads them after (0 tuned kernel
             launches: they have no backward; the optimizer's kernels
             on every leaf of every step); (b), four gloo
             ranks sharing the card, is left out (the functional
             collectives over gloo on CUDA tensors hang there,
             `tools/gloo_cuda.py`; the CPU tests run four-rank gloo
             worlds); (c) ``python -m
             repro_torch.launch.dryrun``: gemma-7b train_4k on pod256
             and pod512, qwen2-moe-a2.7b train_4k on pod256, at
             published depth, in two subprocesses (a fake process
             group, meta tensors: nothing runs on the card), each
             record's flops per device over model_flops / chips, its
             memory peak (arguments + temporaries) against 80 GB,
             collective bytes and H100 roofline terms printed; fatal if
             qwen2-moe's flops ratio passes 2.0 (the reference's 1.61
             x 1.25).  ``python3 chip_smoke.py --mesh-only [--mesh-shape
             D,M]`` runs this phase alone (with a shape: (a) alone, on
             a D x M mesh of cards) and prints no result line;
12. memory — the memory accounting held to the card
             (`tools/train_memory.py`): whisper-tiny at published width
             and depth, unmeshed, one train step of 16 x 4096 tokens
             (``train_4k``'s per-device batch on the 16 x 16 mesh):
             ``torch.cuda.max_memory_allocated`` over the step beside
             the trace's prediction for the same step on meta tensors
             (`launch.dryrun.lower_train_step`, arguments plus
             temporaries) and the storages it names at its peak; fatal
             when the step fails or its loss is not finite, not on the
             ratio (a finding); 0 hand-written kernel launches.
             ``python3 chip_smoke.py --memory-only`` runs it alone and
             prints no result line.

Phase 2 also holds the Table IV kernels against their plain versions at
the tuner's sizes (above the 50 MB L2), jacobi3d on its static pick (a
TMA ring row) and on the plane row the analysis ranks first among its
own.  Every row of phases 2 and 2b launches the tile dispatch picks
(`lookup_or_tune` under the H100).  The
last two lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``; the line before them is the JSON
``{"kernels": [...]}`` of every ported kernel, each with its launches on
the path that launches it (a serving kernel's also on ``[families]``'
qwen2-moe-a2.7b path) and its SASS registers, spills and main-loop
instructions.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
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
# the registry ops the serving path dispatches
SERVE_OPS = ("matmul", "rms_norm", "flash_attention", "mlp_matmul")
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


def device_us(fn, calls: int = 200, tries: int = 4) -> float:
    """Device time per call of ``fn()`` in microseconds: the self device
    time `torch.profiler` records over ``calls`` back-to-back calls (every
    kernel the call launches), over ``calls``.  A profile whose kernel
    count is not a whole number a call has lost records and would read
    short: it is taken again, at most ``tries`` times.  If none was
    whole, the fullest profile that kept nine tenths of its k launches a
    call is read per recorded launch (its time x k / its launches);
    else fatal.  The profiler drops from a handful to a few tens of a
    window's records: 200 calls keep them a small share."""
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
                for ev in _device_events(prof)]
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
    picks, ranked into a fresh database.  Each row's stream is the one
    the registry ranks it by: its feature row, or its SASS stream inside
    `repro_torch.core.sass.use_sass`."""
    from repro_torch import tuning_cache as tc
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels import api
    from repro_torch.tuning_cache.registry import _model_for
    spec = api.get_spec(kid)
    model = _model_for(H100_SXM, "pipeline")
    sched = spec._hopper_problem(H100_SXM, spec.normalize(sig)).schedule
    times = []
    for p in pts:
        info = spec.hopper_static_info(p, H100_SXM, **sig)
        times.append(model.time_info(
            info, schedule=sched(p) if sched is not None and info.ok
            else None))
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
               "atax": lambda a, x: torch.linalg.multi_dot([a.T, a, x]),
               "jacobi3d": _conv3d_jacobi(dev, jc.C0_DEFAULT, jc.C1_DEFAULT)}
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
                    kid, sig, dtype, plane, args, launch[kid],
                    library[kid], None)[kid]
            del args
    torch.cuda.empty_cache()
    return results


def _conv3d_jacobi(dev, c0: float, c1: float):
    """jacobi3d's one-call yardstick: ``F.conv3d`` of the 7-point
    stencil over the interior, the boundary copied through unchanged
    (the reference's sweep, `kernels/ref.py` ``jacobi3d_ref``)."""
    import torch
    import torch.nn.functional as F
    w = torch.zeros((1, 1, 3, 3, 3), dtype=torch.float32, device=dev)
    w[0, 0, 1, 1, 1] = c0
    for d in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
              (1, 1, 2)):
        w[(0, 0) + d] = c1

    def lib(u):
        out = u.clone()
        out[1:-1, 1:-1, 1:-1] = F.conv3d(u[None, None], w.to(u.dtype))[0, 0]
        return out
    return lib


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
        row["device_us"] = device_us(lambda: fn(*args, tile=tile))
        extra = f" | device {row['device_us']:.2f} us per launch"
        if lib is not None:
            row["library_device_us"] = device_us(lambda: lib(*args))
            l_err = (lib(*args).float() - want[0].float()).abs().max().item()
            extra += (f" | library (conv3d + boundary copy) device "
                      f"{row['library_device_us']:.2f} us, max|err| "
                      f"{l_err:.3g}")
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
                dev_ms.append(device_us(lambda: fn(p["tile"], *args)) / 1e3)
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
                             pick=names[pick], best=names[best],
                             rows=rows, names=names, meas=meas,
                             dev_ms=dev_ms or None))
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
                            pipe_rho=prho, ptimes=ptimes)
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
                                   q, k, v, is_causal=True))
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


CHECK_TOL = 2e-3


@contextlib.contextmanager
def router_margins():
    """Record, for each call of the port's MoE top-k inside the block,
    the smallest router margin over its tokens: the k-th largest
    probability less the (k+1)-th (a near tie routes either way under
    float rounding).  Yields the list of margins."""
    from repro_torch.models import moe
    margins, top_k = [], moe._top_k

    def recording(probs, k):
        vals, idx = top_k(probs, probs.shape[-1])
        margins.append((vals[..., k - 1] - vals[..., k]).min().item())
        return vals[..., :k], idx[..., :k]

    moe._top_k = recording
    try:
        yield margins
    finally:
        moe._top_k = top_k


def _check_config(dev, arch: str) -> None:
    """``arch``'s smoke config in float32: prefill logits and 8 greedy
    tokens of the tuned CUDA path against the plain path on the CPU."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core.target import use_target
    from repro_torch.distributed import make_serve_fns
    from repro_torch.models import build_model, map_params
    from repro_torch.models.layers import use_tuned_layers
    from repro_torch.models.params import Param

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = build_model(cfg)
    p_cpu = model.init(seed=0, device="cpu")
    p_dev = map_params(lambda p: Param(p.value.to(dev), p.dims), p_cpu)
    prefill, decode = make_serve_fns(model)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=g)}
    if cfg.frontend == "frames":
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                      generator=g).to(torch.bfloat16)

    def run(params, inputs):
        logits, cache = prefill(params, inputs)
        first = logits
        tok = logits[:, -1:].argmax(-1)
        out = [tok]
        for _ in range(8):
            logits, cache = decode(params, cache, tok)
            tok = logits[:, -1:].argmax(-1)
            out.append(tok)
        return first, torch.cat(out, 1)

    with torch.inference_mode(), use_tuned_layers(), use_target("h100"):
        with router_margins() as margins:
            l_dev, t_dev = run(p_dev, {k: v.to(dev)
                                       for k, v in batch.items()})
        l_cpu, t_cpu = run(p_cpu, batch)
    err = (l_dev.float().cpu() - l_cpu.float()).abs().max().item()
    ok = torch.isfinite(l_dev).all().item() and err <= CHECK_TOL
    same = torch.equal(t_dev.cpu(), t_cpu)
    margin = (f"; smallest top-{cfg.top_k} router margin "
              f"{min(margins):.3g}" if margins else "")
    print(f"[check] {cfg.name} f32, tuned CUDA path vs plain CPU path: "
          f"prefill logits max|err| {err:.3g} (tol {CHECK_TOL:g}), greedy "
          f"tokens identical over 8 steps: {same}{margin}", flush=True)
    if not ok or not same:
        fail(f"{cfg.name}: the card's tuned path disagrees with the plain "
             f"path{margin}")


def phase_check(dev):
    """Every arch's smoke config (gemma's first) through `_check_config`."""
    from repro_torch.configs import ARCHS
    for arch in ["gemma-7b"] + [a for a in ARCHS if a != "gemma-7b"]:
        _check_config(dev, arch)


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


def _instance_fns(dev, kid: str, sig: dict, params: dict):
    """One serving instance on the card: (launch, plain, library call or
    None, bytes, operations) for ``kid`` at ``sig`` with a pick's
    ``params``, on operands drawn from a seeded generator (the matmul's
    and the MLP's weights scaled by fan-in^-1/2, so a dot's terms do not
    grow with its length, as the card tests draw them).  Bytes count
    each input read once and each output written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import mlp_matmul as mlp
    from repro_torch.kernels import rms_norm as rn

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    dt = getattr(torch, sig["dtype"])
    eb = torch.empty((), dtype=dt).element_size()
    randn = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=dev)
                                   * scale).to(dt)
    tile, vid = params["tile"], params.get("variant")
    if kid == "matmul":
        m, n, k = sig["m"], sig["n"], sig["k"]
        a, b = randn(m, k), randn(k, n, scale=k ** -0.5)
        return (lambda: mm.matmul_cuda(a, b, tile=tile),
                lambda: mm.matmul_plain(a, b), lambda: torch.matmul(a, b),
                eb * (m * k + k * n + m * n), 2.0 * m * n * k)
    if kid == "rms_norm":
        m, d = sig["m"], sig["d"]
        x = randn(m, d)
        g = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
        gd = g.to(dt)
        return (lambda: rn.rms_norm_cuda(x, g, tile=tile),
                lambda: rn.rms_norm_plain(x, g),
                lambda: F.rms_norm(x, (d,), gd, 1e-6),
                eb * 2.0 * m * d + 4.0 * d, 4.0 * m * d)
    if kid == "flash_attention":
        b, h, d, sq, skv = sig["b"], sig["h"], sig["d"], sig["sq"], sig["skv"]
        causal = sig["causal"]
        q, k, v = randn(b, h, sq, d), randn(b, h, skv, d), randn(b, h, skv, d)
        fn = fa.flash_cuda if vid == "flash" else fa.blocked_cuda
        pairs = (b * h * sq * (sq + 1) / 2 if causal and sq == skv
                 else b * h * sq * skv)           # unmasked (row, col)
        return (lambda: fn(q, k, v, causal, tile=tile),
                lambda: fa.attention_plain(q, k, v, causal),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                eb * 2.0 * b * h * (sq + skv) * d, 4.0 * pairs * d)
    if kid == "mlp_matmul":
        m, d, f = sig["m"], sig["d"], sig["f"]
        args = (randn(m, d), randn(d, f, scale=d ** -0.5),
                randn(d, f, scale=d ** -0.5), sig["act"])
        fn = {"fused": mlp.fused_cuda, "stream": mlp.stream_cuda,
              "split": mlp.split_cuda}[vid]
        return (lambda: fn(*args, tile=tile), lambda: mlp.mlp_plain(*args),
                None, eb * (m * d + 2.0 * d * f + m * f), 4.0 * m * d * f)
    raise KeyError(kid)


def _pretuned_call(dev, kid: str, sig: dict, params: dict):
    """Launch ``kid`` on the card at ``sig`` with a record's ``params``
    and return (kernel output, plain output)."""
    import torch
    from repro_torch.kernels import api
    from repro_torch.kernels import atax as ax
    from repro_torch.kernels import bicg as bc
    from repro_torch.kernels import jacobi3d as jc
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import stencil2d as st

    if kid in SERVE_OPS:
        launch, plain, *_ = _instance_fns(dev, kid, sig, params)
        return launch(), plain()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cuda, plain = {"matvec": (mv.matvec_cuda, mv.matvec_plain),
                   "atax": (ax.atax_cuda, ax.atax_plain),
                   "bicg": (bc.bicg_cuda, bc.bicg_plain),
                   "jacobi3d": (jc.jacobi3d_cuda, jc.jacobi3d_plain),
                   "stencil2d": (st.stencil2d_cuda, st.stencil2d_plain)}[kid]
    args = api.get_spec(kid).make_inputs(gen, **sig)
    return cuda(*args, tile=params["tile"]), plain(*args)


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


# ---------------------------------------------------------------------------
# phase 4d: the other model families
# ---------------------------------------------------------------------------

# the other configs' request: (batch, prompt_len, gen)
FAMILY_REQUEST = (2, 64, 8)
# depth cuts, so that a config's bf16 weights take at most 40 GB, half
# of the card: width is never cut
FAMILY_DEPTH = {"moonshot-v1-16b-a3b": 24, "chameleon-34b": 24,
                "qwen1.5-110b": 12}
FAMILY_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _serve_family(arch: str, cfg, requests):
    """``cfg`` served through ``repro_torch.launch.serve --tuned-ops
    --pretune --assert-frozen`` for each (batch, prompt_len, gen) of
    ``requests``, with the launch counters set to 0 before and read
    after.  Returns (reports, launches)."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve

    label = cfg.name
    reports = []
    kernels.reset_launch_counts()           # the path starts here
    for batch, plen, gen in requests:
        t0 = time.perf_counter()
        rep = serve.main(["--arch", arch, "--batch", str(batch),
                          "--prompt-len", str(plen), "--gen", str(gen),
                          "--tuned-ops", "--pretune", "--assert-frozen"],
                         cfg=cfg)
        gc.collect()
        torch.cuda.empty_cache()
        toks = torch.tensor(rep["tokens"])
        st = rep["dispatch"]
        if not rep["logits_finite"] or not rep["device"].startswith("cuda"):
            fail(f"[families] {label} {batch}x{plen}: device "
                 f"{rep['device']}, finite logits {rep['logits_finite']}")
        if toks.shape != (batch, gen + 1) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            fail(f"[families] {label}: bad tokens {tuple(toks.shape)}")
        if st["frozen"] != st["total"] or st["live"] or st["fallback"] \
                or rep["runtime_tunes"]:
            fail(f"[families] {label}: {st}, {rep['runtime_tunes']} "
                 f"runtime tunes")
        print(f"[families] {label} {batch}x{plen}+{gen}: prefill "
              f"{rep['prefill_ms']:.1f} ms, {rep['ms_per_token']:.2f} "
              f"ms/token, wall {time.perf_counter() - t0:.1f} s; "
              f"{len(rep['instances'])} unique instances, "
              f"{st['frozen']}/{st['total']} frozen, {st['live']} live, "
              f"{st['fallback']} fallback, {rep['runtime_tunes']} runtime "
              f"tunes; first tokens {rep['tokens'][0][:8]}", flush=True)
        reports.append(rep)
    launches = kernels.launch_counts()       # ... and ends here
    print(f"[families] {label} CUDA launches: "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    _require_picks_launched(f"[families] {label}", reports, launches)
    return reports, launches


def _require_picks_launched(what: str, reports, launches) -> None:
    """Fatal unless every kernel family the serving instances picked
    launched on the path (each pick's wrapper counts under its variant's
    name or the kernel's, the gated MLP's also under its family's)."""
    from repro_torch.kernels import mlp_matmul as mlp
    counter = {"fused": (mlp.GATED_TILES, mlp._GATED_COUNTER),
               "stream": (mlp.STREAM_TILES, mlp._STREAM_COUNTER)}
    selected = set()
    for rep in reports:
        for inst in rep["instances"]:
            p = inst["params"]
            selected.add(p.get("variant", inst["kernel"]))
            if inst["kernel"] == "mlp_matmul" and p["variant"] in counter:
                table, names = counter[p["variant"]]
                selected.add(names[table[p["tile"]][5]])
    missing = sorted(k for k in selected if launches.get(k, 0) == 0)
    if missing:
        fail(f"{what}: kernels picked for the path never launched: "
             f"{missing}")


def _moe_byte_floor(cfg) -> float:
    """Bytes one MoE decode step must read for its experts: every
    routed expert's three matrices in every MoE layer (the capacity of
    at least 32 slots meets every expert each step)."""
    n_moe = cfg.n_layers - cfg.first_dense_layers
    e = max(cfg.n_experts, cfg.pad_experts_to)
    return 2.0 * n_moe * e * 3 * cfg.d_model * cfg.d_ff_expert


def _profile_moe_decode(dev, cfg, batch: int, prompt_len: int,
                        steps: int = 4) -> dict:
    """`torch.profiler` over ``steps`` decode steps of ``cfg`` at the
    first request's shape: device busy ms per step beside the experts'
    byte floor, the idle share, device time by kernel."""
    import torch
    from repro_torch.distributed import make_serve_fns
    from repro_torch.models import build_model
    from repro_torch.models.layers import use_tuned_layers

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
    del params, cache
    torch.cuda.empty_cache()
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        fail("[families] the profiler recorded no device time")
    floor = _moe_byte_floor(cfg)
    floor_ms = floor / HBM_BYTES_PER_S * 1e3
    print(f"[families] {cfg.name} decode batch {batch}: {steps} steps in "
          f"{wall_ms:.1f} ms wall ({wall_ms / steps:.2f} ms/step), device "
          f"busy {busy / steps:.2f} ms/step, idle share "
          f"{1 - busy / wall_ms:.3f}; the experts' byte floor "
          f"{floor / 1e9:.2f} GB/step = {floor_ms:.2f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s", flush=True)
    for ms, key, n in rows[:14]:
        print(f"[families]   {ms / steps:8.3f} ms/step  "
              f"{100 * ms / busy:5.1f}%  x{n // steps:<4d} {key[:90]}")
    return {"busy_ms_per_step": busy / steps, "wall_ms_per_step":
            wall_ms / steps, "floor_ms": floor_ms}


def _hold_instances(dev, instances: dict) -> list:
    """Each unique (kernel, signature) -> pick: launched on the card,
    held against its plain version (bf16 2e-2, f32 2e-4), timed (CUDA
    events, and device time per call by `torch.profiler`) beside that
    version, its bound and its one-call library equivalent."""
    import torch
    rows = []
    for (kid, sig_items), (params, configs) in instances.items():
        sig = dict(sig_items)
        launch, plain, lib, nbytes, flops = _instance_fns(dev, kid, sig,
                                                          params)
        got, want = launch(), plain()
        torch.cuda.synchronize()
        tol = FAMILY_TOL[sig["dtype"]]
        try:
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
        except AssertionError as e:
            fail(f"[families] {kid} {sig} {params} disagrees with its "
                 f"plain version: {str(e).splitlines()[0:4]}")
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        b_ms, b_by = bound(nbytes, flops, sig["dtype"])
        row = dict(kernel=kid, signature=sig, params=params,
                   configs=sorted(configs), max_abs_err=err,
                   ms=time_ms(launch), plain_ms=time_ms(plain),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=time_ms(lib) if lib is not None else None,
                   device_us=device_us(launch),
                   library_device_us=(device_us(lib) if lib is not None
                                      else None))
        rows.append(row)
        shape = ",".join(f"{k}={v}" for k, v in sig.items()
                         if k != "dtype")
        tag = f"{params.get('variant', kid)}/{params['tile']}"
        print(f"[families] {kid} {sig['dtype']} {shape} -> {tag}: "
              f"max|err| {err:.3g} | kernel {row['ms']:.4f} ms, device "
              f"{row['device_us']:.2f} us | plain {row['plain_ms']:.4f} ms "
              f"| bound {b_ms:.4f} ms ({b_by}, "
              f"{100e3 * b_ms / row['device_us']:.0f}% of device time) | "
              f"library "
              + (f"{row['library_ms']:.4f} ms, device "
                 f"{row['library_device_us']:.2f} us" if lib is not None
                 else "none") + f" | {', '.join(row['configs'])}",
              flush=True)
        torch.cuda.empty_cache()
    return rows


def phase_families(dev, gemma_reports) -> dict:
    """The other model families at published width: qwen2-moe-a2.7b at
    its full depth for both REQUESTS and a profiled decode, then each
    other config for FAMILY_REQUEST (depth cut per FAMILY_DEPTH), every
    config's dispatches frozen; then every unique instance of the ten
    configs (gemma-7b's from [serve]) launched on its H100 pick and held
    against its plain version.  Returns {"launches": qwen2-moe's path's
    counts, "profile": ..., "rows": [...]}."""
    from repro_torch.configs import ARCHS, get_config

    t_phase = time.perf_counter()
    instances = {}

    def collect(reports, name):
        for rep in reports:
            for inst in rep["instances"]:
                key = (inst["kernel"], tuple(sorted(
                    inst["signature"].items())))
                instances.setdefault(key, (inst["params"], set()))[1].add(
                    name)

    collect(gemma_reports, "gemma-7b")
    out = {}
    for arch in ["qwen2-moe-a2.7b"] + [a for a in ARCHS if a not in (
            "qwen2-moe-a2.7b", "gemma-7b")]:
        full = get_config(arch)
        n = FAMILY_DEPTH.get(arch, full.n_layers)
        cfg = dataclasses.replace(full, n_layers=n)
        cut = "no depth cut" if n == full.n_layers else "depth cut"
        print(f"[families] {arch} at full width: d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads x {cfg.hd} (kv {cfg.n_kv}), d_ff "
              f"{cfg.d_ff_expert if cfg.family == 'moe' else cfg.d_ff}"
              + (f" x {cfg.n_experts} experts top-{cfg.top_k} + "
                 f"{cfg.n_shared} shared" if cfg.family == "moe" else "")
              + f", vocab {cfg.vocab}, {n} of {full.n_layers} layers "
              f"({cut}), {cfg.num_params() * 2 / 1e9:.1f} GB of "
              f"{cfg.dtype} weights from seed 0", flush=True)
        if arch == "qwen2-moe-a2.7b":
            reports, launches = _serve_family(arch, cfg, REQUESTS)
            for op, names in (("rms_norm", ("rms_norm",)),
                              ("flash_attention", ("flash", "blocked")),
                              ("mlp_matmul", ("fused", "stream", "split")),
                              ("matmul", ("matmul",))):
                if not any(launches[k] for k in names):
                    fail(f"[families] {arch}: {op} launched no CUDA "
                         f"kernel")
            out["launches"] = launches
            batch, plen, _ = REQUESTS[0]
            out["profile"] = _profile_moe_decode(dev, cfg, batch, plen)
        else:
            reports, _ = _serve_family(arch, cfg, (FAMILY_REQUEST,))
        collect(reports, arch)
    whisper = get_config("whisper-tiny")
    if not any(k == "flash_attention" and not dict(sig)["causal"]
               and dict(sig)["sq"] == whisper.enc_seq
               for k, sig in instances):
        fail("[families] whisper's non-causal encoder attention is not "
             "among the instances")
    print(f"[families] {len(instances)} unique instances over the ten "
          f"configs, each on its H100 pick:", flush=True)
    out["rows"] = _hold_instances(dev, instances)
    # on device time: a wrapper's CUDA-event time under 0.05 ms is
    # mostly the host's
    slow = [r for r in out["rows"]
            if (r["library_device_us"] is not None
                and r["device_us"] > r["library_device_us"])
            or 1e3 * r["bound_ms"] < 0.5 * r["device_us"]]
    print(f"[families] {len(slow)} of {len(out['rows'])} picks slower "
          f"than their library call or under half of their bound on "
          f"device time: "
          + "; ".join(f"{r['kernel']} {r['params']['tile']} "
                      f"{r['signature']}" for r in slow))
    print(f"[families] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


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
        fail("[profile] the profiler recorded no device time")
    out = {"decode_busy_ms": busy / steps}
    print(f"[profile] decode batch {batch}: {steps} steps in {wall_ms:.1f} "
          f"ms wall ({wall_ms / steps:.2f} ms/step), device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    for ms, key, n in rows[:12]:
        print(f"[profile]   {ms / steps:8.3f} ms/step  {100 * ms / busy:5.1f}%"
              f"  x{n // steps:<4d} {key[:90]}")
    out["decode"] = _per_launch("decode", rows, steps)
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
    out["prefill"] = _per_launch("prefill", rows, 1)
    out["prefill_busy_ms"] = busy
    del params, cache
    torch.cuda.empty_cache()
    out["table4"] = _table4_device_us(dev)
    return out


def _table4_device_us(dev) -> dict:
    """Device time per launch of matvec, atax and BiCG at TABLE4_SHAPES,
    float32 and bfloat16, on the tile the tuning path picks: {(kernel,
    dtype): us}."""
    import torch
    from repro_torch import tuning_cache as tc
    from repro_torch.kernels import api
    from repro_torch.kernels import atax as ax
    from repro_torch.kernels import bicg as bc
    from repro_torch.kernels import matvec as mv
    launch = {"matvec": mv.matvec_cuda, "atax": ax.atax_cuda,
              "bicg": bc.bicg_cuda}
    out = {}
    for kid, fn in launch.items():
        for dtype in ("float32", "bfloat16"):
            sig = dict(TABLE4_SHAPES[kid], dtype=dtype)
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            args = api.get_spec(kid).make_inputs(gen, **sig)
            tile = tc.lookup_or_tune(kid, spec="h100", db=tc.TuningDatabase(),
                                     **sig)[api.TILE_AXIS]
            us = device_us(lambda: fn(*args, tile=tile))
            out[(kid, dtype)] = us
            print(f"[profile] {kid} {dtype} "
                  f"{'x'.join(str(v) for v in TABLE4_SHAPES[kid].values())} "
                  f"tile {tile}: {us:.2f} us device time per launch "
                  f"(kernels of one call)", flush=True)
            del args
    torch.cuda.empty_cache()
    return out


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


def _device_events(prof):
    """The device-side events of a profile (kernels, copies, sets).  A
    CPU op's row repeats, as its self device time, the time of the
    kernels it launched: summing it beside theirs counts them twice."""
    import torch
    return [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]


def _device_rows(prof):
    """(device ms, kernel name, launches) of a profile's device-side
    events, largest first."""
    rows = []
    for ev in _device_events(prof):
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt > 0:
            rows.append((dt / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows


def _per_launch(what: str, rows, steps: int) -> dict:
    """The port's kernels' device time per launch in a profile:
    {kernel name: (launches per step, us per launch)}."""
    out = {}
    for ms, key, n in rows:
        for tag, names in PROFILED.items():
            # whole names: gemv_kernel is not stream_gemv_kernel
            if any(re.search(rf"(?<!\w){k}<", key) for k in names):
                out[key] = (n // steps, 1e3 * ms / n)
                print(f"[profile]   {what} {tag} {key[:60]}: x{n // steps} "
                      f"per step, {1e3 * ms / n:.2f} us device time per "
                      f"launch")
    return out


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
                                      custom_kernel, serve_lm)
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
            dev_us = device_us(lambda: ops.mega_matmul(a, b))
        lib_ms = time_ms(lambda: torch.matmul(a, b))
        lib_us = device_us(lambda: torch.matmul(a, b))
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

    # last: it serves on a fresh default database and resets it after;
    # the example itself fails on logits past bf16's tolerance or on a
    # parting that is not a tie
    print("[extend] examples/serve_lm.main([]) (graph pretune, freeze, "
          "tuned serving, plain fallback):", flush=True)
    before = kernels.launch_counts()
    rep = serve_lm.main([])
    st = rep["dispatch"]
    ran = {k: v - before[k] for k, v in kernels.launch_counts().items()
           if v - before[k]}
    parts = [(p["row"], p["step"], round(p["gap"], 5),
              round(p["top1_top2"], 5)) for p in rep["parts"]]
    print(f"[extend] serve_lm: greedy tokens tuned == fallback "
          f"{rep['match']}; logits max|err| {rep['max_abs_err']:.4g}; "
          f"partings (row, step, plain top minus tuned token, top-1 minus "
          f"top-2), each a tie: {parts}; {st['frozen']}/{st['total']} "
          f"dispatches frozen, {rep['runtime_tunes']} runtime tunes, "
          f"kernel launches {ran}", flush=True)
    if rep["runtime_tunes"] or st["frozen"] != st["total"] or not ran:
        fail(f"serve_lm: tuned serving was not all frozen kernel launches "
             f"({st}, {rep['runtime_tunes']} tunes, launches {ran})")
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
                            composite_device_us=device_us(composite))
                other = (f"torch composite (conv2d + boundary copy, 3 "
                         f"calls) {base['composite_ms']:.4f} ms, device "
                         f"{base['composite_device_us']:.2f} us, max|err| "
                         f"{c_err:.3g}")
            else:
                def lib(a, b):
                    return torch.add(b, a, alpha=2.0)
                base.update(library_ms=time_ms(lambda: lib(*args)),
                            library_device_us=device_us(
                                lambda: lib(*args)))
                other = (f"library torch.add(b, a, alpha=2) "
                         f"{base['library_ms']:.4f} ms, device "
                         f"{base['library_device_us']:.2f} us")
            tol = EXT_TOL[kid] if dtype == "float32" else 2e-2
            for name, tile in tiles.items():
                err = _hold(kid, fn(*args, tile=tile), plain(*args), dtype,
                            f"8192x8192 {dtype} tile {tile}")
                row = dict(base, max_abs_err=err,
                           ms=time_ms(lambda: fn(*args, tile=tile)),
                           device_us=device_us(lambda: fn(*args, tile=tile)),
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


# ---------------------------------------------------------------------------
# phase 9: the extraction tier on the card's own binaries
# ---------------------------------------------------------------------------

# each KERNELS row: (kernel id, variant, element type) of the row it
# holds; the split-K reduction is a kernel of its own, not a row
EXTRACT_ROWS = {
    "matmul": ("matmul", None, "bfloat16"),
    "matmul_prefill": ("matmul", None, "bfloat16"),
    "splitk_reduce": (None, None, "bfloat16"),
    "rms_norm": ("rms_norm", None, "bfloat16"),
    "rms_cluster": ("rms_norm", None, "bfloat16"),
    "rms_simt": ("rms_norm", None, "bfloat16"),
    "rms_simt_ragged": ("rms_norm", None, "bfloat16"),
    "flash": ("flash_attention", "flash", "bfloat16"),
    "flash_tf32": ("flash_attention", "flash", "float32"),
    "flash_simt": ("flash_attention", "flash", "float32"),
    "blocked_tc": ("flash_attention", "blocked", "bfloat16"),
    "blocked_simt": ("flash_attention", "blocked", "bfloat16"),
    "fused": ("mlp_matmul", "fused", "bfloat16"),
    "fused_simt": ("mlp_matmul", "fused", "bfloat16"),
    "stream": ("mlp_matmul", "stream", "bfloat16"),
    "stream_simt": ("mlp_matmul", "stream", "bfloat16"),
    "split": ("mlp_matmul", "split", "bfloat16"),
    "matvec": ("matvec", None, "float32"),
    "atax": ("atax", None, "float32"),
    "bicg": ("bicg", None, "float32"),
    "jacobi3d": ("jacobi3d", None, "float32"),
    "jacobi_plane": ("jacobi3d", None, "float32"),
    "stencil2d": ("stencil2d", None, "float32"),
    "stencil2d_march": ("stencil2d", None, "float32"),
    "saxpy2d": ("saxpy2d", None, "float32"),
}
# a signature per kernel id for its rows' symbols (the element type is
# the row's)
EXTRACT_SIGS = {
    "matmul": dict(m=4, n=3072, k=24576),
    "rms_norm": dict(m=4, d=3072),
    "flash_attention": dict(b=4, h=16, sq=64, skv=64, d=256, causal=True),
    "mlp_matmul": dict(m=4, d=3072, f=24576, act="gelu"),
    "stencil2d": dict(y=8192, x=8192), "saxpy2d": dict(m=8192, n=8192),
    **TABLE4_SHAPES}
# (b): the decode instances and prefill's two wgmma kernels, with the
# name `torch.profiler` gives the kernel and the [profile] pass it is in
ISSUE_CASES = (
    ("stream_gemv m=4", "mlp_matmul",
     dict(m=4, d=3072, f=24576, act="gelu", dtype="bfloat16"),
     "stream_gemv_kernel", "decode"),
    ("gemv_kernel m4s16", "matmul",
     dict(m=4, n=3072, k=24576, dtype="bfloat16"), "gemv_kernel", "decode"),
    ("rms_vec", "rms_norm", dict(m=4, d=3072, dtype="bfloat16"),
     "rms_vec_kernel", "decode"),
    ("gated_wgmma prefill", "mlp_matmul",
     dict(m=256, d=3072, f=24576, act="gelu", dtype="bfloat16"),
     "gated_wgmma_kernel", "prefill"),
    ("wgmma_kernel prefill", "matmul",
     dict(m=256, n=3072, k=24576, dtype="bfloat16"), "wgmma_kernel",
     "prefill"))


def _row_tile(shape: str):
    """(variant or None, tile) of a [kernels] row's shape string."""
    vid, _, tile = shape.partition("tile ")[2].split()[0].rpartition("/")
    return vid or None, tile


def _loop_line(fn) -> str:
    """The census of a function's main loop (the loop a row's K, D or KV
    runs through) and, where work loops nest in it, of the largest
    innermost one."""
    from repro_torch.core.sass import census
    loop = fn.main_loop()
    if loop is None:
        return "no loop (straight-line code)"
    loops = census(fn, {loop.index: 1.0}).loops

    def line(what, lc):
        classes = ", ".join(f"{k} {v}" for k, v in sorted(
            lc["classes"].items(), key=lambda kv: -kv[1]))
        return (f"{what} {lc['instructions']} instructions a pass "
                f"({classes}), {lc['stall_cycles']} stall cycles, "
                f"{lc['opcodes']}")
    out = line("main loop", loops[loop.index])
    inner = [l for l in fn.innermost()
             if l is not loop and l.addrs < loop.addrs]
    if inner:
        big = max(inner, key=lambda l: len(l.addrs))
        out += "; " + line("innermost", loops[big.index])
    return out


def _one_bound_bytes(kid: str, sig: dict) -> float:
    """Each input read once and each output written once (bf16)."""
    if kid == "matmul":
        m, n, k = sig["m"], sig["n"], sig["k"]
        return 2.0 * (m * k + k * n + m * n)
    if kid == "mlp_matmul":
        m, d, f = sig["m"], sig["d"], sig["f"]
        return 2.0 * (m * d + 2 * d * f + m * f)
    return 2.0 * 2 * sig["m"] * sig["d"] + 4.0 * sig["d"]


def phase_extract(rows: dict, ranking: list, profile: dict) -> dict:
    """The extraction tier on the port's own binaries, with no kernel
    built or launched: (a) the SASS census of every KERNELS row's
    kernels, fatal where a row names no function of the disassembly;
    (b) issue time beside the bytes bound and [profile]'s device time on
    the decode instances and prefill's wgmma kernels; (c) [ranking]'s
    instances ranked by the pipeline tier on SASS streams against the
    same run's times, beside eq6 and the feature-row pipeline; (d) one
    gemma-7b decode step and prefill at full width traced on ``meta``
    tensors, through `mix_of_fn`'s extractor and the H100 roofline,
    fatal if the step reads less than one copy of the weights.  Returns
    {KERNELS name: its SASS summary}."""
    import numpy as np
    import torch
    from repro_torch import tuning_cache as tc
    from repro_torch.configs import get_config
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.mix import mix_from_graph, trace_fn
    from repro_torch.core.predict import spearman
    from repro_torch.core.roofline import roofline_from_artifacts
    from repro_torch.core.sass import find_function, template_symbol, \
        use_sass
    from repro_torch.distributed import make_serve_fns
    from repro_torch.kernels import _cuda, api
    from repro_torch.models import build_model
    from repro_torch.models.layers import use_tuned_layers

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        parts = list(ex.map(_cuda.sass_functions, (None,) + EXTEND))
    funcs = {k: v for part in parts for k, v in part.items()}
    print(f"[extract] cuobjdump -res-usage -sass of the library and the "
          f"{', '.join(EXTEND)} extensions: {len(funcs)} functions, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (a) every KERNELS row's functions
    summary = {}
    for name in KERNELS:
        kid, vid, dtype = EXTRACT_ROWS[name]
        if kid is None:
            syms = (template_symbol("splitk_reduce_kernel", dtype),)
            tile = "-"
        else:
            rvid, tile = _row_tile(rows[name]["shape"])
            params = {"tile": tile} if vid is None else {
                "variant": rvid or vid, "tile": tile}
            syms = api.get_spec(kid).sass_symbols(
                params, **EXTRACT_SIGS[kid], dtype=dtype)
        if not syms:
            fail(f"[extract] {name} {tile}: its launch space names no "
                 f"SASS function")
        for k, sym in enumerate(syms):
            fn = find_function(funcs, sym)
            if fn is None:
                fail(f"[extract] {name} {tile} {dtype}: no function "
                     f"{sym}... in the disassembly")
            loop = fn.main_loop()
            if k == 0:
                summary[name] = dict(
                    function=fn.demangled, regs=fn.regs, local=fn.local,
                    spills=fn.spill_stores + fn.spill_loads,
                    instructions=len(fn.instructions),
                    loop_instructions=(len(fn.body(loop))
                                       if loop is not None else 0))
            print(f"[extract] {name} {tile} {dtype}: {fn.demangled[:90]}: "
                  f"{fn.regs} registers, {fn.local} B local, spills "
                  f"{fn.spill_stores} STL / {fn.spill_loads} LDL, "
                  f"{len(fn.instructions)} instructions, "
                  f"{len(fn.loops)} loops; {_loop_line(fn)}", flush=True)

    # (b) issue time beside the bounds
    clock = H100_SXM.gpu_clock_mhz * 1e6
    issue_rate = 4 * H100_SXM.multiprocessors * clock
    print(f"[extract] issue bound = warp instructions / (4 schedulers x "
          f"{H100_SXM.multiprocessors} SMs x {clock / 1e9:.2f} GHz, the "
          f"spec's boost clock)", flush=True)
    for label, kid, sig, kname, where in ISSUE_CASES:
        spec = api.get_spec(kid)
        p = tc.lookup_or_tune(kid, spec="h100", db=tc.TuningDatabase(),
                              **sig)
        row = spec.sass_row(p, funcs, **sig)
        c = row.census
        instr = c.instructions
        hbm = row.info.mix.hbm_bytes
        t_issue = instr / issue_rate * 1e6
        t_bytes = hbm / HBM_BYTES_PER_S * 1e6
        t_once = _one_bound_bytes(kid, sig) / HBM_BYTES_PER_S * 1e6
        hits = [(n, us) for key, (n, us) in profile[where].items()
                if re.search(rf"(?<!\w){kname}<", key)]
        meas = max(hits)[1] if hits else float("nan")
        loop = row.function.main_loop()
        classes = ", ".join(f"{k} {v:.3g}" for k, v in c.issued.items()
                            if v)
        print(f"[extract] {label} {p}: {instr:.4g} warp instructions "
              f"issued ({classes}), "
              f"main loop {row.trips.get(loop.index, 0) if loop else 0:.3g} "
              f"passes a warp x {row.warps:.0f} warps; "
              f"{instr / hbm:.4f} instructions per HBM byte; issue bound "
              f"{t_issue:.2f} us | the row's bytes {t_bytes:.2f} us, one "
              f"read of each operand {t_once:.2f} us | [profile] device "
              f"{meas:.2f} us per launch", flush=True)

    # (c) the ranking instances on SASS streams
    want = [("matmul", dict(m=256, n=3072, k=24576, dtype="bfloat16")),
            ("matmul", dict(m=4, n=3072, k=24576, dtype="bfloat16")),
            ("rms_norm", dict(m=256, d=3072, dtype="bfloat16")),
            ("rms_norm", dict(m=4, d=3072, dtype="bfloat16")),
            ("rms_norm", dict(RMS_LONG)),
            ("mlp_matmul", dict(m=256, d=3072, f=24576, act="gelu",
                                dtype="bfloat16")),
            ("mlp_matmul", dict(m=4, d=3072, f=24576, act="gelu",
                                dtype="bfloat16"))] + [
        ("flash_attention", dict(b=4, h=16, sq=64, skv=64, d=256,
                                 causal=True, dtype=dt))
        for dt in ("bfloat16", "float32")]
    with use_sass(funcs):
        for kid, sig in want:
            r = next((r for r in ranking if r["kernel"] == kid
                      and r["sig"] == sig), None)
            if r is None:
                fail(f"[extract] {kid} {sig}: not among [ranking]'s rows")
            times, via = _pipeline_rank(kid, sig, r["rows"])
            pick = r["names"].index(f"{via.get('variant', kid)}/"
                                    f"{via['tile']}")
            shape = {k: v for k, v in sig.items() if k not in ("act",
                                                                  "causal")}
            for what, meas in (("wrapper", r["meas"]),
                               ("device", r["dev_ms"])):
                if meas is None:
                    continue
                best = int(np.argmin(meas))
                eq6 = r["names"].index(r["pick"])
                pipe = r["names"].index(r["pipe_pick"])
                rho = lambda t: spearman(t, meas) if len(t) > 2 else 0.0
                eq6_rho = r["rho"] if what == "wrapper" else r["device_rho"]
                print(f"[extract] {kid} {shape} on {what} time: SASS "
                      f"pipeline pick {r['names'][pick]} regret "
                      f"{meas[pick] / meas[best]:.2f}x spearman "
                      f"{rho(times):.2f}; eq6 "
                      f"{r['pick']} {meas[eq6] / meas[best]:.2f}x "
                      f"{eq6_rho:.2f}; feature-row pipeline "
                      f"{r['pipe_pick']} {meas[pipe] / meas[best]:.2f}x "
                      f"{rho(r['ptimes']):.2f}; best {r['names'][best]}",
                      flush=True)
            print("[extract]   SASS pipeline pred ms: " + "; ".join(
                f"{n} {1e3 * t:.4f}" for n, t in zip(r["names"], times)))

    # (d) one decode step and one prefill of 4 x 64 + 32, traced
    cfg = get_config("gemma-7b")
    model = build_model(cfg)
    params = model.init(seed=0, device="meta")
    prefill, decode = make_serve_fns(model)
    tokens = torch.zeros((4, 64), dtype=torch.long, device="meta")
    with torch.inference_mode(), use_tuned_layers():
        g_pre = trace_fn(prefill, params, {"tokens": tokens})
        with api.collect_dispatches():
            _, cache = prefill(params, {"tokens": tokens})
        g_dec = trace_fn(decode, params, cache,
                         torch.zeros((4, 1), dtype=torch.long,
                                     device="meta"))
    weights = sum(p.value.numel() * p.value.element_size()
                  for k, p in _param_items(params) if k != "embed")
    n_params = sum(p.value.numel() for _, p in _param_items(params))
    floor_ms = weights / HBM_BYTES_PER_S * 1e3
    for what, graph, tokens_n, busy in (
            ("decode step", g_dec, 4, profile["decode_busy_ms"]),
            ("prefill", g_pre, 4 * 64, profile["prefill_busy_ms"])):
        mix = mix_from_graph(graph)
        terms = roofline_from_artifacts(
            f"gemma-7b {what}", {}, None, 1, 2.0 * n_params * tokens_n,
            spec=H100_SXM, mix=mix)
        leaves = sum(1 for o in graph.ops if o.kernel is not None)
        print(f"[extract] gemma-7b {what} (4 x 64 + 32, traced on meta: "
              f"{len(graph.ops)} ops, {leaves} tuned-op leaves): "
              f"mxu {mix.mxu_flops:.4g} vpu {mix.vpu_flops:.4g} trans "
              f"{mix.trans_flops:.4g} flops, {mix.hbm_bytes / 1e9:.3f} GB; "
              f"t_compute {terms.t_compute * 1e3:.3f} ms, t_memory "
              f"{terms.t_memory * 1e3:.3f} ms ({terms.dominant}) | "
              f"[profile] device busy {busy:.2f} ms | bytes floor "
              f"{floor_ms:.2f} ms ({weights / 1e9:.2f} GB of bf16 weights "
              f"past the embedding)", flush=True)
        if what == "decode step" and mix.hbm_bytes < weights:
            fail(f"[extract] the traced decode step reads "
                 f"{mix.hbm_bytes:.4g} B, less than one read of the "
                 f"{weights:.4g} B of weights")
    print(f"[extract] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return summary


# ---------------------------------------------------------------------------
# phase 10: training on one card
# ---------------------------------------------------------------------------

# the CPU tests' tolerances (tests/test_torch_train.py): the metrics
# (loss, grad norm) within 1e-5 relative, every parameter within 1e-4
# (a tenth of one AdamW step at peak lr 1e-3)
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-5, 1e-4
TRAIN_CHECK = ("gemma-7b", "qwen2-moe-a2.7b", "whisper-tiny")
# gemma-7b at its published width, 4 of its 28 layers: f32 masters,
# gradients and two moments are 16 B a parameter
TRAIN_LAYERS = 4


def _train_check(dev, arch: str) -> None:
    """``arch``'s smoke config in float32, three steps of
    `make_train_step` (microbatches 2, remat full) from the same
    parameters and batches on the card and on the CPU."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import TrainStepConfig, make_train_step
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import build_model, map_params
    from repro_torch.models.params import Param, tree_leaves
    from repro_torch.optim import AdamWConfig, init_adamw

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32",
                              remat="full")
    model = build_model(cfg)
    p_cpu = model.init(seed=0, device="cpu", param_dtype=torch.float32)
    p_dev = map_params(lambda p: Param(p.value.to(dev, copy=True), p.dims),
                       p_cpu)
    o_cpu, o_dev = init_adamw(p_cpu), init_adamw(p_dev)
    step = make_train_step(model, AdamWConfig(**TRAIN_OPT),
                           step_cfg=TrainStepConfig(microbatches=2))
    stream = TokenStream(DataConfig(vocab=cfg.vocab, global_batch=4,
                                    seq_len=32))
    batch_cpu = make_batch_fn(cfg, stream, 0, torch.device("cpu"))
    batch_dev = make_batch_fn(cfg, stream, 0, dev)
    losses, norms = [], []
    for s in range(3):
        p_cpu, o_cpu, m_cpu = step(p_cpu, o_cpu, batch_cpu(s))
        p_dev, o_dev, m_dev = step(p_dev, o_dev, batch_dev(s))
        losses.append((float(m_dev["loss"]), float(m_cpu["loss"])))
        norms.append((float(m_dev["grad_norm"]), float(m_cpu["grad_norm"])))
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    # the clip and AdamW's first steps hide a gradient's scale from the
    # losses and parameters; its norm shows it
    norm_err = max(abs(a - b) / abs(b) for a, b in norms)
    param_err = max(
        (a.value.cpu() - b.value).abs().max().item()
        for (_, a), (_, b) in zip(tree_leaves(p_dev), tree_leaves(p_cpu)))
    print(f"[train] check {cfg.name} f32, 3 steps x 2 microbatches, remat "
          f"full, card vs CPU: losses "
          f"{[round(a, 6) for a, _ in losses]} (rel err {loss_err:.3g}, "
          f"tol {TRAIN_LOSS_RTOL:g}), grad norms "
          f"{[round(a, 6) for a, _ in norms]} (rel err {norm_err:.3g}, "
          f"tol {TRAIN_LOSS_RTOL:g}), final params max|err| "
          f"{param_err:.3g} (tol {TRAIN_PARAM_ATOL:g})", flush=True)
    if (loss_err > TRAIN_LOSS_RTOL or norm_err > TRAIN_LOSS_RTOL
            or param_err > TRAIN_PARAM_ATOL):
        fail(f"[train] {cfg.name}: the card's training steps disagree "
             f"with the CPU's")


def _train_full_width(dev, card: str) -> dict:
    """gemma-7b at its published width, depth cut to TRAIN_LAYERS,
    through `launch.train.main`: 8 steps of 8 x 256 tokens, bf16 compute
    over f32 masters, remat full.  Prints the run beside its floor."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import tree_leaves

    full = get_config("gemma-7b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS, remat="full")
    n = cfg.num_params()
    print(f"[train] gemma-7b at full width: d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}; {cfg.n_layers} of {full.n_layers} layers = "
          f"{n / 1e9:.3f} B parameters (f32 masters + grads + 2 moments: "
          f"{16 * n / 1e9:.1f} GB; {16 * full.num_params() / 1e9:.1f} GB "
          f"at {full.n_layers} layers); device memory in use before: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    batch, seq, steps = 8, 256, 8
    opt_launches = _reset_opt_launches()      # the training path starts
    rep = train.main(["--arch", "gemma-7b", "--batch", str(batch),
                      "--seq", str(seq), "--steps", str(steps),
                      "--log-every", "1"], cfg=cfg)
    opt_launches = dict(opt_launches)         # ... and ends here
    leaves = len(list(tree_leaves(rep["state"]["params"])))
    want = len(rep["losses"]) * leaves
    print(f"[train] the optimizer's kernels on gemma-7b's run: "
          f"{opt_launches} over {len(rep['losses'])} steps of {leaves} "
          f"leaves (two a leaf a step: sumsq_kernel and adamw_kernel)",
          flush=True)
    if opt_launches != {"sumsq": want, "adamw": want}:
        fail(f"[train] the optimizer launched {opt_launches}, not "
             f"{want} of each kernel")
    for i, (loss, gn, ms) in enumerate(zip(rep["losses"], rep["grad_norms"],
                                           rep["step_ms"])):
        print(f"[train]   step {i + 1}: loss {loss:.4f}, grad norm "
              f"{gn:.4f}, {ms:.1f} ms", flush=True)
    finite = all(map(lambda x: x == x and abs(x) != float("inf"),
                     rep["losses"] + rep["grad_norms"]))
    if len(rep["losses"]) != steps or not finite:
        fail("[train] gemma-7b: a loss or grad norm is not finite")
    flops = _train_step_flops(cfg, rep["state"]["params"], batch, seq)
    t_flops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_opt = 32.0 * n / HBM_BYTES_PER_S * 1e3
    floor = t_flops + t_opt
    # model FLOPs with the recompute (8ND over every parameter, the
    # embedding's gather and the lm_head outside remat included): a side
    # number, not the floor
    flops_8nd = build_model(cfg).model_flops(
        ShapeSpec("train", seq, batch, "train")) * 8 / 6
    ms = rep["ms_per_step"]
    print(f"[train] gemma-7b {batch} x {seq}, {cfg.n_layers} layers "
          f"({card}): {ms:.2f} ms/step (median of steps 3-{steps}), "
          f"{rep['tokens_per_s']:.0f} tokens/s, peak "
          f"{(rep['peak_bytes'] or 0) / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated) | floor {floor:.2f} ms = "
          f"the step's products, {flops / 1e12:.2f} TFLOP (8ND on the "
          f"remat layers' matrices + 6ND on the lm_head + causal "
          f"attention, no embedding) at bf16 peak {t_flops:.2f} ms + 32 B "
          f"x {n / 1e9:.3f} B params of optimizer traffic at 3.35 TB/s "
          f"{t_opt:.2f} ms; step at {ms / floor:.2f}x the floor "
          f"(model_flops x 8/6 = {flops_8nd / 1e12:.2f} TFLOP, "
          f"{flops_8nd / PEAK_FLOPS['bfloat16'] * 1e3:.2f} ms at the "
          f"peak, for reference)", flush=True)
    out = {k: rep[k] for k in ("losses", "grad_norms", "step_ms",
                               "ms_per_step", "tokens_per_s", "peak_bytes")}
    out.update(floor_ms=floor, flops=flops, flops_8nd=flops_8nd, params=n,
               opt_launches=opt_launches)
    out.update(_train_profile(dev, cfg, rep["state"], batch, seq, t_flops,
                              t_opt))
    del rep
    return out


def _train_step_flops(cfg, params, batch: int, seq: int) -> float:
    """The matrix products one training step runs on a dense model under
    full remat, read off its parameters: forward, recompute and two
    backward products (8 FLOPs a token) on every stacked layer matrix,
    forward and two backward (6) on the lm_head, which sits outside
    remat, and the causal half of the attention scores and values in
    the same four passes.  The embedding is a gather; norms are no
    products."""
    tokens = batch * seq
    layer = sum(p.value.numel() for _, p in _param_items(params["blocks"])
                if p.value.dim() >= 3)
    scores = 8.0 * cfg.n_layers * batch * cfg.n_heads * seq * seq * cfg.hd
    return (8.0 * layer * tokens + 6.0 * params["lm_head"].value.numel()
            * tokens + scores)


def _is_gemm(kernel: str) -> bool:
    k = kernel.lower()
    return any(t in k for t in ("gemm", "nvjet", "xmma", "cutlass"))


def _train_profile(dev, cfg, state, batch: int, seq: int, t_flops: float,
                   t_opt: float, steps: int = 2) -> dict:
    """Where a full-width training step's time goes: `torch.profiler`
    over ``steps`` more steps from the trained state (device busy time,
    idle share, the matrix products' share, time by kernel), then the
    optimizer's kernels (`_optimizer_kernels`)."""
    import torch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig

    opt_cfg = AdamWConfig(peak_lr=3e-3, warmup_steps=0, decay_steps=8)
    step = make_train_step(build_model(cfg), opt_cfg)
    make_batch = make_batch_fn(cfg, TokenStream(DataConfig(
        vocab=cfg.vocab, global_batch=batch, seq_len=seq)), 0, dev)
    p, o = state["params"], state["opt"]
    p, o, _ = step(p, o, make_batch(8))                   # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(steps):
            p, o, _ = step(p, o, make_batch(9 + s))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / steps
    if busy <= 0:
        fail("[train] the profiler recorded no device time")
    gemm = sum(ms for ms, key, _ in rows if _is_gemm(key)) / steps
    print(f"[train] profile, {steps} steps: {wall:.2f} ms/step wall, "
          f"device busy {busy:.2f} ms/step, idle share "
          f"{1 - busy / wall:.3f}; matrix products {gemm:.2f} ms/step "
          f"({100 * gemm / busy:.1f} % of busy; bound at the bf16 peak "
          f"{t_flops:.2f} ms)", flush=True)
    for ms, key, n in rows[:12]:
        print(f"[train]   {ms / steps:8.3f} ms/step  "
              f"{100 * ms / steps / busy:5.1f}%  x{n // steps:<5d} "
              f"{key[:90]}", flush=True)
    del prof
    opt = _optimizer_kernels(dev, p, o, opt_cfg, rows, steps, busy, t_opt)
    return {"profile_wall_ms": wall, "busy_ms": busy, "gemm_ms": gemm,
            **opt}


def _reset_opt_launches() -> dict:
    """The optimizer's launch counters (`optim.adamw.LAUNCHES`, apart
    from the tuning registry's), set to 0."""
    from repro_torch.optim import adamw
    for k in adamw.LAUNCHES:
        adamw.LAUNCHES[k] = 0
    return adamw.LAUNCHES


# the optimizer's kernels in the kernels JSON line.  They have no Pallas
# counterpart: the reference's jitted, donating step lets XLA fuse its
# norm and its per-leaf update; "replaces" names those functions.
OPT_KERNELS = {
    "sumsq": ("src/repro_torch/kernels/csrc/optim.cu",
              "src/repro/optim/adamw.py:44"),
    "adamw": ("src/repro_torch/kernels/csrc/optim.cu",
              "src/repro/optim/adamw.py:67"),
}
# the kernels' global norm against the plain version's: each leaf's sum
# in another order (f32 over at most 786 M squares)
OPT_NORM_RTOL = 1e-6


def _optimizer_kernels(dev, params, opt_state, opt_cfg, rows, steps: int,
                       busy: float, t_opt: float) -> dict:
    """The optimizer's kernels (csrc/optim.cu) on gemma-7b's leaves from
    the trained state and seeded gradients: held against the plain
    version on the card — the global norm within OPT_NORM_RTOL, one
    update of every leaf from the same state and norm with m, v and p
    bit for bit (each operation rounds as the eager op does) — then
    their device time per launch in the profile above, their time over
    one step's leaves beside the plain version's, the bytes bound and
    one PyTorch call each (``torch.dot`` per leaf; ``torch._fused_adamw_``,
    whose clip runs apart and whose eps sits elsewhere: timed, its values
    not compared), their SASS registers; and ``adamw_update`` alone on
    both routes beside ``torch._fused_adamw_``.  Returns the kernels'
    rows of the kernels JSON line."""
    import torch
    from repro_torch.core.sass import find_function, template_symbol
    from repro_torch.kernels import _cuda
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw

    paths = [path for path, _ in tree_leaves(params)]
    ps = [leaf.value for _, leaf in tree_leaves(params)]
    ms = [leaf.value for _, leaf in tree_leaves(opt_state["m"])]
    vs = [leaf.value for _, leaf in tree_leaves(opt_state["v"])]
    gen = torch.Generator(device=dev).manual_seed(0)
    gs = [torch.randn(x.shape, generator=gen, device=dev) * 1e-3
          for x in ps]
    grads = {}
    for path, g in zip(paths, gs):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    n = sum(x.numel() for x in ps)

    # held against the plain version: the kernels on copies, the plain
    # version on the state itself (it scales each gradient in place)
    norm = adamw.global_norm(grads)
    norm_err = _rel(float(norm), float(adamw.global_norm_plain(grads)))
    sq_err = max(abs(float(adamw.sumsq(g))
                     - float(torch.sum(torch.square(g)))) for g in gs)
    same_mv, ulps, p_err = True, 0, 0.0
    state = lambda m, v: {"count": opt_state["count"].clone(),
                          "m": {"w": m}, "v": {"w": v}}
    for x, g, m, v in zip(ps, gs, ms, vs):
        xk, mk, vk = x.clone(), m.clone(), v.clone()
        adamw.update_with_norm({"w": xk}, {"w": g}, state(mk, vk), opt_cfg,
                               norm, kernels=True)
        adamw.update_with_norm({"w": x}, {"w": g}, state(m, v), opt_cfg,
                               norm, kernels=False)
        same_mv = same_mv and torch.equal(mk, m) and torch.equal(vk, v)
        if not torch.equal(xk, x):
            ulps = max(ulps, (xk.view(torch.int32) - x.view(torch.int32))
                       .abs().max().item())
            p_err = max(p_err, (xk - x).abs().max().item())
        del xk, mk, vk
    print(f"[train] the optimizer's kernels against the plain version on "
          f"the card, gemma-7b's {len(ps)} leaves ({n / 1e9:.3f} B "
          f"parameters) from the trained state: global norm rel err "
          f"{norm_err:.3g} (tol {OPT_NORM_RTOL:g}), a leaf's sum of "
          f"squares max|err| {sq_err:.3g}; one update from the same state "
          f"and norm: m and v equal bit for bit {same_mv}, p "
          f"{'equal bit for bit' if ulps == 0 else f'{ulps} ulps off'} "
          f"(max|err| {p_err:.3g}; tol 0 ulps: eager PyTorch's one "
          f"contraction, add_(x, alpha=), is the kernel's fma)", flush=True)
    if norm_err > OPT_NORM_RTOL or not same_mv or ulps:
        fail("[train] the optimizer's kernels disagree with the plain "
             "version")

    # device time per launch in the profile of the steps
    dev_us = {}
    for name, keys in (("sumsq", ("sumsq_kernel", "sumsq_final_kernel")),
                       ("adamw", ("adamw_kernel",))):
        got = [(ms_, c) for ms_, key, c in rows
               if any(k in key for k in keys)]
        step_ms = sum(m_ for m_, _ in got) / steps
        launches = max((c for _, c in got), default=0) // steps
        dev_us[name] = 1e3 * step_ms / max(launches, 1)
        print(f"[train] {name}: {step_ms:.3f} ms/step of device time in "
              f"the profile ({100 * step_ms / busy:.1f} % of busy), "
              f"{launches} launches a step, {dev_us[name]:.1f} us a "
              f"launch", flush=True)

    # one step's leaves, each route; the plain versions scale each
    # gradient by a clip of 1
    b1, b2, eps, wd = (opt_cfg.b1, opt_cfg.b2, opt_cfg.eps,
                       opt_cfg.weight_decay)
    one = torch.ones((), device=dev)
    lr, bc1, bc2 = (torch.full((), x, device=dev) for x in (1e-4, 0.1, 0.05))
    scal = torch.stack([one, lr, bc1, bc2])
    steps_t = [torch.full((), 10.0, device=dev) for _ in ps]
    leaves = list(zip(ps, gs, ms, vs))
    t = lambda fn: time_ms(fn, warmup=1, budget_ms=300.0)
    sq = dict(
        ms=t(lambda: [adamw.sumsq(g) for g in gs]),
        plain_ms=t(lambda: [torch.sum(torch.square(g.float())) for g in gs]),
        library_ms=t(lambda: [torch.dot(g.view(-1), g.view(-1))
                              for g in gs]),
        bound_ms=4.0 * n / HBM_BYTES_PER_S * 1e3)
    up = dict(
        ms=t(lambda: [adamw.adamw_leaf(x, g, m, v, scal, b1, b2, eps, wd)
                      for x, g, m, v in leaves]),
        plain_ms=t(lambda: [adamw.leaf_update_plain(
            x, g, m, v, one, lr, bc1, bc2, opt_cfg)
            for x, g, m, v in leaves]),
        library_ms=t(lambda: torch._fused_adamw_(
            ps, gs, ms, vs, [], steps_t, lr=1e-4, beta1=b1, beta2=b2,
            weight_decay=wd, eps=eps, amsgrad=False, maximize=False)),
        bound_ms=28.0 * n / HBM_BYTES_PER_S * 1e3)
    funcs = _cuda.sass_functions()
    out = {}
    for name, row, sym, err in (
            ("sumsq", sq, template_symbol("sumsq_kernel", "float"), sq_err),
            ("adamw", up, template_symbol("adamw_kernel", "float", "float"),
             p_err)):
        fn = find_function(funcs, sym)
        if fn is None:
            fail(f"[train] no function {sym}... in the disassembly")
        loop = fn.main_loop()
        out[name] = dict(
            row, max_abs_err=err, bound_by="bytes",
            device_us=dev_us[name], shape=f"{len(ps)} f32 leaves, "
            f"{n / 1e9:.3f} B elements",
            sass=dict(regs=fn.regs, spills=fn.spill_stores + fn.spill_loads,
                      loop_instructions=(len(fn.body(loop))
                                         if loop is not None else 0)))
        print(f"[train] {name}_kernel over one step's {len(ps)} leaves: "
              f"{row['ms']:.3f} ms (bound {row['bound_ms']:.3f} ms, bytes: "
              f"{row['bound_ms'] / row['ms']:.2f} of it), plain "
              f"{row['plain_ms']:.3f} ms, one PyTorch call "
              f"{row['library_ms']:.3f} ms ("
              + ("torch.dot a leaf" if name == "sumsq" else
                 "torch._fused_adamw_ over the leaves, no clip")
              + f"); {fn.regs} registers, "
              f"{fn.spill_stores + fn.spill_loads} spill instructions",
              flush=True)

    # the whole update, each route, beside the fused call
    k_ms = t(lambda: adamw.adamw_update(params, grads, opt_state, opt_cfg))
    p_ms = t(lambda: adamw.adamw_update_plain(params, grads, opt_state,
                                              opt_cfg))
    print(f"[train] adamw_update alone: {k_ms:.2f} ms on the kernels "
          f"({100 * k_ms / busy:.1f} % of the step's busy time; bound "
          f"{t_opt:.2f} ms, 32 B a parameter at 3.35 TB/s: "
          f"{t_opt / k_ms:.2f} of it), {p_ms:.2f} ms on the plain version "
          f"({t_opt / p_ms:.2f} of the bound), torch._fused_adamw_ "
          f"{up['library_ms']:.2f} ms (no norm, no clip)", flush=True)
    del grads, gs, leaves
    return {"adamw_ms": k_ms, "adamw_plain_ms": p_ms, "kernels": out}


def _train_fault_resume() -> None:
    """gemma-smoke in bf16 through ``--checkpoint-dir``: an
    uninterrupted run, and one whose fault fires once after the first
    checkpoint; the final parameters must be equal bit for bit."""
    import tempfile
    import torch
    from repro_torch.launch import train
    from repro_torch.models.params import tree_leaves
    from repro_torch.runtime import FaultSchedule, scheduled_fault

    argv = ["--arch", "gemma-7b", "--smoke", "--steps", "8", "--batch",
            "4", "--seq", "64", "--checkpoint-every", "3", "--log-every",
            "0"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as work:
        clean = train.main(argv + ["--checkpoint-dir",
                                   os.path.join(work, "clean")])
        # the hook's 5th call (before step 4) fires once, after the
        # checkpoint of step 3: step 3 runs again from it, 9 steps in all
        faulted = train.main(
            argv + ["--checkpoint-dir", os.path.join(work, "faulted")],
            inject_fault=scheduled_fault(FaultSchedule(after=5, every=0)))
    diffs = [(path, (a.value.float() - b.value.float()).abs().max().item())
             for (path, a), (_, b) in zip(
                 tree_leaves(clean["state"]["params"]),
                 tree_leaves(faulted["state"]["params"]))
             if not torch.equal(a.value, b.value)]
    print(f"[train] fault and resume, gemma-smoke bf16, 8 steps, "
          f"checkpoints every 3: {len(faulted['losses'])} steps run "
          f"(one restart), final parameters equal bit for bit: "
          f"{not diffs}" + (f"; differing leaves {diffs}" if diffs else ""),
          flush=True)
    if faulted["steps"] != 8 or len(faulted["losses"]) != 9 or diffs:
        fail("[train] the resumed run does not reproduce the "
             "uninterrupted run")


def phase_train(dev, card: str) -> dict:
    """The training path (`repro_torch.launch.train`): the card against
    the CPU on three smoke configs, gemma-7b at full width with the
    optimizer's kernels held and timed, and a fault with a restart; the
    registry's launch counters set to 0 before and read after (the
    tuned kernels have no backward, so training launches none).
    Returns gemma-7b's run with the optimizer's kernel rows."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.models.layers import use_tuned_layers

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    # the serving phases switch tuned layers on for the process; a train
    # step refuses them (no backward kernels)
    with use_tuned_layers(False):
        for arch in TRAIN_CHECK:
            _train_check(dev, arch)
        full = _train_full_width(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        _train_fault_resume()
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    print(f"[train] hand-written kernel launches on the training path: "
          f"{sum(launches.values())} {launches}", flush=True)
    if launches:
        fail("[train] the training path launched tuned kernels, which "
             "have no backward")
    print(f"[train] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return full


MESH_STEPS = 3
# on one card, where runs are compared bit for bit, more steps time the
# step: each side's medians read steps 3-10 of two runs, in the order
# meshed, unmeshed, unmeshed, meshed (`_time_again`), so that neither a
# few steps nor a run slowed by the shared host's other work decides
MESH_TIMED_STEPS = 10
# the arch whose step [mesh] (a) profiles, in its config's type (bf16)
PROFILE_ARCH = "gemma-7b"
# one card, (1, 1): the meshed step runs the unmeshed one's work as one
# local program, so its host ms/step stays within 1.25x the unmeshed
# one's and its wall ms/step within 1.15x (medians of steps 3-10 of two
# runs a side, no dispatch mode active)
MESH_ONE_HOST_RATIO, MESH_ONE_WALL_RATIO = 1.25, 1.15


def _mesh_census(params) -> dict:
    """{placements: leaves} of a Param tree on a mesh."""
    from collections import Counter
    from repro_torch.models.params import tree_leaves
    return dict(Counter(str(tuple(leaf.value.placements))
                        for _, leaf in tree_leaves(params)))


def _host_params(params, rank: int) -> dict:
    """{path: whole float32 host tensor} of a Param tree, on rank 0 (a
    DTensor leaf is gathered: every rank joins); {} elsewhere."""
    import torch
    from repro_torch.models.params import tree_leaves
    out = {}
    for path, leaf in tree_leaves(params):
        v = leaf.value
        whole = v.full_tensor() if hasattr(v, "full_tensor") else v
        if rank == 0:
            out[path] = whole.detach().to("cpu", torch.float32, copy=True)
        del whole
    return out


def counted_step(rep) -> dict:
    """One more step of a `launch.train.main` run under ``CommDebugMode``,
    after its timed steps (which run under no dispatch mode): the
    collectives a step issues, by kind."""
    from torch.distributed.tensor.debug import CommDebugMode
    st = rep["state"]
    with CommDebugMode() as comm:
        st["params"], st["opt"], m = rep["train_step"](
            st["params"], st["opt"], rep["make_batch"](rep["steps"]))
        float(m["loss"])
    return {str(k): v for k, v in comm.get_comm_counts().items()}


# host time by op class: the self time of a cProfiled step's functions,
# each in the first class whose words its file or name holds
OP_CLASSES = (
    ("collectives and waits", ("_functional_collectives", "distributed_c10d",
                               "c10d", "all_gather", "reduce_scatter",
                               "all_reduce", "all_to_all", "wait_tensor",
                               "_collective_utils")),
    ("sharding propagation", ("distributed/tensor/_sharding_prop",
                              "distributed/tensor/_op_schema",
                              "distributed/tensor/_ops/",
                              "distributed/tensor/_dtensor_spec")),
    ("redistributes", ("distributed/tensor/_redistribute",
                       "distributed/tensor/placement_types")),
    ("DTensor dispatch", ("distributed/tensor/",)),
    ("autograd and remat", ("utils/checkpoint", "torch/autograd/",
                            "run_backward", "_functions")),
    ("local kernels", ("built-in method", "torch._C", "torch/_ops",
                       "torch/_tensor", "nn/functional", "functional.py")),
)


def op_class(filename: str, name: str) -> str:
    """`OP_CLASSES`' class of a profiled function (file, name), or "model
    and other Python"."""
    text = f"{filename}:{name}".replace("\\", "/")
    for cls, words in OP_CLASSES:
        if any(w in text for w in words):
            return cls
    return "model and other Python"


def step_profile(rep, setting: str) -> dict:
    """Where one steady step of a `launch.train.main` run goes, after its
    timed steps (each a step of its own; every rank takes them): wall and
    host ms (host: the step's start until ``train_step`` returns, before
    the loss is read) of a plain step; device busy (the union of its
    kernels' intervals) and idle share under ``torch.profiler``; host
    time by op class (`OP_CLASSES`) under ``cProfile``, whose hooks
    inflate Python-heavy classes: read its shares, not its sum."""
    import cProfile
    import pstats
    import torch
    st, step, make_batch = rep["state"], rep["train_step"], rep["make_batch"]
    n = [rep["steps"] + 1]

    def one():
        st["params"], st["opt"], m = step(st["params"], st["opt"],
                                          make_batch(n[0]))
        n[0] += 1
        return m

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = one()
    t1 = time.perf_counter()
    float(m["loss"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tp = time.perf_counter()
        float(one()["loss"])
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - tp) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    busy /= 1e3
    del prof
    pr = cProfile.Profile()
    torch.cuda.synchronize()
    tc = time.perf_counter()
    pr.enable()
    m = one()
    pr.disable()
    host_c = (time.perf_counter() - tc) * 1e3
    float(m["loss"])
    by = {}
    for (fname, _, func), row in pstats.Stats(pr).stats.items():
        cls = op_class(fname, func)
        by[cls] = by.get(cls, 0.0) + row[2] * 1e3      # self seconds
    out = {"setting": setting, "wall_ms": (t2 - t0) * 1e3,
           "host_ms": (t1 - t0) * 1e3, "profiled_wall_ms": prof_wall,
           "busy_ms": busy, "idle": 1 - busy / prof_wall,
           "cprofile_host_ms": host_c,
           "by_class_ms": dict(sorted(by.items(), key=lambda kv: -kv[1]))}
    return out


def _host_state(state) -> dict:
    """A host copy of a train state's parameters and moments (what
    rank 0 shares for a held step)."""
    from repro_torch.models.params import Param, map_params
    copy = lambda p: Param(p.value.detach().to("cpu", copy=True), p.dims)
    opt = state["opt"]
    return {"params": map_params(copy, state["params"]),
            "m": map_params(copy, opt["m"]), "v": map_params(copy, opt["v"]),
            "count": opt["count"].detach().to("cpu", copy=True)}


def _shared_state(rank: int, host, mesh, cfg, dev):
    """Rank 0's host state (`_host_state`) on the mesh: each leaf
    scattered from rank 0 by its weight rules (``distribute_tensor``,
    ``src_data_rank=0``: the other ranks send nothing), the count
    broadcast; returns (params, opt state)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import build_model, param_shardings
    from repro_torch.models.params import Param, tree_leaves

    tmpl = build_model(cfg).abstract_params()
    shards = dict(tree_leaves(param_shardings(tmpl, mesh)))

    def place(name):
        src = dict(tree_leaves(host[name])) if rank == 0 else None

        def one(path, p):
            whole = (src[path].value.to(dev) if rank == 0 else
                     torch.empty(p.value.shape, dtype=torch.float32,
                                 device=dev))
            return Param(distribute_tensor(whole, mesh,
                                           shards[path].placements,
                                           src_data_rank=0), p.dims)
        return _map_paths(one, tmpl)
    count = (host["count"].to(dev) if rank == 0 else
             torch.zeros((), dtype=torch.int32, device=dev))
    dist.broadcast(count, src=0)
    return place("params"), {"m": place("m"), "v": place("v"),
                             "count": count}


def _map_paths(fn, tree, path=()):
    from repro_torch.models.params import Param
    if isinstance(tree, Param):
        return fn(path, tree)
    return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}


def _held_steps(rank: int, rep, mesh, cfg, states: dict,
                plain_final: dict) -> dict:
    """Each step k of a float32 run held from one shared state: the
    unmeshed run's state before step k (k = 1: the seed's, which every
    rank builds; else rank 0's host copy of it, ``states[k - 1]``,
    scattered onto the mesh), one meshed step from it with batch k, its
    loss and grad norm, and the parameters after its update against the
    unmeshed step's (``plain_final`` for the last step): per leaf the
    norm of the difference over the norm of the unmeshed update, the
    largest leaf kept.  The placed parameters must be rank 0's state
    bit for bit."""
    import torch
    from repro_torch.models import build_model, device_put, param_shardings
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import init_adamw

    losses, norms, rels, worst, exact = [], [], [], [], []
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    host_params = lambda k: {path: leaf.value for path, leaf in
                             tree_leaves(states[k]["params"])}
    for k in range(1, MESH_STEPS + 1):
        if k == 1:
            params = build_model(cfg).init(seed=0, device=dev,
                                           param_dtype=torch.float32)
            params = device_put(params, param_shardings(params, mesh))
            opt = init_adamw(params)
        else:
            params, opt = _shared_state(rank, states.get(k - 1), mesh, cfg,
                                        dev)
        prev = _host_params(params, rank)
        if k > 1 and rank == 0:
            saved = host_params(k - 1)
            exact.append(saved.keys() == prev.keys() and all(
                torch.equal(prev[path], saved[path]) for path in saved))
        params, opt, m = rep["train_step"](params, opt,
                                           rep["make_batch"](k - 1))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        after = _host_params(params, rank)
        del params, opt, m
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if rank != 0:
            continue
        ref = host_params(k) if k < MESH_STEPS else plain_final
        rel = {path: float((after[path] - ref[path]).norm()
                           / max(float((ref[path] - prev[path]).norm()),
                                 1e-30)) for path in ref}
        leaf = max(rel, key=rel.get)
        rels.append(rel[leaf])
        worst.append(".".join(leaf))
        del ref, after, prev
    return {"losses": losses, "grad_norms": norms, "param_rel": rels,
            "param_leaf": worst, "restored_exact": exact}


def _mesh_rank_nccl(rank: int, world: int, arch: str, layers: int,
                    shape: str, compute: str = "config",
                    held: bool = False) -> dict:
    """One rank of phase (a): ``arch`` at full width, ``layers`` layers,
    on the (data, model) mesh ``shape`` over every card, then the
    unmeshed step on this card (rank 0's report is the phase's), both
    in the config's compute type or, with ``compute="float32"``, in
    float32 with TF32 off.  The timed steps run under no dispatch mode;
    one more step of the meshed run counts its collectives
    (`counted_step`), and `PROFILE_ARCH`'s config-type runs profile one
    more (`step_profile`).  With ``held`` (float32 on several cards)
    every step is also held from one shared state (`_held_steps`): rank
    0's unmeshed run keeps a host copy of its state after each step but
    the last.  Each rank counts its own kernel
    launches (the tuning registry's and the optimizer's) around each
    run; rank 0 compares the two runs' final parameters."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.params import tree_leaves

    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              remat="full")
    if compute == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = dataclasses.replace(cfg, dtype="float32")
    steps = MESH_STEPS if world > 1 else MESH_TIMED_STEPS
    argv = ["--arch", arch, "--batch", "8", "--seq", "256",
            "--steps", str(steps), "--log-every", "0"]
    profile = arch == PROFILE_ARCH and compute == "config"
    launched = lambda: {k: v for k, v in kernels.launch_counts().items()
                        if v}
    kernels.reset_launch_counts()           # the meshed path starts here
    opt = _reset_opt_launches()
    rep = train.main(argv + ["--mesh-shape", shape], cfg=cfg)
    out = {k: rep[k] for k in ("losses", "grad_norms", "step_ms",
                               "host_step_ms", "ms_per_step",
                               "host_ms_per_step", "peak_bytes", "mesh")}
    out["launches"] = {"meshed": launched()}    # ... and ends here
    out["opt_launches"] = dict(opt)
    out["leaves"] = len(list(tree_leaves(rep["state"]["params"])))
    out["compute"] = cfg.dtype
    out["census"] = _mesh_census(rep["state"]["params"])
    mesh = next(iter(tree_leaves(rep["state"]["params"])))[1] \
        .value.device_mesh
    # every rank joins each gather; rank 0 keeps the host copies
    final = _host_params(rep["state"]["params"], rank)
    out["collectives"] = counted_step(rep)
    if profile:
        out["profile"] = {"meshed": step_profile(rep, "meshed")}
    rep["state"] = None         # nothing of the meshed run's state stays
    gc.collect()
    torch.cuda.empty_cache()
    saver, states = None, {}
    if held and rank == 0:
        def saver(n, state):
            if n < MESH_STEPS:
                states[n] = _host_state(state)
    plain_final = {}
    if rank == 0:
        kernels.reset_launch_counts()       # the unmeshed path starts here
        plain = train.main(argv, cfg=cfg, after_step=saver)
        out["launches"]["unmeshed"] = launched()    # ... and ends here
        out["plain"] = {k: plain[k] for k in ("losses", "grad_norms",
                                              "step_ms", "host_step_ms",
                                              "ms_per_step",
                                              "host_ms_per_step",
                                              "peak_bytes")}
        plain_final = _host_params(plain["state"]["params"], 0)
        out["param_err"] = max((plain_final[p] - final[p]).abs().max()
                               .item() for p in plain_final)
        if profile:
            out["profile"]["unmeshed"] = step_profile(plain, "unmeshed")
        del plain
    del final
    gc.collect()
    torch.cuda.empty_cache()
    if world == 1:
        _time_again(out, argv, shape, cfg)
    if held:
        dist.barrier()          # rank 0's states are kept
        out["held"] = _held_steps(rank, rep, mesh, cfg, states, plain_final)
        states.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _runs(timing: dict) -> dict:
    """`_time_again`'s per-run medians, rounded for a log line."""
    return {name: [[round(x, 2) for x in run] for run in runs]
            for name, runs in timing.items()}


def _time_again(out: dict, argv: list, shape: str, cfg) -> None:
    """One card: the unmeshed run, then the meshed one, once more after
    the first two (meshed, unmeshed), so that the four runs go ABBA and
    a drift of the shared host's load between them cancels; each side's
    ms/step (wall and host) becomes the median of its two runs' steps
    past the first two, and ``timing`` keeps each run's own medians."""
    import gc
    import statistics
    import torch
    from repro_torch.launch import train

    sides = {"unmeshed": out["plain"], "meshed": out}
    timing = {name: [(d["ms_per_step"], d["host_ms_per_step"])]
              for name, d in sides.items()}
    for name, extra in (("unmeshed", []),
                        ("meshed", ["--mesh-shape", shape])):
        rep = train.main(argv + extra, cfg=cfg)
        rep["state"] = None
        d = sides[name]
        for key in ("step_ms", "host_step_ms"):
            d[key] = d[key][2:] + rep[key][2:]
        timing[name].append((rep["ms_per_step"], rep["host_ms_per_step"]))
        del rep
        gc.collect()
        torch.cuda.empty_cache()
    for d in sides.values():
        d["ms_per_step"] = statistics.median(d["step_ms"])
        d["host_ms_per_step"] = statistics.median(d["host_step_ms"])
    out["timing"] = timing


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _rels(run: dict, key: str) -> list:
    """Each step's relative difference of ``key`` between a meshed run
    and its unmeshed one."""
    return [_rel(x, y) for x, y in zip(run[key], run["plain"][key])]


def mesh_verdict(world: int, runs: dict, moe: bool = False):
    """Phase (a)'s decision for one arch: (faults, record).  ``runs``
    maps a compute type ("float32", "bfloat16") to rank 0's report of
    `_mesh_rank_nccl` (``losses``, ``grad_norms``, ``param_err``, the
    unmeshed run's under ``plain`` and, for float32 on several cards,
    the steps held from one shared state under ``held``); ``record``
    holds each run's relative differences by step.  On one card the
    bf16 run must equal the unmeshed one (losses and grad norms within
    TRAIN_LOSS_RTOL, parameters within TRAIN_PARAM_ATOL).  On several,
    the float32 run is the gate, twice.  Held: every step of every
    arch, an MoE's too, from the unmeshed run's state before it — losses
    within MESH_F32_LOSS_RTOL, grad norms within MESH_F32_NORM_RTOL and
    each leaf's parameters after the update within MESH_F32_PARAM_RTOL
    of the unmeshed update's norm, the restored state the checkpoint's
    bit for bit.  Chained (each run from its own previous step): losses
    and grad norms within the same bounds, an MoE's on its first
    MESH_MOE_STEPS steps only (the first update's effect included):
    top-k routing is a step function of the router's logits, so once
    updates have moved weights by a rounding, a token near a tie may
    take another expert, which moves the loss by a step, not a
    rounding, and the chained run lets it compound.  The bf16 run's
    losses and grad norms must be finite, its losses within
    MESH_MULTI_RTOL (an MoE's on its first MESH_MOE_STEPS steps), its
    grad norms recorded."""
    faults, record = [], {}
    for compute, run in runs.items():
        rec = record[compute] = {"losses": _rels(run, "losses"),
                                 "grad_norms": _rels(run, "grad_norms"),
                                 "param_err": run["param_err"]}
        tag = f"{compute} on {world} card(s)"
        vals = (run["losses"] + run["grad_norms"] + run["plain"]["losses"]
                + run["plain"]["grad_norms"])
        if len(run["losses"]) != len(run["plain"]["losses"]) or \
                not all(map(math.isfinite, vals)):
            faults.append(f"{tag}: a run stopped short, or a loss or grad "
                          f"norm is not finite")
            continue
        if world == 1:
            loss, norm = max(rec["losses"]), max(rec["grad_norms"])
            if loss > TRAIN_LOSS_RTOL or norm > TRAIN_LOSS_RTOL or \
                    run["param_err"] > TRAIN_PARAM_ATOL:
                faults.append(f"{tag}: the meshed step is not the unmeshed "
                              f"one (losses {loss:.3g}, grad norms "
                              f"{norm:.3g}, params {run['param_err']:.3g})")
            continue
        if compute == "float32":
            faults += _held_faults(tag, run, rec)
        steps = MESH_MOE_STEPS if moe else None
        what = f"steps 1-{steps}'s" if moe else "the"
        loss = max(rec["losses"][:steps])
        norm = max(rec["grad_norms"][:steps])
        if compute == "float32":
            if loss > MESH_F32_LOSS_RTOL:
                faults.append(f"{tag}: {what} losses {loss:.3g} off one "
                              f"card's (tol {MESH_F32_LOSS_RTOL:g})")
            if norm > MESH_F32_NORM_RTOL:
                faults.append(f"{tag}: {what} grad norms {norm:.3g} off "
                              f"one card's (tol {MESH_F32_NORM_RTOL:g})")
        elif loss > MESH_MULTI_RTOL:
            faults.append(f"{tag}: {what} losses {loss:.3g} off one card's "
                          f"(tol {MESH_MULTI_RTOL:g})")
    return faults, record


def _held_faults(tag: str, run: dict, rec: dict) -> list:
    """The held check's faults (`mesh_verdict`), each step's readings
    kept in ``rec["held"]``: the first step past a bound names it."""
    held = run.get("held")
    n = len(run["plain"]["losses"])
    if not held or len(held["losses"]) != n or \
            len(held["param_rel"]) != n or \
            not all(map(math.isfinite, held["losses"] + held["grad_norms"]
                        + held["param_rel"])):
        return [f"{tag}: the steps held from one shared state are missing, "
                f"short or not finite"]
    rec["held"] = {"losses": [_rel(x, y) for x, y in
                              zip(held["losses"], run["plain"]["losses"])],
                   "grad_norms": [_rel(x, y) for x, y in
                                  zip(held["grad_norms"],
                                      run["plain"]["grad_norms"])],
                   "param_rel": list(held["param_rel"]),
                   "param_leaf": list(held.get("param_leaf", []))}
    faults = []
    for k in range(n):
        for key, tol, what in (("losses", MESH_F32_LOSS_RTOL, "loss"),
                               ("grad_norms", MESH_F32_NORM_RTOL,
                                "grad norm"),
                               ("param_rel", MESH_F32_PARAM_RTOL,
                                "parameters")):
            got = rec["held"][key][k]
            if got > tol:
                leaf = (f" (leaf {rec['held']['param_leaf'][k]})"
                        if key == "param_rel" and rec["held"]["param_leaf"]
                        else "")
                faults.append(f"{tag}: step {k + 1} held from the shared "
                              f"state: {what} {got:.3g} off one card's"
                              f"{leaf} (tol {tol:g})")
    if not all(held.get("restored_exact", [])):
        faults.append(f"{tag}: a restored shared state is not its "
                      f"checkpoint bit for bit")
    return faults


def _print_profile(prof: dict, where: str, card: str) -> None:
    classes = ", ".join(f"{k} {v:.2f}" for k, v in
                        prof["by_class_ms"].items())
    print(f"[mesh] (a) profile {PROFILE_ARCH} bf16 8 x 256, {where}: "
          f"wall {prof['wall_ms']:.2f} ms/step, host {prof['host_ms']:.2f} "
          f"ms/step (to train_step's return), device busy "
          f"{prof['busy_ms']:.2f} of {prof['profiled_wall_ms']:.2f} ms "
          f"profiled (idle share {prof['idle']:.3f}); host ms by op class "
          f"under cProfile ({prof['cprofile_host_ms']:.2f} ms in all): "
          f"{classes} ({card})", flush=True)


def _mesh_case(arch: str, layers: int, of: int, shape, card: str):
    """Phase (a) for one arch: the meshed run against the unmeshed one
    (on several cards in float32, each step also held from one shared
    state, then in the config's type), judged by `mesh_verdict` after
    each; fatal on a fault or on any launch of a tuned kernel, and
    unless the optimizer's kernels ran on every leaf of every step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_world

    world = shape[0] * shape[1]
    moe = get_config(arch).family == "moe"
    runs = {}
    for compute in ("float32", "config") if world > 1 else ("config",):
        held = compute == "float32"
        if held:
            # the shared states: f32 parameters and two moments after
            # every step but the last, in rank 0's host memory
            cfg = dataclasses.replace(get_config(arch), n_layers=layers)
            print(f"[mesh] (a) {arch}: the shared states take "
                  f"{12 * cfg.num_params() * (MESH_STEPS - 1) / 1e9:.1f} "
                  f"GB of rank 0's host memory ({cfg.num_params() / 1e9:.3f}"
                  f" B parameters x 12 B x {MESH_STEPS - 1} steps)",
                  flush=True)
        ranks = spawn_world(_mesh_rank_nccl, world, arch, layers,
                            f"{shape[0]},{shape[1]}", compute, held,
                            backend="nccl", timeout=900)
        a = ranks[0]
        plain = a["plain"]
        runs[a["compute"]] = a
        faults, record = mesh_verdict(world, runs, moe)
        rec = record[a["compute"]]
        print(f"[mesh] (a) NCCL, {world} card(s), mesh {a['mesh']}: {arch} "
              f"{layers} of {of} layers in {a['compute']}, "
              f"{len(a['losses'])} steps of 8 x 256: losses {a['losses']} "
              f"vs unmeshed {plain['losses']} (rel err by step "
              f"{[f'{x:.3g}' for x in rec['losses']]}), grad norms "
              f"{a['grad_norms']} vs unmeshed {plain['grad_norms']} (rel "
              f"err by step {[f'{x:.3g}' for x in rec['grad_norms']]}), "
              f"final params max|err| {a['param_err']:.3g}; leaf "
              f"placements {a['census']}; collectives of one step "
              f"counted after the timed ones {a['collectives']}",
              flush=True)
        if "held" in rec:
            h = rec["held"]
            print(f"[mesh] (a) {arch} {a['compute']}, each step held from "
                  f"the unmeshed run's state before it (scattered from "
                  f"rank 0's host copy, bit for bit: "
                  f"{a['held']['restored_exact']}): losses "
                  f"{a['held']['losses']} (rel err by step "
                  f"{[f'{x:.3g}' for x in h['losses']]}), grad norms "
                  f"{a['held']['grad_norms']} (rel err by step "
                  f"{[f'{x:.3g}' for x in h['grad_norms']]}), parameters "
                  f"after the update, |meshed - unmeshed| / |unmeshed "
                  f"update| of the worst leaf by step "
                  f"{[f'{x:.3g}' for x in h['param_rel']]} "
                  f"({h['param_leaf']})", flush=True)
        wall = a["ms_per_step"] / plain["ms_per_step"]
        host = a["host_ms_per_step"] / plain["host_ms_per_step"]
        print(f"[mesh] (a) {arch} {a['compute']}: {a['ms_per_step']:.2f} "
              f"ms/step meshed vs {plain['ms_per_step']:.2f} ms/step "
              f"unmeshed ({wall:.3f}x), host {a['host_ms_per_step']:.2f} "
              f"vs {plain['host_ms_per_step']:.2f} ms/step ({host:.3f}x) "
              f"(medians past the first two steps"
              + (f" of two runs each, run in the order meshed, unmeshed, "
                 f"unmeshed, meshed: wall and host ms/step by run "
                 f"{_runs(a['timing'])}" if "timing" in a else "")
              + f", no dispatch mode active), peak "
              f"{(a['peak_bytes'] or 0) / 1e9:.2f} GB meshed, "
              f"{(plain['peak_bytes'] or 0) / 1e9:.2f} GB unmeshed "
              f"({card})", flush=True)
        if world == 1 and (host > MESH_ONE_HOST_RATIO
                           or wall > MESH_ONE_WALL_RATIO):
            faults.append(f"one card: the meshed step's host {host:.3f}x "
                          f"(at most {MESH_ONE_HOST_RATIO}) or wall "
                          f"{wall:.3f}x (at most {MESH_ONE_WALL_RATIO}) "
                          f"the unmeshed step's")
        for where, prof in (a.get("profile") or {}).items():
            _print_profile(prof, "unmeshed" if where == "unmeshed" else
                           f"meshed {tuple(shape)}", card)
        if faults:
            fail(f"[mesh] (a) {arch}: the meshed step disagrees with the "
                 f"unmeshed one: {'; '.join(faults)}")
        launches = [r["launches"] for r in ranks]
        opt = [r["opt_launches"] for r in ranks]
        n_steps = len(a["losses"])
        want = n_steps * a["leaves"]
        print(f"[mesh] (a) {arch}: hand-written kernel launches, counted in "
              f"each rank around its runs: tuned {launches}, the "
              f"optimizer's on the meshed run {opt} ({want} of each "
              f"wanted: {n_steps} steps x {a['leaves']} leaves)",
              flush=True)
        if any(n for r in launches for run in r.values()
               for n in run.values()):
            fail(f"[mesh] (a) the training path launched tuned kernels: "
                 f"{launches}")
        if any(o != {"sumsq": want, "adamw": want} for o in opt):
            fail(f"[mesh] (a) the optimizer's kernels did not run on every "
                 f"leaf of every step: {opt}")


# (c)'s cells: (arch, shape, --multi-pod)
DRYRUN_CELLS = (("gemma-7b", "train_4k", True),
                ("qwen2-moe-a2.7b", "train_4k", False))
# qwen2-moe-a2.7b train_4k on pod256: the reference's compiled program
# does 1.61 x model_flops / chips per device (repro.launch.dryrun on a
# 16 x 16 mesh of Auto axes, jax 0.9.0, on a CPU; the card's machine has
# no JAX); the port may do at most 1.25 x that
MOE_FLOPS_GATE = 2.0
# (a) on more than one card, against one card's run.  The float32 run
# (TF32 off) is the gate that finds a fault of the meshed step (on
# (2, 2) a sound tree read losses 3.99e-6 and grad norms 5.24e-4 off).
MESH_F32_LOSS_RTOL, MESH_F32_NORM_RTOL = 1e-5, 1e-3
# The config's bf16 run: losses within 1e-2 (gemma-7b read 1.66e-3 on
# (2, 2)); its grad norms are recorded, not gated: the reordered bf16
# sums, amplified by the step-2 gradient spike (norm ~119), part the
# step-3 norms at the parent too (0.123 off; this tree 0.375).
MESH_MULTI_RTOL = 1e-2
# An MoE's gates hold steps 1-2 (qwen2-moe-a2.7b on (2, 2): float32
# 7.16e-6 / 3.92e-5, bf16 losses 8.15e-4 at step 2); its step 3 parts
# by a routing flip (float32 1.43e-4 / 5.57e-3, as far as one card's own
# run moved one ulp parts) and is recorded, unheld.
MESH_MOE_STEPS = 2
# Held from one shared state (float32, several cards): each leaf's
# parameters after a step's update within 1e-2 of the unmeshed update's
# norm, |meshed - unmeshed| / |unmeshed - before|.  A float32 reordering
# moves an AdamW update as it moves the gradient; where a leaf's
# gradient elements are small, Adam's first update (near lr x sign)
# moves most.  Read on (2, 2), a sound tree: qwen2-moe-a2.7b 1.0e-3 at
# step 1 (then 4.25e-4, 6.97e-5), each on blocks.attn.bk, the key bias;
# gemma-7b 3.68e-4 (embed).  One card, every parameter one ulp off
# (tools/train_sensitivity.py), moves the same key bias by 8.2e-4 to
# 8.5e-4: rounding alone.  A rank that skips its shards' update (the
# planted fault, on qwen2-moe's expert weights) read 0.626, 0.549 and
# 0.524.  1e-2 sits a decade above the first and fifty times below the
# second.
MESH_F32_PARAM_RTOL = 1e-2
CARD_BYTES = 80e9
MOE_LAYERS = 2


def phase_mesh(card: str, shape=None) -> None:
    """The mesh tier: (a) NCCL over every visible card (a (data, model)
    = ``shape`` mesh, default (1, cards)), gemma-7b and qwen2-moe-a2.7b,
    each rank's launch counters read; (c) the dry-run (meta tensors:
    nothing runs on the card), left out when ``shape`` is given.  (b),
    four gloo ranks sharing the card, is left out: the functional
    collectives over gloo on CUDA tensors hang there
    (`tools/gloo_cuda.py`); the CPU tests run those worlds."""
    import gc
    import tempfile
    import torch
    from repro_torch.kernels import _cuda

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dryrun = shape is None
    shape = shape or (1, torch.cuda.device_count())
    _cuda.library()         # built here once; each rank loads it

    # (a)
    for arch, layers, of in (("gemma-7b", TRAIN_LAYERS, 28),
                             ("qwen2-moe-a2.7b", MOE_LAYERS, 24)):
        _mesh_case(arch, layers, of, shape, card)
    if not dryrun:
        print(f"[mesh] phase took {time.perf_counter() - t0:.1f} s",
              flush=True)
        return

    # (c)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out_dir:
        t_c = time.perf_counter()
        runs = [(cell, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cell[0], "--shape", cell[1], "--out-dir", out_dir]
            + (["--multi-pod"] if cell[2] else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=SRC))) for cell in DRYRUN_CELLS]
        for (arch, shp, _), run in runs:
            out, _ = run.communicate(timeout=900)
            if run.returncode != 0:
                fail(f"[mesh] (c) the dry-run of {arch} {shp} exited "
                     f"{run.returncode}: {out[-2000:]}")
        for arch, shp, multi in DRYRUN_CELLS:
            for tag in ("pod256", "pod512") if multi else ("pod256",):
                with open(os.path.join(out_dir,
                                       f"{arch}_{shp}_{tag}.json")) as f:
                    r = json.load(f)
                roof, mem = r["roofline"], r["memory_analysis"]
                ratio = r["flops"] / (r["model_flops"] / r["chips"])
                peak = mem["argument_bytes"] + mem["temp_bytes"]
                print(f"[mesh] (c) dry-run {arch} {shp} {tag} (analysis, "
                      f"H100 terms): {r['chips']} ranks, "
                      f"{r['microbatches']} microbatches, flops/device "
                      f"{r['flops']:.4e} = {ratio:.3f} x model_flops / "
                      f"chips, memory peak {peak / 1e9:.2f} GB (arguments "
                      f"{mem['argument_bytes'] / 1e9:.2f} + temporaries "
                      f"{mem['temp_bytes'] / 1e9:.2f}) against the card's "
                      f"{CARD_BYTES / 1e9:.0f} GB: "
                      f"{'fits' if peak <= CARD_BYTES else 'does not fit'}"
                      f", bytes/device {r['bytes_accessed']:.4e}, "
                      f"collective bytes {r['collective_bytes']:.4e} "
                      f"{r['collectives_by_kind']}, t_compute "
                      f"{roof['t_compute']:.4f} s, t_memory "
                      f"{roof['t_memory']:.4f} s, t_collective "
                      f"{roof['t_collective']:.4f} s ({roof['dominant']}), "
                      f"traced in {r['lower_s']} s", flush=True)
                if arch == "qwen2-moe-a2.7b" and tag == "pod256" \
                        and ratio > MOE_FLOPS_GATE:
                    fail(f"[mesh] (c) {arch} {shp} {tag}: {ratio:.3f} x "
                         f"model_flops / chips per device, past "
                         f"{MOE_FLOPS_GATE} (the reference's 1.61 x 1.25)")
        print(f"[mesh] (c) took {time.perf_counter() - t_c:.1f} s",
              flush=True)
    print(f"[mesh] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_memory(card: str) -> dict:
    """[memory]: one unmeshed train step of `train_memory.STEP` on the card,
    its measured peak beside the trace's prediction (module docstring,
    phase 12)."""
    import gc
    import math
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models.layers import use_tuned_layers
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_memory

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    arch, batch, seq = train_memory.STEP
    cfg = get_config(arch)
    # the serving phases switch tuned layers on for the process; a train
    # step refuses them (no backward kernels), traced or run
    with use_tuned_layers(False):
        pred = train_memory.predict(cfg, batch, seq)
        kernels.reset_launch_counts()
        got = train_memory.measure(cfg, batch, seq)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    if got["oom"]:
        fail(f"[memory] {arch} {batch} x {seq}: out of device memory "
             f"({got['error']})")
    if not math.isfinite(got["loss"]):
        fail(f"[memory] {arch}: the step's loss is {got['loss']}")
    if launches:
        fail(f"[memory] the training step launched tuned kernels: "
             f"{launches}")
    ratio = got["peak_bytes"] / pred["peak_bytes"]
    print(f"[memory] {arch} at published width and depth ({cfg.n_layers} "
          f"+ {cfg.enc_layers} layers, vocab {cfg.vocab}), one unmeshed "
          f"train step of {batch} x {seq} tokens, bf16 over f32 masters, "
          f"loss {got['loss']:.4f} ({card}): "
          f"torch.cuda.max_memory_allocated {got['peak_bytes'] / 1e9:.3f} "
          f"GB ({got['before_bytes'] / 1e9:.3f} GB resident before the "
          f"step) | trace {pred['peak_bytes'] / 1e9:.3f} GB = arguments "
          f"{pred['argument_bytes'] / 1e9:.3f} + temporaries "
          f"{pred['temp_bytes'] / 1e9:.3f} | measured / trace "
          f"{ratio:.3f}", flush=True)
    for st in pred["peak_storages"][:6]:
        print(f"[memory]   held at the trace's peak: {st['bytes'] / 1e9:.3f}"
              f" GB {st['op']} {st['dtype']}{st['shape']}", flush=True)
    print(f"[memory] phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"measured": got, "predicted": pred, "ratio": ratio}


def _param_items(tree, prefix: str = ""):
    from repro_torch.models.params import Param
    for k, v in tree.items():
        if isinstance(v, Param):
            yield prefix + k, v
        else:
            yield from _param_items(v, prefix + k + ".")


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
    if "--mesh-only" in sys.argv[1:]:
        # phase 11 alone, on a --mesh-shape D,M mesh (D x M cards)
        args = sys.argv[1:]
        shape = (tuple(int(v) for v in args[args.index("--mesh-shape") + 1]
                       .split(",")) if "--mesh-shape" in args else None)
        phase_mesh(card, shape)
        print(card)
        # a partial run: no result line, which only a full run prints
        print(f"[smoke] --mesh-only: the mesh phase passed in "
              f"{time.perf_counter() - t_all:.1f} s", flush=True)
        return
    if "--memory-only" in sys.argv[1:]:
        # phase 12 alone
        phase_memory(card)
        print(card)
        print(f"[smoke] --memory-only: the memory phase passed in "
              f"{time.perf_counter() - t_all:.1f} s", flush=True)
        return
    phase_build()
    rows = phase_kernels(dev)
    rows.update(phase_table4(dev))
    pretuned_launches = phase_pretuned(dev)
    ranking = phase_ranking(dev)
    phase_check(dev)
    reports, launches = phase_serve()
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        jsonl, deploy_launches = phase_deploy(reports, launches, work)
        service_launches = phase_service(reports, jsonl)
    families = phase_families(dev, reports)
    profile = phase_profile(dev)
    for (kid, dtype), us in profile["table4"].items():
        if dtype == "float32":
            rows[kid]["device_us"] = us
    _, tuner_launches = phase_tuner()
    dispatch_launches = phase_dispatch(dev)
    ext_launches = phase_extend(dev, card)
    rows.update(phase_extend_kernels(dev))
    sass = phase_extract(rows, ranking, profile)
    train = phase_train(dev, card)
    phase_mesh(card)
    phase_memory(card)

    _require_picks_launched("the main path", reports, launches)
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
                **({"families_launches":
                    families["launches"][COUNTER.get(name, name)]}
                   if name in SERVE_KERNELS else {}),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                **{k: r[k] for k in ("device_us", "library_device_us",
                                     "composite_ms", "composite_device_us")
                   if k in r},
                "sass": {k: sass[name][k] for k in ("regs", "spills",
                                                    "loop_instructions")}}

    def opt_entry(name):
        src, replaces = OPT_KERNELS[name]
        r = train["kernels"][name]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": train["opt_launches"][name], "path": "train",
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "device_us", "sass")}}

    for n in OPT_KERNELS:
        r = train["kernels"][n]
        print(f"[smoke] kernel {n}: launched on the train path "
              f"({train['opt_launches'][n]} launches), err "
              f"{r['max_abs_err']:.3g} ok at {r['shape']}, {r['ms']:.4f} ms "
              f"vs bound {r['bound_ms']:.4f} ms")
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
    print(json.dumps({"kernels": [entry(n) for n in KERNELS]
                      + [opt_entry(n) for n in OPT_KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
