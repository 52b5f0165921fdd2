#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. build   — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
             for sm_90a (one nvcc per source, in parallel) and print each
             compiled instantiation's registers beside the analysis'
             declared estimate;
2. kernels — every kernel wrapper on the card at the shapes the serving
             path gives it, held against its plain PyTorch version, and
             timed beside that version, its roofline bound and, where one
             PyTorch call computes the same function, that call; then
             every feasible (variant, tile) of the serving instances
             timed beside the H100 analysis' prediction (rank
             correlation, the static pick's regret);
3. check   — gemma-smoke in float32: prefill logits and 8 greedy tokens
             of the tuned CUDA path against the plain path on the CPU;
4. serve   — the main path: gemma-7b at full width and depth (random
             weights from a seed) served through
             ``repro_torch.launch.serve --tuned-ops --pretune
             --assert-frozen`` for two requests (4 x 64 prompt tokens, 32
             generated; 1 x 64, 8 generated), with every launch counter
             set to 0 before and read after;
5. profile — `torch.profiler` over a few decode steps of the first
             request's shape: device time by kernel, idle share.

The last two lines are the card's ``nvidia-smi`` name and power limit
and ``{"ok": true, "device": {...}}``; the line before them is the JSON
``{"kernels": [...]}`` of the kernels the main path launched.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
    "rms_norm": ("src/repro_torch/kernels/csrc/rms_norm.cu",
                 "src/repro/kernels/rms_norm.py:30"),
    "flash": ("src/repro_torch/kernels/csrc/attention.cu",
              "src/repro/kernels/flash_attention.py:49"),
    "blocked": ("src/repro_torch/kernels/csrc/attention.cu",
                "src/repro/kernels/flash_attention.py:122"),
    "fused": ("src/repro_torch/kernels/csrc/gemm.cu",
              "src/repro/kernels/mlp_matmul.py:54"),
    "stream": ("src/repro_torch/kernels/csrc/gemm.cu",
               "src/repro/kernels/mlp_matmul.py:132"),
    "split": ("src/repro_torch/kernels/csrc/gemm.cu",
              "src/repro/kernels/mlp_matmul.py:192"),
}

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


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    import numpy as np
    import ctypes
    from repro_torch.kernels import _cuda, api
    t0 = time.perf_counter()
    lib = _cuda.library()
    log = _cuda.build_log()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {log.get('build_s', 0.0):.1f} s, "
          f"cached={log.get('cached')}) -> {log.get('path')}")
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
    kinds = {("matmul", None): 0, ("mlp_matmul", "fused"): 1,
             ("mlp_matmul", "stream"): 2, ("mlp_matmul", "split"): 0,
             ("rms_norm", None): 3, ("flash_attention", "flash"): 4,
             ("flash_attention", "blocked"): 5}
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
                rc = lib.repro_kernel_attrs(kind, i, dt, ctypes.byref(regs),
                                            ctypes.byref(smem),
                                            ctypes.byref(thr))
                if rc != 0:
                    fail(f"cudaFuncGetAttributes({kid}/{vid} {tile}): {rc}")
                got.append(regs.value)
            print(f"[build]   {kid}/{vid or kid} {tile}: "
                  f"{int(declared[i])} | {got[0]}, {got[1]} | "
                  f"{smem.value} B")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _winner(kid: str, vid, sig):
    """The H100 analysis' best tile of one implementation at ``sig``."""
    import numpy as np
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels import api
    h = api.get_spec(kid)._hopper[vid]
    info = h.info(h.tiles, sig, H100_SXM)
    return h.tiles[int(np.argmin(info.pipe))]


def phase_kernels(dev):
    """Returns {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms, shape}}."""
    import torch
    import torch.nn.functional as F
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
               shape):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        try:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2e-2, atol=2e-2)
        except AssertionError as e:
            fail(f"{name} at {shape} disagrees with its plain version: "
                 f"{str(e).splitlines()[0:4]}")
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        row = dict(max_abs_err=err, ms=time_ms(fn),
                   plain_ms=time_ms(plain),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=(time_ms(lib_fn)
                               if lib_fn is not None else None),
                   shape=shape)
        results[name] = row
        print(f"[kernels] {name} {shape}: max|err| {err:.3g} "
              f"(max|ref| {ref:.3g}, tol 2e-2 abs + 2e-2 rel) | kernel "
              f"{row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
              f"bound {b_ms:.4f} ms ({b_by}) | library "
              + (f"{row['library_ms']:.4f} ms" if lib_fn else "none"),
              flush=True)

    # decode-step matmul (down-projection): (4, 24576) . (24576, 3072)
    a, w = randn(4, f), randn(f, d, scale=f ** -0.5)
    tile = _winner("matmul", None, dict(m=4, n=d, k=f, dtype="bfloat16"))
    got = mm.matmul_cuda(a, w, tile=tile)
    record("matmul", got, mm.matmul_plain(a, w),
           lambda: mm.matmul_cuda(a, w, tile=tile),
           lambda: mm.matmul_plain(a, w), lambda: torch.matmul(a, w),
           2.0 * (4 * f + f * d + 4 * d), 2.0 * 4 * f * d,
           f"(4x{f}).({f}x{d}) bf16 tile {tile}")

    # decode-step RMSNorm: (4, 3072)
    x, g = randn(4, d), torch.ones(d, device=dev)
    tile = _winner("rms_norm", None, dict(m=4, d=d, dtype="bfloat16"))
    gb = g.to(bf)
    record("rms_norm", rn.rms_norm_cuda(x, g, tile=tile),
           rn.rms_norm_plain(x, g),
           lambda: rn.rms_norm_cuda(x, g, tile=tile),
           lambda: rn.rms_norm_plain(x, g),
           lambda: F.rms_norm(x, (d,), gb, 1e-6),
           2.0 * 2 * 4 * d + 4.0 * d, 4.0 * 4 * d,
           f"(4x{d}) bf16 tile {tile}")

    # prefill attention, batch 4 (flash) and batch 1 (blocked)
    for name, b, fn in (("flash", 4, fa.flash_cuda),
                        ("blocked", 1, fa.blocked_cuda)):
        q, k, v = (randn(b, h, s, hd) for _ in range(3))
        sig = dict(b=b, h=h, sq=s, skv=s, d=hd, causal=True,
                   dtype="bfloat16")
        tile = _winner("flash_attention", name, sig)
        pairs = b * h * s * (s + 1) / 2          # unmasked (row, col)
        record(name, fn(q, k, v, True, tile=tile),
               fa.attention_plain(q, k, v, True),
               lambda: fn(q, k, v, True, tile=tile),
               lambda: fa.attention_plain(q, k, v, True),
               lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True),
               2.0 * 4 * b * h * s * hd, 4.0 * pairs * hd,
               f"({b}x{h}x{s}x{hd}) causal bf16 tile {tile}")

    # decode-step gated MLP front half: (4, 3072) . (3072, 24576) x2
    x = randn(4, d)
    wg, wu = randn(d, f, scale=d ** -0.5), randn(d, f, scale=d ** -0.5)
    want = mlp.mlp_plain(x, wg, wu, "gelu")
    sig = dict(m=4, d=d, f=f, act="gelu", dtype="bfloat16")
    for name, fn in (("fused", mlp.fused_cuda), ("stream", mlp.stream_cuda),
                     ("split", mlp.split_cuda)):
        tile = _winner("mlp_matmul", name, sig)
        record(name, fn(x, wg, wu, "gelu", tile=tile), want,
               lambda: fn(x, wg, wu, "gelu", tile=tile),
               lambda: mlp.mlp_plain(x, wg, wu, "gelu"), None,
               2.0 * (4 * d + 2 * d * f + 4 * f), 2.0 * 2 * 4 * d * f,
               f"(4x{d}).({d}x{f}) x2 gelu bf16 tile {tile}")
    composite = time_ms(lambda: F.gelu(x @ wg, approximate="tanh")
                        * (x @ wu))
    print(f"[kernels] torch composite for the gated MLP (two matmuls + "
          f"gelu + product, 4 calls): {composite:.4f} ms")
    # the prefill shapes too (compared and timed, printed only)
    a = randn(256, f)
    sig = dict(m=256, n=d, k=f, dtype="bfloat16")
    tile = _winner("matmul", None, sig)
    got = mm.matmul_cuda(a, w, tile=tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), mm.matmul_plain(a, w).float(),
                               rtol=2e-2, atol=2e-2)
    ms = time_ms(lambda: mm.matmul_cuda(a, w, tile=tile))
    lib = time_ms(lambda: torch.matmul(a, w))
    b_ms = bound(2.0 * (256 * f + f * d + 256 * d), 2.0 * 256 * f * d,
                 "bfloat16")[0]
    print(f"[kernels] matmul prefill (256x{f}).({f}x{d}) tile {tile}: "
          f"{ms:.4f} ms, torch.matmul {lib:.4f} ms, bound {b_ms:.4f} ms")
    x = randn(256, d)
    tile = _winner("mlp_matmul", "fused", dict(m=256, d=d, f=f, act="gelu",
                                               dtype="bfloat16"))
    got = mlp.fused_cuda(x, wg, wu, "gelu", tile=tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               mlp.mlp_plain(x, wg, wu, "gelu").float(),
                               rtol=2e-2, atol=2e-2)
    ms = time_ms(lambda: mlp.fused_cuda(x, wg, wu, "gelu", tile=tile))
    b_ms = bound(2.0 * (256 * d + 2 * d * f + 256 * f), 4.0 * 256 * d * f,
                 "bfloat16")[0]
    print(f"[kernels] fused prefill (256x{d}).({d}x{f}) x2 tile {tile}: "
          f"{ms:.4f} ms, bound {b_ms:.4f} ms")
    return results


# ---------------------------------------------------------------------------
# phase 2b: the static ranking against measured times
# ---------------------------------------------------------------------------


def phase_ranking(dev):
    """Time every feasible (variant, tile) of the main path's instances
    and set the H100 analysis' predicted times beside them: Spearman
    rank correlation, the static pick, the measured best, and the pick's
    regret (its time over the best's)."""
    import numpy as np
    import torch
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.predict import spearman
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
        cases.append(("mlp_matmul", dict(m=m, d=d, f=f, act="gelu",
                                         dtype="bfloat16"),
                      (randn(m, d), randn(d, f, scale=d ** -0.5),
                       randn(d, f, scale=d ** -0.5))))
    for b in (4, 1):
        cases.append(("flash_attention", dict(b=b, h=16, sq=64, skv=64,
                                              d=256, causal=True,
                                              dtype="bfloat16"),
                      tuple(randn(b, 16, 64, 256) for _ in range(3))))
    rows_out = []
    for kid, sig, args in cases:
        spec = api.get_spec(kid)
        pts = spec.hopper_space(**sig).enumerate()
        cols = {k: np.asarray([p[k] for p in pts]) for k in pts[0]}
        info = spec.hopper_info_batch(cols, H100_SXM, **sig)
        pred, meas, names = [], [], []
        for p, t_pred, ok in zip(pts, info.pipe, info.feasible):
            if not ok:
                continue
            fn = launch[(kid, p.get("variant"))]
            meas.append(time_ms(lambda: fn(p["tile"], *args), warmup=1))
            pred.append(float(t_pred) * 1e3)
            names.append(f"{p.get('variant', kid)}/{p['tile']}")
        pick = int(np.argmin(pred))
        best = int(np.argmin(meas))
        rho = spearman(pred, meas) if len(pred) > 2 else float("nan")
        regret = meas[pick] / meas[best]
        rows_out.append(dict(kernel=kid, sig=sig, rho=rho, regret=regret,
                             pick=names[pick], best=names[best]))
        shape = {k: v for k, v in sig.items() if k not in ("dtype", "act",
                                                              "causal")}
        print(f"[ranking] {kid} {shape}: {len(pred)} feasible rows, "
              f"spearman {rho:.2f}; pick {names[pick]} "
              f"pred {pred[pick]:.4f} ms meas {meas[pick]:.4f} ms; best "
              f"{names[best]} meas {meas[best]:.4f} ms; regret "
              f"{regret:.2f}x", flush=True)
        print("[ranking]   " + "; ".join(
            f"{n} {p:.4f}/{m:.4f}" for n, p, m in zip(names, pred, meas)))
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
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt > 0:
            rows.append((dt / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
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
    del params, cache
    torch.cuda.empty_cache()


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
    phase_ranking(dev)
    phase_check(dev)
    reports, launches = phase_serve()
    phase_profile(dev)

    selected = {}
    for rep in reports:
        for inst in rep["instances"]:
            p = inst["params"]
            selected[p.get("variant", inst["kernel"])] = True
    missing = [k for k in selected if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels picked for the main path never launched: {missing}")
    for op, names in (("matmul", ("matmul",)), ("rms_norm", ("rms_norm",)),
                      ("flash_attention", ("flash", "blocked")),
                      ("mlp_matmul", ("fused", "stream", "split"))):
        if not any(launches[n] for n in names):
            fail(f"{op}: no CUDA kernel launched on the main path")

    def entry(name):
        src, replaces = KERNELS[name]
        r = rows[name]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    on_path = [n for n in KERNELS if launches[n] > 0]
    off_path = [n for n in KERNELS if launches[n] == 0]
    for n in off_path:
        print(f"[smoke] {n}: built and checked at {rows[n]['shape']}, not "
              f"picked by the H100 analysis for any instance of the main "
              f"path: {json.dumps(entry(n))}")
    for n in KERNELS:
        status = "launched" if launches[n] else "not selected"
        print(f"[smoke] kernel {n}: {status}"
              f" ({launches[n]} launches), err {rows[n]['max_abs_err']:.3g}"
              f" ok, {rows[n]['ms']:.4f} ms vs bound "
              f"{rows[n]['bound_ms']:.4f} ms")
    print(f"[smoke] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [entry(n) for n in on_path]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
