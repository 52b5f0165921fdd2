"""Bring your own kernel: one `@tuned_kernel` declaration makes any CUDA
kernel a first-class tuning citizen.

    python -m repro_torch.examples.custom_kernel [--smoke] [--device cpu]

This file and its CUDA source, ``saxpy2d.cu`` beside it, are the whole
integration: no edits to ops.py, api.py, the tuning cache or the kernel
library.  `_cuda.load_extension` builds the source at first use into its
own library, and the declaration below derives

* dispatch (cold full-space rank, then warm memoized hits),
* the dispatch-registry problem (`tuning_cache.get_problem` /
  `lookup_or_tune`),
* `KernelTuner` packaging (static / hybrid / empirical modes),
* the fallback launch if the database is unavailable.

It runs on the CUDA card by default, where dispatch ranks the H100 tile
table; without a card it raises unless ``--device cpu`` is given, which
ranks for the process-default target and runs the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from repro_torch import tuning_cache
from repro_torch.core import KernelTuner
from repro_torch.core.hw import dtype_bytes
from repro_torch.core.sass import template_symbol
from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, TILE_AXIS, divisors,
                                     get_spec, tuned_kernel)
from repro_torch.kernels.common import cdiv, dtype_name, resolve_device
from repro_torch.kernels.matmul import tile_fields

# Launches of the CUDA kernel by `saxpy2d_cuda` (one per call).
LAUNCHES = {"saxpy2d": 0}

# name -> (threads per block, 16-byte vectors per thread); order =
# saxpy2d.cu SAXPY_TILES.
SAXPY_TILES: Dict[str, Tuple[int, ...]] = {
    "t128v1": (128, 1), "t256v1": (256, 1), "t512v1": (512, 1),
    "t1024v1": (1024, 1), "t128v2": (128, 2), "t256v2": (256, 2),
    "t512v2": (512, 2), "t128v4": (128, 4), "t256v4": (256, 4),
    "t1024v4": (1024, 4),
}

_SOURCE = Path(__file__).resolve().with_name("saxpy2d.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "saxpy2d_launch": [_I, _I, _P, _P, _P, ctypes.c_longlong, _P],
    "saxpy2d_attrs": [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I),
                      ctypes.POINTER(_I)],
    "saxpy2d_tile_info": [_I, ctypes.POINTER(_I)],
}


def extension() -> ctypes.CDLL:
    """The compiled ``saxpy2d.cu`` (built at first use)."""
    return _cuda.load_extension("saxpy2d", _SOURCE, _SIGNATURES)


# -- 1. the kernel: its CUDA body (saxpy2d.cu) and its plain version ---------

def saxpy2d_plain(a, b):
    """The plain PyTorch version."""
    return 2.0 * a + b


def saxpy2d_cuda(a, b, *, tile: str):
    """Launch the CUDA instantiation ``tile`` on CUDA tensors a, b
    (M, N) -> 2 a + b."""
    import torch
    _cuda.require_operands("saxpy2d", a, b)
    if a.dim() != 2 or a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"saxpy2d: a and b must be one non-empty (M, N) "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if tile not in SAXPY_TILES:
        raise ValueError(f"saxpy2d: unknown tile {tile!r}")
    lib = extension()
    out = torch.empty_like(a)
    rc = lib.saxpy2d_launch(
        list(SAXPY_TILES).index(tile), _cuda.dtype_code(a), a.data_ptr(),
        b.data_ptr(), out.data_ptr(), a.numel(), _cuda.stream_of(a))
    _cuda.check(rc, "saxpy2d", lib)
    LAUNCHES["saxpy2d"] += 1
    return out


# -- 2. the static analyzers: one array-agnostic function per target ---------
# `p["bm"]` is a scalar when dispatch probes one config and an (N,)
# column when the cold rank scores the whole lattice — same code.

def _saxpy_analysis(p, *, m: int, n: int, dtype: str = "float32"):
    """The reference's TPU analysis: row blocks of bm rows."""
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    return dict(
        in_blocks=[(bm, n), (bm, n)],
        out_blocks=[(bm, n)],
        in_dtypes=[dtype, dtype],
        out_dtypes=[dtype],
        flops_per_step=0.0,
        vpu_per_step=2.0 * bm * n,        # one mul + one add per element
        grid_steps=cdiv(m, bm),
    )


def _saxpy_hopper(cols, *, m: int, n: int, dtype: str = "float32"):
    """The H100 analysis: a and b read once, y written once; each block
    covers threads x vectors 16-byte vectors."""
    t = tile_fields(SAXPY_TILES, cols[TILE_AXIS])
    tpb, v = t[:, 0], t[:, 1]
    eb = dtype_bytes(dtype)
    elems = float(m) * n
    nvec = max(1, int(elems) * eb // 16)
    return dict(blocks=cdiv(nvec, tpb * v), threads=tpb,
                busy_threads=np.minimum(tpb, nvec), regs=16 + 8 * v,
                smem=0, flops=2.0 * elems, hbm_bytes=3.0 * elems * eb)


def _saxpy_inputs(gen, *, m: int, n: int, dtype: str = "float32"):
    import torch
    dt = getattr(torch, dtype)
    return (torch.randn((m, n), generator=gen, device=gen.device).to(dt),
            torch.randn((m, n), generator=gen, device=gen.device).to(dt))


def _saxpy_symbols(tile: str, *, m: int, n: int, dtype: str = "float32"):
    """The SASS function of row ``tile`` (the pipeline tier reads its
    instruction stream from the disassembly)."""
    tpb, v = SAXPY_TILES[tile]
    return (template_symbol("saxpy_kernel", dtype, tpb, v),)


# -- 3. the declaration: everything else is derived --------------------------

@tuned_kernel(
    "saxpy2d",
    space={"bm": divisors("m", (8, 16, 32, 64, 128, 256, 512))},
    signature=lambda a, b, **_: dict(m=a.shape[0], n=a.shape[1],
                                     dtype=dtype_name(a)),
    static_info=_saxpy_analysis,
    hopper=HopperSpace(tiles=tuple(SAXPY_TILES), analysis=_saxpy_hopper,
                       symbols=_saxpy_symbols),
    out=lambda a, b, **_: (tuple(a.shape), a.dtype),
    make_inputs=_saxpy_inputs,
    reference=saxpy2d_plain,
)
def saxpy2d(a, b, *, tile: str | None = None):
    """2 a + b: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if a.device.type == "cpu":
        return saxpy2d_plain(a, b)
    return saxpy2d_cuda(a, b, tile=tile)


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes / skip the hybrid tune")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                    "the plain version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    m, n = (256, 256) if args.smoke else (2048, 1024)

    spec = get_spec("saxpy2d")
    a = torch.ones((m, n), device=device)
    b = torch.ones((m, n), device=device)
    db = tuning_cache.get_default_db()
    tunes0 = db.stats.tunes

    print(f"== dispatch on {device}: cold rank, then warm memo hits ==")
    out = spec.op(a, b)                     # first call tunes
    torch.testing.assert_close(out, saxpy2d_plain(a, b))
    for _ in range(3):
        spec.op(a, b)                       # pure cache/memo hits
    params = tuning_cache.lookup_or_tune("saxpy2d", m=m, n=n,
                                         dtype="float32")
    print(f"   resolved params: {params}  db stats: "
          f"{db.stats.as_dict()}")
    assert db.stats.tunes - tunes0 <= 1, "warm dispatch must not re-tune"

    print("\n== the same declaration drives the full KernelTuner ==")
    tk = spec.tunable(m=m, n=n, dtype="float32", device=device)
    rep = KernelTuner(tk, repeats=1).tune(mode="static")
    print("   " + rep.summary())
    assert rep.empirical_evals == 0
    reports = {"static": rep, "params": params}

    if not args.smoke:
        rep_h = KernelTuner(tk, repeats=2).tune(mode="hybrid",
                                                empirical_budget=2)
        print("   " + rep_h.summary())
        reports["hybrid"] = rep_h

    print("\n== fallback params (database unavailable) ==")
    print(f"   {spec.fallback_params(m=m, n=n)}")
    print("\nOK: one decorated module, zero edits elsewhere.")
    return reports


if __name__ == "__main__":
    main()
