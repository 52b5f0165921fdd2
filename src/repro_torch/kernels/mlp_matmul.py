"""Gated-MLP up-projection ``act(x @ w_gate) * (x @ w_up)``, three ways.

Ports of the three Pallas variants of `src/repro/kernels/mlp_matmul.py`
as CUDA kernels of ``csrc/gemm.cu`` (design, bound and what is left on
the table are noted there):

* ``fused`` (primary) — one tiled kernel with two f32 accumulators,
  the activation and gating multiply at the store (`_fused_kernel`);
* ``stream`` — whole-D panels of x, W_gate and W_up resident in shared
  memory, no contraction loop (`_stream_kernel`); on the H100 it fits
  only where ``(BM + 2*BN) * D`` elements fit 227 KB, so at gemma's
  D = 3072 the analysis rules out all but its smallest tiles;
* ``split`` — two tiled GEMM passes with f32 outputs
  (`_split_mm_kernel`), then the elementwise combine in PyTorch, as
  the reference combines in jnp outside Pallas.

The declaration keeps the reference's TPU spaces, analyses and pretune
grid; the H100 space is each variant's compiled tiles.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, KernelVariant, TILE_AXIS,
                                     divisors, tuned_kernel)
from repro_torch.core.hw import dtype_bytes
from repro_torch.kernels.common import cdiv, dtype_name, require_shape
from repro_torch.kernels.matmul import (GEMM_TILES, gemm_hopper_cost,
                                        gemm_launch, tile_fields)

__all__ = ["mlp_matmul", "mlp_matmul_stream", "mlp_matmul_split",
           "mlp_plain", "fused_cuda", "stream_cuda", "split_cuda",
           "GATED_TILES", "STREAM_TILES", "ACT_CODES", "LAUNCHES"]

# Launches of each CUDA kernel by its wrapper: one per call for fused
# and stream; split launches its GEMM twice per call (gate, up).
LAUNCHES = {"fused": 0, "stream": 0, "split": 0}

_SIZES = (8, 16, 32, 64, 128, 256, 512, 1024)

# the C side's activation switch
ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2}

# name -> (BM, BN, BK, TM, TN); order = csrc/gemm.cu GATED_TILES.
GATED_TILES: Dict[str, Tuple[int, ...]] = {
    "m16n64k32": (16, 64, 32, 1, 4),
    "m32n64k32": (32, 64, 32, 2, 4),
    "m64n64k16": (64, 64, 16, 4, 4),
    "m128n64k16": (128, 64, 16, 8, 4),
    "m64n128k16": (64, 128, 16, 4, 8),
    "m16n32k64": (16, 32, 64, 1, 2),
    "m16n16k64": (16, 16, 64, 1, 1),
}

# name -> (BM, BN, TM, TN); order = csrc/gemm.cu STREAM_TILES.
STREAM_TILES: Dict[str, Tuple[int, ...]] = {
    "m4n4": (4, 4, 1, 1),
    "m8n8": (8, 8, 1, 1),
    "m16n16": (16, 16, 1, 1),
    "m32n32": (32, 32, 2, 2),
}


def _act(name: str):
    import torch.nn.functional as F
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_plain(x, w_gate, w_up, act: str = "silu"):
    """The plain PyTorch version of all three kernels: f32 products,
    f32 activation and gating, cast back to ``x``'s type."""
    gate = x.float() @ w_gate.float()
    up = x.float() @ w_up.float()
    return (_act(act)(gate) * up).to(x.dtype)


# ---------------------------------------------------------------------------
# TPU-space analyses (the reference's)
# ---------------------------------------------------------------------------


def _fused_analysis(p, *, m: int, d: int, f: int, act: str = "silu",
                    dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols)."""
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    bn = np.minimum(np.asarray(p["bn"], dtype=np.int64), f)
    bk = np.minimum(np.asarray(p["bk"], dtype=np.int64), d)
    steps = cdiv(m, bm) * cdiv(f, bn) * cdiv(d, bk)
    return dict(
        in_blocks=[(bm, bk), (bk, bn), (bk, bn)],
        out_blocks=[(bm, bn)],
        in_dtypes=[dtype] * 3,
        out_dtypes=[dtype],
        flops_per_step=4.0 * bm * bn * bk,         # two dots per step
        vpu_per_step=4.0 * bm * bn,                # act + gate multiply
        trans_per_step=1.0 * bm * bn,              # exp inside silu/gelu
        grid_steps=steps,
        scratch_bytes=2 * bm * bn * 4,             # gate + up f32 tiles
    )


def _stream_analysis(p, *, m: int, d: int, f: int, act: str = "silu",
                     dtype: str = "float32"):
    """Whole-D panels: one grid step per output tile, single output
    flush, zero scratch — per-step footprint scales with D."""
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    bn = np.minimum(np.asarray(p["bn"], dtype=np.int64), f)
    return dict(
        in_blocks=[(bm, d), (d, bn), (d, bn)],
        out_blocks=[(bm, bn)],
        in_dtypes=[dtype] * 3,
        out_dtypes=[dtype],
        flops_per_step=4.0 * bm * bn * d,
        vpu_per_step=4.0 * bm * bn,
        trans_per_step=1.0 * bm * bn,
        grid_steps=cdiv(m, bm) * cdiv(f, bn),
    )


def _split_analysis(p, *, m: int, d: int, f: int, act: str = "silu",
                    dtype: str = "float32"):
    """Two matmul passes (x read twice, one f32 accumulator each) plus
    an output-sized elementwise combine, folded into per-step averages
    over the doubled step count."""
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    bn = np.minimum(np.asarray(p["bn"], dtype=np.int64), f)
    bk = np.minimum(np.asarray(p["bk"], dtype=np.int64), d)
    steps = 2 * cdiv(m, bm) * cdiv(f, bn) * cdiv(d, bk)
    return dict(
        in_blocks=[(bm, bk), (bk, bn)],
        out_blocks=[(bm, bn), (bm, bn)],     # f32 pass output + combine
        in_dtypes=[dtype, dtype],
        out_dtypes=["float32", dtype],
        flops_per_step=2.0 * bm * bn * bk,
        vpu_per_step=3.0 * bm * bn,          # act + multiply + cast, avg
        trans_per_step=0.5 * bm * bn,        # exp, one pass of the two
        grid_steps=steps,
        scratch_bytes=bm * bn * 4,           # single accumulator tile
    )


# ---------------------------------------------------------------------------
# H100-space analyses
# ---------------------------------------------------------------------------


def _fused_hopper(cols, *, m: int, d: int, f: int, act: str = "silu",
                  dtype: str = "float32"):
    t = tile_fields(GATED_TILES, cols[TILE_AXIS])
    eb = dtype_bytes(dtype)
    out = gemm_hopper_cost(m=m, n=f, k=d, bm=t[:, 0], bn=t[:, 1],
                           bk=t[:, 2], tm=t[:, 3], tn=t[:, 4],
                           in_bytes=eb, out_bytes=eb, operands=2)
    out["trans"] = float(m) * f              # one exp/tanh per output
    return out


def _stream_hopper(cols, *, m: int, d: int, f: int, act: str = "silu",
                   dtype: str = "float32"):
    t = tile_fields(STREAM_TILES, cols[TILE_AXIS])
    eb = dtype_bytes(dtype)
    out = gemm_hopper_cost(m=m, n=f, k=d, bm=t[:, 0], bn=t[:, 1], bk=None,
                           tm=t[:, 2], tn=t[:, 3], in_bytes=eb,
                           out_bytes=eb, operands=2)
    out["trans"] = float(m) * f
    return out


def _split_hopper(cols, *, m: int, d: int, f: int, act: str = "silu",
                  dtype: str = "float32"):
    """Two GEMM passes with f32 outputs, then three elementwise torch
    launches (activation, product, cast) over (m, f) f32 arrays."""
    t = tile_fields(GEMM_TILES, cols[TILE_AXIS])
    eb = dtype_bytes(dtype)
    one = gemm_hopper_cost(m=m, n=f, k=d, bm=t[:, 0], bn=t[:, 1],
                           bk=t[:, 2], tm=t[:, 3], tn=t[:, 4],
                           in_bytes=eb, out_bytes=4)
    mf = float(m) * f
    return dict(blocks=one["blocks"], threads=one["threads"],
                regs=one["regs"], smem=one["smem"],
                flops=2.0 * one["flops"] + 3.0 * mf, trans=mf,
                hbm_bytes=2.0 * one["hbm_bytes"] + mf * (7 * 4.0 + eb),
                smem_bytes=2.0 * one["smem_bytes"], launches=5)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check(kernel: str, x, w_gate, w_up, act: str):
    _cuda.require_operands(kernel, x, w_gate, w_up)
    if x.dim() != 2:
        raise ValueError(f"{kernel}: x must be (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    f = w_gate.shape[1]
    require_shape(kernel, "w_gate", tuple(w_gate.shape), (d, f))
    require_shape(kernel, "w_up", tuple(w_up.shape), (d, f))
    if act not in ACT_CODES:
        raise ValueError(f"{kernel}: unknown activation {act!r}")
    return m, d, f


def _gated_launch(kernel: str, fn_name: str, tiles, x, w_gate, w_up,
                  act: str, tile: str):
    import torch
    m, d, f = _check(kernel, x, w_gate, w_up, act)
    if tile not in tiles:
        raise ValueError(f"{kernel}: unknown tile {tile!r}")
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    rc = getattr(_cuda.library(), fn_name)(
        list(tiles).index(tile), _cuda.dtype_code(x), ACT_CODES[act],
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), out.data_ptr(),
        m, f, d, _cuda.stream_of(x))
    _cuda.check(rc, kernel)
    return out


def fused_cuda(x, w_gate, w_up, act: str = "silu", *, tile: str):
    """Launch the two-accumulator CUDA kernel ``tile``."""
    out = _gated_launch("mlp_matmul", "repro_gemm_gated", GATED_TILES,
                        x, w_gate, w_up, act, tile)
    LAUNCHES["fused"] += 1
    return out


def stream_cuda(x, w_gate, w_up, act: str = "silu", *, tile: str):
    """Launch the whole-D-panel CUDA kernel ``tile``."""
    out = _gated_launch("mlp_matmul_stream", "repro_gemm_stream",
                        STREAM_TILES, x, w_gate, w_up, act, tile)
    LAUNCHES["stream"] += 1
    return out


def split_cuda(x, w_gate, w_up, act: str = "silu", *, tile: str):
    """Two CUDA GEMM passes (tile ``tile``) into f32, then the combine."""
    import torch
    m, d, f = _check("mlp_matmul_split", x, w_gate, w_up, act)
    if tile not in GEMM_TILES:
        raise ValueError(f"mlp_matmul_split: unknown tile {tile!r}")
    gate = torch.empty((m, f), dtype=torch.float32, device=x.device)
    up = torch.empty_like(gate)
    gemm_launch("mlp_matmul_split", x, w_gate, gate, tile)
    LAUNCHES["split"] += 1
    gemm_launch("mlp_matmul_split", x, w_up, up, tile)
    LAUNCHES["split"] += 1
    return (_act(act)(gate) * up).to(x.dtype)


def mlp_matmul_stream(x, w_gate, w_up, act: str = "silu", *,
                      tile: str | None = None):
    """Stream schedule: whole-D panels per block, gated tile in one shot."""
    if x.device.type == "cpu":
        return mlp_plain(x, w_gate, w_up, act)
    return stream_cuda(x, w_gate, w_up, act, tile=tile)


def mlp_matmul_split(x, w_gate, w_up, act: str = "silu", *,
                     tile: str | None = None):
    """Split schedule: two f32 GEMM passes combined elementwise."""
    if x.device.type == "cpu":
        return mlp_plain(x, w_gate, w_up, act)
    return split_cuda(x, w_gate, w_up, act, tile=tile)


@tuned_kernel(
    "mlp_matmul",
    space={"bm": divisors("m", _SIZES),
           "bn": divisors("f", _SIZES),
           "bk": divisors("d", _SIZES)},
    signature=lambda x, w_gate, w_up, act="silu", **_: dict(
        m=x.shape[0], d=x.shape[1], f=w_gate.shape[1], act=act,
        dtype=dtype_name(x)),
    static_info=_fused_analysis,
    hopper={"fused": HopperSpace(tiles=tuple(GATED_TILES),
                                 analysis=_fused_hopper),
            "stream": HopperSpace(tiles=tuple(STREAM_TILES),
                                  analysis=_stream_hopper),
            "split": HopperSpace(tiles=tuple(GEMM_TILES),
                                 analysis=_split_hopper)},
    out=lambda x, w_gate, w_up, act="silu", **_: (
        (x.shape[0], w_gate.shape[1]), x.dtype),
    pretune=tuple(dict(m=m, d=d, f=f, act=act, dtype=dt)
                  for (m, d, f) in [(256, 512, 1024), (1024, 1024, 4096),
                                    (2048, 2048, 8192), (4096, 4096, 16384)]
                  for act in ("silu", "gelu")
                  for dt in ("float32", "bfloat16")),
    variants=(
        KernelVariant(
            variant_id="stream",
            fn=mlp_matmul_stream,
            space={"bm": divisors("m", _SIZES),
                   "bn": divisors("f", _SIZES)},
            analysis=_stream_analysis),
        KernelVariant(
            variant_id="split",
            fn=mlp_matmul_split,
            space={"bm": divisors("m", _SIZES),
                   "bn": divisors("f", _SIZES),
                   "bk": divisors("d", _SIZES)},
            analysis=_split_analysis),
    ),
    primary_variant="fused",
)
def mlp_matmul(x, w_gate, w_up, act: str = "silu", *,
               tile: str | None = None):
    """x (M, D); w_gate, w_up (D, F) -> act(x@w_gate) * (x@w_up): the
    fused CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return mlp_plain(x, w_gate, w_up, act)
    return fused_cuda(x, w_gate, w_up, act, tile=tile)
