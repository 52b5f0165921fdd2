"""Gated-MLP up-projection ``act(x @ w_gate) * (x @ w_up)``, three ways.

Ports of the three Pallas variants of `src/repro/kernels/mlp_matmul.py`
as CUDA kernels of ``csrc/gemm.cu`` (design, bound and what is left on
the table are noted there):

* ``fused`` (primary) — one tiled kernel with two f32 accumulators,
  the activation and gating multiply at the store (`_fused_kernel`):
  SIMT rows (any type and shape), and TMA + wgmma rows for bf16 — X
  staged once a stage for both weights, two wgmma chains — the tiled
  regime (prefill);
* ``stream`` — the whole contraction D in one block, one output flush,
  no accumulator carried across blocks (`_stream_kernel`): SIMT rows
  with whole-D panels of x, W_gate and W_up resident in shared memory
  (on the H100 only where ``(BM + 2*BN) * D`` elements fit 227 KB, so at
  gemma's D = 3072 the analysis rules out all but the smallest), and
  gated GEMV rows with only x's panel resident and both weights streamed
  once — the small-M regime (decode);
* ``split`` — two tiled GEMM passes with f32 outputs
  (`_split_mm_kernel`), then the elementwise combine in PyTorch, as
  the reference combines in jnp outside Pallas.

The declaration keeps the reference's TPU spaces, analyses and pretune
grid; the H100 space is each variant's compiled tiles, each family
priced by its own cost (`family_costs`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.kernels import _cuda
from repro_torch.kernels.api import (HopperSpace, KernelVariant, TILE_AXIS,
                                     divisors, tuned_kernel)
from repro_torch.core.hw import H100_SXM, dtype_bytes
from repro_torch.core.sass import template_symbol
from repro_torch.kernels.common import (cdiv, dtype_name, family_costs,
                                        require_shape)
from repro_torch.kernels.matmul import (GEMM_TILES, GEMV, SIMT, WGMMA,
                                        gemm_symbols,
                                        gemm_hopper_cost, gemm_launch,
                                        gemm_tiles_cost, tile_fields,
                                        wgmma_takes)

__all__ = ["mlp_matmul", "mlp_matmul_stream", "mlp_matmul_split",
           "mlp_plain", "fused_cuda", "stream_cuda", "split_cuda",
           "GATED_TILES", "STREAM_TILES", "ACT_CODES", "LAUNCHES",
           "stream_gemv_takes"]

# Launches of each CUDA kernel by its wrapper: "fused" and "stream"
# count calls (one launch each), "gated_simt" / "gated_wgmma" and
# "stream_simt" / "stream_gemv" the kernel of each family those calls
# launch; split launches its GEMM twice per call (gate, up).
LAUNCHES = {"fused": 0, "stream": 0, "split": 0, "gated_simt": 0,
            "gated_wgmma": 0, "stream_simt": 0, "stream_gemv": 0}
_GATED_COUNTER = {SIMT: "gated_simt", WGMMA: "gated_wgmma"}
_STREAM_COUNTER = {SIMT: "stream_simt", GEMV: "stream_gemv"}

_SIZES = (8, 16, 32, 64, 128, 256, 512, 1024)

# the C side's activation switch
ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2}

# warps of a stream GEMV block (csrc/gemm.cu SG_WARPS)
SG_WARPS = 8

# name -> (BM, BN, BK, TM, TN, FAMILY, STAGES, SPLIT), the GEMM table's
# fields; order = csrc/gemm.cu GATED_TILES, GATED_WGMMA_TILES.  The wgmma
# rows are 128 x BN x 64 tiles of two 64-row warpgroups, STAGES stages
# of one X box and two weight boxes, the deeper ring first (the first
# of two rows the analysis ties wins); no row splits K.
GATED_TILES: Dict[str, Tuple[int, ...]] = {
    "m16n64k32": (16, 64, 32, 1, 4, SIMT, 1, 1),
    "m32n64k32": (32, 64, 32, 2, 4, SIMT, 1, 1),
    "m64n64k16": (64, 64, 16, 4, 4, SIMT, 1, 1),
    "m128n64k16": (128, 64, 16, 8, 4, SIMT, 1, 1),
    "m64n128k16": (64, 128, 16, 4, 8, SIMT, 1, 1),
    "m16n32k64": (16, 32, 64, 1, 2, SIMT, 1, 1),
    "m16n16k64": (16, 16, 64, 1, 1, SIMT, 1, 1),
    "wgmma_n64s4": (128, 64, 64, 64, 64, WGMMA, 4, 1),
    "wgmma_n64s3": (128, 64, 64, 64, 64, WGMMA, 3, 1),
    "wgmma_n128s4": (128, 128, 64, 64, 128, WGMMA, 4, 1),
    "wgmma_n128s3": (128, 128, 64, 64, 128, WGMMA, 3, 1),
}

# name -> the same eight fields; order = csrc/gemm.cu STREAM_TILES,
# STREAM_GEMV_TILES.  BK is 0: the whole of D in one block.  GEMV rows:
# BM rows of x, BN columns a block, TN a lane's 8 bf16 columns (4 in
# f32), STAGES the rows of its weight in flight per lane (half the warps
# read W_gate, half W_up).
STREAM_TILES: Dict[str, Tuple[int, ...]] = {
    "m4n4": (4, 4, 0, 1, 1, SIMT, 1, 1),
    "m8n8": (8, 8, 0, 1, 1, SIMT, 1, 1),
    "m16n16": (16, 16, 0, 1, 1, SIMT, 1, 1),
    "m32n32": (32, 32, 0, 2, 2, SIMT, 1, 1),
    "gemv_m1n64": (1, 64, 0, 1, 8, GEMV, 16, 1),
    "gemv_m1n128": (1, 128, 0, 1, 8, GEMV, 16, 1),
    "gemv_m4n64": (4, 64, 0, 4, 8, GEMV, 16, 1),
    "gemv_m4n128": (4, 128, 0, 4, 8, GEMV, 16, 1),
    "gemv_m8n64": (8, 64, 0, 8, 8, GEMV, 8, 1),
    "gemv_m8n128": (8, 128, 0, 8, 8, GEMV, 8, 1),
}

# CUDA's limit on a grid's y dimension (gated wgmma rows put F/BN on y,
# stream GEMV rows M/BM)
_GRID_Y = 65535


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


def _gated_bytes(m: int, d: int, f: int, eb: int, rows: int) -> np.ndarray:
    """Device-memory bytes of a gated launch with x, W_gate and W_up read
    once and the output written once (`matmul._unique_bytes` with two
    weights)."""
    return np.full(rows, (float(m) * d + 2.0 * d * f) * eb + float(m) * f * eb)


def _gated_wgmma_cost(t, *, m: int, d: int, f: int, eb: int):
    """TMA + wgmma gated rows: `matmul._wgmma_cost`'s shape with two
    weights.  Two wgmma chains on one X box double the tensor-core
    FLOPs; a stage is one X box and two weight boxes; the unique bytes of
    x, W_gate, W_up and the output (row tiles are the grid's fast axis,
    so the blocks that share a weight tile run side by side); STAGES
    stages in flight; two m64nBN accumulators, BN f32 registers a
    thread."""
    bn, stages = t[:, 1], t[:, 6]
    gm, gn = cdiv(m, 128), cdiv(f, bn)
    stage = 128 * 64 * 2 + 2 * 64 * bn * 2
    return dict(
        blocks=gm * gn,
        threads=np.full(len(t), 384),
        regs=bn + 26,
        smem=stages * stage + 16 * stages + 1024,
        flops=np.zeros(len(t)),
        tc_flops=2.0 * 2.0 * (cdiv(m, 64) * 64) * (gn * bn)
        * (cdiv(d, 64) * 64.0),
        hbm_bytes=_gated_bytes(m, d, f, eb, len(t)),
        smem_bytes=(gm * gn) * cdiv(d, 64) * stage * 1.0,
        inflight_bytes=stages * (min(m, 128) * 64 * 2 + 2 * 64 * bn * 2)
        * 1.0,
        feasible=gn <= _GRID_Y)


def _stream_gemv_smem(bm, bn, d: int, eb: int):
    """Shared bytes of a stream GEMV block: x's whole-D panel (pitch D
    rounded up to 16 elements), the warps' f32 sums of both products and
    the panel's barrier."""
    return bm * (cdiv(d, 16) * 16) * eb + 2 * bm * bn * 4 + 16


def _stream_gemv_cost(t, *, m: int, d: int, f: int, eb: int):
    """Whole-D gated GEMV rows: `matmul._gemv_cost`'s shape with two
    weights and no split.  A lane's 16-byte slice of a row of its half's
    weight, STAGES rows in flight per lane; row blocks are the grid's
    slowest axis, each re-reading the weights from HBM; every row is
    bounded to 128 registers (2 blocks per SM).  Infeasible where x's
    panel does not fit the block's shared memory."""
    bm, bn, rows = t[:, 0], t[:, 1], t[:, 6]
    gm, gn = cdiv(m, bm), cdiv(f, bn)
    return dict(
        blocks=gn * gm,
        threads=np.full(len(t), 32 * SG_WARPS),
        regs=np.full(len(t), 128),
        smem=_stream_gemv_smem(bm, bn, d, eb),
        flops=2.0 * 2.0 * (gm * bm) * (gn * bn) * float(d),
        tc_flops=np.zeros(len(t)),
        hbm_bytes=(_gated_bytes(m, d, f, eb, len(t))
                   + (gm - 1) * 2.0 * d * f * eb),
        smem_bytes=(gn * gm) * (2.0 * bm * d * eb
                                + 2.0 * SG_WARPS * 2 * bm * bn * 4),
        inflight_bytes=32.0 * SG_WARPS * rows * 16,
        feasible=gm <= _GRID_Y)


_KEYS = ("blocks", "threads", "regs", "smem", "flops", "tc_flops",
         "hbm_bytes", "smem_bytes", "inflight_bytes")


def _fused_hopper(cols, *, m: int, d: int, f: int, act: str = "silu",
                  dtype: str = "float32"):
    """The gated table: SIMT rows priced by `gemm_hopper_cost` with two
    operands, wgmma rows by `_gated_wgmma_cost` (infeasible unless
    `wgmma_takes` the product)."""
    t = tile_fields(GATED_TILES, cols[TILE_AXIS])
    eb = dtype_bytes(dtype)
    fam = t[:, 5]
    out = family_costs(fam, {
        SIMT: lambda sel: gemm_hopper_cost(
            m=m, n=f, k=d, bm=t[sel, 0], bn=t[sel, 1], bk=t[sel, 2],
            tm=t[sel, 3], tn=t[sel, 4], in_bytes=eb, out_bytes=eb,
            operands=2),
        WGMMA: lambda sel: _gated_wgmma_cost(t[sel], m=m, d=d, f=f, eb=eb)},
        keys=_KEYS)
    out["feasible"] &= (fam != WGMMA) | wgmma_takes(dtype, f, d)
    out["trans"] = float(m) * f              # one exp/tanh per output
    return out


def _stream_hopper(cols, *, m: int, d: int, f: int, act: str = "silu",
                   dtype: str = "float32"):
    """The stream table: SIMT rows priced by `gemm_hopper_cost` over the
    whole-K panel, GEMV rows by `_stream_gemv_cost`."""
    t = tile_fields(STREAM_TILES, cols[TILE_AXIS])
    eb = dtype_bytes(dtype)
    out = family_costs(t[:, 5], {
        SIMT: lambda sel: gemm_hopper_cost(
            m=m, n=f, k=d, bm=t[sel, 0], bn=t[sel, 1], bk=None,
            tm=t[sel, 3], tn=t[sel, 4], in_bytes=eb, out_bytes=eb,
            operands=2),
        GEMV: lambda sel: _stream_gemv_cost(t[sel], m=m, d=d, f=f, eb=eb)},
        keys=_KEYS)
    out["trans"] = float(m) * f
    return out


def stream_gemv_takes(tile: str, d: int, dtype: str) -> bool:
    """Whether the stream GEMV row ``tile`` holds x's (BM, D) panel in a
    block's shared memory (the only limit of its kernel's shapes)."""
    bm, bn = STREAM_TILES[tile][:2]
    return _stream_gemv_smem(bm, bn, d, dtype_bytes(dtype)) \
        <= H100_SXM.shmem_per_block


def _split_hopper(cols, *, m: int, d: int, f: int, act: str = "silu",
                  dtype: str = "float32"):
    """Two GEMM passes with f32 outputs (any row of the GEMM table,
    priced by `gemm_tiles_cost`), then three elementwise torch launches
    (activation, product, cast) over (m, f) f32 arrays."""
    t = tile_fields(GEMM_TILES, cols[TILE_AXIS])
    eb = dtype_bytes(dtype)
    one = gemm_tiles_cost(t, m=m, n=f, k=d, dtype=dtype, out_bytes=4)
    mf = float(m) * f
    return dict(one, flops=2.0 * one["flops"] + 3.0 * mf,
                tc_flops=2.0 * one["tc_flops"], trans=mf,
                hbm_bytes=2.0 * one["hbm_bytes"] + mf * (7 * 4.0 + eb),
                smem_bytes=2.0 * one["smem_bytes"],
                launches=2 * one["launches"] + 3)


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


def _refuse(kernel: str, tiles, tile: str, x, w_gate, w_up) -> None:
    """ValueError for a product the tile's kernel cannot take: the gated
    wgmma rows take bfloat16 with D and F multiples of 8 and 16-byte-
    aligned operands (`wgmma_takes`, as the GEMM table's wgmma rows);
    the stream GEMV rows an x panel that fits a block's shared memory."""
    m, d = x.shape
    f = w_gate.shape[1]
    fam = tiles[tile][5]
    if fam == WGMMA:
        if not wgmma_takes(dtype_name(x), f, d):
            raise ValueError(
                f"{kernel}: tile {tile} takes bfloat16 with D and F "
                f"multiples of 8, got {dtype_name(x)} (M={m}, D={d}, F={f})")
        if any(t.data_ptr() % 16 for t in (x, w_gate, w_up)):
            raise ValueError(f"{kernel}: tile {tile} needs 16-byte-aligned "
                             f"operands for its tensor maps")
    elif fam == GEMV and not stream_gemv_takes(tile, d, dtype_name(x)):
        raise ValueError(
            f"{kernel}: tile {tile} holds x's ({tiles[tile][0]}, D) panel "
            f"in shared memory, and D={d} in {dtype_name(x)} does not fit")


def _gated_launch(kernel: str, fn_name: str, tiles, x, w_gate, w_up,
                  act: str, tile: str):
    import torch
    m, d, f = _check(kernel, x, w_gate, w_up, act)
    if tile not in tiles:
        raise ValueError(f"{kernel}: unknown tile {tile!r}")
    _refuse(kernel, tiles, tile, x, w_gate, w_up)
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    rc = getattr(_cuda.library(), fn_name)(
        list(tiles).index(tile), _cuda.dtype_code(x), ACT_CODES[act],
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), out.data_ptr(),
        m, f, d, _cuda.stream_of(x))
    _cuda.check(rc, kernel)
    return out


def fused_cuda(x, w_gate, w_up, act: str = "silu", *, tile: str):
    """Launch the gated CUDA kernel of ``tile``: a SIMT row's
    two-accumulator kernel, or a wgmma row's TMA + wgmma kernel."""
    out = _gated_launch("mlp_matmul", "repro_gemm_gated", GATED_TILES,
                        x, w_gate, w_up, act, tile)
    LAUNCHES["fused"] += 1
    LAUNCHES[_GATED_COUNTER[GATED_TILES[tile][5]]] += 1
    return out


def stream_cuda(x, w_gate, w_up, act: str = "silu", *, tile: str):
    """Launch the whole-D CUDA kernel of ``tile``: a SIMT row's resident
    panels, or a GEMV row's streamed weights."""
    out = _gated_launch("mlp_matmul_stream", "repro_gemm_stream",
                        STREAM_TILES, x, w_gate, w_up, act, tile)
    LAUNCHES["stream"] += 1
    LAUNCHES[_STREAM_COUNTER[STREAM_TILES[tile][5]]] += 1
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
    """Stream schedule: the whole of D per block, the gated tile in one
    flush."""
    if x.device.type == "cpu":
        return mlp_plain(x, w_gate, w_up, act)
    return stream_cuda(x, w_gate, w_up, act, tile=tile)


def mlp_matmul_split(x, w_gate, w_up, act: str = "silu", *,
                     tile: str | None = None):
    """Split schedule: two f32 GEMM passes combined elementwise."""
    if x.device.type == "cpu":
        return mlp_plain(x, w_gate, w_up, act)
    return split_cuda(x, w_gate, w_up, act, tile=tile)


def _fused_symbols(tile: str, *, m: int, d: int, f: int, act: str = "silu",
                   dtype: str = "float32"):
    bm, bn, bk, tm, tn, fam, stages, _ = GATED_TILES[tile]
    if fam == WGMMA:
        return (template_symbol("gated_wgmma_kernel", bn, stages),)
    return (template_symbol("gated_kernel", dtype, bm, bn, bk, tm, tn),)


def _stream_symbols(tile: str, *, m: int, d: int, f: int, act: str = "silu",
                    dtype: str = "float32"):
    bm, bn, _, tm, tn, fam, stages, _ = STREAM_TILES[tile]
    if fam == GEMV:
        return (template_symbol("stream_gemv_kernel", dtype, bm, bn,
                                stages),)
    return (template_symbol("stream_kernel", dtype, bm, bn, tm, tn),)


def _split_symbols(tile: str, *, m: int, d: int, f: int, act: str = "silu",
                   dtype: str = "float32"):
    return gemm_symbols(tile, dtype, out_f32=True)


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
                                 analysis=_fused_hopper,
                                 symbols=_fused_symbols),
            "stream": HopperSpace(tiles=tuple(STREAM_TILES),
                                  analysis=_stream_hopper,
                                  symbols=_stream_symbols),
            "split": HopperSpace(tiles=tuple(GEMM_TILES),
                                 analysis=_split_hopper,
                                 symbols=_split_symbols)},
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
