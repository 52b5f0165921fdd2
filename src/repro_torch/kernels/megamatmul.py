"""Mega-space matmul: a multi-axis, constrained tuning space (§III-C at
tuner-literature scale).

The paper demonstrates static ranking on ~10²–10³-point spaces; the
kernel-tuner benchmarking literature evaluates on *constrained* spaces
of 10⁵–10⁷ points.  This module declares that shape of problem for the
blocked matmul, as the reference does: block shapes × unroll factor ×
grid dimension order × scheme × accumulator dtype — a ~4.2-million-point
lattice of which only the constraint-feasible slice (tiles divide the
problem, unroll divides the K block, working set fits VMEM) is ever
analyzed, thanks to constraint pushdown in `SearchSpace.iter_lattice`.
Under a TPU target its problem is the reference's, bit for bit.

Under the H100 its space is the GEMM's own launch space — the compiled
tile table of `repro_torch.kernels.matmul` (`GEMM_TILES`, priced by the
same H100 analysis) — and the constraints, which describe the TPU
block space, do not apply.  The executable `mega_matmul` launches the
ported B1 GEMM (`matmul_cuda`) with the tile dispatch picked, so this
module adds no kernel of its own; TPU params name no tile, and then the
GEMM's feasible fallback tile launches.

The spec is built by a **factory** rather than module-level
`@tuned_kernel` so importing `repro_torch.kernels` does not grow the
registry.  Call ``mega_matmul_spec()`` and, if dispatch through
`lookup_or_tune` is wanted, pass ``register=True``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.hw import dtype_bytes
from repro_torch.kernels.api import HopperSpace, KernelSpec, register_spec
from repro_torch.kernels.common import (cdiv, dtype_name,
                                        pick_divisor_candidates)
from repro_torch.kernels.matmul import (GEMM_TILES, _matmul_hopper,
                                        _matmul_symbols,
                                        _matmul_inputs, matmul_cuda,
                                        matmul_plain)
from repro_torch.kernels.ref import matmul_ref

__all__ = ["mega_matmul_spec", "mega_matmul", "MEGA_BLOCKS", "MEGA_UNROLLS",
           "MEGA_ORDERS", "MEGA_SCHEMES", "MEGA_ACCS"]

# 28 block candidates: the 19 divisors of 6144 (= 2^11 * 3) from 8 up —
# so a 6144³ problem keeps a rich feasible slice — interleaved with 9
# non-divisors that the divisibility constraints prune, the way real
# tuner spaces carry far more lattice points than legal configs.
MEGA_BLOCKS = (8, 12, 16, 20, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128,
               160, 192, 224, 256, 288, 352, 384, 512, 768, 1024, 1536,
               2048, 3072, 6144)
MEGA_UNROLLS = (1, 2, 3, 4, 6, 8, 12, 16)
MEGA_ORDERS = ("mnk", "mkn", "nmk", "nkm", "kmn", "knm")
# "variant" is reserved for the registry's joint implementation axis
# (kernels/variants.py), so this analysis-only strategy knob is "scheme".
MEGA_SCHEMES = ("blocked", "split_k")
MEGA_ACCS = ("f32", "bf16")

# Working-set ceiling for the pushdown constraint: operand tiles +
# double-buffered accumulator must fit a v5e-class VMEM (the occupancy
# model re-checks the exact per-target budget; this cruder static cut
# exists so the giant-tile corner of the lattice never reaches feature
# construction at all).
_VMEM_BUDGET_BYTES = 64 * 1024 * 1024


def _mega_analysis(p, *, m: int, n: int, k: int, dtype: str = "float32"):
    """Static analysis of one config (scalars) or a lattice ((N,) cols).

    Axis semantics (all array-agnostic — `np.where` on value columns):

    * ``unroll`` — K-loop unroll factor; amortizes loop control, so
      control ops drop from one per grid step to ``steps / unroll``.
    * ``order`` — grid dimension order.  K-innermost orders ("mnk",
      "nmk") keep the f32 accumulator resident in VMEM; K-outer orders
      re-stream the partial output tile every step (a second scratch
      buffer plus a VPU accumulate pass per element).
    * ``scheme`` — "split_k" buffers per-split partials and reduces
      them on the VPU; "blocked" is the plain sequential-K kernel.
    * ``acc`` — accumulator dtype: "bf16" halves the scratch bytes but
      pays a VPU round trip per element per step.
    """
    bm = np.minimum(np.asarray(p["bm"], dtype=np.int64), m)
    bn = np.minimum(np.asarray(p["bn"], dtype=np.int64), n)
    bk = np.minimum(np.asarray(p["bk"], dtype=np.int64), k)
    unroll = np.asarray(p["unroll"], dtype=np.int64)
    order = np.asarray(p["order"])
    scheme = np.asarray(p["scheme"])
    acc = np.asarray(p["acc"])
    steps = cdiv(m, bm) * cdiv(n, bn) * cdiv(k, bk)

    k_inner = np.isin(order, ("mnk", "nmk"))
    acc_bytes = np.where(acc == "f32", 4, 2).astype(np.int64)
    scratch = bm * bn * acc_bytes
    scratch = np.where(k_inner, scratch, 2 * scratch)
    vpu = np.where(k_inner, 0.0, 1.0) * bm * bn
    vpu = vpu + np.where(acc == "f32", 0.0, 1.0) * bm * bn
    split = scheme == "split_k"
    vpu = vpu + np.where(split, 1.0, 0.0) * bm * bn
    scratch = scratch + np.where(split, bm * bn, 0) * acc_bytes

    return dict(
        in_blocks=[(bm, bk), (bk, bn)],
        out_blocks=[(bm, bn)],
        in_dtypes=[dtype, dtype],
        out_dtypes=[dtype],
        flops_per_step=2.0 * bm * bn * bk,
        vpu_per_step=vpu,
        grid_steps=steps,
        scratch_bytes=scratch,
        ctrl_ops=steps / np.maximum(unroll, 1),
    )


def _mega_constraints(*, m: int, n: int, k: int, dtype: str = "float32"):
    """Vectorized feasibility predicates over the axis columns, closed
    over the signature dims (the `constraints=` callable form)."""
    esize = dtype_bytes(dtype)

    def tiles_divide(cols):
        return ((m % cols["bm"] == 0) & (n % cols["bn"] == 0)
                & (k % cols["bk"] == 0))

    def unroll_divides_bk(cols):
        return cols["bk"] % cols["unroll"] == 0

    def fits_vmem_budget(cols):
        bm = np.asarray(cols["bm"], dtype=np.int64)
        bn = np.asarray(cols["bn"], dtype=np.int64)
        bk = np.asarray(cols["bk"], dtype=np.int64)
        operands = (bm * bk + bk * bn) * esize
        scratch = 2 * bm * bn * 4          # double-buffered f32 acc
        return operands + scratch <= _VMEM_BUDGET_BYTES

    return (tiles_divide, unroll_divides_bk, fits_vmem_budget)


def _mega_fallback(*, m: int, n: int, k: int, dtype: str = "float32"):
    """The reference's TPU dispatch fallback: modest dividing tiles,
    neutral knobs.  On the card the fallback launch is the GEMM's
    feasible fallback tile (`KernelSpec.fallback_tile`) instead."""
    safe = tuple(c for c in MEGA_BLOCKS if c <= 256)
    return dict(bm=max(pick_divisor_candidates(m, safe)),
                bn=max(pick_divisor_candidates(n, safe)),
                bk=max(pick_divisor_candidates(k, safe)),
                unroll=1, order="mnk", scheme="blocked", acc="f32")


def mega_matmul(a, b, *, tile: str | None = None):
    """Executable entry point for the mega space: the ported B1 GEMM
    instantiation ``tile`` for CUDA tensors, the plain version for CPU
    tensors."""
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    return matmul_cuda(a, b, tile=tile)


def mega_matmul_spec(*, blocks: Sequence[int] = MEGA_BLOCKS,
                     unrolls: Sequence[int] = MEGA_UNROLLS,
                     orders: Sequence[str] = MEGA_ORDERS,
                     schemes: Sequence[str] = MEGA_SCHEMES,
                     accs: Sequence[str] = MEGA_ACCS,
                     chunk_size: Optional[int] = None,
                     register: bool = False) -> KernelSpec:
    """Build the mega-space matmul `KernelSpec`.

    With the default candidate lists the lattice is
    ``28³ · 8 · 6 · 2 · 2 = 4,214,784`` points; tests shrink the lists
    to exercise the same constrained multi-axis shape at parity-test
    size.  ``register=True`` additionally registers the spec for
    `lookup_or_tune` dispatch (callers own the `unregister`).
    """
    spec = KernelSpec(
        kernel_id="mega_matmul",
        fn=mega_matmul,
        space={"bm": tuple(blocks), "bn": tuple(blocks),
               "bk": tuple(blocks), "unroll": tuple(unrolls),
               "order": tuple(orders), "scheme": tuple(schemes),
               "acc": tuple(accs)},
        extract_signature=lambda a, b, **_: dict(
            m=a.shape[0], n=b.shape[1], k=a.shape[1], dtype=dtype_name(a)),
        analysis=_mega_analysis,
        hopper=HopperSpace(tiles=tuple(GEMM_TILES), analysis=_matmul_hopper,
                           symbols=_matmul_symbols),
        out=lambda a, b, **_: ((a.shape[0], b.shape[1]), a.dtype),
        make_inputs=_matmul_inputs,
        reference=matmul_ref,
        constraints=_mega_constraints,
        chunk_size=chunk_size,
    )
    if register:
        register_spec(spec)
    return spec
