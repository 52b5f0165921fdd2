"""Instruction mix: the static-analysis currency of Eq. 6 (paper §III-B).

The paper disassembles the CUDA binary and classifies instructions into
FLOPS / MEM / CTRL / REG classes, weighting each by its reciprocal
throughput (Table II).  The kernel analyzers of this package derive the
same classes analytically from launch parameters and shapes, so only
the :class:`InstructionMix` record and its intensity helpers live here.

Categories:

=============  ===========================================================
mxu_flops      matrix-unit FLOPs (2*M*N*K counting)
vpu_flops      elementwise/reduction vector ALU ops (one per output elem)
trans_flops    transcendental elementwise ops (exp/log/tanh/...)
hbm_bytes      bytes moved to/from device memory
vmem_bytes     bytes streamed through on-core memory
mem_ops        count of memory *operations* (paper's O_mem, for intensity)
ctrl_ops       predication/select/control-flow events (paper's O_ctrl)
reg_ops        moves: broadcast/transpose/reshape/convert (paper's O_reg)
=============  ===========================================================
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["InstructionMix", "intensity", "classify_boundedness"]


@dataclasses.dataclass
class InstructionMix:
    mxu_flops: float = 0.0
    vpu_flops: float = 0.0
    trans_flops: float = 0.0
    hbm_bytes: float = 0.0
    vmem_bytes: float = 0.0
    mem_ops: float = 0.0
    ctrl_ops: float = 0.0
    reg_ops: float = 0.0
    # bookkeeping
    unknown_ops: int = 0
    unknown_trip_loops: int = 0

    # -- algebra ------------------------------------------------------------
    def __add__(self, other: "InstructionMix") -> "InstructionMix":
        return InstructionMix(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(self)
        })

    def scaled(self, k: float) -> "InstructionMix":
        out = InstructionMix(**{
            f.name: getattr(self, f.name) * k for f in dataclasses.fields(self)
        })
        out.unknown_ops = int(self.unknown_ops * k)
        out.unknown_trip_loops = int(self.unknown_trip_loops * k)
        return out

    # -- views --------------------------------------------------------------
    @property
    def flops_total(self) -> float:
        return self.mxu_flops + self.vpu_flops + self.trans_flops

    @property
    def o_fl(self) -> float:          # paper O_fl
        return self.flops_total

    @property
    def o_mem(self) -> float:         # paper O_mem
        return self.mem_ops

    @property
    def o_ctrl(self) -> float:        # paper O_ctrl
        return self.ctrl_ops

    @property
    def o_reg(self) -> float:         # paper O_reg
        return self.reg_ops

    def as_dict(self) -> Dict[str, float]:
        return {f.name: float(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    def __repr__(self) -> str:  # compact for logs
        return ("Mix(mxu={:.3g}, vpu={:.3g}, trans={:.3g}, hbm_B={:.3g}, "
                "mem_ops={:.3g}, ctrl={:.3g}, reg={:.3g}, I={:.2f})").format(
                    self.mxu_flops, self.vpu_flops, self.trans_flops,
                    self.hbm_bytes, self.mem_ops, self.ctrl_ops, self.reg_ops,
                    intensity(self))


def intensity(mix: InstructionMix) -> float:
    """Paper's computational intensity: FLOPs per memory operation."""
    return mix.flops_total / max(1.0, mix.mem_ops)


def classify_boundedness(mix: InstructionMix, threshold: float = 4.0) -> str:
    """Rule-based classification; threshold 4.0 is the paper's §III-C value."""
    i = intensity(mix)
    if i > threshold:
        return "compute_bound"
    if i > threshold / 2:
        return "balanced"
    return "memory_bound"
