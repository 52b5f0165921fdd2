"""The kernels of the serving path, each a `@tuned_kernel` declaration
with a CUDA kernel written for Hopper (``csrc/``) and a plain PyTorch
version: matmul, rms_norm, flash_attention (flash / blocked) and
mlp_matmul (fused / stream / split).  Oracles live in ref.py; the
generated dispatch entry points in ops.py.

Importing this package registers every declaration; nothing is compiled
until a CUDA tensor reaches a kernel (`repro_torch.kernels._cuda`).
"""
from typing import Dict

from repro_torch.kernels import api
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import rms_norm as _rms_norm
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import mlp_matmul as _mlp_matmul
from repro_torch.kernels import ops, ref
from repro_torch.kernels.api import KernelSpec, divisors, tuned_kernel

_COUNTERS = (_rms_norm.LAUNCHES, _flash_attention.LAUNCHES,
             _mlp_matmul.LAUNCHES, _matmul.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel since the last reset, by name."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
