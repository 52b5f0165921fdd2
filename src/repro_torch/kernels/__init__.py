"""The port's kernels, each a `@tuned_kernel` declaration with a CUDA
kernel written for Hopper (``csrc/``) and a plain PyTorch version: the
serving path's matmul, rms_norm, flash_attention (flash / blocked) and
mlp_matmul (fused / stream / split), and the paper's Table IV kernels
matvec, atax, bicg and jacobi3d.  Oracles live in ref.py; the generated
dispatch entry points in ops.py; ``make_tunable_*`` package a kernel for
`repro_torch.core.KernelTuner`.

Importing this package registers every declaration; nothing is compiled
until a CUDA tensor reaches a kernel (`repro_torch.kernels._cuda`).
"""
from typing import Dict

from repro_torch.kernels import api
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import rms_norm as _rms_norm
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import mlp_matmul as _mlp_matmul
from repro_torch.kernels import matvec as _matvec
from repro_torch.kernels import atax as _atax
from repro_torch.kernels import bicg as _bicg
from repro_torch.kernels import jacobi3d as _jacobi3d
from repro_torch.kernels import ops, ref
from repro_torch.kernels.api import KernelSpec, divisors, tuned_kernel
from repro_torch.kernels.atax import make_tunable_atax
from repro_torch.kernels.bicg import make_tunable_bicg
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.jacobi3d import make_tunable_jacobi3d
from repro_torch.kernels.matmul import make_tunable_matmul
from repro_torch.kernels.matvec import make_tunable_matvec

TUNABLE_FACTORIES = {
    "matmul": make_tunable_matmul,
    "matvec": make_tunable_matvec,
    "atax": make_tunable_atax,
    "bicg": make_tunable_bicg,
    "jacobi3d": make_tunable_jacobi3d,
}

_COUNTERS = (_rms_norm.LAUNCHES, _flash_attention.LAUNCHES,
             _mlp_matmul.LAUNCHES, _matmul.LAUNCHES, _matvec.LAUNCHES,
             _atax.LAUNCHES, _bicg.LAUNCHES, _jacobi3d.LAUNCHES)


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
