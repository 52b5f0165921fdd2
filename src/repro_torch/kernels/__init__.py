"""The port's kernels, each a `@tuned_kernel` declaration with a CUDA
kernel written for Hopper and a plain PyTorch version: the serving
path's matmul, rms_norm, flash_attention (flash / blocked) and
mlp_matmul (fused / stream / split), the paper's Table IV kernels
matvec, atax, bicg and jacobi3d, and whatever else a module of this
package declares.  Oracles live in ref.py; the generated dispatch entry
points in ops.py;
``make_tunable_*`` package a kernel for `repro_torch.core.KernelTuner`.

Every non-private module in this package is imported here (so its
declaration registers), which is what makes "drop a decorated module in
``kernels/`` and call ``ops.<kernel_id>``" work with zero edits to any
other file; `megamatmul` is a factory and registers nothing on import.
Nothing is compiled until a CUDA tensor reaches a kernel
(`repro_torch.kernels._cuda`).
"""
import importlib
import pkgutil
import sys
from typing import Dict

# ops re-exports the registry, so it must come after every declaration;
# everything else registers (or is inert) on import.
_DEFERRED = {"ops"}
for _mod in pkgutil.iter_modules(__path__):
    if _mod.name.startswith("_") or _mod.name in _DEFERRED:
        continue
    importlib.import_module(f"{__name__}.{_mod.name}")

from repro_torch.kernels import api, ops, ref
from repro_torch.kernels.api import KernelSpec, divisors, tuned_kernel
from repro_torch.kernels.atax import make_tunable_atax
from repro_torch.kernels.bicg import make_tunable_bicg
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention import make_tunable_flash
from repro_torch.kernels.jacobi3d import make_tunable_jacobi3d
from repro_torch.kernels.matmul import make_tunable_matmul
from repro_torch.kernels.matvec import make_tunable_matvec
from repro_torch.kernels.stencil2d import make_tunable_stencil2d

TUNABLE_FACTORIES = {
    "matmul": make_tunable_matmul,
    "matvec": make_tunable_matvec,
    "atax": make_tunable_atax,
    "bicg": make_tunable_bicg,
    "jacobi3d": make_tunable_jacobi3d,
    "flash": make_tunable_flash,
    "stencil2d": make_tunable_stencil2d,
}


def _counters():
    """The ``LAUNCHES`` dict of every module that declares a registered
    kernel — this package's and any declared elsewhere (an example's,
    a caller's) — found from the registry, not from a list."""
    seen: Dict[int, Dict[str, int]] = {}
    for kid in api.registered_kernels():
        spec = api.get_spec(kid)
        fns = [spec.fn] + [v.fn for v in (spec._variants or {}).values()]
        for fn in fns:
            c = getattr(sys.modules.get(fn.__module__), "LAUNCHES", None)
            if isinstance(c, dict):
                seen[id(c)] = c
    return list(seen.values())


def launch_counts() -> Dict[str, int]:
    """Launches of every CUDA kernel since the last reset, by name."""
    out: Dict[str, int] = {}
    for c in _counters():
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _counters():
        for k in c:
            c[k] = 0
