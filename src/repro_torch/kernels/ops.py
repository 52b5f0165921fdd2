"""Public entry points for the kernel layer — generated, not hand-written.

Every attribute of this module is a re-export of a
`repro_torch.kernels.api.KernelSpec.op` dispatch wrapper:
``ops.matmul``, ``ops.rms_norm``, ``ops.flash_attention`` and
``ops.mlp_matmul`` exist because a module declared
``@tuned_kernel("matmul", ...)`` and so on.  Each op resolves its launch
configuration through the tuning database for the active hardware
target (`repro_torch.core.target.default_target`, pinned with
``use_target(...)`` / ``REPRO_TUNING_TARGET``): the first call for a
given (kernel, shapes, dtype, chip) ranks the whole launch space with
the static cost model; every later call is a cache hit, and after
``repro_torch.tuning_cache.freeze()`` a lock-free frozen-table probe.
"""
from __future__ import annotations

from repro_torch.kernels import api


def __getattr__(name: str):
    if name == "__all__":
        return sorted(api.registered_kernels())
    spec = api.get_spec(name, default=None)
    if spec is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r} "
            f"(declared kernels: {api.registered_kernels()})")
    op = spec.op
    globals()[name] = op        # memoize: later lookups skip this hook
    return op


def __dir__():
    return sorted(set(globals()) | set(api.registered_kernels()))
