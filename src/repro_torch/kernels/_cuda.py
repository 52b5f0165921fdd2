"""Build, load and call the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled for Hopper (``sm_90a``) with ``nvcc`` at first
use — one ``nvcc -c`` per source, all started together, then one link
into a shared library with a plain C interface — and loaded with
``ctypes``.  Nothing here runs at import time: a machine without
``nvcc`` or a card imports every kernel module and runs the plain
PyTorch versions.

The build lands in ``build/repro_torch_kernels/`` at the repository
root (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a digest of the
sources and flags, so an edited source rebuilds and an unchanged one
loads the cached library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["library", "build_log", "check", "stream_of", "dtype_code",
           "require_operands", "CSRC", "SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gemm.cu", "rms_norm.cu", "attention.cu", "library.cu")
_HEADERS = ("common.cuh",)
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_log: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function (all return cudaError_t as int)
_SIGNATURES = {
    "repro_gemm": [_I, _I, _I, _P, _P, _P, _I, _I, _I, _P],
    "repro_gemm_gated": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_gemm_stream": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_rms_norm": [_I, _I, _P, _P, _P, _I, _I, _F, _P],
    "repro_flash": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "repro_blocked": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "repro_kernel_attrs": [_I, _I, _I, ctypes.POINTER(_I),
                           ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "repro_tile_count": [_I],
    "repro_tile_info": [_I, _I, ctypes.POINTER(_I)],
}


def _build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this machine")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = out.parent / f"{out.stem}.{Path(name).stem}.o"
        cmd = [nvcc, *_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    ptxas: Dict[str, str] = {}
    failed: List[str] = []
    for name, _obj, p in procs:
        so, se = p.communicate()
        ptxas[name] = so + se
        if p.returncode != 0:
            failed.append(f"{name} (rc={p.returncode}):\n{se[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in procs]
        + ["-lcudart"], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr[-4000:]}")
    os.replace(tmp, out)
    _log.update(build_s=time.perf_counter() - t0, ptxas=ptxas, cached=False)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            out = _build_dir() / f"librepro_torch_{_digest()}.so"
            if out.is_file():
                _log.update(build_s=0.0, ptxas={}, cached=True)
            else:
                _compile(out)
            lib = ctypes.CDLL(str(out))
            for fn, args in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = args
                f.restype = _I
            lib.repro_error_string.argtypes = [_I]
            lib.repro_error_string.restype = ctypes.c_char_p
            _log["path"] = str(out)
            _lib = lib
    return _lib


def build_log() -> Dict[str, object]:
    """Build time, library path and ``-Xptxas -v`` output per source of
    the build this process made (empty until `library` ran)."""
    return dict(_log)


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error: a refused launch (too
    many threads, too much shared memory) never runs, and a later
    synchronize would not report it."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t) -> int:
    """The C side's element-type switch: 0 float32, 1 bfloat16."""
    import torch
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")


def require_operands(kernel: str, *tensors) -> None:
    """ValueError unless every operand is a contiguous CUDA tensor of one
    supported dtype on one device — what the kernels take."""
    import torch
    t0 = tensors[0]
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{kernel}: operand on {t.device}, the CUDA "
                             f"kernel needs CUDA tensors")
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{kernel}: operands disagree on device/dtype "
                             f"({t.device}/{t.dtype} vs "
                             f"{t0.device}/{t0.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
    if t0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: CUDA kernels take float32 or "
                        f"bfloat16, got {t0.dtype}")
