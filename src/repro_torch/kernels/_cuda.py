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

A kernel declared outside the library — a module dropped into
``kernels/``, or the caller's own file — brings its own ``.cu`` and
builds it with `load_extension`: one ``nvcc`` with the same flags, into
its own digest-named library beside the main one, loaded with ctypes.
The library's source list and C interface never name it.

`disassemble` reads what was built: ``cuobjdump -res-usage -sass`` of the
library or of an extension, from the toolkit ``nvcc`` came from, cached
beside the binary; `sass_functions` parses it (`repro_torch.core.sass`)
with names demangled by the toolkit's ``cu++filt``.
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
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["library", "load_extension", "build_log", "check", "stream_of",
           "dtype_code", "require_operands", "disassemble", "demangle",
           "sass_functions", "CSRC", "SOURCES", "TILE_INFO_INTS"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gemm.cu", "rms_norm.cu", "attention.cu", "blas2.cu",
           "jacobi3d.cu", "optim.cu", "library.cu")
_HEADERS = ("common.cuh", "hopper.cuh")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_log: Dict[str, object] = {}
# extensions: name -> (source as given, library), their build logs, a
# lock each; the wrappers pass one module-level path object per launch,
# so the warm check is an identity test that touches no file
_exts: Dict[str, Tuple[object, ctypes.CDLL]] = {}
_ext_logs: Dict[str, Dict[str, object]] = {}
_ext_locks: Dict[str, threading.Lock] = {}
_ext_guard = threading.Lock()   # guards _ext_locks, never held over nvcc

# ints one `repro_tile_info` call may write (common.cuh
# REPRO_TILE_INFO_INTS): a caller's buffer holds this many
TILE_INFO_INTS = 9

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every exported function (all return cudaError_t as int)
_SIGNATURES = {
    "repro_gemm": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_splitk_reduce": [_I, _P, _P, _I, _I, _I, _P],
    "repro_gemm_gated": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_gemm_stream": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_rms_norm": [_I, _I, _P, _P, _P, _I, _I, _F, _P],
    "repro_flash": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "repro_blocked": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "repro_matvec": [_I, _I, _P, _P, _P, _I, _I, _P],
    "repro_blas2_grid": [_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    "repro_atax": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_bicg": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_jacobi3d": [_I, _I, _P, _P, _I, _I, _I, _F, _F, _P],
    "repro_sumsq": [_I, _P, _P, _I, _P, _L, _L, _P],
    "repro_adamw": [_I, _I, _P, _P, _P, _P, _P, _L, _L, _F, _F, _F, _F, _F,
                    _F, _P],
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
        # named by process: ranks of a world may build at once
        obj = out.parent / f"{out.stem}.{Path(name).stem}.{os.getpid()}.o"
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
    for _, obj, _ in procs:
        obj.unlink()
    _log.update(build_s=time.perf_counter() - t0, ptxas=ptxas, cached=False)


def _bind(lib: ctypes.CDLL, signatures: Dict[str, Sequence]) -> None:
    """Declare every exported function's arguments (each returns a
    cudaError_t as int) and the shared error string."""
    for fn, args in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(args)
        f.restype = _I
    lib.repro_error_string.argtypes = [_I]
    lib.repro_error_string.restype = ctypes.c_char_p


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
            _bind(lib, _SIGNATURES)
            _log["path"] = str(out)
            _lib = lib
    return _lib


def load_extension(name: str, source: Union[str, Path],
                   signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (at first use) and load one extension: a ``.cu`` file that
    includes ``common.cuh``, exports ``signatures``' functions with C
    linkage and ``REPRO_EXPORT_ERROR_STRING``.

    It compiles with the library's flags into
    ``lib<name>_<digest>.so`` in the build directory, the digest taken
    over the flags, the source and the shared headers, so an edited
    source rebuilds and an unchanged one loads the cached file.  Later
    calls in the process return the loaded library without touching
    the files (the wrappers call this on every launch), as `library`
    does.  A failed build raises: there is no CPU fallback for a CUDA
    tensor.
    """
    hit = _exts.get(name)
    if hit is not None and hit[0] is source:
        return hit[1]
    with _ext_guard:
        lock = _ext_locks.setdefault(name, threading.Lock())
    with lock:
        hit = _exts.get(name)
        if hit is not None and hit[0] == source:
            return hit[1]
        path = Path(source).resolve()
        h = hashlib.sha256(" ".join(_FLAGS).encode())
        h.update(path.read_bytes())
        for hdr in _HEADERS:
            h.update((CSRC / hdr).read_bytes())
        out = _build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"
        log: Dict[str, object] = {"build_s": 0.0, "ptxas": {},
                                  "cached": True}
        if not out.is_file():
            out.parent.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            p = subprocess.run(
                [_nvcc(), *_FLAGS, "-I", str(CSRC), "-shared", "-o",
                 str(tmp), str(path), "-lcudart"],
                capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for extension {name!r} "
                                   f"({path}, rc={p.returncode}):\n"
                                   f"{p.stderr[-4000:]}")
            os.replace(tmp, out)
            log = {"build_s": time.perf_counter() - t0,
                   "ptxas": {path.name: p.stdout + p.stderr},
                   "cached": False}
        lib = ctypes.CDLL(str(out))
        _bind(lib, signatures)
        _ext_logs[name] = dict(log, path=str(out))
        _exts[name] = (source, lib)
    return lib


def build_log(extension: Optional[str] = None) -> Dict[str, object]:
    """Build time, library path and ``-Xptxas -v`` output per source of
    the build this process made of the library (empty until `library`
    ran), or of the named extension (empty until it loaded)."""
    if extension is not None:
        return dict(_ext_logs.get(extension, {}))
    return dict(_log)


def _toolkit(tool: str) -> str:
    """A binary of the toolkit ``nvcc`` came from (no fallback: a
    missing tool raises)."""
    path = os.path.join(os.path.dirname(_nvcc()), tool)
    if not os.path.isfile(path):
        raise RuntimeError(f"{tool} not found beside {_nvcc()}: the built "
                           f"kernels cannot be disassembled on this "
                           f"machine")
    return path


def _binary(extension: Optional[str]) -> Path:
    if extension is None:
        library()
        return Path(str(_log["path"]))
    log = _ext_logs.get(extension)
    if not log:
        raise RuntimeError(f"extension {extension!r} is not loaded: call "
                           f"its module's extension() first")
    return Path(str(log["path"]))


def disassemble(extension: Optional[str] = None) -> str:
    """``cuobjdump -res-usage`` and ``-sass`` of the kernel library
    (building it first if needed) or of a loaded extension, in one text.
    The text is cached beside the binary (``<library>.sass``, named by
    the same digest), so an unchanged build disassembles once."""
    lib = _binary(extension)
    cache = lib.with_suffix(".sass")
    if cache.is_file():
        return cache.read_text()
    tool = _toolkit("cuobjdump")
    procs = [subprocess.Popen([tool, flag, str(lib)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for flag in ("-res-usage", "-sass")]
    parts = []
    for flag, p in zip(("-res-usage", "-sass"), procs):
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"cuobjdump {flag} {lib} failed "
                               f"(rc={p.returncode}): {err[-2000:]}")
        parts.append(out)
    text = "".join(parts)
    tmp = cache.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, cache)
    return text


def demangle(names: Sequence[str]) -> Dict[str, str]:
    """Mangled -> demangled names, by the toolkit's ``cu++filt``."""
    names = list(names)
    p = subprocess.run([_toolkit("cu++filt")], input="\n".join(names),
                       capture_output=True, text=True)
    out = p.stdout.splitlines()
    if p.returncode != 0 or len(out) != len(names):
        raise RuntimeError(f"cu++filt failed (rc={p.returncode}): "
                           f"{p.stderr[-2000:]}")
    return dict(zip(names, out))


_sass: Dict[str, Dict[str, object]] = {}


def sass_functions(extension: Optional[str] = None) -> Dict[str, object]:
    """The library's (or an extension's) SASS functions, keyed by mangled
    name (`repro_torch.core.sass.parse_sass` of `disassemble`, names
    demangled by `demangle`); memoized per binary."""
    from repro_torch.core.sass import parse_sass
    key = str(_binary(extension))
    hit = _sass.get(key)
    if hit is None:
        hit = parse_sass(disassemble(extension))
        for name, full in demangle(list(hit)).items():
            hit[name].demangled = full
        _sass[key] = hit
    return hit


def check(rc: int, what: str, lib: Optional[ctypes.CDLL] = None) -> None:
    """Raise when a launch returned a CUDA error: a refused launch (too
    many threads, too much shared memory) never runs, and a later
    synchronize would not report it.  ``lib`` is the extension that
    launched (default: the kernel library)."""
    if rc != 0:
        msg = (lib or library()).repro_error_string(rc).decode()
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
