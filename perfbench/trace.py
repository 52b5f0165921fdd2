"""The traced stretch: each registry op the model calls wrapped in a
``torch.profiler.record_function`` span named after it, and the
profile reduced to what the per-layer readers take.

Device time goes to an op by the span's device-side range, which the
profiler derives from the kernels launched inside the span, whatever
their names; the library's ``__global__`` names (read from its
sources) only check that every library kernel falls in some op's
range.  (The host-side link of a kernel to its span, a profiler
event's ``kernels``, stays empty for kernels the library launches
through ctypes.)
"""
from __future__ import annotations

import bisect
import contextlib
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from perfbench.work import op_work, least_s

__all__ = ["SPAN", "profile"]

SPAN = "perfbench.op."
_GAPS_NAMED = 200        # idle gaps named by what the host was doing
_TOP = 10


@contextlib.contextmanager
def op_spans(least: Dict[str, float], uncounted: set):
    """Every op of ``repro_torch.kernels.ops`` wrapped in its span for
    the block; each call's least time (`work.op_work`) summed into
    ``least`` by op, an op without one named in ``uncounted``."""
    from repro_torch.kernels import api, ops
    saved = {}
    for name in api.registered_kernels():
        op = getattr(ops, name)
        saved[name] = op

        def wrapped(*args, _op=op, _name=name, **kw):
            w = op_work(_name, args, kw)
            if w is None:
                uncounted.add(_name)
            else:
                least[_name] = least.get(_name, 0.0) + least_s(*w)
            with torch.profiler.record_function(SPAN + _name):
                return _op(*args, **kw)
        setattr(ops, name, wrapped)
    try:
        yield
    finally:
        for name, op in saved.items():
            setattr(ops, name, op)


def _library_kernels() -> List[str]:
    """The ``__global__`` functions the port's library declares."""
    import repro_torch.kernels._cuda as cuda
    names = set()
    for src in Path(cuda.CSRC).glob("*.cu"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*"
            r"\)\s*)?(\w+)\s*\(", src.read_text()))
    return sorted(names)


def profile(fn: Callable[[], Dict], sync: Callable[[], None]) -> Dict:
    """Run ``fn`` under the profiler with the op spans on and reduce the
    trace."""
    least: Dict[str, float] = {}
    uncounted: set = set()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync()
    with op_spans(least, uncounted), \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    red = reduce(prof, wall)
    red.update(least_s=least, uncounted=sorted(uncounted), stretch=out)
    return red


def reduce(prof, wall_s: float) -> Dict:
    """Device busy time (the union of the kernels' and copies'
    intervals), their summed time by name and inside each op's span,
    and the idle gaps.  A span's device-side range (the profiler's
    projection of a ``record_function`` onto the device: its first
    kernel's start to its last one's end) holds the kernels launched
    inside it; on one stream no other kernel runs there."""
    DT = torch.autograd.DeviceType
    dev = [e for e in prof.events() if e.device_type == DT.CUDA
           and e.time_range.end > e.time_range.start]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name[len(SPAN):])
                    for e in dev if e.name.startswith(SPAN))
    kernels = [e for e in dev if not (e.name.startswith(SPAN)
                                      or getattr(e, "is_user_annotation",
                                                 False))]
    iv = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, gaps, end = 0.0, [], None
    for a, b in iv:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name: Dict[str, float] = {}
    spans: Dict[str, float] = {}
    starts = [r[0] for r in ranges]
    lib = _library_kernels()
    is_lib = re.compile(r"(?<!\w)(" + "|".join(lib) + r")\b")
    n_lib = n_lib_spans = 0
    for e in kernels:
        a, b = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
        i = bisect.bisect_right(starts, (a + b) / 2) - 1
        inside = i >= 0 and ranges[i][1] >= (a + b) / 2
        if inside:
            spans[ranges[i][2]] = spans.get(ranges[i][2], 0.0) + (b - a)
        if is_lib.search(e.name):
            n_lib += 1
            n_lib_spans += inside
    cpu = [e for e in prof.events() if e.device_type == DT.CPU]
    return {"wall_s": wall_s, "busy_s": busy / 1e6,
            "kernel_s": sum(by_name.values()) / 1e6,
            "span_kernel_s": {k: v / 1e6 for k, v in spans.items()},
            "library_kernels": n_lib, "library_kernels_in_spans": n_lib_spans,
            "device_ops": [[k, v / 1e6] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:_TOP]],
            "idle_gaps": _name_gaps(gaps, cpu)}


def _name_gaps(gaps: List[Tuple[float, float]], cpu) -> List:
    """The longest idle gaps, each named by the innermost host op open
    at its middle, summed by name."""
    if not gaps or not cpu:
        return []
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:_GAPS_NAMED]
    starts = np.array([e.time_range.start for e in cpu], dtype=np.float64)
    ends = np.array([e.time_range.end for e in cpu], dtype=np.float64)
    out: Dict[str, float] = {}
    for a, b in longest:
        mid = (a + b) / 2
        hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = cpu[hit[np.argmax(starts[hit])]].name if hit.size \
            else "(no host op)"
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])
            [:_TOP]]
