"""Spans of the serving path: where a step's host and device time go, by
model layer and by kernel op.

    from repro_torch.runtime import spans

    with spans.span("model.block", h, layer=i):
        ...

A span is off unless `enable()` was called or the torch profiler is
recording (``torch.autograd.profiler._is_profiler_enabled``, the flag
torch keeps for such checks).  Off, it costs one check and returns a
shared null context: no clock is read and nothing is made.  On, it
records its name, its id, its parent's id (a stack per thread), the id
of the outermost span open when it began (the serving call it belongs
to), its attributes and its host start and end
(`time.perf_counter_ns`).  A span given a CUDA tensor is a device span:
it also records a CUDA event pair on the current stream, except while
that stream is being captured into a graph.  Every span is also a
profiler range named ``repro_torch.<name>``, so in a torch profile a
span and the kernels it launched lie on one timeline.  The range is a
function-scope one (`torch._C._profiler._RecordFunctionFast`), not a
``record_function``: the profiler gives each kernel to the innermost
user range open at its launch, so a user range here would take the
kernels of a caller's own ``record_function`` around an op (the
benchmark's ``perfbench.op.*``) from it.

`KernelSpec.op` adds, while spans are on, each registry call's dispatch
time (its entry to the kernel's launch) through `count_dispatch`.

The record is kept in memory until `reset()`.  `summary()` resolves it
by span name, `records()` span by span; nothing here writes it out
(`repro_torch.launch.serve --trace PATH` does).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

__all__ = ["PREFIX", "span", "active", "enable", "disable",
           "count_dispatch", "records", "summary", "reset"]

PREFIX = "repro_torch."

_enabled = False
_NULL = contextlib.nullcontext()
_record: List["_Span"] = []
_dispatch_ns: List[int] = []
_ids = itertools.count(1)
_local = threading.local()


def active() -> bool:
    """True while spans record: after `enable()`, or while the torch
    profiler is recording."""
    return _enabled or _profiler._is_profiler_enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Spans record again only under the torch profiler."""
    global _enabled
    _enabled = False


def span(name: str, on: Optional[torch.Tensor] = None, /, **attrs: Any):
    """A context that records the span ``name`` with ``attrs``; with
    ``on``, a tensor of the work inside, a device span when it lies on
    a CUDA device."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, on, attrs)


def count_dispatch(ns: int) -> None:
    """One registry call's dispatch time, in host ns."""
    _dispatch_ns.append(ns)


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "call", "start_ns",
                 "end_ns", "events", "device_ms", "_range")

    def __init__(self, name: str, on, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs
        self.end_ns = self.device_ms = None
        self.events = None
        if on is not None and on.is_cuda \
                and not torch.cuda.is_current_stream_capturing():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.call = stack[0].id if stack else self.id
        stack.append(self)
        _record.append(self)
        self._range = _RecordFunctionFast(PREFIX + self.name)
        self._range.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        self._range = None
        _stack().pop()
        return False


def _resolve() -> List[_Span]:
    """The closed spans, their device times read (one synchronise)."""
    done = [s for s in _record if s.end_ns is not None]
    timed = [s for s in done if s.events is not None]
    if timed:
        torch.cuda.synchronize()
        for s in timed:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    return done


def records() -> List[Dict[str, Any]]:
    """Every closed span of the record, in the order they began:
    ``id``, ``parent``, ``call``, ``name``, ``attrs``,
    ``host_start_ns``, ``host_end_ns`` and ``device_ms`` (None for a
    host span)."""
    return [{"id": s.id, "parent": s.parent, "call": s.call,
             "name": s.name, "attrs": dict(s.attrs),
             "host_start_ns": s.start_ns, "host_end_ns": s.end_ns,
             "device_ms": s.device_ms} for s in _resolve()]


def summary() -> Dict[str, Any]:
    """The record by span name: ``count``, ``host_ms`` and
    ``host_self_ms`` (less the part its child spans cover),
    ``device_ms`` and ``device_self_ms`` (None where no span of the name
    was timed on the device), and the per-call ``host_ms_each`` and
    ``device_ms_each``; beside them ``device`` (``cuda`` when any span
    was timed on a CUDA device, else ``cpu``) and ``dispatch``: the
    registry calls' summed dispatch ``ns`` and ``calls`` while spans
    were on, and the dispatch tiers' counters (``tiers``,
    `repro_torch.kernels.api.dispatch_stats`)."""
    from repro_torch.kernels.api import dispatch_stats
    recs = _resolve()
    kid_host: Dict[int, int] = {}
    kid_dev: Dict[int, float] = {}
    for s in recs:
        if s.parent is not None:
            kid_host[s.parent] = kid_host.get(s.parent, 0) \
                + s.end_ns - s.start_ns
            if s.device_ms is not None:
                kid_dev[s.parent] = kid_dev.get(s.parent, 0.0) + s.device_ms
    out: Dict[str, Dict[str, Any]] = {}
    for s in recs:
        e = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                    "host_self_ms": 0.0, "device_ms": None,
                                    "device_self_ms": None,
                                    "host_ms_each": [], "device_ms_each": []})
        host = (s.end_ns - s.start_ns) / 1e6
        e["count"] += 1
        e["host_ms"] += host
        e["host_self_ms"] += host - kid_host.get(s.id, 0) / 1e6
        e["host_ms_each"].append(host)
        if s.device_ms is not None:
            e["device_ms"] = (e["device_ms"] or 0.0) + s.device_ms
            e["device_self_ms"] = (e["device_self_ms"] or 0.0) \
                + s.device_ms - kid_dev.get(s.id, 0.0)
            e["device_ms_each"].append(s.device_ms)
    timed = any(s.device_ms is not None for s in recs)
    ns = list(_dispatch_ns)
    return {"device": "cuda" if timed else "cpu", "spans": out,
            "dispatch": {"ns": sum(ns), "calls": len(ns),
                         "tiers": dispatch_stats()}}


def reset() -> None:
    """Forget the record and the dispatch times."""
    _record.clear()
    _dispatch_ns.clear()
