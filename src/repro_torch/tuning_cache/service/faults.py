"""Fault injection for the tuning service (the chaos harness).

The serving thesis of DESIGN.md §13 is that a dead, slow, or corrupting
tuning backend can never take down a dispatch — the zero-run property
means a correct answer always exists locally.  Proving that requires
*making* the backend die, stall, and corrupt on demand, declaratively,
in both the server and the client, so the chaos tests and
``python -m repro_torch.tuning_cache serve --fault ...`` share one vocabulary.

A :class:`ServiceFault` names a **site** (a choke point the code fires
explicitly — ``server.request``, ``server.tune``, ``client.request``),
a **kind** (what happens there), and a :class:`FaultSchedule` (which
hits of that site it applies to).  The :class:`FaultInjector` is the
site-keyed dispatcher threaded through `TuningServer` and
`ServiceClient`; production code paths hold a no-fault injector whose
``fire`` is a single dict probe.

Kinds:

``drop``        close the connection without any response
``delay``       sleep ``delay_s`` before proceeding (slow backend)
``corrupt``     respond successfully with garbage bytes
``disconnect``  advertise a full response, send half of it, then close
``error``       respond HTTP 500
``kill``        ``os._exit`` the process on the spot (crash mid-tune)

`FaultSchedule` is the when-to-fire arithmetic the reference shares
with its per-*step* training faults (`runtime/fault.py`, which this
package does not have yet).  This module is deliberately stdlib-only so
a client-only process can import it in milliseconds.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["DROP", "DELAY", "CORRUPT", "DISCONNECT", "ERROR", "KILL",
           "KINDS", "FaultSchedule", "ServiceFault", "FaultInjector",
           "parse_fault"]

DROP = "drop"
DELAY = "delay"
CORRUPT = "corrupt"
DISCONNECT = "disconnect"
ERROR = "error"
KILL = "kill"
KINDS = (DROP, DELAY, CORRUPT, DISCONNECT, ERROR, KILL)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Which hits of a site a fault fires on.

    ``after`` is the first firing hit (1-based), ``every`` the repeat
    stride from there on (0 = fire only on the ``after``-th hit), and
    ``times`` the total fire budget (0 = unlimited).  The default fires
    on every hit — a bare ``ServiceFault(site, kind)`` is a standing
    outage, the common chaos-test shape.
    """

    after: int = 1
    every: int = 1
    times: int = 0

    def fires_at(self, hit: int, fired: int) -> bool:
        """``hit`` is this site's 1-based hit counter; ``fired`` how
        many times this fault already fired."""
        if self.times > 0 and fired >= self.times:
            return False
        if hit < self.after:
            return False
        if self.every <= 0:
            return hit == self.after
        return (hit - self.after) % self.every == 0


@dataclasses.dataclass(frozen=True)
class ServiceFault:
    """One declarative fault: *kind* happens at *site* per *schedule*."""

    site: str
    kind: str
    delay_s: float = 0.25
    payload: bytes = b'{"generation": }garbage'   # deliberately not JSON
    schedule: FaultSchedule = dataclasses.field(default_factory=FaultSchedule)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if not self.site:
            raise ValueError("fault site must be a non-empty string")


class FaultInjector:
    """Site-keyed fault dispatcher (thread-safe).

    Code under test calls ``injector.fire(site)`` at each choke point
    and acts on the returned fault (or ``None``).  The injector only
    decides *which* fault applies; the *mechanics* (closing a socket,
    sleeping, exiting) live at the site, which is the only place that
    has the connection in hand.  ``fired`` logs every decision for test
    assertions.
    """

    def __init__(self, faults: Sequence[ServiceFault] = ()):
        self._faults: List[ServiceFault] = list(faults)
        self._fired_counts: Dict[int, int] = {}
        self._hits: Dict[str, int] = {}
        self.fired: List[Tuple[str, str]] = []      # (site, kind) log
        self._lock = threading.Lock()

    def add(self, fault: ServiceFault) -> ServiceFault:
        with self._lock:
            self._faults.append(fault)
        return fault

    def fire(self, site: str) -> Optional[ServiceFault]:
        """Record a hit of ``site``; return the fault that applies (the
        first declared match wins), or ``None``."""
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            for i, fault in enumerate(self._faults):
                if fault.site != site:
                    continue
                if fault.schedule.fires_at(hit, self._fired_counts.get(i, 0)):
                    self._fired_counts[i] = self._fired_counts.get(i, 0) + 1
                    self.fired.append((site, fault.kind))
                    return fault
            return None

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)


def parse_fault(text: str) -> ServiceFault:
    """Parse the CLI spelling ``kind@site[:key=value,...]``.

    Examples::

        drop@server.request
        delay@server.tune:delay=2.0
        kill@server.tune:after=1
        corrupt@server.request:after=2,every=3,times=5
    """
    head, _, opts = text.partition(":")
    kind, sep, site = head.partition("@")
    if not sep or not kind or not site:
        raise ValueError(f"fault spec {text!r} must be kind@site[:k=v,...]")
    kw: Dict[str, float] = {}
    for pair in filter(None, opts.split(",")):
        k, sep, v = pair.partition("=")
        if not sep:
            raise ValueError(f"fault option {pair!r} must be key=value")
        kw[k.strip()] = float(v)
    sched = FaultSchedule(after=int(kw.pop("after", 1)),
                          every=int(kw.pop("every", 1)),
                          times=int(kw.pop("times", 0)))
    delay = float(kw.pop("delay", 0.25))
    if kw:
        raise ValueError(f"unknown fault options {sorted(kw)} in {text!r}; "
                         f"expected delay/after/every/times")
    return ServiceFault(site=site, kind=kind, delay_s=delay, schedule=sched)
