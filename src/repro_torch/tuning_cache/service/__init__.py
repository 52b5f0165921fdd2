"""Fault-tolerant tuning service: server, resilient client, chaos tools.

See DESIGN.md §13.  The package split keeps imports honest:

* `faults`, `protocol`, `client` — stdlib-only; a client process pays
  milliseconds, never a torch import;
* `server` — imports the registry/tuner stack (and transitively torch
  via the kernel modules) because only the server runs ranks.

The wire format is the reference's (`repro.tuning_cache.service`), so a
client of either package talks to a server of the other.

Import ``from repro_torch.tuning_cache.service import ...`` for the chaos and
client types; import `TuningServer` from `.server` explicitly (or via
the lazy attribute here) so light processes stay light.
"""
from __future__ import annotations

from repro_torch.tuning_cache.service.client import (CircuitBreaker, ClientPolicy,
                                               ClientStats, ServiceClient)
from repro_torch.tuning_cache.service.faults import (CORRUPT, DELAY, DISCONNECT,
                                               DROP, ERROR, KILL, KINDS,
                                               FaultInjector, FaultSchedule,
                                               ServiceFault, parse_fault)

__all__ = ["FaultInjector", "FaultSchedule", "ServiceFault", "parse_fault",
           "KINDS", "DROP", "DELAY", "CORRUPT", "DISCONNECT", "ERROR", "KILL",
           "CircuitBreaker", "ClientPolicy", "ClientStats", "ServiceClient",
           "TuningServer", "SingleFlight", "ServerStats"]


def __getattr__(name):
    # lazy: pulling in the server (and its tuner deps) only when asked
    if name in ("TuningServer", "SingleFlight", "ServerStats"):
        from repro_torch.tuning_cache.service import server
        return getattr(server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
