"""Resilient tuning-service client: the tier that is allowed to fail.

`ServiceClient.resolve` is consulted by `registry.lookup_or_tune`
between the live memo and the local database (DESIGN.md §13).  Its one
contract is **strict graceful degradation**: whatever the backend does
— refuse connections, stall past the deadline, return 5xx, emit a
corrupt payload, die mid-response — ``resolve`` returns ``None`` and
the dispatch falls through to the local tiers (memo → LRU → disk →
pretuned) and ultimately to `KernelSpec.fallback_params`.  It NEVER
raises into a dispatch, and it logs the degradation once per kernel
(rate-limited), not once per trace.

Resilience machinery, in the order a request meets it:

* a **circuit breaker**: after ``breaker_threshold`` consecutive
  failures the breaker opens and calls short-circuit to ``None``
  without touching the socket (a dead backend costs a dict probe, not
  a connect timeout, per dispatch); after ``breaker_cooldown_s`` it
  half-opens and admits one probe — success closes it, failure re-opens;
* a **deadline** (``deadline_s``) bounding the whole call including
  retries and backoff sleeps;
* **bounded retry** with exponential backoff and full jitter, capped by
  both ``backoff_max_s`` and the remaining deadline.

Responses are validated by `protocol.check_lookup_response` before
anything is trusted — a corrupt payload is a *transport failure*
(retry, breaker) while a well-formed per-request ``error`` is a
*definitive miss* (local fallthrough, breaker untouched).  Every good
response's ``generation`` stamp is tracked; a change fires the
``on_generation_change`` hooks, which `repro_torch.tuning_cache` wires to
`TuningDatabase.invalidate` so frozen tables and live memos drop
(DESIGN.md §12's hooks-not-checks rule, extended to the network).

Deliberately stdlib-only and import-light: a client-only process pays
milliseconds, not a torch import.
"""
from __future__ import annotations

import dataclasses
import http.client
import logging
import random
import socket
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.tuning_cache.service import protocol
from repro_torch.tuning_cache.service.faults import (CORRUPT, DELAY, ERROR,
                                               FaultInjector)

__all__ = ["ClientPolicy", "ClientStats", "CircuitBreaker", "ServiceClient"]

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ClientPolicy:
    """Knobs of the degradation ladder (see the module docstring)."""

    deadline_s: float = 2.0         # whole-call budget incl. retries
    connect_timeout_s: float = 0.5  # per-attempt socket timeout cap
    retries: int = 2                # extra attempts after the first
    backoff_base_s: float = 0.05
    backoff_max_s: float = 1.0
    jitter: float = 0.5             # +-fraction of each backoff sleep
    breaker_threshold: int = 5      # consecutive failures to trip open
    breaker_cooldown_s: float = 5.0


@dataclasses.dataclass
class ClientStats:
    requests: int = 0           # resolve/resolve_batch calls
    attempts: int = 0           # HTTP exchanges actually attempted
    hits: int = 0               # lookups answered with params
    misses: int = 0             # definitive per-request errors
    failures: int = 0           # transport/corruption failures
    retries: int = 0            # backoff-and-retry cycles
    degraded: int = 0           # calls that fell through to None
    breaker_trips: int = 0      # closed/half-open -> open transitions
    generation_changes: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class CircuitBreaker:
    """Classic three-state breaker (thread-safe).

    ``closed`` admits everything; ``open`` admits nothing until
    ``cooldown_s`` elapsed, then ``half-open`` admits exactly one probe
    whose outcome closes or re-opens the circuit.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            if (self._state == self.OPEN
                    and self._clock() - self._opened_at >= self.cooldown_s):
                return self.HALF_OPEN
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state != self.OPEN:
                return True
            if self._clock() - self._opened_at < self.cooldown_s:
                return False
            # half-open: admit ONE probe; racers stay short-circuited
            # until its verdict (re-arm the cooldown so they re-check).
            self._state = self.HALF_OPEN
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._state != self.CLOSED:
                _log.info("tuning-service circuit closed (backend "
                          "recovered)")
            self._state = self.CLOSED
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            tripped = (self._state == self.HALF_OPEN
                       or (self._state == self.CLOSED
                           and self._failures >= self.threshold))
            if tripped:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self.trips += 1
        if tripped:
            _log.warning("tuning-service circuit OPEN after %d consecutive "
                         "failure(s); probing again in %.1fs",
                         self._failures, self.cooldown_s)


class _NoDelayConnection(http.client.HTTPConnection):
    """HTTPConnection with Nagle off: a request/response exchange per
    dispatch would otherwise eat the ~40 ms Nagle/delayed-ACK stall."""

    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class _ServerError(Exception):
    """Non-200 status from the service (5xx, unexpected 4xx)."""

    def __init__(self, status: int):
        super().__init__(f"server returned HTTP {status}")
        self.status = status


class ServiceClient:
    """Deadline-bounded, breaker-guarded client for one tuning server.

    Thread-safe; each thread keeps its own persistent HTTP/1.1
    connection (re-established transparently after any failure).
    """

    def __init__(self, url: str, policy: Optional[ClientPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 clock: Callable[[], float] = time.monotonic):
        parsed = urllib.parse.urlsplit(url if "//" in url else f"//{url}",
                                       scheme="http")
        if parsed.scheme != "http" or not parsed.hostname:
            raise ValueError(f"tuning-service URL must be http://host:port, "
                             f"got {url!r}")
        self.url = f"http://{parsed.hostname}:{parsed.port or 80}"
        self._host = parsed.hostname
        self._port = parsed.port or 80
        self.policy = policy if policy is not None else ClientPolicy()
        self.injector = injector if injector is not None else FaultInjector()
        self.stats = ClientStats()
        self.breaker = CircuitBreaker(self.policy.breaker_threshold,
                                      self.policy.breaker_cooldown_s,
                                      clock=clock)
        self._clock = clock
        self._rng = random.Random(0x5EBF)
        self._local = threading.local()
        self._conns: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        self._generation: Optional[int] = None
        self._gen_hooks: List[Callable[[], None]] = []
        self._degraded_logged: set = set()

    # -- generation tracking -------------------------------------------------
    def on_generation_change(self, hook: Callable[[], None]
                             ) -> Callable[[], None]:
        """Register a callback fired whenever a response's generation
        stamp differs from the last one seen (bulk mutation of the
        shared database).  Hook errors are swallowed and logged — the
        dispatch path must stay unbreakable."""
        with self._lock:
            if hook not in self._gen_hooks:
                self._gen_hooks.append(hook)
        return hook

    @property
    def generation(self) -> Optional[int]:
        return self._generation

    def _note_generation(self, gen: Any) -> None:
        if not isinstance(gen, int) or isinstance(gen, bool):
            return
        with self._lock:
            changed = self._generation is not None and gen != self._generation
            self._generation = gen
            hooks = list(self._gen_hooks) if changed else []
            if changed:
                self.stats.generation_changes += 1
        for hook in hooks:
            try:
                hook()
            except Exception:
                _log.exception("tuning-service generation hook failed")

    # -- transport ----------------------------------------------------------
    def _connection(self, timeout: float) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = _NoDelayConnection(self._host, self._port,
                                      timeout=timeout)
            self._local.conn = conn
            with self._lock:
                self._conns.append(conn)
        else:
            # refresh the socket timeout for this attempt's budget
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            with self._lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
            try:
                conn.close()
            except Exception:
                pass

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass

    def _exchange(self, method: str, path: str, body: Optional[bytes],
                  timeout: float) -> bytes:
        fault = self.injector.fire("client.request")
        if fault is not None:
            if fault.kind == DELAY:
                time.sleep(fault.delay_s)
            elif fault.kind == CORRUPT:
                return fault.payload
            elif fault.kind == ERROR:
                raise ConnectionError("injected client-side fault")
        conn = self._connection(timeout)
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise _ServerError(resp.status)
        return data

    def _call(self, method: str, path: str, body: Optional[bytes] = None,
              validate: Optional[Callable[[Dict[str, Any]], Any]] = None
              ) -> Optional[Any]:
        """One deadline-bounded, retried, breaker-guarded exchange.
        Returns the validated payload, or ``None`` (degraded).  Never
        raises."""
        if not self.breaker.allow():
            self.stats.degraded += 1
            return None
        pol = self.policy
        deadline = self._clock() + pol.deadline_s
        attempt = 0
        while True:
            attempt += 1
            self.stats.attempts += 1
            remaining = deadline - self._clock()
            timeout = max(0.01, min(remaining, pol.connect_timeout_s))
            try:
                data = self._exchange(method, path, body, timeout)
                payload = protocol.decode(data)     # ValueError on corrupt
                out = validate(payload) if validate is not None else payload
                self.breaker.record_success()
                self._note_generation(payload.get("generation"))
                return out
            except Exception as e:
                # transport errors, timeouts, 5xx, corrupt payloads —
                # all one failure class; anything truly unexpected must
                # still degrade, never escape into a dispatch
                self._drop_connection()
                self.breaker.record_failure()
                self.stats.failures += 1
                _log.debug("tuning-service %s %s attempt %d failed: %s: %s",
                           method, path, attempt, type(e).__name__, e)
                remaining = deadline - self._clock()
                if (attempt > pol.retries or remaining <= 0
                        or not self.breaker.allow()):
                    self.stats.degraded += 1
                    return None
                self.stats.retries += 1
                sleep = min(pol.backoff_base_s * (2 ** (attempt - 1)),
                            pol.backoff_max_s)
                sleep *= 1.0 + pol.jitter * (2.0 * self._rng.random() - 1.0)
                time.sleep(max(0.0, min(sleep, remaining)))

    # -- API ----------------------------------------------------------------
    def resolve_batch(self, requests: Sequence[Dict[str, Any]]
                      ) -> List[Optional[Dict[str, Any]]]:
        """Resolve a batch of lookup requests in one round trip; one
        record payload (or ``None``) per request, in order."""
        self.stats.requests += 1
        n = len(requests)
        if n == 0:
            return []
        try:
            body = protocol.encode(protocol.lookup_request(requests))
        except (TypeError, ValueError) as e:
            # unserializable signature: a local-tier problem, not ours
            _log.debug("tuning-service request not serializable: %s", e)
            self.stats.degraded += 1
            return [None] * n
        results = self._call(
            "POST", protocol.LOOKUP_PATH, body,
            validate=lambda p: protocol.check_lookup_response(p, n)[1])
        if results is None:
            self._log_degraded(requests)
            return [None] * n
        self.stats.hits += sum(1 for r in results if r is not None)
        self.stats.misses += sum(1 for r in results if r is None)
        return results

    def resolve(self, kernel_id: str, signature: Dict[str, Any], *,
                target: str, fingerprint: Optional[str] = None,
                mode: str = "static") -> Optional[Dict[str, Any]]:
        """Resolve one kernel instance: a record payload dict
        (``params`` + provenance) or ``None`` on miss/degradation."""
        req = {"kernel_id": kernel_id, "signature": dict(signature),
               "target": target, "mode": mode}
        if fingerprint is not None:
            req["fingerprint"] = fingerprint
        return self.resolve_batch([req])[0]

    def health(self) -> Optional[Dict[str, Any]]:
        """Server liveness payload, or ``None`` when unreachable."""
        return self._call("GET", protocol.HEALTH_PATH)

    def remote_stats(self) -> Optional[Dict[str, Any]]:
        return self._call("GET", protocol.STATS_PATH)

    def _log_degraded(self, requests: Sequence[Dict[str, Any]]) -> None:
        """Warn once per kernel_id that its dispatches run degraded;
        later degradations log at DEBUG (rate-limited)."""
        kernels = {str(r.get("kernel_id")) for r in requests}
        with self._lock:
            fresh = kernels - self._degraded_logged
            self._degraded_logged |= fresh
        for kernel_id in sorted(fresh):
            _log.warning(
                "tuning service %s unavailable for %s; dispatch degrades "
                "to the local tiers (memo/LRU/disk/pretuned, then fallback "
                "params).  Further degradations for this kernel log at "
                "DEBUG.", self.url, kernel_id)
        if not fresh:
            _log.debug("tuning service %s unavailable for %s (degraded)",
                       self.url, sorted(kernels))
