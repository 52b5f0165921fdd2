"""The tuning server: coalesced multi-process `lookup_or_tune` over HTTP.

One server process owns one `TuningDatabase`; N trace-time client
processes resolve launch params against it (``POST /v1/lookup``,
batched).  This is the shared warm tier: the database's
exactly-one-tune-per-cold-key guarantee — an RLock held over the tune —
lifted across process boundaries.

The cross-process generalization is :class:`SingleFlight`, not the
database lock: holding ``db.lock`` over a tune would serialize *every*
request behind *any* cold rank.  Instead each cold `CacheKey` digest
gets one in-flight slot; the first arrival (the *leader*) ranks the
space while racers for the same digest park on an event and share the
leader's stored record, and requests for other digests — warm probes
included — proceed untouched in their own handler threads
(`ThreadingHTTPServer`: one thread per connection).

Every response carries the database ``generation`` so clients notice
bulk mutation of the shared store (an operator ``import_jsonl`` /
`TuningDatabase.invalidate`) and drop their frozen tables and live
memos through the existing `on_invalidate` hook machinery.

Fault sites (`repro_torch.tuning_cache.service.faults`): ``server.request``
fires as a lookup POST arrives (drop / delay / corrupt / disconnect /
error / kill), ``server.tune`` fires as a cold rank begins (delay
stretches the coalescing window; kill crashes the process mid-tune —
the chaos suite's favourite).

Run it: ``python -m repro_torch.tuning_cache serve`` (see the CLI), or embed
:class:`TuningServer` in-process (tests, benchmarks).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.hw import resolve_target
from repro_torch.core.target import use_target
from repro_torch.tuning_cache import registry as registry_mod
from repro_torch.tuning_cache.keys import fingerprint_spec
from repro_torch.tuning_cache.store import TuningDatabase, TuningRecord, now_unix
from repro_torch.tuning_cache.service import protocol
from repro_torch.tuning_cache.service.faults import (CORRUPT, DELAY, DISCONNECT,
                                               DROP, ERROR, KILL,
                                               FaultInjector)

__all__ = ["ServerStats", "SingleFlight", "TuningServer"]

_log = logging.getLogger(__name__)


class _Flight:
    __slots__ = ("event", "record", "error")

    def __init__(self):
        self.event = threading.Event()
        self.record: Optional[TuningRecord] = None
        self.error: Optional[BaseException] = None


class SingleFlight:
    """Per-key request coalescing: N concurrent ``do(key, fn)`` calls
    run ``fn`` exactly once; every caller gets its result.

    If the leader's ``fn`` raises, parked racers do NOT inherit the
    error — they loop and elect a new leader (the failure may have been
    the leader's alone, e.g. an injected fault), so one poisoned
    request can never fan an exception out to the whole fleet.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: Dict[Any, _Flight] = {}

    def do(self, key: Any, fn: Callable[[], TuningRecord]
           ) -> Tuple[TuningRecord, bool]:
        """Returns ``(result, led)``; ``led`` is False for coalesced
        racers that waited on another caller's flight."""
        led = True
        while True:
            with self._lock:
                flight = self._inflight.get(key)
                if flight is None:
                    flight = self._inflight[key] = _Flight()
                    lead = True
                else:
                    lead = False
            if lead:
                try:
                    flight.record = fn()
                except BaseException as e:
                    flight.error = e
                    raise
                finally:
                    with self._lock:
                        self._inflight.pop(key, None)
                    flight.event.set()
                return flight.record, led
            led = False
            flight.event.wait()
            if flight.error is None:
                return flight.record, led
            # leader failed: loop and try to lead a fresh flight


@dataclasses.dataclass
class ServerStats:
    requests: int = 0       # HTTP requests handled
    batches: int = 0        # /v1/lookup POSTs
    resolved: int = 0       # individual lookups answered with params
    errors: int = 0         # per-request error results
    tunes: int = 0          # cold ranks actually run
    coalesced: int = 0      # racers served by another request's tune
    faults: int = 0         # injected faults fired

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class TuningServer:
    """A `TuningDatabase` served over HTTP with request coalescing.

    ``port=0`` binds an ephemeral port (read it back from ``address`` /
    ``url``).  The handler pool is `ThreadingHTTPServer`'s
    thread-per-connection with ``daemon_threads``, so ``close()`` never
    hangs on a stuck client.  Usable as a context manager; ``start()``
    serves from a daemon thread for in-process embedding.
    """

    def __init__(self, db: Optional[TuningDatabase] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 injector: Optional[FaultInjector] = None):
        self.db = db if db is not None else TuningDatabase()
        self.injector = injector if injector is not None else FaultInjector()
        self.stats = ServerStats()
        self.flight = SingleFlight()
        self._stats_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.tuning_server = self        # handler backref
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "TuningServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="tuning-server", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "TuningServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _count(self, field: str, n: int = 1) -> None:
        with self._stats_lock:
            setattr(self.stats, field, getattr(self.stats, field) + n)

    # -- resolution ---------------------------------------------------------
    def resolve_one(self, req: Any) -> Dict[str, Any]:
        """Resolve one lookup request dict into one result dict.

        Never raises: anything wrong with the *request* (unknown
        kernel, unresolvable target, bad signature) becomes an
        ``{"error": ...}`` result — a definitive miss the client
        handles locally without tripping its breaker.
        """
        try:
            if not isinstance(req, dict):
                raise TypeError(f"request must be an object, got {req!r}")
            kernel_id = req["kernel_id"]
            mode = str(req.get("mode", "static"))
            spec = resolve_target(req.get("target"))
            fp = fingerprint_spec(spec)
            want_fp = req.get("fingerprint")
            if want_fp is not None and want_fp != fp:
                # the client tuned for a custom spec this server does
                # not know; params for *our* spec would be wrong for it
                raise ValueError(
                    f"target {spec.name!r} resolves to fingerprint {fp}, "
                    f"client expects {want_fp}")
            sig = registry_mod.normalize_signature(
                kernel_id, dict(req.get("signature") or {}))
            model = registry_mod._model_for(spec)
            # The shared extras-aware key builder: the digest this key
            # yields is both the single-flight coalescing key below and
            # the client's acceptance guard, so variant-set extras MUST
            # ride here exactly as they do in the client's own key —
            # two variants of one logical op never share a leader.
            key = registry_mod.dispatch_key(
                kernel_id, spec=spec, mode=mode,
                model_name=model.fingerprint(), signature=sig)
        except Exception as e:
            self._count("errors")
            return {"error": f"{type(e).__name__}: {e}"}

        rec = self.db.lookup(key)
        if rec is None:
            def cold() -> TuningRecord:
                # double-check under flight leadership: a racer that
                # lost the first lookup may find the leader's record
                r = self.db.lookup(key)
                if r is not None:
                    return r
                fault = self.injector.fire("server.tune")
                if fault is not None:
                    self._count("faults")
                    if fault.kind == KILL:
                        _log.error("injected fault: killing server "
                                   "mid-tune of %s", kernel_id)
                        os._exit(86)
                    if fault.kind == DELAY:
                        time.sleep(fault.delay_s)
                with use_target(spec):
                    problem = registry_mod.get_problem(kernel_id, **sig)
                    params, predicted, n = registry_mod.rank_space(problem,
                                                                   model)
                r = TuningRecord(key=key, params=dict(params),
                                 predicted_s=predicted, space_size=n,
                                 source=mode, created_unix=now_unix())
                self.db.put(r)
                self._count("tunes")
                return r
            try:
                rec, led = self.flight.do(key.digest, cold)
            except Exception as e:
                self._count("errors")
                return {"error": f"{type(e).__name__}: {e}"}
            if not led:
                self._count("coalesced")
        self._count("resolved")
        out = rec.to_dict()
        out.pop("key", None)            # the client holds its own key
        out["digest"] = rec.key.digest
        return out

    def handle_lookup(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        requests = payload.get("requests")
        if not isinstance(requests, list):
            raise ValueError("lookup payload must carry a requests list")
        self._count("batches")
        results = [self.resolve_one(req) for req in requests]
        # generation read AFTER resolution: a bulk mutation that lands
        # mid-batch is reported to the client, never hidden behind a
        # pre-read stamp.
        return {"v": protocol.PROTOCOL_VERSION,
                "generation": self.db.generation,
                "results": results}

    def health(self) -> Dict[str, Any]:
        return {"v": protocol.PROTOCOL_VERSION, "ok": True,
                "generation": self.db.generation,
                "records": len(self.db),
                "kernels": list(registry_mod.registered())}

    def stats_payload(self) -> Dict[str, Any]:
        with self._stats_lock:
            server = self.stats.as_dict()
        with self.db.lock:
            db_stats = self.db.stats.as_dict()
        return {"v": protocol.PROTOCOL_VERSION,
                "generation": self.db.generation,
                "server": server, "db": db_stats}


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-tuning/1"
    # HTTP/1.1: keep-alive, so a serving client pays connection setup
    # once, not per dispatch (every response sets Content-Length).
    protocol_version = "HTTP/1.1"
    # Nagle + delayed ACK on a request/response socket costs ~40 ms per
    # exchange; these are millisecond dispatches.
    disable_nagle_algorithm = True

    @property
    def tuning(self) -> TuningServer:
        return self.server.tuning_server

    def log_message(self, fmt: str, *args: Any) -> None:
        _log.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, body: bytes, truncate: bool = False) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if truncate:                # disconnect-mid-response fault
                self.wfile.write(body[:max(1, len(body) // 2)])
                self.wfile.flush()
                self.close_connection = True
                self.connection.close()
                return
            self.wfile.write(body)
        except OSError:
            # client went away mid-write: their problem, not a handler
            # crash (the chaos suite hammers exactly this)
            self.close_connection = True

    def _send_json(self, code: int, payload: Dict[str, Any],
                   truncate: bool = False) -> None:
        self._send(code, protocol.encode(payload), truncate=truncate)

    def do_GET(self) -> None:
        self.tuning._count("requests")
        if self.path == protocol.HEALTH_PATH:
            self._send_json(200, self.tuning.health())
        elif self.path == protocol.STATS_PATH:
            self._send_json(200, self.tuning.stats_payload())
        else:
            self._send_json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self) -> None:
        srv = self.tuning
        srv._count("requests")
        if self.path != protocol.LOOKUP_PATH:
            self._send_json(404, {"error": f"unknown path {self.path!r}"})
            return
        fault = srv.injector.fire("server.request")
        if fault is not None:
            srv._count("faults")
            if fault.kind == KILL:
                os._exit(86)
            if fault.kind == DROP:
                self.close_connection = True
                self.connection.close()
                return
            if fault.kind == DELAY:
                time.sleep(fault.delay_s)
            elif fault.kind == ERROR:
                self._send_json(500, {"error": "injected server error"})
                return
            elif fault.kind == CORRUPT:
                self._send(200, fault.payload)
                return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            payload = protocol.decode(self.rfile.read(length))
            response = srv.handle_lookup(payload)
        except (ValueError, KeyError, TypeError) as e:
            self._send_json(400, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send_json(200, response,
                        truncate=fault is not None
                        and fault.kind == DISCONNECT)
