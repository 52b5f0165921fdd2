"""Wire format of the tuning service (stdlib-only, shared by both ends).

Everything is JSON over HTTP.  One POST endpoint does the work; two GET
endpoints observe it:

``POST /v1/lookup``
    ``{"v": 1, "requests": [{"kernel_id", "signature": {...},
    "target": "<name>", "fingerprint": "<name>@<12hex>",
    "mode": "static"}, ...]}`` — a *batch* of lookups resolved in one
    round trip.  Response: ``{"v": 1, "generation": <int>,
    "results": [<result>, ...]}`` with one result per request, in
    order: either a record payload (``params`` + provenance + the
    server-side ``digest``) or ``{"error": "<why>"}`` for a request the
    server cannot serve (unknown kernel, unresolvable target, custom
    spec whose fingerprint does not match) — a *definitive* miss the
    client degrades locally, distinct from a transport failure.

``GET /v1/health``   liveness + ``generation`` + resident record count.
``GET /v1/stats``    server counters + database `CacheStats`.

Every response is stamped with the server database's ``generation`` so
clients detect bulk mutation of the shared store and invalidate their
frozen tables / live memos (DESIGN.md §13).

`check_lookup_response` is the client's armor against the
corrupt-payload fault class: any shape violation raises ``ValueError``,
which the client treats exactly like a transport failure (retry, then
degrade) — a half-written response can never leak garbage params into a
dispatch.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["PROTOCOL_VERSION", "LOOKUP_PATH", "HEALTH_PATH", "STATS_PATH",
           "encode", "decode", "lookup_request", "check_lookup_response"]

PROTOCOL_VERSION = 1

LOOKUP_PATH = "/v1/lookup"
HEALTH_PATH = "/v1/health"
STATS_PATH = "/v1/stats"


def encode(payload: Dict[str, Any]) -> bytes:
    """Strict JSON bytes (``allow_nan=False``: a NaN must fail loudly
    at the sender, not emit a body no strict parser reads back)."""
    return json.dumps(payload, sort_keys=True, allow_nan=False,
                      separators=(",", ":")).encode("utf-8")


def decode(data: bytes) -> Dict[str, Any]:
    """Parse a JSON object; anything else (including a non-object
    top level) raises ``ValueError``."""
    payload = json.loads(data.decode("utf-8"))
    if not isinstance(payload, dict):
        raise ValueError(f"payload must be a JSON object, "
                         f"got {type(payload).__name__}")
    return payload


def lookup_request(requests: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    return {"v": PROTOCOL_VERSION, "requests": list(requests)}


def check_lookup_response(payload: Dict[str, Any], n: int
                          ) -> Tuple[int, List[Optional[Dict[str, Any]]]]:
    """Validate a ``/v1/lookup`` response against the batch size.

    Returns ``(generation, results)`` where each result is a record
    payload dict (guaranteed to carry a non-empty ``params`` dict with
    string keys) or ``None`` (the server reported a per-request error).
    Raises ``ValueError`` on any structural corruption.
    """
    gen = payload.get("generation")
    if not isinstance(gen, int) or isinstance(gen, bool):
        raise ValueError(f"generation must be an int, got {gen!r}")
    results = payload.get("results")
    if not isinstance(results, list) or len(results) != n:
        raise ValueError(f"expected {n} results, got "
                         f"{len(results) if isinstance(results, list) else results!r}")
    out: List[Optional[Dict[str, Any]]] = []
    for res in results:
        if not isinstance(res, dict):
            raise ValueError(f"result must be an object, got {res!r}")
        if "error" in res:
            out.append(None)
            continue
        params = res.get("params")
        if (not isinstance(params, dict) or not params
                or not all(isinstance(k, str) for k in params)):
            raise ValueError(f"result params must be a non-empty "
                             f"str-keyed object, got {params!r}")
        out.append(res)
    return gen, out
