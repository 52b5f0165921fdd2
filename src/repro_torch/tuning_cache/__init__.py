"""repro_torch.tuning_cache — the tuning database + dispatch registry.

The paper's thesis (near-optimal launch parameters from static analysis,
zero program runs) implies tuning results are pure functions of
``(kernel, shapes/dtype, hardware, tuner mode, model version)`` — so we
compute them once and reuse them everywhere:

* `keys`      content-addressed cache keys + the MODEL_VERSION stamp
* `store`     TuningRecord, in-process LRU, on-disk JSON, JSONL interchange
* `registry`  dispatch: kernels resolve launch params via
              `lookup_or_tune` instead of hard-coded defaults
* `cli`       ``python -m repro_torch.tuning_cache
              export|import|show|tune|pretune|serve``
* `service`   the tuning server and its resilient client

The process-wide default database is memory-only unless the
``REPRO_TUNING_CACHE_DIR`` environment variable points at a directory;
it is warmed at first use from the pretuned JSONL shipped for the
active hardware target under ``tuning_cache/pretuned/`` (one
``<target>.jsonl`` per chip: the reference's six, byte for byte, and
``h100_sxm.jsonl`` for the card the port launches on), so common shapes
dispatch warm out of the box.  Dispatching under another target
(`repro_torch.core.target.use_target` or ``REPRO_TUNING_TARGET``)
lazily warms that target's file on first use.  ``--tuning-db`` warms a
deployment's own JSONL on top, and ``REPRO_TUNING_SERVICE`` (or
`configure_service`) points cold dispatches at a tuning server.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from repro_torch.tuning_cache.keys import (CacheKey, MODEL_VERSION,
                                           canonical_json, fingerprint_spec,
                                           make_key)
from repro_torch.tuning_cache.service.client import (ClientPolicy,
                                                     ServiceClient)
from repro_torch.tuning_cache.store import (CacheStats, DiskStore,
                                            TuningDatabase, TuningRecord)
from repro_torch.tuning_cache import registry
from repro_torch.tuning_cache.registry import (ENV_MODEL, MODEL_KINDS,
                                               TuningProblem,
                                               clear_dispatch_memo,
                                               default_model_kind,
                                               dispatch_key, freeze,
                                               frozen_lookup, frozen_table,
                                               get_problem,
                                               invalidate_kernel, is_frozen,
                                               lookup_or_tune,
                                               normalize_signature,
                                               on_dispatch_memo_clear,
                                               rank_space, register,
                                               register_entry, registered,
                                               set_default_model, thaw,
                                               unregister)

__all__ = [
    "CacheKey", "MODEL_VERSION", "canonical_json", "fingerprint_spec",
    "make_key", "CacheStats", "DiskStore", "TuningDatabase", "TuningRecord",
    "TuningProblem", "clear_dispatch_memo", "get_problem", "lookup_or_tune",
    "normalize_signature", "on_dispatch_memo_clear", "rank_space",
    "register", "register_entry", "registered", "unregister",
    "invalidate_kernel", "dispatch_key",
    "ENV_MODEL", "MODEL_KINDS", "default_model_kind", "set_default_model",
    "freeze", "thaw", "is_frozen", "frozen_lookup", "frozen_table",
    "get_default_db", "set_default_db", "reset_default_db", "pretuned_dir",
    "pretuned_path", "warm_pretuned",
    "configure_service", "service_client",
]

ENV_DB_DIR = "REPRO_TUNING_CACHE_DIR"
# URL of a tuning service (e.g. http://127.0.0.1:8137); when set, the
# default dispatch path consults it between the live memo and the local
# database tiers.  See DESIGN.md §13.
ENV_SERVICE = "REPRO_TUNING_SERVICE"

_default_db: Optional[TuningDatabase] = None

_log = logging.getLogger(__name__)

_service: Optional[ServiceClient] = None
_service_env_checked = False
_service_lock = threading.Lock()


def _on_service_generation() -> None:
    # The shared database moved under us (operator import, re-warm):
    # our frozen tables and live memos may hold its previous answers.
    # One local generation bump routes the thaw through the existing
    # on_invalidate machinery — the frozen tier drops and memo entries
    # self-invalidate against the new generation.
    db = _default_db
    if db is not None:
        db.invalidate()


def configure_service(url: Optional[str] = None, *,
                      client: Optional[ServiceClient] = None,
                      policy: Optional[ClientPolicy] = None
                      ) -> Optional[ServiceClient]:
    """Set (or, with no arguments, clear) the process tuning-service
    client used by the default dispatch path.  Explicit configuration
    overrides the ``REPRO_TUNING_SERVICE`` environment variable."""
    global _service, _service_env_checked
    if client is None and url:
        client = ServiceClient(url, policy=policy)
    with _service_lock:
        old, _service = _service, client
        _service_env_checked = True
        if client is not None:
            client.on_generation_change(_on_service_generation)
    if old is not None and old is not client:
        old.close()
    return client


def service_client() -> Optional[ServiceClient]:
    """The configured tuning-service client, building one lazily from
    ``REPRO_TUNING_SERVICE`` on first ask; ``None`` when no service is
    configured (the normal, local-only mode)."""
    global _service, _service_env_checked
    if _service is not None or _service_env_checked:
        return _service
    with _service_lock:
        if _service is None and not _service_env_checked:
            _service_env_checked = True
            url = os.environ.get(ENV_SERVICE, "").strip()
            if url:
                try:
                    _service = ServiceClient(url)
                    _service.on_generation_change(_on_service_generation)
                except ValueError as e:
                    _log.warning("ignoring %s=%r: %s", ENV_SERVICE, url, e)
        return _service


def pretuned_dir() -> str:
    """Directory of pre-tuned JSONL databases shipped with the package."""
    return os.path.join(os.path.dirname(__file__), "pretuned")


def pretuned_path(target=None) -> str:
    """Shipped JSONL for one hardware target: ``pretuned/<name>.jsonl``
    (canonical name, '-' -> '_'; e.g. tpu-v5p -> tpu_v5p.jsonl)."""
    from repro_torch.core.hw import resolve_target
    name = resolve_target(target).name.replace("-", "_")
    return os.path.join(pretuned_dir(), f"{name}.jsonl")


def warm_pretuned(db: TuningDatabase, target=None) -> int:
    """Fold the target's shipped pretuned records into ``db`` (memory
    only), once per (database, target) — repeat calls are a set probe.
    Missing file (a target we ship no database for) warms nothing."""
    from repro_torch.core.hw import resolve_target
    spec = resolve_target(target)
    return _warm_pretuned_spec(db, spec)


def _warm_pretuned_spec(db: TuningDatabase, spec) -> int:
    # check-then-add under the database lock: two threads taking their
    # first dispatch for the same target must not double-import (and
    # double-bump the generation, spuriously invalidating the memo)
    with db.lock:
        if spec.name in db.warmed_targets:
            return 0
        db.warmed_targets.add(spec.name)
        path = pretuned_path(spec)
        if os.path.isfile(path):
            return db.warm_jsonl(path)
        return 0


def get_default_db() -> TuningDatabase:
    """Process-wide database: LRU + optional env-configured disk root,
    warmed from the pre-tuned JSONL shipped for the default target
    (other targets warm lazily at first dispatch)."""
    global _default_db
    if _default_db is None:
        _default_db = TuningDatabase(root=os.environ.get(ENV_DB_DIR))
        warm_pretuned(_default_db)
    return _default_db




def set_default_db(db: Optional[TuningDatabase]) -> None:
    global _default_db
    _default_db = db
    # the dispatch memo shadows the default database; a new default
    # must not serve another database's answers
    clear_dispatch_memo()


def reset_default_db() -> None:
    """Drop the process default (tests; env-var changes)."""
    set_default_db(None)
