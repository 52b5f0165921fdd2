"""repro_torch.tuning_cache — the tuning database + dispatch registry.

The paper's thesis (near-optimal launch parameters from static analysis,
zero program runs) implies tuning results are pure functions of
``(kernel, shapes/dtype, hardware, tuner mode, model version)`` — so we
compute them once and reuse them everywhere:

* `keys`      content-addressed cache keys + the MODEL_VERSION stamp
* `store`     TuningRecord, in-process LRU, on-disk JSON, JSONL interchange
* `registry`  dispatch: kernels resolve launch params via
              `lookup_or_tune` instead of hard-coded defaults

The process-wide default database is memory-only unless the
``REPRO_TUNING_CACHE_DIR`` environment variable points at a directory.
Unlike the reference, the port ships no pretuned databases yet: every
instance is ranked on first dispatch (or by a graph pretune before
serving), and ``--tuning-db`` warms a deployment's own JSONL.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.tuning_cache.keys import (CacheKey, MODEL_VERSION,
                                           canonical_json, fingerprint_spec,
                                           make_key)
from repro_torch.tuning_cache.store import (CacheStats, DiskStore,
                                            TuningDatabase, TuningRecord)
from repro_torch.tuning_cache import registry
from repro_torch.tuning_cache.registry import (ENV_MODEL, MODEL_KINDS,
                                               TuningProblem,
                                               clear_dispatch_memo,
                                               default_model_kind,
                                               dispatch_key, freeze,
                                               frozen_lookup, get_problem,
                                               is_frozen, lookup_or_tune,
                                               normalize_signature,
                                               on_dispatch_memo_clear,
                                               rank_space, register_entry,
                                               registered, set_default_model,
                                               thaw)

__all__ = [
    "CacheKey", "MODEL_VERSION", "canonical_json", "fingerprint_spec",
    "make_key", "CacheStats", "DiskStore", "TuningDatabase", "TuningRecord",
    "TuningProblem", "clear_dispatch_memo", "get_problem", "lookup_or_tune",
    "normalize_signature", "on_dispatch_memo_clear", "rank_space",
    "register_entry", "registered", "dispatch_key",
    "ENV_MODEL", "MODEL_KINDS", "default_model_kind", "set_default_model",
    "freeze", "thaw", "is_frozen", "frozen_lookup",
    "get_default_db", "set_default_db", "reset_default_db",
]

ENV_DB_DIR = "REPRO_TUNING_CACHE_DIR"

_default_db: Optional[TuningDatabase] = None


def get_default_db() -> TuningDatabase:
    """Process-wide database: LRU + optional env-configured disk root."""
    global _default_db
    if _default_db is None:
        _default_db = TuningDatabase(root=os.environ.get(ENV_DB_DIR))
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
