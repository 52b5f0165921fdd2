"""Tuning-record storage: in-process LRU over an on-disk JSON backend.

Layout of a persistent database rooted at ``root``::

    root/
      <digest>.json     one TuningRecord per file, digest = CacheKey.digest

Records are tiny (a params dict plus a few floats), so one-file-per-key
keeps writes atomic-enough (write temp + rename) and makes corruption
strictly local: a record that fails to parse is quarantined to
``<digest>.json.corrupt`` and treated as a miss — the next
``lookup_or_tune`` simply re-tunes and overwrites it.

JSONL is the interchange format (`export_jsonl` / `import_jsonl`): one
record per line, self-describing (the full key travels with the params),
so a database tuned on one host can be shipped in-repo and warmed
elsewhere — see `repro_torch.tuning_cache.cli`.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import logging
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

try:                          # advisory locking is POSIX-only; the
    import fcntl              # store degrades to lock-free elsewhere
except ImportError:           # pragma: no cover - non-POSIX
    fcntl = None

from repro_torch.tuning_cache.keys import CacheKey

__all__ = ["TuningRecord", "CacheStats", "DiskStore", "TuningDatabase"]

_log = logging.getLogger(__name__)

# Multi-process crash-safety knob: when set (to anything but "0"),
# DiskStore fsyncs each record file before the rename, so a record that
# survives a power loss is guaranteed whole, at ~1 disk flush per tune.
# Tunes are rare by design (the whole point of the cache), so the
# default stays off for dev speed and on only where a shared disk store
# feeds a serving fleet (the tuning service turns it on).
ENV_FSYNC = "REPRO_TUNING_CACHE_FSYNC"


@dataclasses.dataclass
class TuningRecord:
    """One tuning decision: the winning params + provenance."""

    key: CacheKey
    params: Dict[str, Any]
    predicted_s: float = math.inf
    measured_s: Optional[float] = None
    space_size: int = 0
    source: str = "static"      # 'static' | 'hybrid' | 'empirical' | 'import'
    created_unix: float = 0.0
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["key"] = self.key.to_dict()
        # Non-finite floats serialize as null: the default predicted_s
        # is +inf (e.g. fallback-params provenance, or an all-infeasible
        # CUDA space), and bare ``Infinity``/``NaN`` in a JSON/JSONL
        # export is invalid JSON that breaks strict parsers downstream.
        # `from_dict` restores null -> the field's non-finite default.
        if not math.isfinite(self.predicted_s):
            d["predicted_s"] = None
        if self.measured_s is not None and not math.isfinite(self.measured_s):
            d["measured_s"] = None
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TuningRecord":
        return TuningRecord(
            key=CacheKey.from_dict(d["key"]),
            params=dict(d["params"]),
            predicted_s=(math.inf if d.get("predicted_s") is None
                         else float(d["predicted_s"])),
            measured_s=(None if d.get("measured_s") is None
                        else float(d["measured_s"])),
            space_size=int(d.get("space_size", 0)),
            source=str(d.get("source", "import")),
            created_unix=float(d.get("created_unix", 0.0)),
            extras=dict(d.get("extras", {})),
        )


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    tunes: int = 0
    corrupt: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class _FileLock:
    """Blocking advisory ``flock`` on a sidecar file (context manager).

    Advisory on purpose: a reader that ignores it stays correct
    (publishes are ``os.replace``-atomic), and a crashed holder releases
    it for free when the kernel reaps the fd — no stale-lockfile
    recovery dance."""

    def __init__(self, path: str):
        self.path = path
        self._fd: Optional[int] = None

    def __enter__(self) -> "_FileLock":
        try:
            self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except OSError:
            # a lock we cannot take must not block a save (e.g. a
            # read-only sidecar); fall back to lock-free best effort
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
        return self

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None


class DiskStore:
    """One-JSON-file-per-record backend with quarantine-on-corruption."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.corrupt_seen = 0
        self._io_error_logged = False

    def path_for(self, digest: str) -> str:
        return os.path.join(self.root, f"{digest}.json")

    def load(self, digest: str) -> Optional[TuningRecord]:
        path = self.path_for(digest)
        try:
            with open(path, "r", encoding="utf-8") as f:
                return TuningRecord.from_dict(json.load(f))
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            # Corrupted record: quarantine so it never poisons lookups
            # again, and report a miss so the caller re-tunes.
            self.corrupt_seen += 1
            try:
                os.replace(path, path + ".corrupt")
            except OSError:
                pass
            return None
        except OSError as e:
            # I/O-level failure (EACCES, EIO, a directory squatting on
            # the path, ...): the record may be fine, the *store* is
            # sick.  Count it as corruption but do NOT quarantine — a
            # transient error must not destroy a good record — and
            # report a miss so a dispatch degrades instead of crashing.
            self.corrupt_seen += 1
            if not self._io_error_logged:
                self._io_error_logged = True
                _log.warning(
                    "tuning disk store %s unreadable (%s: %s); treating "
                    "as cache misses.  Further I/O errors for this store "
                    "are silent.", self.root, type(e).__name__, e)
            return None

    def save(self, record: TuningRecord) -> None:
        os.makedirs(self.root, exist_ok=True)
        path = self.path_for(record.key.digest)
        # pid-unique temp: two *processes* saving the same digest must
        # not interleave writes into one temp file (each rename then
        # publishes a whole record; last writer wins, both are valid)
        tmp = f"{path}.{os.getpid()}.tmp"
        with self._root_lock():
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    # allow_nan=False: to_dict already mapped non-finite
                    # floats to null; anything that still sneaks through
                    # (e.g. a NaN inside extras) must fail loudly here,
                    # not emit a file no strict JSON parser can read back.
                    json.dump(record.to_dict(), f, sort_keys=True,
                              allow_nan=False)
                    if os.environ.get(ENV_FSYNC, "0") not in ("", "0"):
                        f.flush()
                        os.fsync(f.fileno())
                os.replace(tmp, path)
            finally:
                try:
                    os.unlink(tmp)          # only survives a failed write
                except OSError:
                    pass

    def _root_lock(self):
        """Advisory cross-process writer lock on ``root/.lock``.

        Readers never take it (rename keeps loads atomic); it only
        serializes concurrent *savers* so that multi-process tuning
        against one shared store cannot race inside ``makedirs``/
        cleanup.  Degrades to a no-op where ``fcntl`` is unavailable."""
        if fcntl is None:                   # pragma: no cover - non-POSIX
            import contextlib
            return contextlib.nullcontext()
        return _FileLock(os.path.join(self.root, ".lock"))

    def iter_records(self) -> Iterator[TuningRecord]:
        if not os.path.isdir(self.root):
            return
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".json"):
                continue
            rec = self.load(name[:-len(".json")])
            if rec is not None:
                yield rec


class TuningDatabase:
    """LRU-fronted tuning store; optionally backed by a `DiskStore`.

    `lookup` / `put` / `lookup_or_tune` are the whole API surface the
    tuner layer needs; everything else is import/export plumbing.

    Thread-safe: one reentrant ``lock`` guards every mutating path
    (concurrent trace-time dispatch from model threads would otherwise
    corrupt the `OrderedDict` mid-``move_to_end`` and miscount
    `CacheStats`).  ``lookup_or_tune`` holds the lock across the tune
    callback on purpose: a cold key is tuned exactly once no matter how
    many threads race to it, and every racer returns the one stored
    record.
    """

    def __init__(self, root: Optional[str] = None, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._lru: "collections.OrderedDict[str, TuningRecord]" = \
            collections.OrderedDict()
        self.disk = DiskStore(root) if root else None
        self.stats = CacheStats()
        self.lock = threading.RLock()
        self._disk_corrupt_synced = 0
        # Bulk-mutation counter: bumped by clear() and import_jsonl()
        # (incl. warm_jsonl).  The dispatch memo snapshots it so that
        # clearing or re-warming the live default database invalidates
        # memoized answers instead of being silently shadowed.
        self.generation = 0
        # Callbacks fired on every generation bump, under the database
        # lock (so a bump and its notification are atomic with respect
        # to readers of `generation`).  Hooks must therefore be cheap
        # and lock-free — the frozen dispatch tier registers its thaw
        # (a bare assignment) here.
        self._invalidation_hooks: list = []
        # Target names whose shipped pretuned JSONL has been folded in
        # (`repro_torch.tuning_cache.warm_pretuned`); per-instance so a fresh
        # default database re-warms.  Deliberately NOT reset by clear():
        # clearing a database must leave it empty, not silently
        # re-warmed on the next lookup.
        self.warmed_targets: set = set()

    # -- core ---------------------------------------------------------------
    def lookup(self, key: CacheKey) -> Optional[TuningRecord]:
        digest = key.digest
        with self.lock:
            rec = self._lru.get(digest)
            if rec is not None:
                self._lru.move_to_end(digest)
                self.stats.hits += 1
                return rec
            if self.disk is not None:
                rec = self.disk.load(digest)
                # fold in only the delta so corrupt JSONL lines counted
                # by import_jsonl are not clobbered
                self.stats.corrupt += (self.disk.corrupt_seen
                                       - self._disk_corrupt_synced)
                self._disk_corrupt_synced = self.disk.corrupt_seen
                if rec is not None:
                    self._remember(digest, rec)
                    self.stats.hits += 1
                    return rec
            self.stats.misses += 1
            return None

    def put(self, record: TuningRecord) -> None:
        with self.lock:
            self._remember(record.key.digest, record)
            if self.disk is not None:
                self.disk.save(record)
            self.stats.puts += 1

    def lookup_or_tune(self, key: CacheKey,
                       tune: Callable[[], TuningRecord]) -> TuningRecord:
        with self.lock:
            rec = self.lookup(key)
            if rec is not None:
                return rec
            rec = tune()
            self.stats.tunes += 1
            self.put(rec)
            return rec

    def _remember(self, digest: str, rec: TuningRecord) -> None:
        self._lru[digest] = rec
        self._lru.move_to_end(digest)
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)

    def __len__(self) -> int:
        return len(self._lru)

    def on_invalidate(self, hook: Callable[[], None]) -> Callable[[], None]:
        """Register a callback fired (under the lock) whenever a bulk
        mutation bumps ``generation``; duplicates are ignored."""
        with self.lock:
            if hook not in self._invalidation_hooks:
                self._invalidation_hooks.append(hook)
        return hook

    def _bump_generation(self) -> None:
        # callers hold self.lock
        self.generation += 1
        for hook in list(self._invalidation_hooks):
            hook()

    def clear(self) -> None:
        with self.lock:
            self._lru.clear()
            self.stats = CacheStats()
            self._bump_generation()

    def invalidate(self) -> None:
        """Declare the cached view of this database stale: bump
        ``generation`` and fire the invalidation hooks, keeping the
        resident records.  This is the entry point for *external* bulk
        mutation — an operator rewrote the shared disk store, or a
        service client saw the server's generation move — where the
        records are still fine but every derived structure (frozen
        tables, dispatch memos) must re-resolve."""
        with self.lock:
            self._bump_generation()

    # -- interchange --------------------------------------------------------
    def records(self) -> Iterator[TuningRecord]:
        """Everything resident: memory first, then disk-only records."""
        seen = set()
        for digest, rec in list(self._lru.items()):
            seen.add(digest)
            yield rec
        if self.disk is not None:
            for rec in self.disk.iter_records():
                if rec.key.digest not in seen:
                    yield rec

    def snapshot(self) -> List[TuningRecord]:
        """`records()` materialized under the lock — a consistent view
        even while other threads keep dispatching."""
        with self.lock:
            return list(self.records())

    def export_jsonl(self, path: str) -> int:
        recs = self.snapshot()
        n = 0
        # Crash-atomic: a previously good export must survive a crash
        # (or an unserializable record) mid-write, so build the file
        # aside and publish it with one rename.
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in recs:
                    f.write(json.dumps(rec.to_dict(), sort_keys=True,
                                       allow_nan=False) + "\n")
                    n += 1
            os.replace(tmp, path)
        finally:
            try:
                os.unlink(tmp)              # only survives a failed write
            except OSError:
                pass
        return n

    def import_jsonl(self, path: str, source: Optional[str] = None) -> int:
        """Load records from a JSONL file; bad lines are skipped."""
        n = 0
        with self.lock:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = TuningRecord.from_dict(json.loads(line))
                    except (json.JSONDecodeError, KeyError, TypeError,
                            ValueError):
                        self.stats.corrupt += 1
                        continue
                    if source is not None:
                        rec.source = source
                    self.put(rec)
                    n += 1
            if n:
                self._bump_generation()
        return n

    def warm_jsonl(self, path: str) -> int:
        """import_jsonl into memory only (no disk write-back)."""
        with self.lock:       # the disk handle swap must not interleave
            disk, self.disk = self.disk, None
            try:
                return self.import_jsonl(path)
            finally:
                self.disk = disk


def now_unix() -> float:
    return time.time()
