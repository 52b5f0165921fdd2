"""Cache keys for the tuning database (DESIGN.md §6).

A tuning result is a pure function of

    (kernel_id, shape/dtype signature, hardware fingerprint,
     tuner mode, model version)

so the cache key is exactly that tuple, content-addressed: the digest is
a SHA-256 over the canonical-JSON rendering of the tuple, which makes it
stable across processes, hosts, and dict orderings — a database exported
on one machine resolves on another as long as the five components agree.

``MODEL_VERSION`` names the analyzer+cost-model generation; bump it
whenever `repro_torch.core.mix`/`predict`/`occupancy` change in a way that can
alter a ranking, and every stale record silently becomes a miss.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional

from repro_torch.core.hw import ChipSpec

__all__ = ["MODEL_VERSION", "CacheKey", "canonical_json",
           "fingerprint_spec", "make_key"]

# Generation of the static analyzer + cost model.  Part of every key:
# bumping it invalidates all previously stored rankings at once.
MODEL_VERSION = "1"


def canonical_json(obj: Any) -> str:
    """Deterministic JSON: sorted keys, no whitespace, str() fallback."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def fingerprint_spec(spec: ChipSpec) -> str:
    """`<name>@<12-hex>` over every field of the hardware descriptor.

    Works for either spec family (`TpuSpec` or `GpuSpec` — anything
    satisfying the `ChipSpec` protocol): the digest covers the frozen
    dataclass fields, so a CUDA target and a TPU target can never
    collide on one cache entry even if someone names them alike.

    Memoized on the instance (this runs on every trace-time dispatch,
    and even hashing a frozen 20-field dataclass for an lru_cache probe
    costs ~0.5 us): the fingerprint is pure content, so caching it on
    the immutable spec is sound, and equal specs still produce equal
    fingerprints because the digest covers the fields, not the id.
    """
    fp = spec.__dict__.get("_fp")
    if fp is None:
        payload = canonical_json(dataclasses.asdict(spec))
        fp = f"{spec.name}@{hashlib.sha256(payload.encode()).hexdigest()[:12]}"
        object.__setattr__(spec, "_fp", fp)     # frozen dataclass
    return fp


@dataclasses.dataclass(frozen=True)
class CacheKey:
    kernel_id: str
    signature: str          # canonical JSON of shapes/dtype/tuner knobs
    spec_fingerprint: str   # fingerprint_spec(...) of the target chip
    mode: str = "static"    # 'static' | 'hybrid' | 'empirical' | 'graph'
    model_version: str = MODEL_VERSION

    @property
    def digest(self) -> str:
        payload = canonical_json(dataclasses.asdict(self))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, str]) -> "CacheKey":
        return CacheKey(kernel_id=d["kernel_id"], signature=d["signature"],
                        spec_fingerprint=d["spec_fingerprint"],
                        mode=d.get("mode", "static"),
                        model_version=d.get("model_version", MODEL_VERSION))


def make_key(kernel_id: str, *, spec: ChipSpec, mode: str = "static",
             model_name: Optional[str] = None,
             **signature: Any) -> CacheKey:
    """Build a key from keyword signature parts (shapes, dtype, knobs)."""
    sig: Dict[str, Any] = dict(signature)
    if model_name is not None:
        sig["model"] = model_name
    return CacheKey(kernel_id=kernel_id,
                    signature=canonical_json(sig),
                    spec_fingerprint=fingerprint_spec(spec),
                    mode=mode)
