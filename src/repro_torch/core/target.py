"""Process-default hardware target (the chip the stack tunes for).

Every layer of the static-tuning stack — occupancy, cost model,
roofline, tuner, dispatch registry, CLI, launch — takes an optional
``spec``; when it is omitted the layer asks this module which chip is
active.  Resolution order:

1. a scoped :func:`use_target` override (context-local: threads and
   async tasks scope independently), then an explicit process-wide
   :func:`set_default_target` pin,
2. the ``REPRO_TUNING_TARGET`` environment variable (any name
   `repro_torch.core.hw.resolve_target` accepts — a TPU table entry like
   ``tpu-v5p`` or a paper Table I GPU like ``kepler_k20``),
3. best-effort auto-detection from ``torch.cuda.get_device_name(0)``
   (memoized; an H100 maps to the H100 spec, no card or another card
   simply doesn't match),
4. the v5e fallback, so behaviour without any configuration is
   identical to the pre-registry stack.

Because tuning-cache keys and the dispatch memo already carry the full
spec fingerprint (`repro_torch.tuning_cache.keys.fingerprint_spec`), switching
the default target re-keys every cached ranking automatically — two
targets can never serve each other's parameters.
"""
from __future__ import annotations

import contextlib
import contextvars
import logging
import os
from typing import Any, Iterator, Optional, Union

from repro_torch.core.hw import ChipSpec, TPU_V5E, resolve_target

__all__ = ["ENV_TARGET", "default_target", "unscoped_default",
           "set_default_target", "use_target", "detect_target",
           "on_default_target_change"]

ENV_TARGET = "REPRO_TUNING_TARGET"

_log = logging.getLogger(__name__)

# Scoped override (use_target).  A ContextVar, not a module global:
# concurrent threads / async tasks each see their own scope, so one
# trace pinning v5p around a cold rank can never leak v5p into another
# thread's v5e analysis (and vice versa).
_scoped: "contextvars.ContextVar[Optional[ChipSpec]]" = \
    contextvars.ContextVar("repro_target_scoped", default=None)
# Process-wide pin (set_default_target) — deliberately global: it must
# be visible to threads spawned before or after the call.
_explicit: Optional[ChipSpec] = None
# Memoized auto-detection result; None = not attempted yet.  Holds
# (spec_or_None,) so a failed detection is remembered as (None,).
_detected: Optional[tuple] = None
# (raw env value, resolved spec) — default_target runs on every warm
# dispatch, so the env string is parsed once, not per call.
_env_cache: Optional[tuple] = None
# Warm dispatch also pays the env *probe* itself on every call, and
# `os.environ.get` re-encodes the key and walks the Mapping machinery
# each time.  On posix, os.environ keeps a plain bytes-keyed dict in
# `_data` that `os.environ[...] = ...` (and monkeypatch.setenv) mutates
# in place — so probing it directly stays live while costing one dict
# get.  Falls back to os.environ.get where the internals differ.
try:
    _env_fast: Optional[tuple] = (os.environ._data, os.fsencode(ENV_TARGET))
except Exception:                                  # non-posix layout
    _env_fast = None
# Callbacks run by set_default_target: layers that specialized state on
# the process default (e.g. the frozen dispatch tables in
# repro_torch.tuning_cache.registry) register here to invalidate it when the
# default changes.  Hooks must be cheap and lock-free.
_change_hooks: list = []


def on_default_target_change(hook) -> Any:
    """Register a callback invoked whenever `set_default_target` runs."""
    if hook not in _change_hooks:
        _change_hooks.append(hook)
    return hook


def detect_target() -> Optional[ChipSpec]:
    """Best-effort chip detection from the local CUDA device.

    Returns the matching spec, or ``None`` when there is no card or its
    name matches no table entry.  The first call may initialize CUDA;
    results — including failures — are memoized for the life of the
    process.
    """
    global _detected
    if _detected is None:
        spec = None
        try:
            import torch
            if torch.cuda.is_available():
                spec = resolve_target(torch.cuda.get_device_name(0))
        except (KeyError, RuntimeError) as e:  # unknown card / no driver
            _log.debug("target auto-detection failed: %s", e)
        _detected = (spec,)
    return _detected[0]


def unscoped_default() -> ChipSpec:
    """The process-default chip, *ignoring* any `use_target` scope:
    explicit pin > environment > autodetect > v5e.

    This is what a ``spec=None`` dispatch resolves to whenever no scoped
    override is active — the frozen dispatch tables
    (`repro_torch.tuning_cache.registry.freeze`) specialize their fast path to
    this value at freeze time.  `set_default_target` notifies the
    registered change hooks; mutating ``REPRO_TUNING_TARGET`` directly
    after a freeze does not, and needs an explicit ``thaw()``.
    """
    spec = _explicit
    if spec is not None:
        return spec
    if _env_fast is not None:
        env: Any = _env_fast[0].get(_env_fast[1])
    else:
        env = os.environ.get(ENV_TARGET)
    if env:
        global _env_cache
        cache = _env_cache
        if cache is None or cache[0] != env:
            cache = _env_cache = (env, resolve_target(os.fsdecode(env)))
        return cache[1]
    detected = detect_target()
    if detected is not None:
        return detected
    return TPU_V5E


def default_target() -> ChipSpec:
    """The chip every ``spec=None`` in the stack resolves to."""
    spec = _scoped.get()
    if spec is not None:
        return spec
    return unscoped_default()


def set_default_target(target: Optional[Union[str, ChipSpec]]) -> ChipSpec:
    """Pin the process-default target (``None`` restores env/auto/v5e
    resolution).  Returns the now-active target."""
    global _explicit
    _explicit = None if target is None else resolve_target(target)
    for hook in list(_change_hooks):
        hook()
    return default_target()


@contextlib.contextmanager
def use_target(target: Union[str, ChipSpec]) -> Iterator[ChipSpec]:
    """Scoped default target; restores the prior default on exit, even
    when the body raises.  Nests (inner targets shadow outer ones) and
    is context-local: concurrent threads/tasks scope independently."""
    spec = resolve_target(target)
    token = _scoped.set(spec)
    try:
        yield spec
    finally:
        _scoped.reset(token)
