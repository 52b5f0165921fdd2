"""Activation/cache layout hooks, single-device.

The reference's `Sharder` pins logical-axis shardings on a device mesh.
The port serves on one card, so it keeps the interface — every layer
still names the logical layout of what it produces — and passes each
tensor through unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["Sharder"]


class Sharder:
    """Single-device pass-through with the reference's call sites."""

    def __init__(self, mesh=None, **_rules):
        if mesh is not None:
            raise NotImplementedError(
                "repro_torch serves on one device; meshes are not ported")
        self.mesh = None

    def act(self, x, dims: Sequence[Optional[str]]):
        return x

    def cache(self, x, dims: Sequence[Optional[str]]):
        return x
