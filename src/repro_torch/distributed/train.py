"""Serving-function factory (the training step is not ported yet)."""
from __future__ import annotations

from typing import Callable, Tuple

from repro_torch.distributed.sharding import Sharder

__all__ = ["make_serve_fns"]


def make_serve_fns(model, mesh=None) -> Tuple[Callable, Callable]:
    """(prefill, decode_step) closures with the Sharder bound."""
    shd = Sharder(mesh)

    def prefill(params, batch):
        return model.prefill(params, batch, shd)

    def decode_step(params, cache, token):
        return model.decode_step(params, cache, token, shd)

    return prefill, decode_step
