"""Autotuner pieces the serving path needs (paper §III-C / §IV-C).

* :class:`KernelStaticInfo` — what the static analyzer derives for one
  launch configuration: its instruction mix plus the occupancy view
  that decides feasibility and the pipeline floor.
* :meth:`GraphTuner.tune_config` — graph-level pretune of one serving
  config: enumerate every ``(kernel_id, signature)`` instance prefill
  and one decode step dispatch, then rank each through
  `repro_torch.tuning_cache.lookup_or_tune` — zero kernel executions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

from repro_torch.core.mix import InstructionMix
from repro_torch.core.occupancy import TpuOccupancy
from repro_torch.core.predict import CostModel

__all__ = ["KernelStaticInfo", "GraphTuner"]


@dataclasses.dataclass
class KernelStaticInfo:
    """Everything the static analyzer derives for one configuration."""

    mix: InstructionMix
    occupancy: Optional[TpuOccupancy] = None

    def feasible(self) -> bool:
        return self.occupancy is None or self.occupancy.fits_vmem

    def static_time(self, model: CostModel) -> float:
        """Predicted seconds; infeasible configs get +inf."""
        if not self.feasible():
            return math.inf
        t_model = model.time(self.mix)
        if self.occupancy is not None:
            t_pipe = (self.occupancy.predicted_step_time
                      * max(self.occupancy.grid_steps, 1))
            return max(t_model, t_pipe)
        return t_model


class GraphTuner:
    """Graph-level static tuning of a serving config (DESIGN.md §15)."""

    @classmethod
    def tune_config(cls, cfg, *, batch: int = 2, prompt_len: int = 64,
                    decode: bool = True, spec=None, db=None,
                    mode: str = "static",
                    tune: bool = True) -> Dict[str, Any]:
        """Enumerate and rank every kernel instance of one serving config.

        The enumeration builds parameters and the token batch on the
        ``meta`` device and runs prefill (and, with ``decode=True``, one
        decode step) under tuned layers with dispatch collection on:
        every op records its signature and returns an empty ``meta``
        tensor of its output shape, so no kernel runs and no memory is
        allocated.  Each distinct instance then resolves through
        `repro_torch.tuning_cache.lookup_or_tune`.  Returns::

            {"config": name, "batch": B, "prompt_len": S,
             "instances": [{"kernel": id, "signature": {...},
                            "params": {...} | None}, ...],
             "dispatches": total_collected, "tuned": n_resolved}
        """
        import torch

        from repro_torch.distributed import make_serve_fns
        from repro_torch.kernels import api
        from repro_torch.models import build_model
        from repro_torch.models.layers import use_tuned_layers

        model = build_model(cfg)
        params = model.init(seed=0, device="meta")
        prefill, decode_step = make_serve_fns(model)
        tokens = torch.zeros((batch, prompt_len), dtype=torch.long,
                             device="meta")
        with use_tuned_layers(), api.collect_dispatches() as col:
            _, cache = prefill(params, {"tokens": tokens})
            if decode:
                tok = torch.zeros((batch, 1), dtype=torch.long,
                                  device="meta")
                decode_step(params, cache, tok)
        # dedup preserving first-seen order (layers repeat instances)
        seen: Dict[Any, Dict[str, Any]] = {}
        for kid, sig in col:
            k = (kid, tuple(sorted(sig.items())))
            if k not in seen:
                seen[k] = {"kernel": kid, "signature": sig,
                           "params": None}
        report = {"config": cfg.name, "batch": batch,
                  "prompt_len": prompt_len,
                  "instances": list(seen.values()),
                  "dispatches": len(col), "tuned": 0}
        if tune:
            from repro_torch.tuning_cache import lookup_or_tune
            for inst in report["instances"]:
                kw = {} if db is None else {"db": db}
                inst["params"] = lookup_or_tune(
                    inst["kernel"], spec=spec, mode=mode, **kw,
                    **inst["signature"])
                report["tuned"] += 1
        return report
