"""Fault-tolerant training supervisor, the reference's policy.

* periodic checkpointing (async, atomic) with exactly-once sample
  accounting (the data pipeline's only state is the step integer);
* crash/exception recovery: reload the last committed checkpoint and
  resume at its step, at most ``max_restarts`` times;
* straggler watermark: each step's time is tracked with an EWMA; a step
  slower than ``straggler_factor`` x EWMA raises `StragglerDetected`
  (or calls ``on_straggler``);
* a fault-injection hook for tests (``inject_fault(step)``).

A step's clock stops once the card has finished it
(``torch.cuda.synchronize`` on the loss's device), where the reference
calls ``jax.block_until_ready``.  A restored checkpoint lands on the
device of the state's parameters.

The when-to-fire arithmetic is shared with the tuning service's chaos
layer: `FaultSchedule` lives in `repro_torch.tuning_cache.service.
faults` (re-exported here) and `scheduled_fault` adapts it into an
``inject_fault`` callback.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models.params import Param, tree_leaves
from repro_torch.tuning_cache.service.faults import FaultSchedule

__all__ = ["FaultPolicy", "FaultSchedule", "StragglerDetected",
           "TrainSupervisor", "scheduled_fault"]


def scheduled_fault(schedule: FaultSchedule,
                    exc: Callable[[int], BaseException] = None
                    ) -> Callable[[int], None]:
    """Adapt a `FaultSchedule` into a `TrainSupervisor.inject_fault`
    callback: raises on the scheduled hits of the per-run step counter
    (``schedule.after`` counts *calls*, 1-based, not step numbers —
    restarts re-visit steps but keep advancing the hit counter).
    ``exc(step)`` builds the exception (default ``RuntimeError``)."""
    state = {"hit": 0, "fired": 0}

    def inject(step: int) -> None:
        state["hit"] += 1
        if schedule.fires_at(state["hit"], state["fired"]):
            state["fired"] += 1
            raise (exc(step) if exc is not None
                   else RuntimeError(f"injected fault at step {step}"))

    return inject


class StragglerDetected(RuntimeError):
    pass


@dataclasses.dataclass
class FaultPolicy:
    checkpoint_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 5.0
    straggler_warmup_steps: int = 5
    ewma_alpha: float = 0.1


def _device_of(state: Dict[str, Any]) -> torch.device:
    for _, leaf in tree_leaves(state.get("params", {})):
        return (leaf.value if isinstance(leaf, Param) else leaf).device
    return torch.device("cpu")


def _mesh_of(state: Dict[str, Any]):
    from torch.distributed.tensor import DTensor
    for _, leaf in tree_leaves(state.get("params", {})):
        v = leaf.value if isinstance(leaf, Param) else leaf
        return v.device_mesh if isinstance(v, DTensor) else None
    return None


def _wait_for(x) -> None:
    """Block until the card has computed ``x``."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


@dataclasses.dataclass
class TrainSupervisor:
    """Drives ``train_step`` with checkpoint/restart semantics."""

    manager: CheckpointManager
    policy: FaultPolicy = dataclasses.field(default_factory=FaultPolicy)
    inject_fault: Optional[Callable[[int], None]] = None
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def _restore(self, state, step: int) -> Dict[str, Any]:
        """The checkpoint where the state lives: on its device, or on
        the mesh its DTensor parameters are laid out on."""
        mesh = _mesh_of(state)
        if mesh is not None:
            return {**state, **self.manager.restore(step, mesh=mesh)}
        return {**state, **self.manager.restore(step,
                                                device=_device_of(state))}

    def run(self, train_step: Callable, state: Dict[str, Any],
            make_batch: Callable[[int], Dict], num_steps: int,
            log_every: int = 0) -> Dict[str, Any]:
        """state: {"params", "opt", "step"}; returns the final state.

        Restores from the latest checkpoint if one exists (warm start),
        then runs to ``num_steps`` total, surviving up to
        ``max_restarts`` faults."""
        restarts = 0
        ewma = None
        latest = self.manager.latest_step()
        if latest is not None:
            state = self._restore(state, latest)
        step = int(state.get("step", 0))

        while step < num_steps:
            try:
                batch = make_batch(step)
                t0 = time.perf_counter()
                if self.inject_fault is not None:
                    self.inject_fault(step)
                state["params"], state["opt"], metrics = train_step(
                    state["params"], state["opt"], batch)
                _wait_for(metrics["loss"])
                dt = time.perf_counter() - t0
                # straggler watermark
                if ewma is not None and \
                        step > self.policy.straggler_warmup_steps and \
                        dt > self.policy.straggler_factor * ewma:
                    if self.on_straggler is not None:
                        self.on_straggler(step, dt, ewma)
                    else:
                        raise StragglerDetected(
                            f"step {step}: {dt:.3f}s vs ewma {ewma:.3f}s")
                ewma = dt if ewma is None else (
                    self.policy.ewma_alpha * dt
                    + (1 - self.policy.ewma_alpha) * ewma)
                step += 1
                state["step"] = step
                if log_every and step % log_every == 0:
                    print(f"[supervisor] step={step} "
                          f"loss={float(metrics['loss']):.4f} "
                          f"dt={dt*1e3:.1f}ms")
                if step % self.policy.checkpoint_every == 0:
                    self.manager.save(step, {
                        "params": state["params"], "opt": state["opt"],
                        "step": step})
            except StragglerDetected:
                raise
            except Exception as e:  # crash-restart path
                restarts += 1
                if restarts > self.policy.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.policy.max_restarts}"
                    ) from e
                # a save that has returned counts: the writer finishes
                # it before the latest checkpoint is looked up
                self.manager.wait()
                latest = self.manager.latest_step()
                if latest is None:
                    raise RuntimeError("fault before first checkpoint") \
                        from e
                state = self._restore(state, latest)
                step = int(state["step"])
                print(f"[supervisor] restart #{restarts} from step {step} "
                      f"after {type(e).__name__}: {e}")
        self.manager.wait()
        return state
