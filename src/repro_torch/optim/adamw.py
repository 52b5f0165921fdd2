"""AdamW with a global-norm clip, the reference's from scratch.

State is a Param-shaped tree of f32 moments plus an int32 ``count``;
parameters are the f32 masters (the model casts to its compute type at
each use).  The norm and the clip run in f32, and leaves go in the
reference's flatten order (dict keys sorted), so the norm's sum runs in
the same order.  `adamw_update` updates parameters and moments in place
under ``torch.no_grad()`` — the counterpart of the reference donating
both to its jitted step — and returns them with the metrics.  Every
scalar stays a tensor on the state's device: a step never waits for
the card.  On a mesh parameters, gradients and moments are DTensors of
one layout per leaf, updated in place shard by shard; the norm is
reduced over the whole mesh.

Two routes, by where the leaves lie (a DTensor's: its local shard).
On the CPU, the plain version: `global_norm_plain` and
`adamw_update_plain`, eager ops, about ten passes a leaf.  Anywhere
else, the reference's compiled step as XLA runs it — one pass a leaf —
by two hand-written kernels (``kernels/csrc/optim.cu``): `sumsq`, a
leaf's f32 sum of squares in one read, and `adamw_leaf`, which reads p,
g, m and v once and writes p, m and v in place, with the clip, the
learning rate and the bias corrections read from device memory.  Both
are ``torch.library`` custom ops: on a CUDA tensor they launch their
kernel (`LAUNCHES` counts each launch), on ``meta`` (a dry-run's trace)
their fake implementations allocate nothing but the norm's scalar.
There is no fallback: a kernel that does not build or launch raises.

The plain route scales an f32 gradient by the clip in place; the
kernel route leaves every gradient as it was.  Nothing reads a
gradient after the update (`distributed.train.make_train_step` drops
them; its int8 compression runs before).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import settle
from repro_torch.models.params import Param, map_params, tree_leaves

__all__ = ["AdamWConfig", "init_adamw", "adamw_update", "global_norm",
           "adamw_update_plain", "global_norm_plain", "update_with_norm",
           "leaf_update_plain", "sumsq", "adamw_leaf", "on_card",
           "LAUNCHES"]

# Launches of the optimizer's kernels, one a call: `sumsq` (a leaf's
# norm) and `adamw_leaf` (a leaf's update).  They have no Pallas
# counterpart and no launch space, so the tuning registry's counters
# (`kernels.launch_counts`) do not hold them.
LAUNCHES = {"sumsq": 0, "adamw": 0}

# Floats of `sumsq`'s partials: csrc/optim.cu's most blocks, which
# `repro_sumsq` checks
_SUMSQ_PARTIALS = 1024


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * peak (f32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * warm * frac


def _values(tree):
    return [leaf.value if isinstance(leaf, Param) else leaf
            for _, leaf in tree_leaves(tree)]


def _local(x):
    """A DTensor's local shard (a view: writes land in the DTensor);
    anything else as is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def on_card(tree) -> bool:
    """Whether ``tree``'s leaves take the kernels: unless they (a
    DTensor's local shards) lie on the CPU."""
    return _local(_values(tree)[0]).device.type != "cpu"


def _require(kernel: str, *tensors) -> None:
    for t in tensors:
        if not t.is_cuda or t.device != tensors[0].device:
            raise ValueError(f"{kernel}: operand on {t.device}, the kernel "
                             f"needs CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")


@torch.library.custom_op("repro_torch::sumsq", mutates_args=())
def sumsq(x: torch.Tensor) -> torch.Tensor:
    """``x``'s sum of squares in f32 (a 0-d tensor) by ``sumsq_kernel``
    (csrc/optim.cu): one read of ``x`` (f32 or bf16), per-block partials
    summed by one block in a fixed order, so a call repeats bit for
    bit."""
    from repro_torch.kernels import _cuda
    lib = _cuda.library()
    _require("sumsq", x)
    code = _cuda.dtype_code(x)
    n = x.numel()
    part = torch.empty(_SUMSQ_PARTIALS, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    vec = 16 // x.element_size()
    nvec = n // vec if x.data_ptr() % 16 == 0 else 0
    rc = lib.repro_sumsq(code, x.data_ptr(), part.data_ptr(), part.numel(),
                         out.data_ptr(), n, nvec, _cuda.stream_of(x))
    _cuda.check(rc, "sumsq")
    LAUNCHES["sumsq"] += 1
    return out


@sumsq.register_fake
def _sumsq_fake(x):
    return x.new_empty((), dtype=torch.float32)


@torch.library.custom_op("repro_torch::adamw_", mutates_args=("p", "m", "v"))
def adamw_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, scal: torch.Tensor, b1: float, b2: float,
               eps: float, weight_decay: float) -> None:
    """One leaf's AdamW step in place by ``adamw_kernel``
    (csrc/optim.cu): p (f32 or bf16) and its f32 moments m, v from the
    gradient g (f32 or bf16); ``scal`` = [clip, lr, bc1, bc2], f32 on
    the device.  Each element rounds as `leaf_update_plain`'s eager ops
    do."""
    from repro_torch.kernels import _cuda
    lib = _cuda.library()
    _require("adamw", p, g, m, v, scal)
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"adamw: p, g, m, v shapes differ: {p.shape}, "
                         f"{g.shape}, {m.shape}, {v.shape}")
    if m.dtype != torch.float32 or v.dtype != torch.float32 or \
            scal.dtype != torch.float32 or scal.numel() != 4:
        raise TypeError("adamw: the moments and [clip, lr, bc1, bc2] must "
                        "be float32")
    n = p.numel()
    if n == 0:
        return
    quads = all(t.data_ptr() % (4 * t.element_size()) == 0
                for t in (p, g, m, v))
    rc = lib.repro_adamw(_cuda.dtype_code(p), _cuda.dtype_code(g),
                         p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr(), scal.data_ptr(), n,
                         n // 4 if quads else 0, b1, 1 - b1, b2, 1 - b2,
                         eps, weight_decay, _cuda.stream_of(p))
    _cuda.check(rc, "adamw")
    LAUNCHES["adamw"] += 1


@adamw_leaf.register_fake
def _adamw_leaf_fake(p, g, m, v, scal, b1, b2, eps, weight_decay):
    return None


def _leaf_sumsq(v):
    """`sumsq` of one leaf; a DTensor's on its local shard, summed over
    the mesh dims that shard it (replicated dims hold it whole)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(v, DTensor):
        return sumsq(v)
    if any(p.is_partial() for p in v.placements):
        raise ValueError(f"global_norm: a leaf of pending sums "
                         f"{v.placements} has no norm yet")
    s = DTensor.from_local(
        sumsq(v.to_local()), v.device_mesh,
        [Partial() if p.is_shard() else Replicate() for p in v.placements],
        run_check=False)
    return settle(s)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's f32
    sum of squares — by `sumsq` off the CPU, else `global_norm_plain`.
    A DTensor leaf's sum is reduced over its shards (`settle`), so a
    gradient sharded over the mesh is normed whole."""
    if not on_card(tree):
        return global_norm_plain(tree)
    total = 0
    for v in _values(tree):
        total = total + _leaf_sumsq(v)
    return torch.sqrt(torch.as_tensor(total))


def global_norm_plain(tree) -> torch.Tensor:
    """`global_norm` in eager ops, on any device."""
    total = 0
    for v in _values(tree):
        total = total + settle(torch.sum(torch.square(v.float())))
    return torch.sqrt(torch.as_tensor(total))


def init_adamw(params) -> Dict:
    """Zero f32 moments shaped (and, on a mesh, laid out) as the
    parameters; ``count`` a plain int32 scalar."""
    zeros = lambda p: Param(torch.zeros_like(p.value, dtype=torch.float32),
                            p.dims)
    dev = next(iter(_values(params))).device
    return {"m": map_params(zeros, params), "v": map_params(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def leaf_update_plain(p, g, m, v, clip, lr, bc1, bc2,
                      cfg: AdamWConfig) -> None:
    """One leaf's step in eager ops, in place (an f32 ``g`` scaled by
    the clip in place too)."""
    g = g.float().mul_(clip)
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    pf = p.float()
    upd = lr * step.add_(pf, alpha=cfg.weight_decay)
    if p.dtype == torch.float32:
        p.sub_(upd)                 # pf is p: no copy of the master
    else:
        p.copy_(pf - upd)


@torch.no_grad()
def update_with_norm(params, grads, state: Dict, cfg: AdamWConfig,
                     gnorm: torch.Tensor, *, kernels: bool
                     ) -> Tuple[object, Dict, Dict]:
    """The step from a given global norm ``gnorm``: by `adamw_leaf` on
    every leaf (``kernels``) or by `leaf_update_plain`.  Bias correction
    uses the incremented count."""
    count = state["count"] + 1
    lr = schedule(cfg, count)
    clip = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    cf = count.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    leaves = zip(_values(params), _values(grads), _values(state["m"]),
                 _values(state["v"]))
    if kernels:
        scal = torch.stack([_local(x).float() for x in (clip, lr, bc1, bc2)])
        for p, g, m, v in leaves:
            adamw_leaf(_local(p), _local(g), _local(m), _local(v), scal,
                       cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    else:
        for p, g, m, v in leaves:
            leaf_update_plain(p, g, m, v, clip, lr, bc1, bc2, cfg)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}


def adamw_update(params, grads, state: Dict, cfg: AdamWConfig
                 ) -> Tuple[object, Dict, Dict]:
    """One AdamW step, in place: by the kernels unless the leaves lie on
    the CPU, where `adamw_update_plain` runs.  ``grads`` is a tree of
    tensors (or Params) in ``params``' structure."""
    if not on_card(params):
        return adamw_update_plain(params, grads, state, cfg)
    with torch.no_grad():
        gnorm = global_norm(grads)
    return update_with_norm(params, grads, state, cfg, gnorm, kernels=True)


def adamw_update_plain(params, grads, state: Dict, cfg: AdamWConfig
                       ) -> Tuple[object, Dict, Dict]:
    """`adamw_update` in eager ops, on any device."""
    with torch.no_grad():
        gnorm = global_norm_plain(grads)
    return update_with_norm(params, grads, state, cfg, gnorm, kernels=False)
