"""Logical-axis sharding rules with divisibility fallback.

Every parameter and constrained activation carries a tuple of
*logical* dimension names (``("embed", "heads", "head_dim")``).  A rule
table maps logical names to mesh-axis candidates; `logical_spec`
assigns, per tensor, the first candidate whose mesh-axis product
divides the dimension, never reusing a mesh axis within one tensor,
and falls back to replication otherwise — the reference's tables and
resolver, value for value.  Its mesh is anything with ``axis_names``
and ``devices.shape``; it returns the tuple of per-dim assignments the
reference's ``PartitionSpec`` holds.

The port trains and serves on one card: `Sharder` keeps the
reference's call sites — every layer still names the logical layout of
what it produces — and passes each tensor through unchanged.  On a
mesh it raises until the mesh slice (ROADMAP A8b) lands.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

__all__ = ["Rules", "WEIGHT_RULES", "ACT_RULES", "ACT_RULES_SP",
           "CACHE_RULES", "CACHE_RULES_SEQSHARD", "logical_spec", "Sharder"]

AxisCand = Union[str, Tuple[str, ...]]
Rule = Tuple[str, Tuple[AxisCand, ...]]
Rules = Tuple[Rule, ...]

WEIGHT_RULES: Rules = (
    ("vocab", ("model",)),
    ("embed", ("data",)),          # FSDP / ZeRO-3 weight sharding
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("head_dim", ("model",)),      # TP fallback when heads indivisible
    ("mlp", ("model",)),
    ("experts", ("model",)),       # expert parallelism
    ("expert_mlp", ("model",)),    # within-expert TP fallback
    ("ssm_inner", ("model",)),
    ("state", ()),
    ("conv", ()),
)

ACT_RULES: Rules = (
    ("batch", (("pod", "data"), "data")),
    ("seq", ()),
    ("embed", ()),
    ("heads", ("model",)),
    # kv activations stay replicated over model: they broadcast up to the
    # TP-sharded q-head axis locally (Megatron GQA recipe)
    ("kv_heads", ()),
    ("head_dim", ()),
    ("mlp", ("model",)),
    ("experts", ("model",)),
    ("expert_mlp", ("model",)),
    ("moe_capacity", (("pod", "data"), "data")),
    ("vocab", ("model",)),
    ("ssm_inner", ("model",)),
    ("state", ()),
    ("residual_seq", ()),          # block-boundary residual stream
)

# Megatron-style sequence parallelism: the residual stream between blocks
# sharded over the model axis
ACT_RULES_SP: Rules = tuple(
    (("residual_seq", ("model",)) if name == "residual_seq"
     else (name, cands))
    for name, cands in ACT_RULES)

# decode caches: kv-heads sharded (head_dim fallback); the seq-sharded
# variant is the split-KV / flash-decoding layout
CACHE_RULES: Rules = (
    ("batch", (("pod", "data"), "data")),
    ("kv_heads", ("model",)),
    ("head_dim", ("model",)),
    ("cache_seq", ()),
    ("state", ()),
    ("ssm_inner", ("model",)),
    ("layers", ()),
)

CACHE_RULES_SEQSHARD: Rules = (
    ("batch", (("pod", "data"), "data")),
    ("cache_seq", ("model",)),
    ("kv_heads", ()),
    ("head_dim", ()),
    ("state", ()),
    ("ssm_inner", ("model",)),
    ("layers", ()),
)


def _axes_of(c: AxisCand) -> Tuple[str, ...]:
    return c if isinstance(c, tuple) else (c,)


def logical_spec(dims: Sequence[Optional[str]], shape: Sequence[int],
                 rules: Rules, mesh) -> Tuple[Optional[AxisCand], ...]:
    """Resolve logical dims -> the per-dim mesh-axis assignments of a
    concrete shape (trailing unassigned dims dropped, as in a
    ``PartitionSpec``)."""
    if len(dims) != len(shape):
        raise ValueError(f"dims {dims} do not match shape {shape}")
    mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    used: set = set()
    out = []
    for dname, size in zip(dims, shape):
        assigned = None
        if dname is not None:
            for ld, cands in rules:
                if ld != dname:
                    continue
                for cand in cands:
                    axs = _axes_of(cand)
                    if any(a in used or a not in mesh_sizes for a in axs):
                        continue
                    n = math.prod(mesh_sizes[a] for a in axs)
                    if n > 1 and size % n == 0:
                        assigned = cand
                        used.update(axs)
                        break
                break  # first matching rule only
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


class Sharder:
    """One-device pass-through with the reference's call sites."""

    def __init__(self, mesh=None, **_rules):
        if mesh is not None:
            raise NotImplementedError(
                "repro_torch runs on one device: sharding on a mesh waits "
                "for the mesh slice (ROADMAP A8b)")
        self.mesh = None

    def act(self, x, dims: Sequence[Optional[str]]):
        return x

    def cache(self, x, dims: Sequence[Optional[str]]):
        return x
