"""Three-term roofline analysis from compiled (dry-run) artifacts.

Per the assignment:

    compute term    = HLO_FLOPs / (chips * peak_FLOP/s)
    memory term     = HLO_bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

``cost_analysis()`` supplies HLO_FLOPs / HLO_bytes; collective bytes
come from :mod:`repro_torch.core.hlo` text parsing.  ``model_flops``
(6·N·D dense, 6·N_active·D MoE) is passed in by the caller so the
useful-compute ratio is reported.

Note on units: on a multi-device module XLA's cost_analysis reports the
*per-device* program (SPMD), so we default ``flops_are_global=False``.

Under a `TpuSpec` every term is the reference's (`repro.core.roofline`),
bit for bit.  Under a `HopperSpec` (the H100 the port launches on) the
compute term prices each class at its own rate::

    compute = mxu_flops / bf16_tensor_flops + vpu_flops / fp32_flops
              + trans_flops / sfu_rate
    memory  = hbm_bytes / hbm_bw

    collective = collective_bytes / (links * nvlink_bw_per_link)

with NVLink 4's 18 links at the datasheet's 50 GB/s each, and ``cost``
may be the dict a torch trace yields (`core.mix`'s ``"flops"`` /
``"bytes accessed"`` keys).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from repro_torch.core.hw import (HopperSpec, TpuSpec, require_tpu,
                                 resolve_target)
from repro_torch.core.hlo import (CollectiveStats, collective_stats,
                                  module_mix, parse_hlo)
from repro_torch.core.mix import InstructionMix

__all__ = ["RooflineTerms", "roofline_from_artifacts", "format_roofline_row"]


@dataclasses.dataclass
class RooflineTerms:
    name: str
    chips: int
    # raw statics
    hlo_flops: float            # per-device
    hlo_bytes: float            # per-device
    collective_bytes: float     # per-device
    model_flops: float          # global useful FLOPs (6ND or 6·N_active·D)
    # derived (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    useful_ratio: float         # model_flops / (hlo_flops * chips)
    roofline_frac: float        # useful compute time / bound
    note: str = ""
    collectives_by_kind: Optional[Dict[str, float]] = None

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        return d

    def json(self) -> str:
        return json.dumps(self.as_dict())


def roofline_from_artifacts(name: str,
                            cost: Dict[str, float],
                            hlo_text: Optional[str],
                            chips: int,
                            model_flops: float,
                            spec=None,
                            ici_links: Optional[int] = None,
                            flops_are_global: bool = False,
                            collectives: Optional[CollectiveStats] = None,
                            mix: Optional[InstructionMix] = None,
                            note: str = "") -> RooflineTerms:
    """Build the three terms for one (arch x shape x mesh) cell.

    Prefers the loop-aware module mix (``repro_torch.core.hlo.module_mix``)
    over ``cost_analysis`` — XLA's analysis counts while bodies once,
    undercounting scan-over-layers / microbatch loops by their trip
    counts.  ``spec`` — chip to model (``None`` = default target): a
    `TpuSpec`, or the H100's `HopperSpec`; ``ici_links`` — links per
    chip (``None`` = from the spec's ICI topology: 2D torus 4, 3D torus
    6; on the H100 its 18 NVLink links).
    """
    spec = resolve_target(spec)
    if isinstance(spec, HopperSpec):
        return _hopper_terms(name, cost, hlo_text, chips, model_flops,
                             spec, flops_are_global, collectives, mix, note,
                             links=ici_links)
    spec = require_tpu(spec, "roofline_from_artifacts")
    if ici_links is None:
        ici_links = spec.ici_links
    if mix is None and hlo_text is not None:
        mod = parse_hlo(hlo_text)
        mix = module_mix(mod)
        if collectives is None:
            collectives = collective_stats(mod)
    if collectives is None:
        collectives = CollectiveStats({}, {}, 0.0, [])
    if mix is not None:
        # per-device, loop-aware
        flops = mix.mxu_flops
        nbytes = mix.hbm_bytes
        t_c = (mix.mxu_flops / spec.peak_flops_bf16
               + mix.vpu_flops / spec.vpu_flops
               + mix.trans_flops / spec.transcendental_flops)
    else:
        flops = float(cost.get("flops", 0.0) or 0.0)
        nbytes = float(cost.get("bytes accessed", 0.0) or 0.0)
        if flops_are_global:
            flops /= chips
            nbytes /= chips
        t_c = flops / spec.peak_flops_bf16
    cbytes = collectives.total_bytes

    # Per-device terms (SPMD program: each chip runs the same per-device
    # program, so per-device time IS the step time).
    t_m = nbytes / spec.hbm_bw
    t_x = cbytes / (spec.ici_bw_per_link * ici_links)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)

    useful = model_flops / max(flops * chips, 1.0)
    # roofline fraction: time the useful math alone would need at peak,
    # over the statically-predicted bound (max of the three terms).
    t_useful = (model_flops / chips) / spec.peak_flops_bf16
    bound = max(t_c, t_m, t_x, 1e-30)
    frac = t_useful / bound

    return RooflineTerms(
        name=name, chips=chips,
        hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=cbytes,
        model_flops=model_flops,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        dominant=dominant, useful_ratio=useful, roofline_frac=frac,
        note=note, collectives_by_kind=dict(collectives.by_kind_bytes),
    )


def _hopper_terms(name, cost, hlo_text, chips, model_flops,
                  spec: HopperSpec, flops_are_global, collectives, mix,
                  note, links: Optional[int] = None) -> RooflineTerms:
    """The three terms on H100s: each instruction class at its own rate,
    device memory at the HBM rate, collective bytes over the card's
    NVLink links (``links``, default all 18, at the datasheet's per-link
    rate).  Like the reference's, every term is per device: an SPMD
    step runs the same program on each card."""
    if mix is None and hlo_text is not None:
        mod = parse_hlo(hlo_text)
        mix = module_mix(mod)
        if collectives is None:
            collectives = collective_stats(mod)
    if collectives is None:
        collectives = CollectiveStats({}, {}, 0.0, [])
    if mix is not None:
        flops = mix.mxu_flops
        nbytes = mix.hbm_bytes
        t_c = (mix.mxu_flops / spec.bf16_tensor_flops
               + mix.vpu_flops / spec.fp32_flops
               + mix.trans_flops / spec.sfu_rate)
    else:
        flops = float(cost.get("flops", 0.0) or 0.0)
        nbytes = float(cost.get("bytes accessed", 0.0) or 0.0)
        if flops_are_global:
            flops /= chips
            nbytes /= chips
        t_c = flops / spec.bf16_tensor_flops
    cbytes = collectives.total_bytes
    t_m = nbytes / spec.hbm_bw
    t_x = cbytes / (spec.nvlink_bw_per_link
                    * (spec.nvlink_links if links is None else links))
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    t_useful = (model_flops / chips) / spec.bf16_tensor_flops
    return RooflineTerms(
        name=name, chips=chips,
        hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=cbytes,
        model_flops=model_flops,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        dominant=dominant,
        useful_ratio=model_flops / max(flops * chips, 1.0),
        roofline_frac=t_useful / max(t_c, t_m, t_x, 1e-30),
        note=note, collectives_by_kind=dict(collectives.by_kind_bytes))


def format_roofline_row(r: RooflineTerms) -> str:
    return ("{:<42s} chips={:<4d} t_c={:.3e}s t_m={:.3e}s t_x={:.3e}s "
            "dom={:<10s} useful={:.3f} roofline={:.3f} {}").format(
        r.name, r.chips, r.t_compute, r.t_memory, r.t_collective,
        r.dominant, r.useful_ratio, r.roofline_frac, r.note)
