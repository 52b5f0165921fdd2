"""Per-chip-family instruction latency tables (the pipeline tier's ISA).

The Eq. 6 tier prices instruction *counts*; this module prices
instruction *classes* the way an in-order pipeline sees them: issue
cycles (how long the class's pipe stays busy per instruction), result
latency (issue -> operand-ready, the quantity dependence stalls wait
on), dual-issue eligibility, whether a stalled consumer can yield to
another context, and how many outstanding memory results the
scoreboard tracks before issue blocks — the SASSOverlay view of a SASS
stream (stall counts, yield flags, WR/RD barriers per instruction),
abstracted to the seven instruction classes the analyzers already
count (`repro_torch.core.predict._FEATURES`).

Every row carries a ``provenance`` note saying where its numbers come
from.  Convention (tested in tests/test_pipeline_model.py): rows are
never silently defaulted — a family table must price all seven classes
with positive issue+latency and a non-empty provenance string.  Three
provenance tiers appear below:

* ``paper``   — derived from the source paper's own constants
  (Table I clocks, Table II IPC -> CPI, the TPU rate table).
* ``microbench`` — public microbenchmark literature for the family
  (Wong et al. 2010 for Fermi; Mei & Chu 2017 for Kepler/Maxwell;
  NVIDIA SASS control encodings for Maxwell stall counts; Luo et al.
  2024 and Jia et al. 2018 for Hopper).
* ``model``   — a documented modeling choice where no public number
  exists (TPU core latencies; derived clocks).

Tables are value-derived from the `ChipSpec` (rates, clocks, CPIs), so
a new chip generation added to ``hw.TPU_TABLE`` / ``hw.GPU_TABLE``
gets a table by writing one `_TPU_LATENCIES`/`_GPU_LATENCIES` entry
for its `repro_torch.core.hw.isa_family` key — see DESIGN.md §16.

The TPU and Fermi/Kepler/Maxwell rows are the reference's, value for
value, so their tables and fingerprints equal the reference's.  The
Hopper table (`HopperSpec`, family ``"Hopper"``) is this package's own:
the paper's Table II has no Hopper CPIs, so its issue costs come from
the spec's rates, the way the TPU table's come from the TPU rate table.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple, Union

from repro_torch.core.hw import (ChipSpec, GpuSpec, HopperSpec, TpuSpec,
                                 cpi, isa_family, resolve_target,
                                 tpu_rate_table)

__all__ = [
    "CLASSES", "CLASS_FEATURE", "FEATURE_CLASS", "IsaOp", "IsaTable",
    "isa_table_for", "tpu_clock_hz",
]

# The seven instruction classes, 1:1 with the feature columns of
# `repro_torch.core.predict.features_matrix` (same order).
CLASSES: Tuple[str, ...] = ("mxu", "vpu", "trans", "hbm", "vmem", "ctrl",
                            "reg")

CLASS_FEATURE: Dict[str, str] = {
    "mxu": "mxu_flops", "vpu": "vpu_flops", "trans": "trans_flops",
    "hbm": "hbm_bytes", "vmem": "vmem_bytes", "ctrl": "ctrl_ops",
    "reg": "reg_ops",
}
FEATURE_CLASS: Dict[str, str] = {v: k for k, v in CLASS_FEATURE.items()}


@dataclasses.dataclass(frozen=True)
class IsaOp:
    """One instruction class priced for one chip family.

    ``work`` is how many feature units (flops, bytes, events) one
    abstract instruction of this class retires — the stream extractor
    divides feature counts by it to get an instruction count.  ``issue``
    is how many cycles the class's ``pipe`` stays busy per instruction;
    ``latency`` is issue -> result-ready, what a dependent instruction
    stalls on.  ``yields`` marks classes whose stalls another context
    (warp / double-buffered grid step) can hide; ``barrier`` marks
    classes whose results occupy a scoreboard slot ('rd'/'wr', empty
    for none).
    """

    cls: str
    pipe: str
    work: float
    issue: float
    latency: float
    dual_issue: bool = False
    yields: bool = True
    barrier: str = ""
    provenance: str = ""


@dataclasses.dataclass(frozen=True)
class IsaTable:
    """All seven instruction classes priced for one chip family."""

    family: str
    clock_hz: float
    barrier_slots: int          # outstanding memory results before issue blocks
    ops: Dict[str, IsaOp]
    provenance: str = ""

    def op(self, cls: str) -> IsaOp:
        try:
            return self.ops[cls]
        except KeyError:
            raise KeyError(
                f"ISA table {self.family!r} prices no class {cls!r}; "
                f"known: {sorted(self.ops)}") from None

    def fingerprint(self) -> str:
        """Content address over every row (any repricing re-keys the
        pipeline model and therefore every cache entry built on it)."""
        fp = self.__dict__.get("_fp")
        if fp is None:
            h = hashlib.sha256()
            h.update(f"{self.family}|{self.clock_hz!r}|"
                     f"{self.barrier_slots}".encode())
            for cls in sorted(self.ops):
                h.update(repr(dataclasses.astuple(self.ops[cls])).encode())
            fp = f"isa-{self.family}@{h.hexdigest()[:10]}"
            self.__dict__["_fp"] = fp
        return fp


# ---------------------------------------------------------------------------
# TPU families (v4 / v5e / v5p / v6e)
# ---------------------------------------------------------------------------

# Core clocks.  provenance[model]: derived as
# peak_bf16 / (MXU count x MACs per MXU x 2 flops/MAC); v4's 1.05 GHz
# matches the published TPUv4 clock, v5p's 1.75 GHz the public figure.
_TPU_CLOCK_HZ: Dict[str, float] = {
    "tpu-v4": 1.05e9,    # 275 TF / (8 MXU x 128x128 x 2)
    "tpu-v5e": 1.50e9,   # 197 TF / (4 MXU x 128x128 x 2)
    "tpu-v5p": 1.75e9,   # 459 TF / (8 MXU x 128x128 x 2)
    "tpu-v6e": 1.75e9,   # 918 TF / (4 MXU x 256x256 x 2)
}


def tpu_clock_hz(spec: TpuSpec) -> float:
    """Approximate core clock for a TPU generation (see _TPU_CLOCK_HZ).
    Unknown generations fall back to 1 GHz — rate-derived ``work``
    keeps per-pipe busy *seconds* exact regardless of the clock; only
    latency-cycle scaling is approximate."""
    return _TPU_CLOCK_HZ.get(spec.name, 1.0e9)


# (latency_cycles, dual_issue, yields, barrier, provenance) per class.
# Latencies are cycles from issue to result-ready.
_TPU_ROWS: Dict[str, Tuple[float, bool, bool, str, str]] = {
    # systolic array: a tile's partial sums drain after the array fills
    "mxu": (128.0, False, False, "",
            "model: systolic fill depth = mxu_tile rows (128)"),
    "vpu": (8.0, False, False, "",
            "model: 8-deep vector pipeline (8x128 lane registers)"),
    "trans": (24.0, False, False, "",
              "model: iterative transcendental unit, ~3x vector depth"),
    # async DMA: ~400 ns HBM round trip at ~1-1.75 GHz core clocks
    "hbm": (700.0, False, True, "wr",
            "model: HBM round-trip ~400ns x core clock; async copy yields"),
    "vmem": (40.0, False, True, "wr",
             "model: on-chip SRAM staging, order-10x vector latency"),
    # scalar core runs ahead of the vector pipes (VLIW-ish co-issue)
    "ctrl": (4.0, True, False, "",
             "paper: busy = ctrl_ops x ctrl_overhead_s via rate table; "
             "scalar core co-issues with vector work"),
    "reg": (2.0, True, False, "",
            "paper: retired at vpu lane rate (hw.tpu_rate_table); "
            "model: 2-cycle move latency"),
}


def _tpu_table(spec: TpuSpec) -> IsaTable:
    clock = tpu_clock_hz(spec)
    rates = tpu_rate_table(spec)
    pipes = {"mxu": "mxu", "vpu": "vpu", "trans": "vpu", "hbm": "hbm",
             "vmem": "vmem", "ctrl": "scalar", "reg": "vpu"}
    ops = {}
    for cls in CLASSES:
        lat, dual, yields, barrier, note = _TPU_ROWS[cls]
        rate = rates[CLASS_FEATURE[cls]]
        # work = feature units retired per cycle at the spec's peak
        # rate, issue = 1: per-pipe busy seconds == units / rate, so
        # the simulator's busy terms reproduce the paper-faithful
        # roofline exactly and the latency/stall terms are pure signal
        # on top.
        ops[cls] = IsaOp(cls=cls, pipe=pipes[cls], work=rate / clock,
                         issue=1.0, latency=lat, dual_issue=dual,
                         yields=yields, barrier=barrier,
                         provenance=f"paper: work={CLASS_FEATURE[cls]} "
                                    f"rate/clock; {note}")
    return IsaTable(
        family=spec.name, clock_hz=clock, barrier_slots=4, ops=ops,
        provenance="rates: hw.tpu_rate_table (paper Eq. 6 TPU analogue); "
                   "clock: derived from peak/MXU count; barrier_slots=4 "
                   "model: bounded outstanding async-copy semaphores per "
                   "buffer pair")


# ---------------------------------------------------------------------------
# CUDA families (Fermi / Kepler / Maxwell)
# ---------------------------------------------------------------------------

# (alu_latency, mem_latency, sfu_latency, dual_issue, provenance) per family.
_GPU_LATENCIES: Dict[str, Tuple[float, float, float, bool, str]] = {
    "Fermi": (18.0, 600.0, 22.0, False,
              "microbench: Wong et al. 2010 (GT200/GF100 dependent-issue "
              "~18-24 cy, global load 400-800 cy); single dispatch per "
              "scheduler"),
    "Kepler": (10.0, 300.0, 16.0, True,
               "microbench: GK110 ALU ~9-11 cy, global ~230-300 cy; two "
               "dispatch units per warp scheduler (dual issue)"),
    "Maxwell": (6.0, 380.0, 12.0, True,
                "microbench: Mei & Chu 2017 (GM204 global ~368 cy); SASS "
                "control encodings stall FFMA consumers 6 cy; dual issue"),
}

# class -> (pipe, paper Table II CPI category)
_GPU_PIPES: Dict[str, Tuple[str, str]] = {
    "mxu": ("fp", "FPIns32"),        # the FP-FMA stream
    "vpu": ("fp", "CompMinMax"),     # int/compare ALU traffic
    "trans": ("sfu", "LogSinCos"),
    "hbm": ("lsu", "LdStIns"),       # global memory
    "vmem": ("lsu", "LdStIns"),      # shared/local memory
    "ctrl": ("ctrl", "CtrlIns"),
    "reg": ("fp", "Regs"),
}


def _gpu_table(spec: GpuSpec) -> IsaTable:
    clock = spec.gpu_clock_mhz * 1e6
    alu, mem, sfu, dual, note = _GPU_LATENCIES[spec.family]
    lats = {"mxu": alu, "vpu": alu, "trans": sfu, "hbm": mem,
            "vmem": max(alu * 2.0, 24.0), "ctrl": alu, "reg": alu}
    ops = {}
    for cls in CLASSES:
        pipe, cat = _GPU_PIPES[cls]
        ops[cls] = IsaOp(
            cls=cls, pipe=pipe, work=1.0,
            # SM-aggregate issue cost: CPI = 1/IPC from the paper's
            # Table II, so busy cycles reproduce Eq. 6 per pipe.
            issue=cpi(cat, spec), latency=lats[cls],
            dual_issue=dual and cls in ("mxu", "vpu", "reg", "ctrl"),
            # every class yields on a GPU: the warp scheduler switches
            # contexts on any scoreboard stall
            yields=True,
            barrier=("rd" if cls == "hbm" else
                     "wr" if cls == "vmem" else ""),
            provenance=f"paper: issue = CPI(Table II {cat}, "
                       f"{spec.family}); latency {note}")
    return IsaTable(
        family=spec.family, clock_hz=clock, barrier_slots=6, ops=ops,
        provenance=f"clock: paper Table I ({spec.name}); {note}; "
                   "barrier_slots=6 model: SASS scoreboard register count "
                   "(6 WR/RD barriers per warp, Maxwell+ encoding)")


# ---------------------------------------------------------------------------
# Hopper (the H100 the port launches on)
# ---------------------------------------------------------------------------

# class -> (pipe, rate field of HopperSpec).  The rates are the ones
# `repro_torch.core.predict.default_hopper_model` prices each feature
# column at; ``launch_rate`` is 1 / launch_overhead_s.  The pipes follow
# that model's composition: the arithmetic classes share the SM's issue
# (the model sums them), device and shared memory share the load/store
# path (summed), launches are their own.
_HOPPER_PIPES: Dict[str, Tuple[str, str]] = {
    "mxu": ("sm", "bf16_tensor_flops"),
    "vpu": ("sm", "fp32_flops"),
    "trans": ("sm", "sfu_rate"),
    "hbm": ("lsu", "hbm_bw"),
    "vmem": ("lsu", "smem_bw"),
    "ctrl": ("launch", "launch_rate"),
    "reg": ("sm", "fp32_flops"),
}

# (latency_cycles, provenance) per class, cycles from issue to result.
_HOPPER_ROWS: Dict[str, Tuple[float, str]] = {
    "mxu": (128.0,
            "model: no public Hopper figure pinned to a wgmma shape; one "
            "m64n256k16 group (524,288 flops) holds an SM's tensor cores "
            "~138 cycles at bf16_tensor_flops / (SMs x clock), its "
            "accumulators are taken ready 128 cycles after issue"),
    "vpu": (4.0,
            "microbench: dependent FFMA latency 4 cycles since Volta (Jia "
            "et al. 2018, 'Dissecting the NVIDIA Volta GPU Architecture "
            "via Microbenchmarking'); Hopper keeps the 4-stage FP32 pipe"),
    "trans": (18.0,
              "model: no Hopper MUFU latency found in the literature; "
              "taken between the Maxwell row's 12 and the Fermi row's 22 "
              "cycles"),
    "hbm": (478.0,
            "microbench: Luo et al. 2024, 'Benchmarking and Dissecting the "
            "Nvidia Hopper GPU Architecture' (IPDPS), pointer-chase global "
            "memory latency ~478 cycles on a Hopper part"),
    "vmem": (29.0,
             "microbench: Luo et al. 2024 (IPDPS), shared-memory load "
             "latency ~29 cycles on a Hopper part"),
    "ctrl": (4.0,
             "model: a launch's cost is all issue (launch_overhead_s, "
             "host and grid setup, the spec's assumption); nothing waits "
             "on its result beyond one ALU latency"),
    "reg": (4.0,
            "model: the H100 analysis counts no register moves "
            "(reg_ops = 0); priced at the FP32 lane rate and FFMA "
            "latency, as the TPU table prices reg at its vector rate"),
}


def _hopper_table(spec: HopperSpec) -> IsaTable:
    clock = spec.gpu_clock_mhz * 1e6
    ops = {}
    for cls in CLASSES:
        pipe, field = _HOPPER_PIPES[cls]
        rate = (1.0 / spec.launch_overhead_s if field == "launch_rate"
                else float(getattr(spec, field)))
        lat, note = _HOPPER_ROWS[cls]
        # work = feature units retired per cycle at the spec's rate,
        # issue = 1: with zero latency a class's busy seconds are units /
        # rate, default_hopper_model's time for that class; latency and
        # stalls are the signal on top (as in the TPU table)
        ops[cls] = IsaOp(cls=cls, pipe=pipe, work=rate / clock, issue=1.0,
                         latency=lat, dual_issue=False, yields=True,
                         barrier=("rd" if cls == "hbm" else
                                  "wr" if cls == "vmem" else ""),
                         provenance=f"spec: work = {field} / clock "
                                    f"({spec.name}); latency {note}")
    return IsaTable(
        family=spec.family, clock_hz=clock, barrier_slots=6, ops=ops,
        provenance=f"clock: gpu_clock_mhz of {spec.name} (boost); rates: "
                   "the HopperSpec fields default_hopper_model prices; no "
                   "dual issue (one instruction per scheduler per cycle "
                   "since Volta); barrier_slots=6 model: SASS scoreboard "
                   "register count (6 WR/RD barriers per warp)")


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------

_TABLES: Dict[ChipSpec, IsaTable] = {}


def isa_table_for(spec: Optional[Union[str, ChipSpec]] = None) -> IsaTable:
    """The `IsaTable` for a chip (name, spec, or None = default target).

    Memoized per spec — specs are frozen dataclasses, so identity of
    content implies identity of table.  Raises KeyError for a family
    no table is declared for (add a `_TPU_ROWS`/`_GPU_LATENCIES`
    entry; see DESIGN.md §16).  A `HopperSpec` gets the Hopper table.
    """
    spec = resolve_target(spec)
    table = _TABLES.get(spec)
    if table is None:
        if isinstance(spec, GpuSpec):
            if spec.family not in _GPU_LATENCIES:
                raise KeyError(
                    f"no ISA latency rows for GPU family {spec.family!r}; "
                    f"known: {sorted(_GPU_LATENCIES)}")
            table = _gpu_table(spec)
        elif isinstance(spec, HopperSpec):
            table = _hopper_table(spec)
        elif isinstance(spec, TpuSpec):
            table = _tpu_table(spec)
        else:
            raise KeyError(f"no ISA table for target {spec!r} "
                           f"(family {isa_family(spec)!r})")
        _TABLES[spec] = table
    return table
