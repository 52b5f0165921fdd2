"""HLO-module static analyzer: the "disassembly" layer (paper §III).

XLA's built-in ``cost_analysis()`` counts a while-loop body ONCE — a
scan over 80 layers or 16 microbatches is undercounted by its trip
count, and operand shapes are not printed inline, so naive text
censuses mis-size ``dot`` contractions.  This module is therefore a
real two-pass parser:

1. **Parse** the module into computations and instructions, building a
   per-computation symbol table (%name -> shape) so operand shapes
   resolve exactly.
2. **Walk the call graph** from ENTRY, propagating execution
   multipliers: while bodies/conditions multiply by the statically
   recoverable trip count (the s32 bound constant in the condition
   computation), fusion/call/to_apply inherit the caller's multiplier.

On top of that it derives loop-aware aggregates:

* :func:`module_mix` — InstructionMix over the whole module
  (trip-count-correct FLOPs / bytes / transcendentals),
* :func:`collective_stats` — per-kind collective bytes (the roofline's
  third term; `-start`/`-done` pairs deduped),
* :func:`remat_duplication` — repeated op_name metadata (static
  recompute-waste signal).

This is the paper's nvdisasm-census methodology ported to the XLA
binary format, with loop awareness the paper's flat kernels never
needed.  The module is the reference's (`repro.core.hlo`) line for
line, so both packages read the same text to the same numbers; the
census of the port's own CUDA binaries is `repro_torch.core.sass`.
"""
from __future__ import annotations

import dataclasses
import re
from collections import Counter, defaultdict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hw import dtype_bytes
from repro_torch.core.mix import InstructionMix

__all__ = [
    "HloInstruction", "HloComputation", "HloModule", "parse_hlo",
    "CollectiveStats", "collective_stats", "module_mix", "op_census",
    "remat_duplication", "HloReport", "analyze_hlo",
]

# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

# computation header:  %name (args) -> ret {     |  ENTRY %name (...) ... {
# args may contain nested parens (tuple types), so match loosely.
_COMP_RE = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{\s*$")
# instruction:  [ROOT] %name = <ret-type> opcode(operands)[, attrs]
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+?)\s+([a-z][a-z0-9\-]*)\((.*)$")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_CALLSITE_RE = re.compile(
    r"(?:calls|to_apply|condition|body|true_computation|false_computation)"
    r"=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_CONST_RE = re.compile(r"s32\[\]\s+constant\((\d+)\)")
_OPNAME_RE = re.compile(r'op_name="([^"]+)"')
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_REPL_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def _parse_shapes(text: str) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    for dt, dims in _SHAPE_RE.findall(text):
        shape = tuple(int(d) for d in dims.split(",") if d) if dims else ()
        out.append((dt, shape))
    return out


def _nelems(shape: Tuple[int, ...]) -> float:
    return float(np.prod(shape)) if shape else 1.0


@dataclasses.dataclass
class HloInstruction:
    name: str
    opcode: str
    ret_shapes: List[Tuple[str, Tuple[int, ...]]]   # result (maybe tuple)
    operands: List[str]
    callees: List[str]
    line: str

    @property
    def out_elems(self) -> float:
        return sum(_nelems(s) for _, s in self.ret_shapes)

    @property
    def out_bytes(self) -> float:
        return sum(_nelems(s) * dtype_bytes(dt)
                   for dt, s in self.ret_shapes)


@dataclasses.dataclass
class HloComputation:
    name: str
    instructions: List[HloInstruction]
    symbols: Dict[str, List[Tuple[str, Tuple[int, ...]]]]
    by_name: Dict[str, "HloInstruction"] = dataclasses.field(
        default_factory=dict)

    def shape_of(self, operand: str):
        return self.symbols.get(operand)

    def resolved_bytes(self, operand: str, depth: int = 6) -> float:
        """Bytes of an operand, chasing through shape-preserving /
        expanding ops (broadcast/reshape/copy/bitcast/transpose/convert,
        and loop fusions of those) to the smallest tensor along the
        chain — on TPU these fuse into the consumer, so a bf16->f32
        convert of a KV cache or an 8x head up-broadcast must not
        inflate the HBM-traffic estimate."""
        shapes = self.symbols.get(operand)
        size = (sum(_nelems(s) * dtype_bytes(dt) for dt, s in shapes)
                if shapes else 0.0)
        if depth <= 0:
            return size
        ins = self.by_name.get(operand)
        if ins is None or not ins.operands:
            return size
        if ins.opcode in ("broadcast", "reshape", "copy", "bitcast",
                          "transpose", "convert", "bitcast-convert"):
            return min(size,
                       self.resolved_bytes(ins.operands[0], depth - 1))
        if ins.opcode == "fusion":
            # an expansion fusion (broadcast/convert chains) reads only
            # its operands from HBM; cap at the sum of resolved inputs.
            inp = sum(self.resolved_bytes(o, depth - 1)
                      for o in ins.operands)
            return min(size, inp) if inp > 0 else size
        return size


@dataclasses.dataclass
class HloModule:
    computations: Dict[str, HloComputation]
    entry: Optional[str]
    multipliers: Dict[str, float]
    unknown_loops: int
    fusion_internal: Dict[str, bool] = dataclasses.field(
        default_factory=dict)


def parse_hlo(text: str) -> HloModule:
    comps: Dict[str, HloComputation] = {}
    cur: Optional[HloComputation] = None
    entry = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line:
            continue
        mc = _COMP_RE.match(line)
        if mc and ("->" in line) and line.endswith("{"):
            cur = HloComputation(mc.group(1), [], {})
            comps[cur.name] = cur
            if line.lstrip().startswith("ENTRY"):
                entry = cur.name
            continue
        if line.strip() == "}":
            continue
        mi = _INSTR_RE.match(line)
        if mi and cur is not None:
            name, ret, opcode, rest = mi.groups()
            ret_shapes = _parse_shapes(ret)
            # operands live before the attr section; attrs follow ')'
            close = _find_close(rest)
            opnd_text = rest[:close]
            attr_text = rest[close:]
            operands = _OPERAND_RE.findall(opnd_text)
            callees = _CALLSITE_RE.findall(attr_text)
            mb = _BRANCHES_RE.search(attr_text)
            if mb:
                callees += _OPERAND_RE.findall(mb.group(1))
            instr = HloInstruction(name, opcode, ret_shapes, operands,
                                   callees, line)
            cur.instructions.append(instr)
            cur.symbols[name] = ret_shapes
            cur.by_name[name] = instr
    mod = HloModule(comps, entry, {}, 0)
    _propagate_multipliers(mod)
    return mod


def _find_close(s: str) -> int:
    depth = 1
    for i, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return i
    return len(s)


_DIRECTION_RE = re.compile(r"direction=([A-Z]+)")


def _const_value(comp: HloComputation, operand: str) -> Optional[int]:
    ins = comp.by_name.get(operand)
    if ins is None or ins.opcode != "constant":
        return None
    m = _CONST_RE.search(ins.line)
    return int(m.group(1)) if m else None


def _compare_bound(comp: HloComputation,
                   ins: HloInstruction) -> Optional[int]:
    """Trip count implied by one induction-variable compare against an
    s32[] constant: ``iv < c`` runs c times (iv counts from 0), ``iv
    <= c`` runs c+1, ``iv != c`` runs c; mirrored when the constant is
    on the left.  Anything else (EQ, two constants, no direction) is
    not statically recoverable here."""
    if ins.opcode != "compare" or len(ins.operands) < 2:
        return None
    md = _DIRECTION_RE.search(ins.line)
    if not md:
        return None
    d = md.group(1)
    c = _const_value(comp, ins.operands[1])
    if c is not None:                       # iv <dir> constant
        return {"LT": c, "LE": c + 1, "NE": c}.get(d)
    c = _const_value(comp, ins.operands[0])
    if c is not None:                       # constant <dir> iv
        return {"GT": c, "GE": c + 1, "NE": c}.get(d)
    return None


def _root_bound(comp: HloComputation, ins: Optional[HloInstruction],
                depth: int = 4) -> Optional[int]:
    """Chase the ROOT's producer chain to the compare that bounds the
    loop (converts/copies pass through; AND runs until the *tightest*
    clause fails, OR until the loosest)."""
    if ins is None or depth <= 0:
        return None
    op = ins.opcode
    if op == "compare":
        return _compare_bound(comp, ins)
    if op in ("convert", "copy", "bitcast", "get-tuple-element", "tuple"):
        nxt = comp.by_name.get(ins.operands[0]) if ins.operands else None
        return _root_bound(comp, nxt, depth - 1)
    if op in ("and", "or"):
        vals = [v for v in (_root_bound(comp, comp.by_name.get(o),
                                        depth - 1)
                            for o in ins.operands) if v is not None]
        if not vals:
            return None
        return min(vals) if op == "and" else max(vals)
    return None


def _trip_count(comp: HloComputation) -> Tuple[Optional[int], bool]:
    """(trip count, exact) of a while-condition computation.

    Exact path: the bound is recovered from the compare feeding the
    ROOT (``compare(iv, constant(16)), direction=LT`` -> 16), so an
    unrelated larger constant elsewhere in the condition cannot
    overcount the loop.  Fallback: the old max-s32[]-constant heuristic
    with ``exact=False`` — callers count it in ``unknown_loops``.
    """
    root = None
    for ins in comp.instructions:
        if ins.line.lstrip().startswith("ROOT"):
            root = ins
    if root is not None:
        tc = _root_bound(comp, root)
        if tc is not None:
            return tc, True
    best = None
    for ins in comp.instructions:
        for m in _CONST_RE.finditer(ins.line):
            v = int(m.group(1))
            if best is None or v > best:
                best = v
    return best, False


def _propagate_multipliers(mod: HloModule) -> None:
    mult: Dict[str, float] = defaultdict(float)
    non_fusion_parent: Dict[str, bool] = defaultdict(bool)
    if mod.entry is None:
        # fall back: every computation counted once
        mod.multipliers = {k: 1.0 for k in mod.computations}
        mod.fusion_internal = {k: False for k in mod.computations}
        return
    mult[mod.entry] = 1.0
    non_fusion_parent[mod.entry] = True
    q = deque([mod.entry])
    seen_edges = set()
    while q:
        cname = q.popleft()
        comp = mod.computations.get(cname)
        if comp is None:
            continue
        m = mult[cname]
        for ins in comp.instructions:
            if not ins.callees:
                continue
            trip = 1.0
            if ins.opcode == "while":
                cond_name = None
                mcond = re.search(r"condition=%?([\w.\-]+)", ins.line)
                if mcond:
                    cond_name = mcond.group(1)
                tc, exact = None, False
                if cond_name and cond_name in mod.computations:
                    tc, exact = _trip_count(mod.computations[cond_name])
                if tc is None:
                    mod.unknown_loops += 1
                    trip = 1.0
                else:
                    if not exact:
                        # heuristic bound: usable, but flagged so
                        # consumers can see the census is approximate
                        mod.unknown_loops += 1
                    trip = float(max(tc, 1))
            for callee in ins.callees:
                edge = (cname, ins.name, callee)
                if edge in seen_edges:
                    continue
                seen_edges.add(edge)
                mult[callee] += m * trip
                if ins.opcode != "fusion":
                    non_fusion_parent[callee] = True
                q.append(callee)
    mod.multipliers = dict(mult)
    mod.fusion_internal = {k: not non_fusion_parent[k]
                           for k in mod.computations}


# ---------------------------------------------------------------------------
# instruction classification (shared tables with mix.py HLO census)
# ---------------------------------------------------------------------------

_TRANS = {"exponential", "exponential-minus-one", "log", "log-plus-one",
          "tanh", "sine", "cosine", "rsqrt", "sqrt", "power", "logistic",
          "erf", "atan2", "cbrt", "tan"}
_VPU = {"add", "subtract", "multiply", "divide", "maximum", "minimum",
        "negate", "abs", "floor", "ceil", "round-nearest-afz",
        "round-nearest-even", "sign", "and", "or", "xor", "not",
        "shift-left", "shift-right-logical", "shift-right-arithmetic",
        "clamp", "remainder", "compare", "is-finite", "popcnt",
        "count-leading-zeros", "rng", "rng-bit-generator", "map", "clz",
        "complex", "real", "imag", "reduce-precision", "atan",
        "stochastic-convert", "exponential-no-reduce"}
_REDUCE = {"reduce", "reduce-window"}
_CTRL = {"select", "select-and-scatter", "conditional", "while", "call",
         "after-all", "add-dependency", "partition-id", "replica-id",
         "opt-barrier"}
_REG = {"broadcast", "reshape", "transpose", "convert", "bitcast",
        "bitcast-convert", "copy", "copy-start", "copy-done"}
_MEM = {"gather", "scatter", "dynamic-slice", "dynamic-update-slice",
        "slice", "concatenate", "pad", "iota", "sort", "reverse"}
_COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute",
                     "collective-broadcast", "ragged-all-to-all")
_SKIP = {"parameter", "constant", "tuple", "get-tuple-element", "fusion",
         "custom-call", "domain", "get-dimension-size", "send", "recv",
         "send-done", "recv-done", "infeed", "outfeed", "while",
         "conditional", "call"}


def _base_collective(op: str) -> Optional[str]:
    for k in _COLLECTIVE_KINDS:
        if op == k or op == k + "-start":
            return k
    return None


# ops whose I/O is plumbing, not HBM traffic (or already counted by
# their body instructions):
_PLUMBING = {"parameter", "constant", "tuple", "get-tuple-element",
             "bitcast", "while", "conditional", "call", "custom-call",
             "after-all", "add-dependency", "opt-barrier", "domain",
             "partition-id", "replica-id", "get-dimension-size"}


def _operand_bytes(ins: HloInstruction, comp: HloComputation) -> float:
    return sum(comp.resolved_bytes(o) for o in ins.operands)


def _compute_mix(ins: HloInstruction, comp: HloComputation,
                 mix: InstructionMix, scale: float) -> None:
    """FLOP-side accounting (valid inside fusions too)."""
    op = ins.opcode
    if op == "dot":
        k = 1.0
        cm = _CONTRACT_RE.search(ins.line)
        lhs = comp.shape_of(ins.operands[0]) if ins.operands else None
        if cm and lhs:
            dims = lhs[0][1]
            for i in (int(x) for x in cm.group(1).split(",") if x):
                if i < len(dims):
                    k *= dims[i]
        mix.mxu_flops += 2.0 * ins.out_elems * k * scale
    elif op == "convolution":
        rhs = comp.shape_of(ins.operands[1]) if len(ins.operands) > 1 \
            else None
        k_elems = _nelems(rhs[0][1]) if rhs else 1.0
        cout = ins.ret_shapes[0][1][-1] if ins.ret_shapes and \
            ins.ret_shapes[0][1] else 1
        mix.mxu_flops += 2.0 * ins.out_elems * max(
            k_elems / max(float(cout), 1.0), 1.0) * scale
    elif op in _TRANS:
        mix.trans_flops += ins.out_elems * scale
    elif op in _VPU:
        mix.vpu_flops += ins.out_elems * scale
    elif op in _REDUCE:
        in_sh = comp.shape_of(ins.operands[0]) if ins.operands else None
        in_elems = _nelems(in_sh[0][1]) if in_sh else ins.out_elems
        mix.vpu_flops += in_elems * scale
    elif op == "select":
        mix.ctrl_ops += ins.out_elems * scale
    elif op in _CTRL:
        mix.ctrl_ops += scale
    elif op in _REG:
        mix.reg_ops += ins.out_elems * scale
        mix.vmem_bytes += ins.out_bytes * scale
    elif op in _MEM or _base_collective(op) or op.endswith("-done") \
            or op in _SKIP:
        return
    else:
        mix.unknown_ops += 1


def module_mix(text_or_module) -> InstructionMix:
    """Loop-aware instruction mix of a compiled module (per-device).

    FLOP/transcendental/vector counts include fusion internals; HBM
    bytes follow the XLA bytes-accessed convention (operands + results
    of every *top-level* instruction — fusion boundaries, dots,
    memory-shaping ops — but not fusion internals, which stay in
    registers/VMEM), each multiplied by the statically recovered
    execution count.
    """
    mod = text_or_module if isinstance(text_or_module, HloModule) \
        else parse_hlo(text_or_module)
    mix = InstructionMix()

    def _contains_dus(fusion_ins) -> bool:
        for callee in fusion_ins.callees:
            c = mod.computations.get(callee)
            if c is not None and any(
                    i.opcode == "dynamic-update-slice"
                    for i in c.instructions):
                return True
        return False

    def _dus_io(ins, comp) -> float:
        """dynamic-update-slice writes its update region in place; the
        buffer operand is a pass-through, not HBM traffic.  Count all
        operands except the largest (the buffer), times 2 (read+write
        of the updated region)."""
        sizes = [comp.resolved_bytes(o) for o in ins.operands]
        if not sizes:
            return ins.out_bytes
        return 2.0 * (sum(sizes) - max(sizes))

    for cname, comp in mod.computations.items():
        scale = mod.multipliers.get(cname, 0.0)
        if scale <= 0:
            continue
        internal = mod.fusion_internal.get(cname, False)
        for ins in comp.instructions:
            _compute_mix(ins, comp, mix, scale)
            if internal:
                continue
            op = ins.opcode
            if op in _PLUMBING or _base_collective(op) \
                    or op.endswith("-done") or op.endswith("-start"):
                continue
            # HBM convention adapted to TPU fusion: each top-level
            # tensor is written once (out_bytes); matmul/conv operands
            # additionally stream from HBM; in-place dynamic-update-
            # slices (incl. DUS-rooted fusions — the KV-cache update
            # pattern) count their update region only.  Counting
            # operands+results of every op (XLA's convention) would
            # double-count on the CPU backend, whose single-op
            # "wrapped" fusions are far finer-grained than the TPU
            # emitter's chains.
            if op == "dynamic-update-slice":
                io = _dus_io(ins, comp)
            elif op == "fusion" and _contains_dus(ins):
                io = _dus_io(ins, comp)
            else:
                io = ins.out_bytes
                if op in ("dot", "convolution"):
                    io += _operand_bytes(ins, comp)
            mix.hbm_bytes += io * scale
            mix.mem_ops += (io / 4.0) * scale
    mix.unknown_trip_loops = mod.unknown_loops
    return mix


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HloCollective:
    kind: str
    bytes_out: float       # per execution
    executions: float      # loop-aware multiplier
    group_size: int
    computation: str


@dataclasses.dataclass
class CollectiveStats:
    by_kind_bytes: Dict[str, float]
    by_kind_count: Dict[str, float]
    total_bytes: float
    ops: List[HloCollective]

    @property
    def total_count(self) -> float:
        return sum(self.by_kind_count.values())


def collective_stats(text_or_module) -> CollectiveStats:
    """Loop-aware per-kind collective byte totals (result-shape sized,
    `-done` ops skipped so async pairs count once)."""
    mod = text_or_module if isinstance(text_or_module, HloModule) \
        else parse_hlo(text_or_module)
    by_bytes: Dict[str, float] = defaultdict(float)
    by_count: Dict[str, float] = defaultdict(float)
    ops: List[HloCollective] = []
    for cname, comp in mod.computations.items():
        scale = mod.multipliers.get(cname, 0.0)
        if scale <= 0:
            continue
        for ins in comp.instructions:
            kind = _base_collective(ins.opcode)
            if kind is None:
                continue
            nbytes = ins.out_bytes
            g = _REPL_GROUPS_RE.search(ins.line)
            group = len(g.group(1).split(",")) if g else 1
            by_bytes[kind] += nbytes * scale
            by_count[kind] += scale
            ops.append(HloCollective(kind, nbytes, scale, group, cname))
    return CollectiveStats(dict(by_bytes), dict(by_count),
                           float(sum(by_bytes.values())), ops)


# ---------------------------------------------------------------------------
# census / remat / report
# ---------------------------------------------------------------------------


def op_census(text_or_module, loop_aware: bool = True) -> Counter:
    mod = text_or_module if isinstance(text_or_module, HloModule) \
        else parse_hlo(text_or_module)
    c: Counter = Counter()
    for cname, comp in mod.computations.items():
        scale = mod.multipliers.get(cname, 0.0) if loop_aware else 1.0
        if scale <= 0:
            continue
        for ins in comp.instructions:
            c[ins.opcode] += scale if loop_aware else 1
    return c


def remat_duplication(text: str) -> Dict[str, int]:
    """op_name metadata appearing >1 time = static recompute signal."""
    c: Counter = Counter()
    for line in text.splitlines():
        m = _OPNAME_RE.search(line)
        if m:
            c[m.group(1)] += 1
    return {k: v for k, v in c.items() if v > 1}


@dataclasses.dataclass
class HloReport:
    collectives: CollectiveStats
    census: Counter
    mix: InstructionMix
    remat_dups: Dict[str, int]
    n_instructions: int

    @property
    def duplicated_instructions(self) -> int:
        return sum(v - 1 for v in self.remat_dups.values())


def analyze_hlo(hlo_text: str) -> HloReport:
    mod = parse_hlo(hlo_text)
    census = op_census(mod, loop_aware=False)
    return HloReport(
        collectives=collective_stats(mod),
        census=census,
        mix=module_mix(mod),
        remat_dups=remat_duplication(hlo_text),
        n_instructions=int(sum(census.values())),
    )
