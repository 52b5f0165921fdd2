"""SASS census: the paper's disassembly methodology on the port's own
binaries (the card's counterpart of `repro_torch.core.hlo`).

The paper disassembles the CUDA binary (``nvdisasm``) and classifies
each instruction into FLOPS / MEM / CTRL / REG, weighting each class by
its reciprocal throughput (Table II).  This module does the same on the
``sm_90a`` SASS that ``nvcc`` builds from ``kernels/csrc`` —
``cuobjdump -sass`` output (or ``nvdisasm``'s), read into functions of
instructions (predicate, opcode with its modifiers, operands, and the
scheduling control bits of the encoding: stall cycles, yield, the
write/read scoreboard barriers and the barriers waited on — the
SASSOverlay view), split into basic blocks at branch targets and after
branches, with loops found from backward branches.

Each instruction falls into one of the pipeline tier's seven classes
(`SASS_CLASSES`, by opcode; provenance beside each row).  SASS carries
no trip count — K and the row count are runtime arguments — so
`census` takes each loop's trips from the caller (`fit_trips` reads
them off the H100 analysis of the row, i.e. off its shape), and returns
the `InstructionMix` of the launch with a per-loop census.  This is the
counterpart of `core.hlo`'s loop-aware multiplier walk.

Units, per executed warp instruction: ``mxu`` the MMA's flops
(``HGMMA.64xNx16`` is one quarter of its warpgroup's 2*64*N*16;
``HMMA.16816`` 2*16*8*16); ``vpu`` and ``reg`` 64, one issue slot of a
scheduler at the FP32 rate (2 flops x 32 lanes) the Hopper ISA table
prices both classes at; ``trans`` 32 results; ``hbm`` / ``vmem`` the
bytes the opcode's width states for 32 lanes (``LDSM.x4``: four 8x8
16-bit matrices); ``ctrl`` one event.  A TMA or bulk copy states no
width: the caller gives the bytes they move.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import re
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

from repro_torch.core.mix import InstructionMix

__all__ = ["SASS_CLASSES", "SassInstruction", "SassLoop", "SassFunction",
           "SassCensus", "parse_sass", "sass_class", "census", "fit_trips",
           "template_symbol", "find_function", "executions", "bulk_share",
           "copy_bytes", "use_sass", "active_sass"]

# opcode (before its first '.') -> (class, provenance).  Classes are the
# pipeline tier's (`repro_torch.core.isa.CLASSES`); the opcode meanings
# are the CUDA Binary Utilities' "Hopper Instruction Set" table
# (cuobjdump/nvdisasm documentation, CUDA 12), grouped by the unit that
# executes them.
_ROWS: Tuple[Tuple[str, Tuple[str, ...], str], ...] = (
    ("mxu", ("HGMMA", "HMMA", "IMMA", "QGMMA", "IGMMA", "BMMA", "DMMA"),
     "tensor-core matrix multiply-accumulate (warpgroup and warp MMA)"),
    ("trans", ("MUFU",),
     "multi-function unit: exp2, rsqrt, rcp, sin, cos, log2, tanh"),
    ("hbm", ("LDG", "STG", "RED", "ATOM", "ATOMG", "LDGSTS", "UTMALDG",
             "UTMASTG", "UTMAPF", "UBLKCP", "UBLKRED", "LD", "ST", "LDL",
             "STL", "CCTL"),
     "global, generic and local memory (local is device memory: spill "
     "traffic), cp.async (LDGSTS), TMA and bulk copies"),
    ("vmem", ("LDS", "STS", "LDSM", "STSM", "ATOMS", "REDS"),
     "shared memory: loads, stores, ldmatrix/stmatrix, shared atomics"),
    ("ctrl", ("BRA", "BRX", "BRXU", "JMP", "JMX", "CALL", "RET", "EXIT",
              "BSSY", "BSYNC", "BREAK", "BMOV", "BPT", "KILL", "WARPSYNC",
              "BAR", "SYNCS", "DEPBAR", "LDGDEPBAR", "MEMBAR", "FENCE",
              "ERRBAR", "CGAERRBAR", "UCGABAR_ARV", "UCGABAR_WAIT",
              "WARPGROUP", "ENDCOLLECTIVE", "ELECT", "YIELD", "NOP",
              "NANOSLEEP", "ACQBULK", "VOTE", "VOTEU", "MATCH"),
     "control flow, convergence, barriers, memory fences and async "
     "scoreboards"),
    ("reg", ("MOV", "UMOV", "SHFL", "PRMT", "UPRMT", "F2F", "F2FP", "S2R",
             "S2UR", "CS2R", "R2UR", "LDC", "ULDC", "P2R", "R2P", "SEL",
             "USEL", "FSEL"),
     "register moves: copies, shuffles, byte permutes, conversions, "
     "special and constant registers, selects"),
)
SASS_CLASSES: Dict[str, str] = {op: cls for cls, ops, _ in _ROWS
                                for op in ops}
SASS_PROVENANCE: Dict[str, str] = {cls: why for cls, _, why in _ROWS}


def sass_class(opcode: str) -> str:
    """The class of an opcode (``"LDG.E.128"`` -> ``"hbm"``); any opcode
    the table does not name is integer or floating-point arithmetic on
    the CUDA cores or the uniform datapath (FFMA, IMAD, IADD3, LOP3,
    ISETP, HFMA2, UIADD3, ...): ``vpu``."""
    return SASS_CLASSES.get(opcode.partition(".")[0], "vpu")


_WIDTH = {"128": 16, "64": 8, "U16": 2, "S16": 2, "U8": 1, "S8": 1}
# TMA and bulk copies: their bytes are the caller's (`census`)
_BULK = ("UTMALDG", "UTMASTG", "UBLKCP", "UBLKRED", "UTMAPF")
# opcodes whose first operand is read, not written
_NO_DEST = ("STG", "STS", "ST", "STL", "STSM", "RED", "REDS", "LDGSTS",
            "UTMASTG", "UBLKCP", "UTMALDG", "SYNCS", "BAR", "BRA", "EXIT",
            "BSYNC", "WARPSYNC", "DEPBAR")
_MMA_SHAPE = re.compile(r"^(\d+)x(\d+)x(\d+)$")
_HMMA_SHAPE = {"16816": (16, 8, 16), "1688": (16, 8, 8), "884": (8, 8, 4),
               "16832": (16, 8, 32), "8816": (8, 8, 16)}
_FLOPS = {"FFMA": 64.0, "FADD": 32.0, "FMUL": 32.0, "HFMA2": 128.0,
          "HADD2": 64.0, "HMUL2": 64.0}
_REG = re.compile(r"\b(U?R)(\d+)\b")
_PRED = re.compile(r"\b(U?P)(\d)\b")


@dataclasses.dataclass(frozen=True)
class SassInstruction:
    """One instruction: its address, guard predicate (``"@!P0"`` or
    ``""``), opcode with modifiers, operand strings and the control
    bits of its encoding (``stall`` cycles before the next issue, the
    ``yield_`` bit, the scoreboard it sets for a result (``wbar``) or
    for its sources' release (``rbar``), -1 for none, and the
    scoreboards it waits on as a bit mask); control bits are None where
    the text carries no encoding."""

    addr: int
    pred: str
    opcode: str
    operands: Tuple[str, ...]
    stall: Optional[int] = None
    yield_: Optional[bool] = None
    wbar: int = -1
    rbar: int = -1
    wait: int = 0
    # the opcode before its modifiers, and its class
    base: str = dataclasses.field(init=False, repr=False, compare=False)
    cls: str = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "base", self.opcode.partition(".")[0])
        object.__setattr__(self, "cls", SASS_CLASSES.get(self.base, "vpu"))

    def target(self) -> Optional[int]:
        """The branch target address of a BRA/BRX/CALL, else None."""
        if self.base not in ("BRA", "BRX", "CALL", "JMP"):
            return None
        for o in reversed(self.operands):
            m = re.search(r"0x([0-9a-f]+)", o)
            if m and "[" not in o:
                return int(m.group(1), 16)
        return None

    def regs(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """(registers written, registers read), each ``R<n>``, ``UR<n>``,
        ``P<n>`` or ``UP<n>``; vector results expand to their width."""
        hit = self.__dict__.get("_du")
        if hit is None:
            hit = self._def_use()
            object.__setattr__(self, "_du", hit)
        return hit

    def _def_use(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        ops = list(self.operands)
        dst: List[str] = []
        if ops and self.base not in _NO_DEST:
            first = ops[0]
            n = self._dst_width()
            for kind, idx in _REG.findall(first.split("[")[0]):
                dst += [f"{kind}{int(idx) + i}" for i in range(n)]
            for kind, idx in _PRED.findall(first):
                dst.append(f"{kind}{idx}")
            # a compare writes a second predicate (PT where unused)
            if self.base.endswith("SETP") and len(ops) > 1:
                for kind, idx in _PRED.findall(ops[1]):
                    dst.append(f"{kind}{idx}")
            ops = ops[1:] + ([first] if "[" in first else [])
        src: List[str] = []
        for o in ops:
            for kind, idx in _REG.findall(o):
                src.append(f"{kind}{idx}")
                if ".64" in o:
                    src.append(f"{kind}{int(idx) + 1}")
            for kind, idx in _PRED.findall(o):
                src.append(f"{kind}{idx}")
        for kind, idx in _PRED.findall(self.pred):
            src.append(f"{kind}{idx}")
        return tuple(dst), tuple(src)

    def _dst_width(self) -> int:
        mods = self.opcode.split(".")[1:]
        if self.base == "HGMMA":
            m = _MMA_SHAPE.match(mods[0]) if mods else None
            return int(m.group(2)) // 2 if m else 1
        if self.base == "HMMA":
            return 4 if "F32" in mods else 2
        if self.base == "LDSM":
            return int(mods[-1]) if mods and mods[-1].isdigit() else 1
        if "128" in mods:
            return 4
        if "64" in mods:
            return 2
        return 1

    def units(self, tma_bytes: float = 0.0) -> float:
        """Feature units of one execution by one warp (module docstring)."""
        base, mods = self.base, self.opcode.split(".")[1:]
        cls = self.cls
        if cls == "mxu":
            if base == "HGMMA":
                m = _MMA_SHAPE.match(mods[0]) if mods else None
                if m:
                    a, b, c = (int(g) for g in m.groups())
                    return 2.0 * a * b * c / 4.0
                return 0.0
            shape = _HMMA_SHAPE.get(mods[0] if mods else "")
            return 2.0 * shape[0] * shape[1] * shape[2] if shape else 0.0
        if cls in ("vpu", "reg"):
            return 64.0
        if cls == "trans":
            return 32.0
        if cls == "ctrl":
            return 1.0
        if base in _BULK:
            return float(tma_bytes)
        if base in ("LDSM", "STSM"):
            n = int(mods[-1]) if mods and mods[-1].isdigit() else 1
            return 128.0 * n
        width = 4
        for m in mods:
            width = _WIDTH.get(m, width)
        return 32.0 * width

    def flops(self) -> float:
        """Real FP32 flops of one warp execution: FFMA 64, FADD/FMUL 32,
        HFMA2 128, HADD2/HMUL2 64, else 0 (`fit_trips`' FP32 count);
        ``HFMA2.MMA`` is the compiler's idiom for moving a constant into
        a register, no arithmetic."""
        if self.opcode == "HFMA2.MMA":
            return 0.0
        return _FLOPS.get(self.base, 0.0)


@dataclasses.dataclass(frozen=True)
class SassLoop:
    """A natural loop: its header address, the addresses of the
    instructions in its body (the header's block and every block that
    reaches the back edge without passing the header), its nesting
    ``depth`` (0 outermost) and ``wait``: a spin loop (a scoreboard or
    barrier try-wait with no work in its body)."""

    index: int
    head: int
    addrs: frozenset = dataclasses.field(repr=False)
    depth: int = 0
    wait: bool = False

    def contains(self, addr: int) -> bool:
        return addr in self.addrs


class SassFunction:
    """One kernel's disassembly: its mangled ``name``, ``demangled``
    name, its resources from ``cuobjdump -res-usage`` (registers, stack,
    shared and local bytes; -1 where not given), and — parsed from its
    text at first use — its instructions and loops."""

    def __init__(self, name: str, text: str, demangled: str = "",
                 regs: int = -1, stack: int = -1, shared: int = -1,
                 local: int = -1):
        self.name, self.demangled = name, demangled or name
        self.regs, self.stack, self.shared, self.local = (regs, stack,
                                                          shared, local)
        self._text = text
        self._ins: Optional[List[SassInstruction]] = None
        self._loops: Optional[List[SassLoop]] = None
        self._main: Optional[Tuple[Optional[SassLoop]]] = None
        self._bodies: Dict[int, List[SassInstruction]] = {}
        self._member: Optional[List[Tuple[int, ...]]] = None

    def __repr__(self) -> str:
        return f"SassFunction({self.demangled!r}, regs={self.regs})"

    @property
    def instructions(self) -> List[SassInstruction]:
        if self._ins is None:
            self._ins = _parse_body(self._text)
        return self._ins

    @property
    def loops(self) -> List[SassLoop]:
        if self._loops is None:
            self._loops = _find_loops(self.instructions)
        return self._loops

    @property
    def spill_stores(self) -> int:
        """STL instructions: register spills to local memory."""
        return sum(1 for i in self.instructions if i.base == "STL")

    @property
    def spill_loads(self) -> int:
        return sum(1 for i in self.instructions if i.base == "LDL")

    def body(self, loop: SassLoop) -> List[SassInstruction]:
        hit = self._bodies.get(loop.index)
        if hit is None:
            hit = self._bodies[loop.index] = [
                i for i in self.instructions if loop.contains(i.addr)]
        return hit

    def membership(self) -> List[Tuple[int, ...]]:
        """Per instruction, the indices of the loops it lies in."""
        if self._member is None:
            self._member = [tuple(l.index for l in self.loops
                                  if l.contains(i.addr))
                            for i in self.instructions]
        return self._member

    def innermost(self) -> List[SassLoop]:
        """Work loops (not spin waits) that contain no other work loop."""
        work = [l for l in self.loops if not l.wait]
        return [l for l in work
                if not any(o is not l and o.addrs < l.addrs for o in work)]

    def main_loop(self) -> Optional[SassLoop]:
        """The work loop (not a spin wait) whose body, nested loops
        included, carries the most work a pass — MMA flops first, then
        FP32 flops, then bytes — the innermost of equals: the loop a
        row's K, D or KV length runs through."""
        if self._main is None:
            self._main = (self._find_main(),)
        return self._main[0]

    def _find_main(self) -> Optional[SassLoop]:
        best, key = None, None
        for loop in self.loops:
            if loop.wait:
                continue
            body = self.body(loop)
            k = (sum(i.units() for i in body if i.cls == "mxu"),
                 sum(i.flops() for i in body),
                 sum(i.units() for i in body if i.cls in ("hbm", "vmem")),
                 loop.depth)
            if key is None or k > key:
                best, key = loop, k
        return best

    def blocks(self) -> List[Tuple[int, int]]:
        """Basic blocks as (first, last) instruction addresses: leaders
        at the entry, at every branch target and after every branch or
        exit."""
        return [(b[0].addr, b[-1].addr) for b in _blocks(self.instructions)]


_ENDS = ("BRA", "BRX", "BRXU", "JMP", "JMX", "EXIT", "RET", "KILL")


def _blocks(ins: List[SassInstruction]) -> List[List[SassInstruction]]:
    leaders = {ins[0].addr} if ins else set()
    for k, i in enumerate(ins):
        t = i.target()
        if t is not None:
            leaders.add(t)
        if (i.base in _ENDS or i.base == "CALL") and k + 1 < len(ins):
            leaders.add(ins[k + 1].addr)
    out: List[List[SassInstruction]] = []
    for i in ins:
        if i.addr in leaders or not out:
            out.append([])
        out[-1].append(i)
    return out


def _find_loops(ins: List[SassInstruction]) -> List[SassLoop]:
    """Natural loops of the control-flow graph: a branch to a block that
    dominates it is a back edge.  A backward branch that is not one (an
    out-of-line slow path returning to the code it left) makes no loop;
    unreachable code (the trap after the last EXIT) has none; a CALL
    falls through, and an indirect branch has no known successor."""
    blocks = _blocks(ins)
    if not blocks:
        return []
    at = {b[0].addr: k for k, b in enumerate(blocks)}
    succ: List[List[int]] = []
    for k, b in enumerate(blocks):
        last = b[-1]
        out = []
        t = last.target()
        if t is not None and last.base != "CALL" and t in at:
            out.append(at[t])
        uncond = last.base in _ENDS and not last.pred
        if not uncond and k + 1 < len(blocks):
            out.append(k + 1)
        succ.append(out)
    n = len(blocks)
    pred: List[List[int]] = [[] for _ in range(n)]
    for k, out in enumerate(succ):
        for j in out:
            pred[j].append(k)
    # reachable blocks in reverse post-order, then iterative dominators
    order, seen, stack = [], {0}, [(0, iter(succ[0]))]
    while stack:
        node, it = stack[-1]
        nxt = next((j for j in it if j not in seen), None)
        if nxt is None:
            order.append(node)
            stack.pop()
        else:
            seen.add(nxt)
            stack.append((nxt, iter(succ[nxt])))
    order.reverse()
    rank = {b: r for r, b in enumerate(order)}
    idom = {0: 0}

    def meet(a, b):
        while a != b:
            while rank[a] > rank[b]:
                a = idom[a]
            while rank[b] > rank[a]:
                b = idom[b]
        return a

    changed = True
    while changed:
        changed = False
        for b in order[1:]:
            ps = [p for p in pred[b] if p in idom]
            if not ps:
                continue
            d = ps[0]
            for p in ps[1:]:
                d = meet(p, d)
            if idom.get(b) != d:
                idom[b], changed = d, True

    def dominates(h, b):
        while True:
            if b == h:
                return True
            if b == 0:
                return False
            b = idom[b]

    bodies: Dict[int, set] = {}
    for u in order:
        for h in succ[u]:
            if h in idom and dominates(h, u):
                body = bodies.setdefault(h, {h})
                work = [u]
                while work:
                    x = work.pop()
                    if x not in body:
                        body.add(x)
                        work += [p for p in pred[x] if p in idom]
    spans = sorted((blocks[h][0].addr, frozenset(
        i.addr for k in body for i in blocks[k])) for h, body in
        bodies.items())
    loops = []
    for k, (head, addrs) in enumerate(spans):
        body = [i for i in ins if i.addr in addrs]
        waits = any(i.base in ("SYNCS", "BAR", "WARPSYNC") for i in body)
        work = any(i.cls in ("mxu", "hbm", "vmem", "trans") for i in body)
        depth = sum(1 for _, other in spans if addrs < other)
        loops.append(SassLoop(k, head, addrs, depth, waits and not work))
    return loops


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_RES_FUNC = re.compile(r"^\s*Function\s+([^\s:]+):\s*$")
_RES = re.compile(r"REG:(\d+)\s+STACK:(\d+)\s+SHARED:(\d+)\s+LOCAL:(\d+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                    r"\s*([^;]*);(?:\s*/\*\s*0x([0-9a-f]{16})\s*\*/)?")
_HEX = re.compile(r"^\s*/\*\s*0x([0-9a-f]{16})\s*\*/\s*$")
# nvdisasm: `.text.<name>:` opens a function, `.L_x_<n>:` names a label
_NV_FUNC = re.compile(r"^\s*\.text\.(\S+?):\s*$")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_LABEL_REF = re.compile(r"`\((\.L_x_\d+)\)")


def _operands(text: str) -> Tuple[str, ...]:
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return tuple(out)


def _control(hi: int) -> Dict[str, object]:
    """Volta-and-later control bits: the top 23 bits of the 128-bit
    encoding (bits 105-125), in the second 64-bit word."""
    return dict(stall=(hi >> 41) & 0xF, yield_=bool((hi >> 45) & 1),
                wbar=((hi >> 46) & 7) if ((hi >> 46) & 7) != 7 else -1,
                rbar=((hi >> 49) & 7) if ((hi >> 49) & 7) != 7 else -1,
                wait=(hi >> 52) & 0x3F)


def parse_sass(text: str, names: Optional[Mapping[str, str]] = None
               ) -> Dict[str, SassFunction]:
    """Functions of ``cuobjdump -sass`` (or ``nvdisasm``) output, keyed
    by their mangled names, with the resources of any ``cuobjdump
    -res-usage`` output in the same text; ``names`` maps mangled to
    demangled names (``cu++filt``).  A function's instructions are read
    at first use.  nvdisasm's label operands (```(.L_x_3)``) resolve to
    the label's address."""
    res: Dict[str, Tuple[int, ...]] = {}
    chunks: Dict[str, List[str]] = {}
    cur: Optional[List[str]] = None
    res_cur: Optional[str] = None
    for line in text.splitlines():
        m = _FUNC.match(line) or _NV_FUNC.match(line)
        if m:
            cur, res_cur = chunks.setdefault(m.group(1), []), None
            continue
        m = _RES_FUNC.match(line)
        if m:
            res_cur, cur = m.group(1), None
            continue
        if res_cur is not None:
            m = _RES.search(line)
            if m:
                res[res_cur] = tuple(int(g) for g in m.groups())
                res_cur = None
        elif cur is not None:
            cur.append(line)
    return {name: SassFunction(name, "\n".join(lines),
                               (names or {}).get(name, name),
                               *res.get(name, (-1, -1, -1, -1)))
            for name, lines in chunks.items()}


def _parse_body(text: str) -> List[SassInstruction]:
    rows: List[list] = []
    labels: Dict[str, int] = {}
    pending = None
    for line in text.splitlines():
        m = _INSTR.match(line)
        if m:
            addr, pred, op, rest, _lo = m.groups()
            # the hex on the instruction's line is the low word of its
            # encoding; the control bits are in the word on the next line
            pending = [int(addr, 16), (pred or "").strip(), op,
                       _operands(rest), None]
            rows.append(pending)
            continue
        m = _HEX.match(line)
        if m and pending is not None and pending[4] is None:
            pending[4] = int(m.group(1), 16)
            continue
        m = _LABEL.match(line)
        if m:
            labels[m.group(1)] = len(rows)    # the next instruction's
    if not rows:
        return []
    addr_of = {lab: (rows[k][0] if k < len(rows) else rows[-1][0] + 16)
               for lab, k in labels.items()}
    out = []
    for addr, pred, op, ops, hi in rows:
        if addr_of:
            ops = tuple(_LABEL_REF.sub(
                lambda mm: hex(addr_of.get(mm.group(1), 0)), o) for o in ops)
        ctl = _control(hi) if hi is not None else {}
        out.append(SassInstruction(addr, pred, op, ops, **ctl))
    return out


# ---------------------------------------------------------------------------
# census
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SassCensus:
    """`census` result: the launch's mix, its instructions executed per
    class, and per loop (in `SassFunction.loops` order) the static body
    size, its classes, the static stall cycles of one pass and the
    executions of one body pass (trips times its enclosing passes)."""

    mix: InstructionMix
    issued: Dict[str, float]
    loops: List[Dict[str, object]]

    @property
    def instructions(self) -> float:
        return float(sum(self.issued.values()))


_FIELD = {"mxu": "mxu_flops", "vpu": "vpu_flops", "trans": "trans_flops",
          "hbm": "hbm_bytes", "vmem": "vmem_bytes", "ctrl": "ctrl_ops",
          "reg": "reg_ops"}


def executions(fn: SassFunction, trips: Mapping[int, float],
               warps: float) -> List[float]:
    """Executions of each instruction over the launch: ``warps`` passes
    of the code, each running an instruction the product of the trips of
    the loops around it."""
    out = []
    for member in fn.membership():
        n = warps
        for k in member:
            n *= float(trips.get(k, 1.0))
        out.append(n)
    return out


def bulk_share(fn: SassFunction, execs: List[float],
               tma_bytes: float) -> float:
    """Bytes of one TMA or bulk-copy execution: ``tma_bytes`` spread over
    the executions ``execs`` (`executions`) of the function's copies."""
    n = sum(k for i, k in zip(fn.instructions, execs) if i.base in _BULK)
    return tma_bytes / n if n else 0.0


def copy_bytes(fn: SassFunction, row_bytes: float,
               trips: Mapping[int, float], warps: float) -> float:
    """The device bytes a launch's TMA and bulk copies move: the row's
    device bytes (``row_bytes``, its analysis) past those its loads and
    stores of stated width move; 0 for a function with no copies."""
    if not any(i.base in _BULK for i in fn.instructions):
        return 0.0
    stated = sum(n * i.units() for i, n in zip(
        fn.instructions, executions(fn, trips, warps))
        if i.cls == "hbm" and i.base not in _BULK)
    return max(row_bytes - stated, 0.0)


def census(fn: SassFunction, trips: Optional[Mapping[int, float]] = None,
           *, warps: float = 1.0, tma_bytes: float = 0.0) -> SassCensus:
    """The launch's instruction census: each instruction executes once
    per warp pass (``warps`` passes: warps per block x blocks) times the
    trips of the loops around it (``trips`` by loop index, per entry; a
    loop not given runs once).  ``tma_bytes`` is the device bytes the
    launch's TMA and bulk copies move in all, spread over their
    executions."""
    trips = dict(trips or {})
    execs = executions(fn, trips, warps)
    per_bulk = bulk_share(fn, execs, tma_bytes)
    mix = InstructionMix()
    issued = {cls: 0.0 for cls in _FIELD}
    for i, n in zip(fn.instructions, execs):
        cls = i.cls
        issued[cls] += n
        field = _FIELD[cls]
        setattr(mix, field, getattr(mix, field) + n * i.units(per_bulk))
        if cls == "hbm":
            mix.mem_ops += n
    loops = []
    pos = {i.addr: k for k, i in enumerate(fn.instructions)}
    for loop in fn.loops:
        body = fn.body(loop)
        passes = execs[pos[body[0].addr]] if body else 0.0
        by_cls: Dict[str, int] = {}
        for i in body:
            by_cls[i.cls] = by_cls.get(i.cls, 0) + 1
        loops.append(dict(
            index=loop.index, head=loop.head,
            depth=loop.depth, wait=loop.wait, instructions=len(body),
            classes=by_cls, executions=passes,
            stall_cycles=sum(i.stall or 0 for i in body),
            opcodes=_top_opcodes(body)))
    return SassCensus(mix=mix, issued=issued, loops=loops)


def _top_opcodes(body: Iterable[SassInstruction], n: int = 6) -> str:
    counts: Dict[str, int] = {}
    for i in body:
        counts[i.opcode] = counts.get(i.opcode, 0) + 1
    top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
    return " ".join(f"{op}x{c}" for op, c in top)


def fit_trips(fn: SassFunction, row: InstructionMix, *,
              warps: float) -> Dict[int, float]:
    """The trips of ``fn``'s main loop (`SassFunction.main_loop`) over
    the launch, read off the row's analysis (``row``, the launch's mix
    the H100 analysis states for the row's shape): the first class the
    loop body carries of tensor-core flops, FP32 flops, device bytes
    (loads and stores of stated width) and shared bytes, divided by the
    body's amount a pass, after what the code outside the loop carries
    (``warps`` passes), per warp pass (a mean over the launch's warps:
    a loop only some warps run, as a warp-specialised kernel's, gets the
    trips that make its executions come out).  A function with no work
    loop gets ``{}``."""
    loop = fn.main_loop()
    if loop is None:
        return {}
    body = fn.body(loop)
    outside = [i for i in fn.instructions if not loop.contains(i.addr)]
    measures = (
        ("mxu_flops", lambda i: i.units() if i.cls == "mxu" else 0.0),
        ("vpu_flops", SassInstruction.flops),
        ("hbm_bytes", lambda i: i.units() if i.cls == "hbm"
         and i.base not in _BULK else 0.0),
        ("vmem_bytes", lambda i: i.units() if i.cls == "vmem" else 0.0))
    for field, measure in measures:
        per = sum(measure(i) for i in body)
        total = float(getattr(row, field))
        if per > 0 and total > 0:
            rest = warps * sum(measure(i) for i in outside)
            return {loop.index: max(total - rest, per) / per / warps}
    return {}


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

_TYPE_CODE = {"float": "f", "float32": "f", "bf16": "13__nv_bfloat16",
              "bfloat16": "13__nv_bfloat16", "int": "i", "bool": "b"}


def template_symbol(kernel: str, *args) -> str:
    """The Itanium-mangled prefix of a function template instantiation
    ``kernel<args...>``: a type argument by name (``"float"``,
    ``"bfloat16"``), an int as a non-type argument.  Every instantiation
    is unique by this prefix: the parameter list follows it."""
    parts = []
    # substitutable components, in order: the template's name, then each
    # class type (``__nv_bfloat16``); a repeat is ``S<n-1>_`` (``S_``
    # for the first), builtin types (``f``, ``i``) are never substituted
    subs = [kernel]
    for a in args:
        if isinstance(a, str):
            code = _TYPE_CODE[a]
            if len(code) == 1:
                parts.append(code)
            elif code in subs:
                k = subs.index(code)
                parts.append(f"S{k - 1}_" if k else "S_")
            else:
                subs.append(code)
                parts.append(code)
        else:
            a = int(a)
            parts.append(f"Li{a}E" if a >= 0 else f"Lin{-a}E")
    return f"_Z{len(kernel)}{kernel}I{''.join(parts)}E"


def find_function(functions: Mapping[str, SassFunction],
                  symbol: str) -> Optional[SassFunction]:
    """The function whose mangled name starts with ``symbol``
    (`template_symbol`), or None."""
    for name, fn in functions.items():
        if name.startswith(symbol):
            return fn
    return None


# ---------------------------------------------------------------------------
# the disassembly the pipeline tier reads (opt-in, scoped)
# ---------------------------------------------------------------------------

# (functions, digest) of the innermost `use_sass`
_ACTIVE: "contextvars.ContextVar[Optional[Tuple[Dict, str]]]" = \
    contextvars.ContextVar("repro_torch_sass", default=None)


def _digest(functions: Mapping[str, SassFunction]) -> str:
    """A digest of a disassembly: its function names, text sizes and
    registers (the binary a model's ranks were read from)."""
    h = hashlib.sha256()
    for name in sorted(functions):
        fn = functions[name]
        h.update(f"{name}|{len(fn._text)}|{fn.regs}\n".encode())
    return h.hexdigest()[:12]


@contextlib.contextmanager
def use_sass(functions: Mapping[str, SassFunction]
             ) -> Iterator[Dict[str, SassFunction]]:
    """Within the block, ``model="pipeline"`` prices the H100 rows of every
    kernel whose launch space names its SASS functions by their
    instruction streams in ``functions`` (`repro_torch.core.pipeline.
    stream_from_sass`), under a model whose fingerprint names this
    disassembly; outside it the rows keep their feature-row streams.
    Scoped like `repro_torch.core.target.use_target`."""
    functions = dict(functions)
    tok = _ACTIVE.set((functions, _digest(functions)))
    try:
        yield functions
    finally:
        _ACTIVE.reset(tok)


def active_sass() -> Optional[Tuple[Dict[str, SassFunction], str]]:
    """(functions, key) of the innermost `use_sass`, or None."""
    return _ACTIVE.get()
