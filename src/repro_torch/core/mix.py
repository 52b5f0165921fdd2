"""Instruction-mix extraction (paper §III-B): the currency of Eq. 6.

The paper disassembles the CUDA binary (``nvdisasm``) and classifies
instructions into FLOPS / MEM / CTRL / REG classes, weighting each class
by its reciprocal throughput (Table II).  The kernel analyzers of this
package derive the same classes analytically from launch parameters and
shapes; three extractors read them from a program instead:

* **a torch graph** — `trace_fn` records the aten ops a call dispatches
  on ``meta`` tensors (nothing allocated, nothing launched) and
  `mix_from_graph` classifies them: the counterpart of the reference's
  jaxpr walk (`repro.core.mix.mix_from_jaxpr`), the "PTX-level" view.
  `mix_of_fn` is the two in one call.  A tuned op is a leaf: its
  kernel's own input and output bytes plus the H100 analysis' mix of the
  row dispatch would launch, as the reference counts a ``pallas_call``.
* **HLO text** — `mix_from_hlo_text` and `mix_from_cost_analysis`, the
  reference's line for line, so the two packages read one compiled XLA
  module to the same numbers.
* **SASS** — the card's own binary: `repro_torch.core.sass`.

Categories:

=============  ===========================================================
mxu_flops      matrix-unit FLOPs (2*M*N*K counting)
vpu_flops      elementwise/reduction vector ALU ops (one per output elem)
trans_flops    transcendental elementwise ops (exp/log/tanh/...)
hbm_bytes      bytes moved to/from device memory
vmem_bytes     bytes streamed through on-core memory
mem_ops        count of memory *operations* (paper's O_mem, for intensity)
ctrl_ops       predication/select/control-flow events (paper's O_ctrl)
reg_ops        moves: broadcast/transpose/reshape/convert (paper's O_reg)
=============  ===========================================================
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import weakref
from contextvars import ContextVar
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hw import dtype_bytes

__all__ = [
    "InstructionMix",
    "TracedOp",
    "TorchGraph",
    "trace_fn",
    "live_bytes",
    "mix_from_graph",
    "mix_of_fn",
    "mix_from_hlo_text",
    "mix_from_cost_analysis",
    "intensity",
    "classify_boundedness",
]


@dataclasses.dataclass
class InstructionMix:
    mxu_flops: float = 0.0
    vpu_flops: float = 0.0
    trans_flops: float = 0.0
    hbm_bytes: float = 0.0
    vmem_bytes: float = 0.0
    mem_ops: float = 0.0
    ctrl_ops: float = 0.0
    reg_ops: float = 0.0
    # bookkeeping
    unknown_ops: int = 0
    unknown_trip_loops: int = 0

    # -- algebra ------------------------------------------------------------
    def __add__(self, other: "InstructionMix") -> "InstructionMix":
        return InstructionMix(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(self)
        })

    def scaled(self, k: float) -> "InstructionMix":
        out = InstructionMix(**{
            f.name: getattr(self, f.name) * k for f in dataclasses.fields(self)
        })
        out.unknown_ops = int(self.unknown_ops * k)
        out.unknown_trip_loops = int(self.unknown_trip_loops * k)
        return out

    # -- views --------------------------------------------------------------
    @property
    def flops_total(self) -> float:
        return self.mxu_flops + self.vpu_flops + self.trans_flops

    @property
    def o_fl(self) -> float:          # paper O_fl
        return self.flops_total

    @property
    def o_mem(self) -> float:         # paper O_mem
        return self.mem_ops

    @property
    def o_ctrl(self) -> float:        # paper O_ctrl
        return self.ctrl_ops

    @property
    def o_reg(self) -> float:         # paper O_reg
        return self.reg_ops

    def as_dict(self) -> Dict[str, float]:
        return {f.name: float(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    def __repr__(self) -> str:  # compact for logs
        return ("Mix(mxu={:.3g}, vpu={:.3g}, trans={:.3g}, hbm_B={:.3g}, "
                "mem_ops={:.3g}, ctrl={:.3g}, reg={:.3g}, I={:.2f})").format(
                    self.mxu_flops, self.vpu_flops, self.trans_flops,
                    self.hbm_bytes, self.mem_ops, self.ctrl_ops, self.reg_ops,
                    intensity(self))


def intensity(mix: InstructionMix) -> float:
    """Paper's computational intensity: FLOPs per memory operation."""
    return mix.flops_total / max(1.0, mix.mem_ops)


def classify_boundedness(mix: InstructionMix, threshold: float = 4.0) -> str:
    """Rule-based classification; threshold 4.0 is the paper's §III-C value."""
    i = intensity(mix)
    if i > threshold:
        return "compute_bound"
    if i > threshold / 2:
        return "balanced"
    return "memory_bound"


# ---------------------------------------------------------------------------
# torch-graph extraction (the counterpart of the reference's jaxpr walk)
# ---------------------------------------------------------------------------

# aten op families by overload-packet name (in-place ``_`` suffix
# dropped), mirroring the reference's jaxpr primitive tables
_T_MXU = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
          "vdot", "linear", "convolution", "_convolution"}
_T_TRANS = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
            "sigmoid", "tanh", "tan", "sin", "cos", "asin", "acos", "atan",
            "atan2", "sinh", "cosh", "asinh", "acosh", "atanh", "erf",
            "erfc", "erfinv", "rsqrt", "sqrt", "pow", "digamma", "lgamma",
            "logit"}
# composite activations: (transcendentals, vector ops) per output element,
# as the reference's jaxpr spells them out (``jax.nn.softmax``: max, sub,
# exp, sum, div; gelu's tanh form: a cube (``integer_pow``, which the
# reference counts as transcendental) and a tanh among six mul/adds, its
# erf form an erf among four; silu: logistic and a mul)
_T_COMPOSITE = {"_softmax": (1, 4), "silu": (1, 1),
                ("gelu", "tanh"): (2, 6), ("gelu", "none"): (1, 4)}
_T_VPU = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum",
          "minimum", "clamp", "clamp_min", "clamp_max", "floor", "ceil",
          "round", "trunc", "sign", "remainder", "fmod", "bitwise_and",
          "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
          "logical_or", "logical_xor", "logical_not", "eq", "ne", "lt",
          "le", "gt", "ge", "isfinite", "isnan", "isinf", "square",
          "reciprocal", "relu", "threshold", "lerp", "addcmul", "addcdiv",
          "hardtanh", "leaky_relu", "bernoulli", "uniform", "normal",
          "random"}
_T_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
             "argmin", "cumsum", "cumprod", "logsumexp", "all", "any",
             "linalg_vector_norm", "norm", "var", "std", "var_mean",
             "sumsq"}
# the optimizer's one-pass kernels (`optim.adamw`'s custom ops):
# (transcendentals, vector ops) per element of a leaf's AdamW step, the
# eager version's sqrt and fifteen multiplies, adds and divides; it
# reads p, g, m, v and writes p, m, v in place
_T_FUSED = {"adamw": (1, 15)}
_T_CTRL = {"where", "masked_fill"}
# casts and fills write every element (the reference's
# ``convert_element_type`` / ``broadcast_in_dim``); views write none
# (torch's ``einsum`` spells a contraction as permutes and views around
# ``bmm`` where XLA's ``dot_general`` carries dimension numbers), so a
# view is one register event
_T_REG = {"_to_copy", "full", "zeros", "ones", "full_like", "zeros_like",
          "ones_like", "fill", "scalar_tensor", "lift_fresh_copy"}
_T_VIEW = {"view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
           "permute", "transpose", "t", "squeeze", "unsqueeze", "flatten",
           "unflatten", "slice", "select", "split", "split_with_sizes",
           "chunk", "narrow", "unbind", "as_strided", "alias", "detach",
           "lift_fresh", "view_as_real", "view_as_complex", "diagonal"}
_T_MEM = {"index", "_unsafe_index", "index_select", "gather", "embedding",
          "cat", "stack", "constant_pad_nd", "arange", "clone", "copy",
          "repeat", "repeat_interleave", "roll", "flip", "sort", "topk",
          "take", "tril", "triu", "masked_select", "nonzero"}
# memory ops that also read the buffer they update (the reference's
# ``scatter*`` rule: result bytes plus input bytes)
_T_SCATTER = {"scatter", "scatter_add", "scatter_reduce", "index_put",
              "index_add", "index_copy", "index_fill", "slice_scatter",
              "select_scatter", "diagonal_scatter", "masked_scatter"}
# allocation and bookkeeping: no work
_T_SKIP = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided", "resize", "set", "_local_scalar_dense",
           "is_same_size", "_has_compatible_shallow_copy_type",
           "record_stream", "sym_size", "sym_stride", "sym_numel",
           "wait_tensor"}

# a DTensor's collectives as a traced rank sees them (the functional
# collectives, and DTensor's own all-to-all that moves a shard from one
# tensor dim to another); as in the HLO mix, each moves its output
# through HBM
_T_COLLECTIVE = {"all_reduce": "all-reduce",
                 "all_reduce_coalesced": "all-reduce",
                 "all_gather_into_tensor": "all-gather",
                 "all_gather_into_tensor_coalesced": "all-gather",
                 "reduce_scatter_tensor": "reduce-scatter",
                 "reduce_scatter_tensor_coalesced": "reduce-scatter",
                 "all_to_all_single": "all-to-all",
                 "shard_dim_alltoall": "all-to-all"}

_Shape = Tuple[Tuple[int, ...], str]


@dataclasses.dataclass(frozen=True)
class TracedOp:
    """One recorded call: an aten op by overload-packet name with its
    tensor inputs and outputs as ``(shape, dtype)`` pairs and its
    string-valued keywords, or a tuned-op leaf (``kernel`` its id,
    ``signature`` its dispatch signature as sorted items)."""

    name: str
    inputs: Tuple[_Shape, ...]
    outputs: Tuple[_Shape, ...]
    attrs: Tuple[Tuple[str, str], ...] = ()
    kernel: Optional[str] = None
    signature: Optional[Tuple[Tuple[str, Any], ...]] = None


@dataclasses.dataclass
class TorchGraph:
    """The ops one call dispatched, in order (`trace_fn`)."""

    ops: List[TracedOp]

    def cost_analysis(self, spec=None) -> Dict[str, float]:
        """``compiled.cost_analysis()``'s keys over this graph: every
        FLOP, the transcendentals and the device bytes of its mix (what
        `repro_torch.core.roofline.roofline_from_artifacts` and
        `mix_from_cost_analysis` take as ``cost``)."""
        mix = mix_from_graph(self, spec=spec)
        return {"flops": mix.mxu_flops + mix.vpu_flops,
                "transcendentals": mix.trans_flops,
                "bytes accessed": mix.hbm_bytes}


def _shapes(tree) -> Tuple[_Shape, ...]:
    import torch
    from torch.utils._pytree import tree_leaves
    return tuple((tuple(t.shape), str(t.dtype).rpartition(".")[2])
                 for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class LiveBytes:
    """The bytes of the local storages alive while a meta trace runs
    (`live_bytes`): each storage an op makes counts from that op until
    it is freed, and the peak is kept.  Storages of ``keep`` (a step's
    arguments) are known from the start and not counted.

    `at_peak` names the storages alive at the peak, each with the op
    that made it: a storage made before the peak and freed after it
    is kept aside when it goes, until a higher peak drops it."""

    def __init__(self, keep=()):
        self.live = self.peak = 0
        self._n = self._peak_at = 0
        # id of each live storage -> (serial, bytes, op, shape, dtype)
        self._held: Dict[int, Tuple] = {}
        self._gone: List[Tuple] = []     # alive at the peak, freed since
        self._keep = [t.untyped_storage() for t in keep]
        self._kept = {id(st) for st in self._keep}

    def add(self, t, op: str = "") -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held or key in self._kept:
            return
        n = st.nbytes()
        self._n += 1
        self._held[key] = (self._n, n, op, tuple(t.shape),
                           str(t.dtype).rpartition(".")[2])
        self.live += n
        if self.live > self.peak:
            self.peak, self._peak_at, self._gone = self.live, self._n, []
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        held = self._held.pop(key)
        self.live -= held[1]
        if held[0] <= self._peak_at:
            self._gone.append(held)

    def at_peak(self, top: int = 10) -> List[Dict[str, Any]]:
        """The ``top`` largest storages alive at the peak, largest
        first: the op that made each (aten name), the shape and dtype
        it was made with, and its bytes."""
        rows = self._gone + [h for h in self._held.values()
                             if h[0] <= self._peak_at]
        rows.sort(key=lambda h: (-h[1], h[0]))
        return [{"op": op, "shape": list(shape), "dtype": dtype,
                 "bytes": int(n)} for _, n, op, shape, dtype in rows[:top]]


_LIVE: "ContextVar[Optional[LiveBytes]]" = ContextVar(
    "repro_torch_live_bytes", default=None)


@contextlib.contextmanager
def live_bytes(keep=()):
    """Within it, `trace_meta_fn` counts the storages its ops make
    (`LiveBytes`, yielded)."""
    lb = LiveBytes(keep)
    tok = _LIVE.set(lb)
    try:
        yield lb
    finally:
        _LIVE.reset(tok)


def _recorder(ops: List[TracedOp], move: bool = True):
    """A dispatch mode that runs every aten op on ``meta`` tensors (real
    inputs and factory devices are moved there first) and appends it to
    ``ops``.  With ``move=False`` nothing is moved: ops on ``meta``
    tensors are recorded, the rest (a device mesh's own bookkeeping on
    host tensors) run as they are, unrecorded."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map

    meta = torch.device("meta")

    def to_meta(t):
        if isinstance(t, torch.Tensor) and t.device.type != "meta":
            return t.to(meta)
        return t

    composite = torch._C.DispatchKey.CompositeImplicitAutograd

    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                # a DTensor op runs as its local ops and collectives on
                # each rank's shards, which come back here one by one:
                # the trace is the per-device program
                return NotImplemented
            if any(issubclass(t, FakeTensor) for t in types):
                # DTensor's shape propagation on the global shapes: not
                # part of any device's program
                return func(*args, **(kwargs or {}))
            if not move:
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                live = _LIVE.get()
                if live is not None:
                    for t in tree_leaves(out):
                        if isinstance(t, torch.Tensor) and \
                                t.device.type == "meta":
                            live.add(t, func.overloadpacket.__name__)
                if any(t.device.type == "meta" for t in tree_leaves(
                        (args, kwargs, out)) if isinstance(t, torch.Tensor)):
                    ops.append(TracedOp(
                        name=func.overloadpacket.__name__,
                        inputs=_shapes((args, kwargs)), outputs=_shapes(out),
                        attrs=tuple(sorted((k, v) for k, v in kwargs.items()
                                           if isinstance(v, str)))))
                return out
            args, kwargs = tree_map(to_meta, (args, kwargs or {}))
            if kwargs.get("device") is not None:
                kwargs["device"] = meta
            # under inference_mode a composite op (einsum, softmax, to,
            # ...) reaches the mode whole: record what it decomposes to,
            # as it runs outside inference_mode
            if torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), composite):
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            ops.append(TracedOp(
                name=name, inputs=_shapes((args, kwargs)),
                outputs=_shapes(out),
                attrs=tuple(sorted((k, v) for k, v in kwargs.items()
                                   if isinstance(v, str)))))
            return out

    return _Recorder()


class _LeafSink:
    """The dispatch layer's collector while `trace_fn` runs: a tuned op
    records itself as one leaf and returns ``meta`` outputs (no params
    resolved, nothing built, launched or run of its plain version)."""

    def __init__(self, ops: List[TracedOp]):
        self.ops = ops

    def record(self, spec, sig, args, kw):
        out = spec.meta_out(*args, **kw)
        self.ops.append(TracedOp(
            name=spec.kernel_id, inputs=_shapes(args), outputs=_shapes(out),
            kernel=spec.kernel_id,
            signature=tuple(sorted(sig.items()))))
        return out


def _trace(fn, args, kwargs, move: bool) -> TorchGraph:
    from repro_torch.kernels import api
    ops: List[TracedOp] = []
    tok = api._COLLECT.set(_LeafSink(ops))
    try:
        with _recorder(ops, move=move):
            fn(*args, **kwargs)
    finally:
        api._COLLECT.reset(tok)
    return TorchGraph(ops)


def trace_meta_fn(fn, *args, **kwargs) -> TorchGraph:
    """`trace_fn` for a call whose tensors are already ``meta`` — DTensors
    with ``meta`` shards on a (fake) device mesh — recording only the ops
    on ``meta`` tensors: each DTensor op as the local ops and
    collectives of this rank's shards, the per-device program."""
    return _trace(fn, args, kwargs, move=False)


def trace_fn(fn, *args, **kwargs) -> TorchGraph:
    """Record the aten ops ``fn(*args, **kwargs)`` dispatches, with no
    execution: every op runs on ``meta`` tensors (tensor arguments on
    another device are moved there as they are used), and each tuned op
    (`repro_torch.kernels.api`) is recorded as one leaf."""
    return _trace(fn, args, kwargs, move=True)


def _elems(shapes) -> float:
    return float(sum(np.prod(s) if s else 1.0 for s, _ in shapes))


def _nbytes(shapes) -> float:
    return float(sum((np.prod(s) if s else 1.0) * dtype_bytes(dt)
                     for s, dt in shapes))


def _matmul_flops(name: str, ins: Tuple[_Shape, ...],
                  outs: Tuple[_Shape, ...]) -> float:
    """2 * (output elements) * (contracted length) for the aten matrix
    products: the contraction is the last dim of the first matrix
    operand (``linear``: of its input; ``convolution``: the weight's
    elements per output channel)."""
    out = _elems(outs[:1])
    if name in ("convolution", "_convolution"):
        w = ins[1][0]
        return 2.0 * out * max(float(np.prod(w)) / max(float(w[0]), 1.0),
                               1.0)
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        ins = ins[1:]
    k = ins[0][0][-1] if ins[0][0] else 1
    return 2.0 * out * float(k)


def mix_from_graph(graph: TorchGraph, *, spec=None) -> InstructionMix:
    """Accumulate the static instruction mix of a traced call, with the
    categories of the reference's `mix_from_jaxpr`: matrix products to
    ``mxu`` (2*M*N*K, operand and result bytes to HBM), transcendental
    elementwise ops to ``trans``, elementwise and reduction ops to
    ``vpu``, selects to ``ctrl``, casts and fills (per element) and
    views (one event each) to ``reg``,
    gathers, index, concatenation and copies to ``hbm``; an op in none
    of these counts in ``unknown_ops`` (and ``ctrl_ops``, as the
    reference's fallback does).

    A tuned-op leaf counts as the reference counts a ``pallas_call``:
    the body mix of the row dispatch picks for its signature under
    ``spec`` (default: the H100), i.e. the H100 analysis' flops, shared
    bytes and launches of that row, plus the kernel's own input and
    output bytes as device traffic (the row's device bytes where they
    exceed those: re-read tiles).
    """
    mix = InstructionMix()
    picks: Dict[Tuple, InstructionMix] = {}
    for op in graph.ops:
        if op.kernel is not None:
            key = (op.kernel, op.signature)
            body = picks.get(key)
            if body is None:
                body = picks[key] = _leaf_body(op, spec)
            io = _nbytes(op.inputs) + _nbytes(op.outputs)
            leaf = dataclasses.replace(body, hbm_bytes=max(io,
                                                           body.hbm_bytes))
            leaf.mem_ops += _elems(op.outputs)
            mix = mix + leaf
            continue
        name = op.name.rstrip("_")      # in-place spelling
        out_e, out_b = _elems(op.outputs), _nbytes(op.outputs)
        in_b = _nbytes(op.inputs)
        attrs = dict(op.attrs)
        comp = _T_COMPOSITE.get((name, attrs.get("approximate", "none"))) \
            or _T_COMPOSITE.get(name)
        if name in _T_SKIP:
            continue
        if name in _T_MXU:
            mix.mxu_flops += _matmul_flops(name, op.inputs, op.outputs)
            mix.hbm_bytes += in_b + out_b
            mix.mem_ops += _elems(op.inputs) + out_e
        elif comp is not None:
            mix.trans_flops += comp[0] * out_e
            mix.vpu_flops += comp[1] * out_e
            mix.vmem_bytes += in_b + out_b
        elif name in _T_TRANS:
            mix.trans_flops += out_e
            mix.vmem_bytes += out_b * 2
            _broadcasts(mix, op, out_e)
        elif name in _T_VPU:
            mix.vpu_flops += out_e
            mix.vmem_bytes += in_b + out_b
            _broadcasts(mix, op, out_e)
        elif name in _T_REDUCE:
            mix.vpu_flops += _elems(op.inputs[:1])
            mix.vmem_bytes += in_b + out_b
        elif name in _T_FUSED:
            n = _elems(op.inputs[:1])
            mix.trans_flops += _T_FUSED[name][0] * n
            mix.vpu_flops += _T_FUSED[name][1] * n
            mix.vmem_bytes += (in_b + _nbytes(op.inputs[:1])
                               + _nbytes(op.inputs[2:4]))
        elif name in _T_CTRL:
            mix.ctrl_ops += out_e
            _broadcasts(mix, op, out_e)
        elif name in _T_REG:
            mix.reg_ops += out_e
            mix.vmem_bytes += out_b
        elif name in _T_VIEW:
            mix.reg_ops += 1
        elif name in _T_COLLECTIVE:
            mix.hbm_bytes += out_b
            mix.mem_ops += out_e
        elif name in _T_MEM or name in _T_SCATTER:
            mix.hbm_bytes += out_b + (in_b if name in _T_SCATTER else 0.0)
            mix.mem_ops += out_e
        else:
            mix.ctrl_ops += 1
            mix.unknown_ops += 1
    return mix


def _broadcasts(mix: InstructionMix, op: TracedOp, out_e: float) -> None:
    """An elementwise op broadcasts a smaller tensor operand implicitly;
    the reference's jaxpr spells that as a ``broadcast_in_dim`` to the
    result's shape (a ``reg`` op of the result's elements)."""
    nbytes = _nbytes(op.outputs[:1]) / max(_elems(op.outputs[:1]), 1.0)
    for shape, _ in op.inputs:
        n = float(np.prod(shape)) if shape else 1.0
        if 1.0 < n < out_e:
            mix.reg_ops += out_e
            mix.vmem_bytes += out_e * nbytes


def _leaf_body(op: TracedOp, spec) -> InstructionMix:
    """The H100 analysis' mix of the row dispatch picks for a leaf."""
    from repro_torch import tuning_cache
    from repro_torch.core.hw import H100_SXM, HopperSpec, resolve_target
    from repro_torch.kernels import api
    spec = H100_SXM if spec is None else resolve_target(spec)
    if not isinstance(spec, HopperSpec):
        raise TypeError(f"mix_from_graph prices tuned-op leaves with the "
                        f"H100 analysis; got the target {spec.name!r}")
    sig = dict(op.signature)
    params = tuning_cache.lookup_or_tune(op.kernel, spec=spec, **sig)
    info = api.get_spec(op.kernel).hopper_static_info(params, spec, **sig)
    return dataclasses.replace(info.mix)


def mix_of_fn(fn, *args, **kwargs) -> InstructionMix:
    """Static mix of ``fn(*args, **kwargs)`` via `trace_fn` (no
    execution), tuned-op leaves priced under the H100."""
    return mix_from_graph(trace_fn(fn, *args, **kwargs))


# ---------------------------------------------------------------------------
# HLO-text-level extraction (the "disassembly" view)
# ---------------------------------------------------------------------------

# %name = bf16[128,256]{1,0} opcode(...)
_HLO_INSTR_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([0-9,]*)\][^\s]*\s+([a-z][a-z0-9\-]*)\(")
_HLO_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")

_HLO_TRANS = {"exponential", "exponential-minus-one", "log", "log-plus-one",
              "tanh", "sine", "cosine", "rsqrt", "sqrt", "power", "logistic",
              "erf", "atan2", "cbrt", "tan"}
_HLO_VPU = {"add", "subtract", "multiply", "divide", "maximum", "minimum",
            "negate", "abs", "floor", "ceil", "round-nearest-afz",
            "round-nearest-even", "sign", "and", "or", "xor", "not",
            "shift-left", "shift-right-logical", "shift-right-arithmetic",
            "clamp", "remainder", "compare", "is-finite", "popcnt",
            "count-leading-zeros", "rng", "rng-bit-generator", "map",
            "clz", "complex", "real", "imag", "reduce-precision", "atan",
            "stochastic-convert"}
_HLO_REDUCE = {"reduce", "reduce-window"}
_HLO_CTRL = {"select", "select-and-scatter", "conditional", "while",
             "call", "after-all", "add-dependency", "partition-id",
             "replica-id", "opt-barrier"}
_HLO_REG = {"broadcast", "reshape", "transpose", "convert", "bitcast",
            "bitcast-convert", "copy", "copy-start", "copy-done", "tuple",
            "get-tuple-element"}
_HLO_MEM = {"gather", "scatter", "dynamic-slice", "dynamic-update-slice",
            "slice", "concatenate", "pad", "iota", "sort", "reverse",
            "dot-as-gather"}
_HLO_COLLECTIVE = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute", "all-gather-start", "all-reduce-start",
                   "collective-permute-start", "all-gather-done",
                   "all-reduce-done", "collective-permute-done",
                   "ragged-all-to-all", "collective-broadcast"}
_HLO_SKIP = {"parameter", "constant", "fusion", "custom-call",
             "get-dimension-size", "domain", "send", "recv", "send-done",
             "recv-done", "infeed", "outfeed"}


def _shape_elems(dims: str) -> float:
    if not dims:
        return 1.0
    return float(np.prod([int(d) for d in dims.split(",") if d]))


def mix_from_hlo_text(text: str) -> InstructionMix:
    """Census over every instruction line in an HLO module dump.

    Fused computations appear as their own blocks in the dump, so ops
    inside fusions are counted (the ``fusion`` caller line is skipped as
    a container).  This is the post-optimization "SASS-level" mix.
    """
    mix = InstructionMix()
    for line in text.splitlines():
        m = _HLO_INSTR_RE.search(line)
        if not m:
            continue
        dtype, dims, opcode = m.group(1), m.group(2), m.group(3)
        out_elems = _shape_elems(dims)
        out_bytes = out_elems * dtype_bytes(dtype)

        if opcode in _HLO_SKIP:
            continue
        if opcode == "dot":
            cm = _CONTRACT_RE.search(line)
            # contraction size: product of lhs dims listed
            shapes = _HLO_SHAPE_RE.findall(line[m.end() - 1:])
            k = 1.0
            if cm and shapes:
                lhs_dims = [int(x) for x in shapes[0][1].split(",") if x]
                idxs = [int(x) for x in cm.group(1).split(",") if x]
                for i in idxs:
                    if i < len(lhs_dims):
                        k *= lhs_dims[i]
            mix.mxu_flops += 2.0 * out_elems * k
            for dt, ds in shapes[:2]:
                mix.hbm_bytes += _shape_elems(ds) * dtype_bytes(dt)
                mix.mem_ops += _shape_elems(ds)
            mix.hbm_bytes += out_bytes
            mix.mem_ops += out_elems
        elif opcode == "convolution":
            shapes = _HLO_SHAPE_RE.findall(line[m.end() - 1:])
            k_elems = _shape_elems(shapes[1][1]) if len(shapes) > 1 else 1.0
            mix.mxu_flops += 2.0 * out_elems * max(1.0, k_elems / max(out_elems, 1.0))
            mix.hbm_bytes += out_bytes + sum(
                _shape_elems(ds) * dtype_bytes(dt) for dt, ds in shapes[:2])
            mix.mem_ops += out_elems
        elif opcode in _HLO_TRANS:
            mix.trans_flops += out_elems
            mix.vmem_bytes += out_bytes * 2
        elif opcode in _HLO_VPU:
            mix.vpu_flops += out_elems
            mix.vmem_bytes += out_bytes * 2
        elif opcode in _HLO_REDUCE:
            shapes = _HLO_SHAPE_RE.findall(line[m.end() - 1:])
            in_elems = _shape_elems(shapes[0][1]) if shapes else out_elems
            mix.vpu_flops += in_elems
            mix.vmem_bytes += in_elems * dtype_bytes(dtype)
        elif opcode in _HLO_CTRL:
            mix.ctrl_ops += out_elems if opcode == "select" else 1.0
        elif opcode in _HLO_REG:
            if opcode in ("tuple", "get-tuple-element"):
                continue
            mix.reg_ops += out_elems
            mix.vmem_bytes += out_bytes
        elif opcode in _HLO_MEM:
            mix.hbm_bytes += out_bytes
            mix.mem_ops += out_elems
        elif opcode in _HLO_COLLECTIVE:
            mix.hbm_bytes += out_bytes
            mix.mem_ops += out_elems
            mix.ctrl_ops += 1.0
        else:
            mix.unknown_ops += 1
    return mix


def mix_from_cost_analysis(cost: Optional[Dict[str, Any]]) -> InstructionMix:
    """Coarse mix from ``compiled.cost_analysis()`` (flops + bytes accessed)."""
    mix = InstructionMix()
    if not cost:
        return mix
    mix.mxu_flops = float(cost.get("flops", 0.0) or 0.0)
    mix.trans_flops = float(cost.get("transcendentals", 0.0) or 0.0)
    mix.hbm_bytes = float(cost.get("bytes accessed", 0.0) or 0.0)
    mix.mem_ops = mix.hbm_bytes / 4.0
    return mix
