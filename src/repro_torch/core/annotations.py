"""Orio-style annotation front-end (paper Fig. 3).

The paper's Orio integration annotates existing loops with a tuning
spec::

    /*@ begin PerfTuning (
      def performance_params {
        param TC[] = range(32,1025,32);
        param BC[] = range(24,193,24);
        param UIF[] = range(1,6);
        param CFLAGS[] = ['', '-use_fast_math'];
      }
      ...
    ) @*/

This module parses that syntax into a :class:`SearchSpace` and binds it
to a kernel builder, producing a :class:`TunableKernel` the autotuner
consumes — the same declarative workflow, with CUDA launch parameters
(or the reference's Pallas block sizes) as the annotated params.
"""
from __future__ import annotations

import ast
import re
from typing import Callable, Dict, Optional

from repro_torch.core.autotuner import KernelStaticInfo, TunableKernel
from repro_torch.core.search import SearchSpace

__all__ = ["parse_tuning_spec", "annotate", "annotate_kernel"]

_BLOCK_RE = re.compile(
    r"def\s+performance_params\s*\{(.*?)\}", re.DOTALL)
_PARAM_RE = re.compile(
    r"param\s+(\w+)\s*\[\s*\]\s*=\s*([^;]+);")
_RANGE_RE = re.compile(
    r"range\(\s*(-?\d+)\s*,\s*(-?\d+)\s*(?:,\s*(-?\d+)\s*)?\)")


def parse_tuning_spec(spec: str) -> SearchSpace:
    """Parse a PerfTuning annotation body into a SearchSpace.

    Accepts the paper's forms: ``range(a, b[, step])`` (Python range
    semantics, upper-exclusive) and bracketed literal lists (numbers or
    quoted strings).  The ``/*@ begin PerfTuning(...) @*/`` wrapper is
    optional.
    """
    body = spec
    m = _BLOCK_RE.search(spec)
    if m:
        body = m.group(1)
    axes: Dict[str, tuple] = {}
    for name, expr in _PARAM_RE.findall(body):
        expr = expr.strip()
        rm = _RANGE_RE.fullmatch(expr)
        if rm:
            a, b = int(rm.group(1)), int(rm.group(2))
            step = int(rm.group(3)) if rm.group(3) else 1
            axes[name] = tuple(range(a, b, step))
            continue
        # literal list: reuse Python's literal parser
        try:
            vals = ast.literal_eval(expr)
        except (ValueError, SyntaxError) as e:
            raise ValueError(f"cannot parse param {name!r}: {expr!r}") \
                from e
        if not isinstance(vals, (list, tuple)):
            vals = (vals,)
        axes[name] = tuple(vals)
    if not axes:
        raise ValueError("no performance_params found in spec")
    return SearchSpace(axes)


def annotate(name: str,
             spec: str,
             build: Callable[[Dict], Callable],
             static_info: Callable[[Dict], KernelStaticInfo],
             make_inputs: Callable[[], tuple],
             reference: Optional[Callable] = None) -> TunableKernel:
    """Bind a PerfTuning annotation to a kernel builder."""
    return TunableKernel(name=name, space=parse_tuning_spec(spec),
                         build=build, static_info=static_info,
                         make_inputs=make_inputs, reference=reference)


def annotate_kernel(kernel_id: str, spec: str, **declaration):
    """Bridge to the declarative kernel API: mint a full
    `repro_torch.kernels.api.KernelSpec` registration from a PerfTuning
    annotation string.

    Returns a decorator equivalent to
    ``@tuned_kernel(kernel_id, space=<parsed spec>, **declaration)`` —
    the paper's annotation workflow (Fig. 3) front-ending the whole
    static-tuning stack: dispatch, registry problem and `KernelTuner`
    packaging all derive from it.  The annotation's params become
    literal axes (``range(...)`` and bracketed lists, upper-exclusive),
    validated eagerly here so a typo'd spec fails at the declaration
    site.
    """
    parse_tuning_spec(spec)          # fail fast with the parser's error
    from repro_torch.kernels.api import tuned_kernel
    return tuned_kernel(kernel_id, space=spec, **declaration)
