"""Declaration-time signature binding: code-generated key builders.

The dispatch hot path used to pay, on *every* warm trace, a generic
``inspect.Signature.bind`` (or a ``tuple(sorted(signature.items()))``
spelling-normalization) just to ask "which cache line is this call?".
But a kernel's signature schema — the ordered parameter names and their
defaults — is fixed at declaration time (`repro_torch.kernels.api.KernelSpec`
derives it from the analysis builder; legacy factories from their own
``inspect.signature``).  So the binding work is compiled **once per
kernel** into two tiny generated functions:

* :func:`compile_binder` → a ``sig_key(sig) -> tuple | None`` that maps
  any valid spelling of a signature (kwarg-order permuted,
  defaults elided) to one canonical value tuple — the memo/frozen-table
  key — and returns ``None`` for invalid spellings (missing required or
  unknown names), which the caller then routes through the full
  ``normalize`` for its proper ``TypeError``.

* :func:`compile_probe` → the frozen-tier read path (DESIGN.md §12):
  a per-(kernel, mode) lookup over immutable tuple-keyed dicts with no
  locks and no generation check.  The common case — full spelling, no
  scoped target override — is a single ``operator.itemgetter`` pull and
  one dict probe, specialized at freeze time to the unscoped default
  target's subtable.

Generated code never hashes anything itself: an unhashable signature
*value* surfaces as a ``TypeError`` from the table probe, which callers
treat as "bypass the memo/frozen tier" (see `registry.lookup_or_tune`).

Schemas with ``*args`` / ``**kwargs`` / positional-only parameters or
unhashable defaults are not compilable; :func:`schema_of` returns
``None`` and the registry falls back to the legacy raw-spelling memo
key (and excludes the kernel from freezing).
"""
from __future__ import annotations

import inspect
import operator
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

__all__ = ["MISSING", "SigBinder", "schema_of", "compile_binder",
           "compile_probe"]


class _Missing:
    """Sentinel: a schema parameter with no default (required)."""

    __slots__ = ()

    def __repr__(self) -> str:          # pragma: no cover - repr only
        return "<required>"


MISSING = _Missing()

# (name, default) per parameter, declaration order; default is MISSING
# for required parameters.
Schema = Tuple[Tuple[str, Any], ...]

_BINDABLE = (inspect.Parameter.POSITIONAL_OR_KEYWORD,
             inspect.Parameter.KEYWORD_ONLY)


def schema_of(parameters: Iterable[inspect.Parameter]) -> Optional[Schema]:
    """Extract a compilable schema, or ``None`` if the signature has
    shapes the generated code cannot validate (var-args, positional-only,
    non-identifier names, unhashable defaults)."""
    out = []
    for p in parameters:
        if p.kind not in _BINDABLE:
            return None
        if not p.name.isidentifier():           # pragma: no cover - defensive
            return None
        if p.default is inspect.Parameter.empty:
            out.append((p.name, MISSING))
        else:
            try:
                hash(p.default)
            except TypeError:
                return None
            out.append((p.name, p.default))
    return tuple(out)


class SigBinder:
    """A compiled signature schema: canonical names + the key builder."""

    __slots__ = ("schema", "names", "key")

    def __init__(self, schema: Schema, key: Callable[[Dict[str, Any]],
                                                     Optional[tuple]]):
        self.schema = schema
        self.names: Tuple[str, ...] = tuple(n for n, _ in schema)
        self.key = key

    def normalized(self, signature: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Full normalized dict for a valid spelling, else ``None``."""
        vals = self.key(signature)
        if vals is None:
            return None
        return dict(zip(self.names, vals))


def _key_source(schema: Schema, fn_name: str) -> Tuple[str, Dict[str, Any]]:
    """Source + exec-namespace for the generated ``sig_key``.

    The generated function counts how many schema names the call spelled
    explicitly (``n``) vs. filled from defaults, and rejects the
    spelling unless the totals reconcile — that is what catches unknown
    keys without ever iterating the caller's dict.
    """
    ns: Dict[str, Any] = {}
    required = [(i, name) for i, (name, d) in enumerate(schema)
                if d is MISSING]
    lines = [f"def {fn_name}(sig):", "    n = len(sig)"]
    if required:
        lines.append("    try:")
        for i, name in required:
            lines.append(f"        v{i} = sig[{name!r}]")
        lines.append("    except KeyError:")
        lines.append("        return None")
    for i, (name, default) in enumerate(schema):
        if default is MISSING:
            continue
        ns[f"_d{i}"] = default
        lines.append("    try:")
        lines.append(f"        v{i} = sig[{name!r}]")
        lines.append("    except KeyError:")
        lines.append(f"        v{i} = _d{i}")
        lines.append("        n += 1")
    lines.append(f"    if n != {len(schema)}:")
    lines.append("        return None")
    vals = ", ".join(f"v{i}" for i in range(len(schema)))
    # single-element tuples need the trailing comma; empty is just ()
    lines.append(f"    return ({vals}{',' if len(schema) == 1 else ''})")
    return "\n".join(lines) + "\n", ns


def compile_binder(schema: Optional[Schema]) -> Optional[SigBinder]:
    """Compile a schema into a `SigBinder` (``None`` passes through)."""
    if schema is None:
        return None
    src, ns = _key_source(schema, "sig_key")
    exec(compile(src, "<repro_torch.tuning_cache.binder>", "exec"), ns)
    return SigBinder(schema, ns["sig_key"])


def compile_probe(binder: SigBinder,
                  subtables: Dict[str, Dict[tuple, Dict[str, Any]]],
                  default_fp: str) -> Callable[..., Optional[Dict[str, Any]]]:
    """Compile one frozen-table probe: ``probe(sig, spec=None) -> params``.

    ``subtables`` maps spec fingerprints to immutable
    ``{canonical sig tuple: params dict}`` tables; ``default_fp`` names
    the subtable the fast path is specialized to — the *unscoped*
    default target at freeze time (`repro_torch.core.target.unscoped_default`).
    The fast path fires only when the caller passed no spec **and** no
    ``use_target`` scope is active, which is exactly when the active
    target is the unscoped default; `set_default_target` thaws the whole
    frozen state via its change hook, so the specialization can never go
    stale through a supported API.

    Every hit returns a fresh ``.copy()`` of the stored params — callers
    may mutate their dict freely without poisoning later dispatches.
    Unhashable signature values raise ``TypeError`` out of the table
    probe; callers treat that as a frozen-tier miss.
    """
    from repro_torch.core.hw import resolve_target
    from repro_torch.core.target import _scoped
    from repro_torch.tuning_cache.keys import fingerprint_spec

    names = binder.names
    ns: Dict[str, Any] = {
        "_g": _scoped.get,
        "_key": binder.key,
        "_t0": subtables.get(default_fp, {}),
        "_sub": subtables,
        "_rt": resolve_target,
        "_fps": fingerprint_spec,
        "_n": len(names),
    }
    if len(names) >= 2:
        ns["_ig"] = operator.itemgetter(*names)
        fast_pull = "_ig(sig)"
    elif len(names) == 1:
        fast_pull = f"(sig[{names[0]!r}],)"
    else:
        fast_pull = "()"
    src = f"""
def probe(sig, spec=None,
          _g=_g, _key=_key, _t0=_t0, _sub=_sub, _rt=_rt, _fps=_fps, _n=_n):
    if spec is None and _g() is None:
        if len(sig) == _n:
            try:
                hit = _t0.get({fast_pull})
            except KeyError:
                hit = None
            else:
                return hit.copy() if hit is not None else None
        k = _key(sig)
        if k is None:
            return None
        hit = _t0.get(k)
        return hit.copy() if hit is not None else None
    k = _key(sig)
    if k is None:
        return None
    if spec is None:
        spec = _g()
    elif isinstance(spec, str):
        spec = _rt(spec)
    t = _sub.get(_fps(spec))
    if t is None:
        return None
    hit = t.get(k)
    return hit.copy() if hit is not None else None
"""
    exec(compile(src, "<repro_torch.tuning_cache.binder>", "exec"), ns)
    return ns["probe"]
