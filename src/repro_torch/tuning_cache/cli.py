"""Tuning-database CLI.

    # dump a disk database (default: $REPRO_TUNING_CACHE_DIR or .tuning_cache)
    PYTHONPATH=src python -m repro_torch.tuning_cache export --out db.jsonl

    # load a shipped JSONL into a disk database
    PYTHONPATH=src python -m repro_torch.tuning_cache import --path db.jsonl

    # inspect what is stored
    PYTHONPATH=src python -m repro_torch.tuning_cache show

    # pre-tune one kernel instance into the database
    PYTHONPATH=src python -m repro_torch.tuning_cache tune \
        --kernel matmul --sig m=1024 n=1024 k=1024 dtype=float32

    # sweep the default shape grid for one chip and regenerate its
    # shipped database (default --out: pretuned/<target>.jsonl)
    PYTHONPATH=src python -m repro_torch.tuning_cache pretune --target tpu-v5p

    # regenerate every shipped per-target database in one command ...
    PYTHONPATH=src python -m repro_torch.tuning_cache pretune --all-targets

    # ... or prove each shipped JSONL is regenerable bit-for-bit
    PYTHONPATH=src python -m repro_torch.tuning_cache pretune --verify --all-targets

    # rank every kernel instance one serving config dispatches, on the
    # meta device (nothing runs), into a database, then export it
    PYTHONPATH=src python -m repro_torch.tuning_cache --db /tmp/db \
        pretune --config gemma-7b --target h100-sxm --batch 4
    PYTHONPATH=src python -m repro_torch.tuning_cache --db /tmp/db \
        export --out gemma.jsonl

    # serve the database to a fleet over HTTP (ready line on stdout)
    PYTHONPATH=src python -m repro_torch.tuning_cache serve --port 0 \
        --warm-jsonl gemma.jsonl

`pretune` (or `tune` + `export` per instance) is how the in-repo
pre-tuned databases under ``src/repro_torch/tuning_cache/pretuned/`` are
produced; `import` (or `launch/serve.py --tuning-db`) is how they are
consumed, and `serve` (with `launch/serve.py --tuning-server`) how a
fleet shares one.  The six reference targets' files are the reference's
byte for byte; ``h100_sxm.jsonl`` ranks the same declared grid over the
H100's compiled tile tables.  `tune` accepts ``--target`` too; omitted,
every command runs against the process-default target
(``REPRO_TUNING_TARGET`` / detected card / v5e).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.hw import resolve_target
from repro_torch.tuning_cache import (ENV_DB_DIR, TuningDatabase, get_problem,
                                lookup_or_tune, pretuned_path, registered)

DEFAULT_DB_DIR = ".tuning_cache"

# Chips we ship a pretuned database for (pretuned/<name>.jsonl each).
# Every spec family: TPU targets rank Pallas block spaces, the paper's
# Table I GPUs rank CUDA thread-block spaces (DESIGN.md §11), and the
# H100 ranks the compiled tile tables of the port's CUDA kernels.
SHIPPED_TARGETS = ("tpu-v5e", "tpu-v5p", "tpu-v6e",
                   "fermi-m2050", "kepler-k20", "maxwell-m40", "h100-sxm")

# The production shape grid behind `pretune` — every signature the
# shipped pretuned databases cover — is *declared*, not listed here:
# each `@tuned_kernel` carries its own ``pretune=`` signatures, so a
# new decorated workload joins the shipped grid with zero CLI edits.
# Each instance is one vectorized full-space rank (`rank_space` batch
# path), so regenerating the whole grid is sub-second.


def default_pretune_cases() -> List[Tuple[str, Dict[str, Any]]]:
    import repro_torch.kernels  # noqa: F401  (runs every @tuned_kernel)
    from repro_torch.kernels import api
    return [(kernel_id, dict(sig))
            for kernel_id in api.registered_kernels()
            for sig in api.get_spec(kernel_id).pretune]


def _render_jsonl(db: TuningDatabase) -> str:
    """Deterministic JSONL rendering of a swept grid.

    Creation timestamps are normalized to 0.0 — the only
    non-reproducible field — so regenerating the same grid for the same
    target yields byte-identical output (`pretune --verify` diffs
    bit-for-bit against the shipped file).
    """
    lines = []
    for rec in db.records():
        rec = dataclasses.replace(rec, created_unix=0.0)
        lines.append(json.dumps(rec.to_dict(), sort_keys=True,
                                allow_nan=False))
    return "".join(line + "\n" for line in lines)


def _diff_shipped(path: str, text: str) -> Tuple[bool, str]:
    """Bit-for-bit comparison of a regenerated grid against a shipped
    JSONL; on mismatch, name the first differing line."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            shipped = f.read()
    except OSError as e:
        return False, f"cannot read shipped db: {e}"
    if shipped == text:
        return True, ""
    a, b = shipped.splitlines(), text.splitlines()
    for i, (la, lb) in enumerate(zip(a, b)):
        if la != lb:
            return False, f"first diff at line {i + 1}"
    return False, f"line count {len(a)} (shipped) vs {len(b)} (regenerated)"


def _open_db(path: Optional[str]) -> TuningDatabase:
    root = path or os.environ.get(ENV_DB_DIR) or DEFAULT_DB_DIR
    return TuningDatabase(root=root)


def _parse_sig(pairs: List[str]) -> Dict[str, Any]:
    sig: Dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--sig entries must be key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        if v.lower() in ("true", "false"):
            # bools must round-trip as bools or the stored key's
            # signature will never match the trace-time dispatch key
            sig[k] = v.lower() == "true"
            continue
        try:
            sig[k] = int(v)
        except ValueError:
            sig[k] = v
    return sig


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning_cache",
        description="Export / import / inspect / grow the tuning database.")
    ap.add_argument("--db", default=None,
                    help=f"database directory (default: ${ENV_DB_DIR} "
                         f"or {DEFAULT_DB_DIR})")
    sub = ap.add_subparsers(dest="cmd", required=True)

    # `--db` is accepted before or after the subcommand; SUPPRESS keeps
    # the subparser from clobbering a value parsed at the top level.
    def add_sub(name, help):
        p = sub.add_parser(name, help=help)
        p.add_argument("--db", default=argparse.SUPPRESS)
        return p

    p_exp = add_sub("export", help="dump the database to JSONL")
    p_exp.add_argument("--out", required=True)

    p_imp = add_sub("import", help="load a JSONL into the database")
    p_imp.add_argument("--path", required=True)

    add_sub("show", help="list stored records")

    p_tune = add_sub("tune", help="pre-tune one kernel instance")
    p_tune.add_argument("--kernel", required=True)
    p_tune.add_argument("--sig", nargs="+", default=[],
                        metavar="KEY=VALUE",
                        help="shape/dtype signature, e.g. m=1024 dtype=float32")
    p_tune.add_argument("--target", default=None,
                        help="hardware target name (default: the "
                             "process-default target)")
    p_tune.add_argument("--model", default=None,
                        choices=("eq6", "pipeline"),
                        help="cost-model tier to rank under (default: "
                             "the kernel's declared kind, else the "
                             "process default — see DESIGN.md §16)")

    p_pre = add_sub("pretune",
                    help="sweep the default shape grid over every "
                         "registered kernel (one vectorized rank per "
                         "instance)")
    p_pre.add_argument("--out", default=None,
                       help="also export the swept grid to this JSONL "
                            "(default with --target/--all-targets: the "
                            "shipped pretuned/<target>.jsonl)")
    p_pre.add_argument("--kernels", default=None,
                       help="comma-separated kernel_id filter "
                            "(default: all)")
    p_pre.add_argument("--target", default=None,
                       help="hardware target to pretune for (default: "
                            "the process-default target)")
    p_pre.add_argument("--all-targets", action="store_true",
                       help=f"pretune every shipped target "
                            f"{SHIPPED_TARGETS} in one run")
    p_pre.add_argument("--model", default=None,
                       choices=("eq6", "pipeline"),
                       help="cost-model tier to rank the sweep under "
                            "(default: each kernel's declared kind, "
                            "else the process default)")
    p_pre.add_argument("--verify", action="store_true",
                       help="regenerate and diff bit-for-bit against "
                            "the shipped JSONL instead of writing "
                            "(and report which cost model produced "
                            "each shipped record); exit 1 on any "
                            "mismatch")
    p_pre.add_argument("--config", action="append", default=[],
                       metavar="ARCH",
                       help="graph-level pretune: enumerate every "
                            "kernel instance this serving config's "
                            "prefill+decode dispatches (abstract trace, "
                            "nothing executes) and rank each into the "
                            "database (repeatable)")
    p_pre.add_argument("--smoke", action="store_true",
                       help="use the smoke-sized variant of each "
                            "--config arch")
    p_pre.add_argument("--batch", type=int, default=2,
                       help="serving batch size for --config (default 2)")
    p_pre.add_argument("--prompt-len", type=int, default=64,
                       help="prompt length for --config (default 64)")

    p_srv = add_sub("serve",
                    help="serve the database over HTTP (coalesced "
                         "lookup-or-tune for a fleet of client "
                         "processes; see DESIGN.md §13)")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=0,
                       help="listen port (default 0: ephemeral — read "
                            "it from the ready line)")
    p_srv.add_argument("--warm-jsonl", default=None,
                       help="JSONL to warm the served database with "
                            "before listening")
    p_srv.add_argument("--warm-pretuned", default=None, metavar="TARGET",
                       help="fold in the shipped pretuned records for "
                            "this hardware target before listening")
    p_srv.add_argument("--fault", action="append", default=[],
                       metavar="KIND@SITE[:K=V,...]",
                       help="inject a chaos fault, e.g. "
                            "delay@server.tune:delay=2.0 or "
                            "kill@server.request:after=3 (repeatable)")

    args = ap.parse_args(argv)
    db = _open_db(args.db)

    if args.cmd == "export":
        n = db.export_jsonl(args.out)
        print(f"exported {n} records -> {args.out}")
    elif args.cmd == "import":
        try:
            n = db.import_jsonl(args.path, source="import")
        except OSError as e:
            raise SystemExit(f"cannot read {args.path}: {e}")
        print(f"imported {n} records from {args.path} -> {db.disk.root}")
    elif args.cmd == "show":
        n = 0
        for rec in db.records():
            n += 1
            print(f"{rec.key.digest}  {rec.key.kernel_id:<16} "
                  f"mode={rec.key.mode:<9} pred={rec.predicted_s:.3e}s "
                  f"params={rec.params}  sig={rec.key.signature}")
        print(f"({n} records; stats={db.stats.as_dict()})")
    elif args.cmd == "tune":
        import repro_torch.kernels  # noqa: F401  (registers dispatch problems)
        sig = _parse_sig(args.sig)
        try:
            get_problem(args.kernel, **sig)  # fail fast on a bad signature
        except (KeyError, TypeError) as e:
            raise SystemExit(f"error: {e.args[0] if e.args else e}")
        spec = resolve_target(args.target)
        params = lookup_or_tune(args.kernel, db=db, spec=spec,
                                model=args.model, **sig)
        print(f"tuned [{spec.name}] {args.kernel} {sig} -> {params} "
              f"(registered kernels: {registered()})")
    elif args.cmd == "pretune":
        import repro_torch.kernels  # noqa: F401  (registers dispatch problems)
        if args.all_targets and args.target:
            raise SystemExit("--target and --all-targets are exclusive")
        targets = (list(SHIPPED_TARGETS) if args.all_targets
                   else [args.target])
        if args.out and len(targets) > 1:
            raise SystemExit("--out only applies to a single target; "
                             "--all-targets writes each shipped path")
        if args.config:
            if args.verify or args.kernels or args.out:
                raise SystemExit("--config pretunes a serving graph "
                                 "into the database and cannot be "
                                 "combined with --verify/--kernels/--out")
            from repro_torch.configs import get_config, get_smoke
            from repro_torch.core.autotuner import GraphTuner
            for target in targets:
                spec = resolve_target(target)
                for arch in args.config:
                    cfg = (get_smoke(arch) if args.smoke
                           else get_config(arch))
                    t0 = time.perf_counter()
                    rep = GraphTuner.tune_config(
                        cfg, batch=args.batch,
                        prompt_len=args.prompt_len, db=db, spec=spec)
                    dt = time.perf_counter() - t0
                    print(f"[{spec.name}] {arch} ({cfg.name}): "
                          f"{rep['dispatches']} dispatches, "
                          f"{len(rep['instances'])} unique instances "
                          f"tuned in {dt*1e3:.0f} ms")
                    for inst in rep["instances"]:
                        print(f"    {inst['kernel']:<16} "
                              f"{inst['signature']} -> {inst['params']}")
            return 0
        if args.verify and args.kernels:
            raise SystemExit("--verify diffs the full shipped grid and "
                             "cannot be combined with --kernels")
        keep = (set(args.kernels.split(",")) if args.kernels else None)
        cases = [(k, s) for k, s in default_pretune_cases()
                 if keep is None or k in keep]
        if not cases:
            raise SystemExit(f"no pretune cases match --kernels "
                             f"{args.kernels!r}; registered: {registered()}")
        failures = []
        for target in targets:
            spec = resolve_target(target)
            # Sweep into a private in-memory database so the export
            # contains exactly the swept grid — a pre-existing disk
            # database (stale shapes, other specs) must never leak into
            # a shipped JSONL.
            mem = TuningDatabase()
            t0 = time.perf_counter()
            for kernel_id, sig in cases:
                params = lookup_or_tune(kernel_id, db=mem, spec=spec,
                                        model=args.model, **sig)
                if not args.verify:
                    print(f"[{spec.name}] {kernel_id:<16} {sig} -> {params}")
            dt = time.perf_counter() - t0
            text = _render_jsonl(mem)
            if args.verify:
                shipped = args.out or pretuned_path(spec)
                ok, why = _diff_shipped(shipped, text)
                # every record's cache key carries the fingerprint of
                # the model that ranked it — surface the census so a
                # shipped grid's provenance is auditable at a glance
                census: Dict[str, int] = {}
                for rec in mem.records():
                    m = json.loads(rec.key.signature).get("model", "?")
                    census[m] = census.get(m, 0) + 1
                by_model = ", ".join(f"{m} x{c}"
                                     for m, c in sorted(census.items()))
                print(f"[{spec.name}] verify {len(cases)} instances in "
                      f"{dt*1e3:.0f} ms against {shipped}: "
                      f"{'OK' if ok else 'MISMATCH (' + why + ')'} "
                      f"(models: {by_model})")
                if not ok:
                    failures.append(spec.name)
                continue
            for rec in mem.records():    # write-through to the target db
                db.put(rec)
            print(f"pretuned [{spec.name}] {len(cases)} instances in "
                  f"{dt*1e3:.0f} ms -> {len(mem)} records into "
                  f"{db.disk.root if db.disk else '<memory>'}")
            out = args.out or (pretuned_path(spec)
                               if args.all_targets or args.target else None)
            if out:
                with open(out, "w", encoding="utf-8") as f:
                    f.write(text)
                print(f"exported {len(mem)} records -> {out}")
        if failures:
            raise SystemExit(f"pretune --verify failed for: {failures}")
    elif args.cmd == "serve":
        import repro_torch.kernels  # noqa: F401  (registers dispatch problems)
        from repro_torch.tuning_cache.service.faults import (FaultInjector,
                                                       parse_fault)
        from repro_torch.tuning_cache.service.server import TuningServer
        from repro_torch.tuning_cache.store import ENV_FSYNC
        from repro_torch.tuning_cache import warm_pretuned
        try:
            injector = FaultInjector([parse_fault(t) for t in args.fault])
        except ValueError as e:
            raise SystemExit(f"error: {e}")
        if db.disk is not None:
            # a served disk store is by definition multi-process shared:
            # records that survive a crash must be whole
            os.environ.setdefault(ENV_FSYNC, "1")
        if args.warm_pretuned:
            n = warm_pretuned(db, args.warm_pretuned)
            print(f"warmed {n} pretuned records for {args.warm_pretuned}")
        if args.warm_jsonl:
            try:
                n = db.warm_jsonl(args.warm_jsonl)
            except OSError as e:
                raise SystemExit(f"cannot warm {args.warm_jsonl}: {e}")
            print(f"warmed {n} records from {args.warm_jsonl}")
        server = TuningServer(db=db, host=args.host, port=args.port,
                              injector=injector)
        # the ready line is machine-read (tests, process managers):
        # flush it before blocking in serve_forever
        print(f"[tuning-service] listening on {server.url} "
              f"({len(db)} records resident, generation {db.generation})",
              flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server._httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
