"""Serving launcher: batched prefill + token-by-token decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
        --tuned-ops --pretune --assert-frozen

Any of the ten archs of `repro_torch.configs.ARCHS` serves (``--smoke``
for its reduced sibling); whisper-tiny's prompt comes with stub frame
embeddings (B, enc_seq, d_model), as the reference's does.

Runs on the CUDA card unless ``--device cpu`` is given (then every
kernel runs its plain PyTorch version).  With ``--tuned-ops`` the
layers dispatch RMSNorm, prefill attention and the gated MLP through
the statically tuned kernels; ``--pretune`` ranks every kernel instance
of this config's prefill + decode before serving (zero kernel runs),
and ``--assert-frozen`` fails unless every dispatch then hit the frozen
tables with zero runtime tunes.  The default tuning database starts
warm with the pretuned JSONL shipped for the target
(``tuning_cache/pretuned/``); ``--tuning-db`` layers a deployment's own
JSONL on top (a ``pretune --config`` export covers every instance, so
serving ranks nothing), and ``--tuning-server URL`` sends cold
dispatches to a tuning service (``python -m repro_torch.tuning_cache
serve``), degrading to local ranks when it is unreachable.
``--trace PATH`` records the prefill's and the decode steps' spans
(`repro_torch.runtime.spans`), prints them by name and writes the
record and its summary to PATH as JSON.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import torch


def _warm_tuning_db(db, path: str, strict: bool = False):
    """Warm ``db`` from a JSONL, reporting skipped corrupt lines.
    ``strict`` turns any corruption into a non-zero exit."""
    corrupt0 = db.stats.corrupt
    try:
        n = db.warm_jsonl(path)
    except OSError as e:
        msg = f"could not warm tuning cache from {path}: {e}"
        if strict:
            raise SystemExit(f"[serve] --strict-db: {msg}")
        print(f"[serve] WARNING: {msg}")
        return 0, 0
    corrupt = db.stats.corrupt - corrupt0
    print(f"[serve] warmed tuning cache: +{n} records from {path}"
          + (f" ({corrupt} corrupt lines skipped)" if corrupt else ""))
    if corrupt and strict:
        raise SystemExit(f"[serve] --strict-db: {corrupt} corrupt "
                         f"line(s) skipped in {path}")
    return n, corrupt


def _connect_tuning_server(url: str):
    """Point cold dispatches at a tuning service; never fatal — an
    unreachable service means serving starts degraded on the local
    tiers (pretuned records, then local ranks), with a banner."""
    from repro_torch import tuning_cache
    try:
        client = tuning_cache.configure_service(url)
    except ValueError as e:
        print(f"[serve] WARNING: bad --tuning-server {url!r} ({e}); "
              f"serving DEGRADED on local tiers")
        return None
    health = client.health()
    if health is None:
        print(f"[serve] WARNING: tuning service {client.url} unreachable "
              f"— serving DEGRADED on local tiers (pretuned records, "
              f"then local ranks)")
    else:
        print(f"[serve] tuning service {client.url}: "
              f"{health.get('records', '?')} records, "
              f"generation {health.get('generation', '?')}")
    return client


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; 'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--tuning-db", default=None,
                    help="JSONL tuning database to warm kernel dispatch "
                         "with before serving (on top of the packaged "
                         "pretuned records)")
    ap.add_argument("--strict-db", action="store_true",
                    help="exit non-zero if --tuning-db has corrupt "
                         "lines (default: skip them, print the count)")
    ap.add_argument("--tuning-server", default=None, metavar="URL",
                    help="tuning service to consult for cold dispatches "
                         "(http://host:port); unreachable -> serve "
                         "degraded on the local tiers")
    ap.add_argument("--tuned-ops", action="store_true",
                    help="route rms_norm / gated-mlp / full attention "
                         "through the tuned kernel registry "
                         "(repro_torch.kernels.ops)")
    ap.add_argument("--pretune", action="store_true",
                    help="graph-level pretune before freezing: rank every "
                         "kernel instance this config's prefill+decode "
                         "dispatches (GraphTuner.tune_config)")
    ap.add_argument("--assert-frozen", action="store_true",
                    help="exit non-zero unless every registry dispatch "
                         "hit the frozen tables and the database saw "
                         "zero runtime tunes")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the serving spans (by model layer and "
                         "kernel op, host and device ms), print them by "
                         "name and write the record and its summary to "
                         "PATH as JSON")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _write_trace(path: str) -> None:
    """One line a span name, then the record and its summary to
    ``path``."""
    from repro_torch.runtime import spans
    summ = spans.summary()
    fmt = lambda v: "-" if v is None else f"{v:.3f}"
    print(f"[serve] spans ({summ['device']}): count, host ms, self host "
          f"ms, device ms, self device ms")
    for name, e in summ["spans"].items():
        print(f"[serve]   {name} {e['count']} {e['host_ms']:.3f} "
              f"{e['host_self_ms']:.3f} {fmt(e['device_ms'])} "
              f"{fmt(e['device_self_ms'])}")
    d = summ["dispatch"]
    if d["calls"]:
        print(f"[serve] dispatch: {d['calls']} registry calls, "
              f"{d['ns'] / d['calls'] / 1e3:.2f} us a call")
    with open(path, "w") as f:
        json.dump({"summary": summ, "records": spans.records()}, f)
    print(f"[serve] trace written to {path}")


def main(argv: Optional[Sequence[str]] = None, *,
         cfg=None) -> Dict[str, Any]:
    """Serve one batch of random prompts; returns the run's report.
    ``cfg`` overrides the ``--arch`` config (e.g. a depth cut made by a
    caller with ``dataclasses.replace``)."""
    t_start = time.perf_counter()
    args = parse_args(argv)

    from repro_torch import tuning_cache
    from repro_torch import kernels as kernel_pkg
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.distributed import make_serve_fns
    from repro_torch.kernels import api as kernel_api
    from repro_torch.models import build_model, resolve_device
    from repro_torch.models.layers import set_tuned_layers
    from repro_torch.runtime import spans

    device = resolve_device(args.device)
    # the default database warms the target's shipped pretuned records;
    # --tuning-db layers a deployment-specific JSONL on top
    db = tuning_cache.get_default_db()
    if args.tuning_db:
        _warm_tuning_db(db, args.tuning_db, strict=args.strict_db)
    if args.tuning_server:
        _connect_tuning_server(args.tuning_server)
    print(f"[serve] tuning cache ready: {len(db)} records resident")

    if cfg is None:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    instances: List[Dict[str, Any]] = []
    if args.pretune:
        from repro_torch.core.autotuner import GraphTuner
        t0 = time.perf_counter()
        rep = GraphTuner.tune_config(cfg, batch=args.batch,
                                     prompt_len=args.prompt_len, db=db)
        instances = rep["instances"]
        print(f"[serve] graph pretune [{cfg.name}]: "
              f"{rep['dispatches']} dispatches, {len(instances)} unique "
              f"kernel instances ranked in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        for inst in instances:
            print(f"[serve]   {inst['kernel']} {inst['signature']} -> "
                  f"{inst['params']}")
    # freeze() reuses a frozen state whose database generation is
    # unchanged, and records tuned since then do not bump it: rebuild,
    # so a process serving a second batch shape compiles its instances
    tuning_cache.thaw()
    n_frozen = tuning_cache.freeze()
    print(f"[serve] dispatch tables frozen: {n_frozen} entries")

    if args.tuned_ops:
        set_tuned_layers(True)
        print("[serve] tuned ops ON: layers dispatch through the "
              "kernel registry")
    n_records_before = len(db)
    kernel_api.reset_dispatch_stats()
    launches0 = kernel_pkg.launch_counts()

    model = build_model(cfg)
    params = model.init(seed=args.seed, device=device)
    prefill, decode_step = make_serve_fns(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    batch = {"tokens": tokens}
    if cfg.frontend == "frames":
        # the stub audio frontend's frame embeddings
        batch["frames"] = torch.randn(
            (args.batch, cfg.enc_seq, cfg.d_model), generator=gen,
            device=device).to(torch.bfloat16)

    if args.trace:
        spans.reset()
        spans.enable()
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        t_first = time.perf_counter() - t_start
        print(f"[serve] prefill {args.batch}x{args.prompt_len}: "
              f"{t_prefill * 1e3:.1f} ms; first token {t_first:.2f} s "
              f"after start")
        finite = bool(torch.isfinite(logits).all())
        tok = logits[:, -1:].argmax(dim=-1)
        out_tokens = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen):
            logits, cache = decode_step(params, cache, tok)
            if args.temperature > 0:
                probs = torch.softmax(
                    logits[:, -1].float() / args.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            else:
                tok = logits[:, -1:].argmax(dim=-1)
            out_tokens.append(tok)
        _sync(device)
        dt = (time.perf_counter() - t0) / max(args.gen, 1)
        finite = finite and bool(torch.isfinite(logits).all())
    if args.trace:
        spans.disable()
        _write_trace(args.trace)
    toks = torch.cat(out_tokens, dim=1).cpu()
    print(f"[serve] decode: {dt * 1e3:.1f} ms/token "
          f"({args.batch} sequences x {args.gen} tokens)")
    print(f"[serve] sample tokens[0]: {toks[0][:16].tolist()}")

    st = kernel_api.dispatch_stats()
    n_new = len(db) - n_records_before
    launches = {k: v - launches0[k]
                for k, v in kernel_pkg.launch_counts().items()}
    print(f"[serve] dispatch audit: {st['frozen']}/{st['total']} frozen, "
          f"{st['live']} live, {st['fallback']} fallback; "
          f"{n_new} runtime tunes")
    print(f"[serve] CUDA kernel launches: {launches}")
    if args.assert_frozen:
        problems = []
        if st["total"] == 0:
            problems.append("no dispatches routed through the kernel "
                            "registry (missing --tuned-ops?)")
        if st["live"] or st["fallback"]:
            problems.append(f"non-frozen dispatches: live={st['live']} "
                            f"fallback={st['fallback']}")
        if st["frozen"] != st["total"]:
            problems.append(f"frozen {st['frozen']} != total {st['total']}")
        if n_new:
            problems.append(f"{n_new} runtime tune(s) grew the database")
        if problems:
            raise SystemExit("[serve] --assert-frozen FAILED: "
                             + "; ".join(problems))
        print("[serve] --assert-frozen OK: 100% frozen dispatch, "
              "zero runtime tunes")
    return {"config": cfg.name, "device": str(device),
            "batch": args.batch, "prompt_len": args.prompt_len,
            "gen": args.gen, "prefill_ms": t_prefill * 1e3,
            "first_token_s": t_first,
            "ms_per_token": dt * 1e3, "tokens": toks.tolist(),
            "logits_finite": finite,
            "instances": instances, "dispatch": st,
            "runtime_tunes": n_new, "launches": launches,
            "frozen_entries": n_frozen}


if __name__ == "__main__":
    main()
