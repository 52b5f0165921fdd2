"""Serving example: graph pretune -> freeze -> tuned serving.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu \\
        [--arch gemma-7b] [--gen 24]

The zero-run serving lifecycle, end to end, on the reduced (smoke)
config of the chosen arch:

1. **graph pretune** — ``GraphTuner.tune_config`` traces the config's
   prefill + decode step on ``meta`` tensors (nothing executes) and
   statically ranks every (kernel, signature) instance they dispatch
   into the tuning database;
2. **freeze** — the ranked records compile into lock-free frozen
   dispatch tables;
3. **serve tuned** — with ``use_tuned_layers()`` the model's rms_norm /
   attention / gated-mlp layers dispatch through the kernel registry
   (the hand-written CUDA kernels on the card; their plain versions on
   the CPU); every dispatch hits the frozen tier and the database sees
   zero runtime tunes;
4. **serve fallback** — the same weights with tuned layers off run the
   plain PyTorch paths (the degraded mode serving falls back to
   whenever the tuned path is unavailable), fed the tuned path's
   tokens; its greedy choice must match the tuned stream at every
   step.  In bfloat16 the kernels and the plain paths round
   differently, so the two logits must agree within bf16's tolerance
   at every step (2e-2 plus 2e-2 of the row's largest logit), and a
   step where the choices part must be a tie: the plain path's logit
   of the tuned token within that tolerance of its own top one.

Runs on the CUDA card unless ``--device cpu`` is given.  The same
lifecycle as a CLI one-liner:

    python -m repro_torch.tuning_cache --db tuned.jsonl pretune \\
        --config gemma-7b --smoke
    python -m repro_torch.launch.serve --arch gemma-7b --smoke \\
        --tuning-db tuned.jsonl --tuned-ops --assert-frozen
"""
import argparse
import time

import torch

import repro_torch.kernels  # noqa: F401  (registers dispatch problems)
from repro_torch import tuning_cache
from repro_torch.configs import get_smoke
from repro_torch.core.autotuner import GraphTuner
from repro_torch.distributed import make_serve_fns
from repro_torch.kernels import api
from repro_torch.models import build_model, resolve_device
from repro_torch.models.layers import use_tuned_layers
from repro_torch.tuning_cache import TuningDatabase


def decode(prefill, decode_step, params, batch, gen, forced=None):
    """Prefill + ``gen`` greedy decode steps: (tokens (B, gen + 1), the
    last position's logits of every step (B, gen + 1, V) in float32,
    ms/token), on the CPU.  With ``forced`` (B, gen + 1) each step is
    fed those tokens in place of its own choice."""
    device = batch["tokens"].device
    if forced is not None:
        forced = forced.to(device)
    with torch.inference_mode():
        logits, cache = prefill(params, batch)
        tok = logits[:, -1:].argmax(dim=-1)
        toks, last = [tok], [logits[:, -1].float()]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for i in range(gen):
            feed = tok if forced is None else forced[:, i:i + 1]
            logits, cache = decode_step(params, cache, feed)
            tok = logits[:, -1:].argmax(dim=-1)
            toks.append(tok)
            last.append(logits[:, -1].float())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return (torch.cat(toks, 1).cpu(), torch.stack(last, 1).cpu(),
            (time.perf_counter() - t0) / max(gen, 1) * 1e3)


def compare(toks_tuned, lg_tuned, toks_plain, lg_plain, atol=2e-2,
            rtol=2e-2):
    """The tuned stream against the plain path's choices on it: exact
    token match; the largest logit difference, each row's against
    ``atol + rtol * `` its largest plain logit; and, at each (row, step)
    where the choices part, the plain path's top logit minus its logit
    of the tuned token (a tie when within the row's tolerance) and its
    top-1 minus top-2 gap."""
    err = (lg_tuned - lg_plain).abs()
    lim = atol + rtol * lg_plain.abs().amax(-1)
    parts = []
    for r, t in (toks_tuned != toks_plain).nonzero().tolist():
        row = lg_plain[r, t]
        top2 = row.topk(2).values
        gap = float(row[toks_plain[r, t]] - row[toks_tuned[r, t]])
        parts.append({"row": r, "step": t, "gap": gap,
                      "top1_top2": float(top2[0] - top2[1]),
                      "tie": gap <= float(lim[r, t])})
    return {"match": not parts, "max_abs_err": float(err.max()),
            "within_tol": bool((err.amax(-1) <= lim).all()),
            "parts": parts}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' serves on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch)

    # -- 1. graph pretune into a fresh database (meta trace only) ------
    tuning_cache.thaw()
    tuning_cache.set_default_db(TuningDatabase())
    db = tuning_cache.get_default_db()
    rep = GraphTuner.tune_config(cfg, batch=args.batch,
                                 prompt_len=args.prompt_len, db=db)
    print(f"[{cfg.name}] pretune: {rep['dispatches']} graph dispatches "
          f"-> {len(rep['instances'])} unique kernel instances ranked")
    for inst in rep["instances"]:
        sig = " ".join(f"{k}={v}" for k, v in inst["signature"].items())
        print(f"  {inst['kernel']:<16} {sig}")

    # -- 2. freeze the ranked records into dispatch tables -------------
    n = tuning_cache.freeze()
    print(f"[{cfg.name}] frozen: {n} dispatch-table entries")

    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    prefill, decode_step = make_serve_fns(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=device)}
    if cfg.frontend == "frames":
        batch["frames"] = torch.randn(
            (args.batch, cfg.enc_seq, cfg.d_model), generator=gen,
            device=device).to(torch.bfloat16)

    # -- 3. serve through the tuned kernel path ------------------------
    n0 = len(db)
    api.reset_dispatch_stats()
    with use_tuned_layers():
        toks_tuned, lg_tuned, ms_tuned = decode(prefill, decode_step,
                                                params, batch, args.gen)
    st = api.dispatch_stats()
    tunes = len(db) - n0
    print(f"[{cfg.name}] tuned serve: {ms_tuned:.1f} ms/token | "
          f"dispatch {st['frozen']}/{st['total']} frozen, "
          f"{st['live']} live, {st['fallback']} fallback, "
          f"{tunes} runtime tunes")

    # -- 4. the plain fallback path (degraded mode), on the same stream -
    with use_tuned_layers(False):
        toks_plain, lg_plain, ms_plain = decode(
            prefill, decode_step, params, batch, args.gen,
            forced=toks_tuned)
    cmp = compare(toks_tuned, lg_tuned, toks_plain, lg_plain)
    print(f"[{cfg.name}] plain fallback: {ms_plain:.1f} ms/token | greedy "
          f"tokens {'MATCH' if cmp['match'] else 'PART'} | logits "
          f"max|err| {cmp['max_abs_err']:.4g} "
          f"({'within' if cmp['within_tol'] else 'OVER'} bf16's "
          f"2e-2 + 2e-2 x the row's largest)")
    for p in cmp["parts"]:
        print(f"  row {p['row']} step {p['step']}: plain top minus the "
              f"tuned token {p['gap']:.4g} "
              f"({'a tie' if p['tie'] else 'NOT a tie'}), top-1 minus "
              f"top-2 {p['top1_top2']:.4g}")
    print("sample:", toks_tuned[0][:16].tolist())

    tuning_cache.thaw()
    tuning_cache.reset_default_db()
    assert cmp["within_tol"], "tuned and fallback logits disagree"
    assert all(p["tie"] for p in cmp["parts"]), \
        "tuned and fallback paths chose different tokens off a tie"
    return {"tokens": toks_tuned.tolist(), "match": cmp["match"],
            "parts": cmp["parts"], "max_abs_err": cmp["max_abs_err"],
            "dispatch": st, "runtime_tunes": tunes, "ms_tuned": ms_tuned,
            "ms_plain": ms_plain}

if __name__ == "__main__":
    main()
