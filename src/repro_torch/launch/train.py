"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \\
        --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \\
        --smoke --steps 100 --batch 8 --seq 256 --checkpoint-dir /tmp/ckpt

Trains on the CUDA card unless ``--device cpu`` is given: f32 master
parameters, compute in the config's type (bf16 by default), AdamW with
warmup and cosine decay, the synthetic `TokenStream`, microbatched
gradient accumulation and layer remat (``cfg.remat``).  With
``--checkpoint-dir`` the `TrainSupervisor` checkpoints every
``--checkpoint-every`` steps and restarts from the last checkpoint
after a fault.  ``--mesh single|multi`` and ``--compress-pod-grads``
wait for the mesh slice (ROADMAP A8b) and raise.  Training runs the
plain PyTorch layers under autograd: the tuned CUDA kernels have no
backward.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card; 'cpu' trains on the CPU)")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_batch_fn(cfg, stream, seed: int, device) -> Callable[[int], Dict]:
    """``step -> batch`` on ``device``: the stream's tokens and, for a
    frames front end, stub frame embeddings (bf16) from a CPU
    ``torch.Generator`` seeded with (seed, step) — the same on every
    device."""
    def make_batch(step: int) -> Dict[str, torch.Tensor]:
        b = {k: torch.from_numpy(v).to(device)
             for k, v in stream.make_batch(step).items()}
        if cfg.frontend == "frames":
            g = torch.Generator().manual_seed(seed * 1_000_003 + step)
            b["frames"] = torch.randn(
                (b["tokens"].shape[0], cfg.enc_seq, cfg.d_model),
                generator=g).to(torch.bfloat16).to(device)
        return b
    return make_batch


def main(argv: Optional[Sequence[str]] = None, *, cfg=None,
         inject_fault: Optional[Callable[[int], None]] = None
         ) -> Dict[str, Any]:
    """Train; returns the run's report (device, losses, grad norms,
    ms/step, tokens/s, peak memory, the final state).  ``cfg``
    overrides the ``--arch`` config (e.g. a depth cut made with
    ``dataclasses.replace``); ``inject_fault`` is handed to the
    supervisor (with ``--checkpoint-dir``)."""
    args = parse_args(argv)
    if args.mesh != "none" or args.compress_pod_grads:
        raise NotImplementedError(
            "--mesh and --compress-pod-grads wait for the mesh slice "
            "(ROADMAP A8b)")

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import TrainStepConfig, make_train_step
    from repro_torch.models import build_model, resolve_device
    from repro_torch.optim import AdamWConfig, init_adamw

    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    print(f"[train] arch={cfg.name} family={cfg.family} "
          f"params={cfg.num_params()/1e6:.1f}M "
          f"active={cfg.num_active_params()/1e6:.1f}M on {device} "
          f"(f32 masters, {cfg.dtype} compute, remat {cfg.remat})",
          flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    params = model.init(seed=args.seed, device=device,
                        param_dtype=torch.float32)
    opt = init_adamw(params)
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=args.steps // 10,
                          decay_steps=args.steps)
    train_step = make_train_step(
        model, opt_cfg,
        step_cfg=TrainStepConfig(microbatches=args.microbatches))
    stream = TokenStream(DataConfig(vocab=cfg.vocab,
                                    global_batch=args.batch,
                                    seq_len=args.seq, seed=args.seed))
    make_batch = make_batch_fn(cfg, stream, args.seed, device)
    state = {"params": params, "opt": opt, "step": 0}
    losses, norms, step_s = [], [], []

    def timed_step(p, o, batch):
        _sync(device)
        t0 = time.perf_counter()
        p, o, metrics = train_step(p, o, batch)
        losses.append(float(metrics["loss"]))     # waits for the card
        norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
        n = len(losses)
        if args.log_every and n % args.log_every == 0:
            print(f"[train] step={n} loss={losses[-1]:.4f} grad_norm="
                  f"{norms[-1]:.4f} ({step_s[-1] * 1e3:.1f} ms)",
                  flush=True)
        return p, o, metrics

    t_start = time.perf_counter()
    if args.checkpoint_dir:
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.runtime import FaultPolicy, TrainSupervisor
        mgr = CheckpointManager(args.checkpoint_dir, keep=3)
        sup = TrainSupervisor(
            mgr, FaultPolicy(checkpoint_every=args.checkpoint_every),
            inject_fault=inject_fault)
        try:
            state = sup.run(timed_step, state, make_batch, args.steps,
                            log_every=0)
        finally:
            mgr.close()
        print(f"[train] done at step {state['step']}")
    else:
        for step in range(args.steps):
            state["params"], state["opt"], _ = timed_step(
                state["params"], state["opt"], make_batch(step))
            state["step"] = step + 1
    wall = time.perf_counter() - t_start
    # steady state: the median step past the first two (warm-up)
    steady = step_s[2:] or step_s
    ms = statistics.median(steady) * 1e3 if steady else float("nan")
    tokens = args.batch * args.seq
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if losses:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{len(losses)} steps; {ms:.1f} ms/step, "
              f"{tokens / ms * 1e3:.0f} tokens/s"
              + (f", peak {peak / 1e9:.2f} GB" if peak else ""), flush=True)
    return {"config": cfg.name, "device": str(device),
            "steps": state["step"], "batch": args.batch, "seq": args.seq,
            "losses": losses, "grad_norms": norms,
            "step_ms": [s * 1e3 for s in step_s], "ms_per_step": ms,
            "tokens_per_s": tokens / ms * 1e3, "wall_s": wall,
            "peak_bytes": peak, "state": state}


if __name__ == "__main__":
    main()
