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
after a fault.  Training runs the plain PyTorch layers under
autograd: the tuned CUDA kernels have no backward.

On a device mesh, one process per device (``torchrun``)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch gemma-7b --smoke --mesh-shape 2,1,2 --compress-pod-grads
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch gemma-7b --smoke --mesh-shape 2,2 --device cpu

``--mesh single|multi`` builds the production (16, 16) / (2, 16, 16)
meshes (256 / 512 ranks); ``--mesh-shape`` any mesh the world fits,
named ``(data, model)`` or ``(pod, data, model)``.  The world comes from
the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``; a lone process without them is a world of one).  The
card means NCCL, ``--device cpu`` gloo.  Every rank builds the same
parameters from the seed and keeps its shards; every rank reads the same
global batch and keeps its rows; only rank 0 prints and writes
checkpoints.  ``--compress-pod-grads`` sends the cross-pod gradient sum
through the int8 error-feedback compression.
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
    ap.add_argument("--mesh-shape", type=str, default=None,
                    help="a small mesh, e.g. 2,2 (data, model) or 2,1,2 "
                         "(pod, data, model)")
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


def make_mesh_from_args(args, device: torch.device):
    """The mesh ``--mesh`` / ``--mesh-shape`` ask for (None without
    either), the process world joined first."""
    if args.mesh != "none" and args.mesh_shape:
        raise ValueError("--mesh and --mesh-shape are exclusive")
    if args.mesh == "none" and not args.mesh_shape:
        if args.compress_pod_grads:
            raise ValueError("--compress-pod-grads needs a mesh with a "
                             "pod dim")
        return None
    from repro_torch.launch.mesh import (init_world, make_mesh,
                                         make_production_mesh)
    init_world(device=device.type)
    if args.mesh != "none":
        return make_production_mesh(multi_pod=(args.mesh == "multi"))
    shape = tuple(int(n) for n in args.mesh_shape.split(","))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(shape))
    if axes is None:
        raise ValueError(f"--mesh-shape {args.mesh_shape}: two or three "
                         f"dims")
    return make_mesh(shape, axes)


def main(argv: Optional[Sequence[str]] = None, *, cfg=None,
         inject_fault: Optional[Callable[[int], None]] = None,
         after_step: Optional[Callable[[int, Dict], None]] = None
         ) -> Dict[str, Any]:
    """Train; returns the run's report (device, losses, grad norms,
    ms/step — wall, and the host's: the step's start until
    ``train_step`` returns, before the loss is read —, tokens/s, peak
    memory, the final state, and the run's
    ``train_step`` and ``make_batch``, with which a caller takes more
    steps after the timed ones: one under a ``CommDebugMode`` counts a
    step's collectives and leaves the timed steps free of any dispatch
    mode).  ``cfg`` overrides the ``--arch`` config (e.g. a depth cut
    made with ``dataclasses.replace``); ``inject_fault`` is handed to
    the supervisor (with ``--checkpoint-dir``); ``after_step(n, state)``
    is called after the n-th step with the state it left (without
    ``--checkpoint-dir``), outside the step's time."""
    args = parse_args(argv)

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import TrainStepConfig, make_train_step
    from repro_torch.models import (build_model, device_put,
                                    param_shardings, resolve_device)
    from repro_torch.optim import AdamWConfig, init_adamw

    device = resolve_device(args.device)
    mesh = make_mesh_from_args(args, device)
    rank = 0
    if mesh is not None:
        import torch.distributed as dist
        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    say = print if rank == 0 else (lambda *a, **k: None)
    if cfg is None:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    say(f"[train] arch={cfg.name} family={cfg.family} "
        f"params={cfg.num_params()/1e6:.1f}M "
        f"active={cfg.num_active_params()/1e6:.1f}M on {device} "
        f"(f32 masters, {cfg.dtype} compute, remat {cfg.remat})"
        + (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
           if mesh is not None else ""), flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    params = model.init(seed=args.seed, device=device,
                        param_dtype=torch.float32)
    if mesh is not None:
        params = device_put(params, param_shardings(params, mesh))
    opt = init_adamw(params)
    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=args.steps // 10,
                          decay_steps=args.steps)
    train_step = make_train_step(
        model, opt_cfg, mesh=mesh,
        step_cfg=TrainStepConfig(microbatches=args.microbatches,
                                 compress_pod_grads=args.compress_pod_grads))
    stream = TokenStream(DataConfig(vocab=cfg.vocab,
                                    global_batch=args.batch,
                                    seq_len=args.seq, seed=args.seed))
    make_batch = make_batch_fn(cfg, stream, args.seed, device)
    state = {"params": params, "opt": opt, "step": 0}
    losses, norms, step_s, host_s = [], [], [], []

    def timed_step(p, o, batch):
        _sync(device)
        t0 = time.perf_counter()
        p, o, metrics = train_step(p, o, batch)
        host_s.append(time.perf_counter() - t0)   # the host's share
        losses.append(float(metrics["loss"]))     # waits for the card
        norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
        n = len(losses)
        if args.log_every and n % args.log_every == 0:
            say(f"[train] step={n} loss={losses[-1]:.4f} grad_norm="
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
        say(f"[train] done at step {state['step']}")
    else:
        for step in range(args.steps):
            state["params"], state["opt"], _ = timed_step(
                state["params"], state["opt"], make_batch(step))
            state["step"] = step + 1
            if after_step is not None:
                after_step(step + 1, state)
    wall = time.perf_counter() - t_start
    # steady state: the median step past the first two (warm-up)
    steady = step_s[2:] or step_s
    ms = statistics.median(steady) * 1e3 if steady else float("nan")
    host = host_s[2:] or host_s
    host_ms = statistics.median(host) * 1e3 if host else float("nan")
    tokens = args.batch * args.seq
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if losses:
        say(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{len(losses)} steps; {ms:.1f} ms/step, "
              f"{tokens / ms * 1e3:.0f} tokens/s"
              + (f", peak {peak / 1e9:.2f} GB" if peak else ""), flush=True)
    return {"config": cfg.name, "device": str(device),
            "steps": state["step"], "batch": args.batch, "seq": args.seq,
            "losses": losses, "grad_norms": norms,
            "step_ms": [s * 1e3 for s in step_s], "ms_per_step": ms,
            "host_step_ms": [s * 1e3 for s in host_s],
            "host_ms_per_step": host_ms,
            "tokens_per_s": tokens / ms * 1e3, "wall_s": wall,
            "peak_bytes": peak, "state": state, "rank": rank,
            "train_step": train_step, "make_batch": make_batch,
            "mesh": (None if mesh is None
                     else dict(zip(mesh.mesh_dim_names, mesh.shape)))}


if __name__ == "__main__":
    main()
