#!/usr/bin/env python3
"""How far one card's own training trajectory moves when every
parameter moves by one ulp: the yardstick for a meshed run's parting
from one card's.

    python3 tools/train_sensitivity.py --arch qwen2-moe-a2.7b --layers 2 \
        [--dtype float32] [--steps 3] [--coins 2]

Runs the unmeshed step of `chip_smoke.py`'s ``[mesh]`` (a) on the card
(``arch`` at published width, ``--layers`` of its layers, remat full,
``launch.train``'s optimizer settings and token stream, 8 x 256 tokens,
seed-0 float32 masters) twice: from the parameters as drawn, and from
the same parameters each moved by one ulp (`torch.nextafter`): all up,
all down, and up or down by a seeded coin, ``--coins`` seeds.  A mesh
sums the same products in another order, which moves the first
gradients by a few ulps; this moves the first parameters by one.
Prints each step's losses and grad norms of every moved run beside the
first and their relative differences.  ``--dtype float32`` computes in
float32 with TF32 off in place of the config's type.  Needs a card."""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _moved(v, how: str):
    """``v`` with every element one ulp up, down, or up or down by the
    coin of seed ``how`` (a string of digits)."""
    import torch
    up = torch.nextafter(v, torch.full_like(v, float("inf")))
    if how == "up":
        return up
    down = torch.nextafter(v, torch.full_like(v, float("-inf")))
    if how == "down":
        return down
    g = torch.Generator(device=v.device).manual_seed(int(how))
    return torch.where(torch.rand(v.shape, generator=g, device=v.device)
                       < 0.5, up, down)


def trajectory(cfg, steps: int, how=None):
    """(losses, grad norms) of ``steps`` unmeshed train steps, the
    parameters moved by `_moved` ``how`` first (not at all: None)."""
    import torch
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import build_model, map_params
    from repro_torch.models.params import Param
    from repro_torch.optim import AdamWConfig, init_adamw

    dev = torch.device("cuda")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev, param_dtype=torch.float32)
    if how is not None:
        params = map_params(lambda p: Param(_moved(p.value, how), p.dims),
                            params)
    opt = init_adamw(params)
    step = make_train_step(model, AdamWConfig(
        peak_lr=3e-3, warmup_steps=steps // 10, decay_steps=steps))
    batch = make_batch_fn(cfg, TokenStream(DataConfig(
        vocab=cfg.vocab, global_batch=8, seq_len=256, seed=0)), 0, dev)
    losses, norms = [], []
    for s in range(steps):
        params, opt, m = step(params, opt, batch(s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del params, opt
    torch.cuda.empty_cache()
    return losses, norms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--coins", type=int, default=2)
    args = ap.parse_args()
    import torch
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers,
                              remat="full")
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if args.dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    base = trajectory(cfg, args.steps)
    rel = lambda x, y: [f"{abs(p - q) / abs(q):.3g}" for p, q in zip(x, y)]
    for how in ["up", "down"] + [str(i) for i in range(args.coins)]:
        b = trajectory(cfg, args.steps, how)
        print(f"[sensitivity] {args.arch}, {args.layers} layers, "
              f"{cfg.dtype}, one card, {args.steps} steps of 8 x 256; "
              f"every parameter one ulp "
              + (how if how in ("up", "down") else f"up or down (coin "
                 f"seed {how})")
              + f": losses {b[0]} vs {base[0]} (rel err by step "
              f"{rel(b[0], base[0])}), grad norms {b[1]} vs {base[1]} "
              f"(rel err by step {rel(b[1], base[1])}) "
              f"({torch.cuda.get_device_name(0)})", flush=True)


if __name__ == "__main__":
    main()
