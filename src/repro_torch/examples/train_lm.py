"""End-to-end example: train a small LM for a few hundred steps with the
whole stack — the synthetic pipeline, AdamW, checkpoints and the
fault-tolerant supervisor.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
        [--steps 300] [--arch gemma-7b]

Trains the reduced (smoke) config of the chosen arch on the CUDA card,
or on the CPU with ``--device cpu`` (`repro_torch.launch.train` is the
launcher this wraps).
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.data import DataConfig, TokenStream
from repro_torch.distributed import TrainStepConfig, make_train_step
from repro_torch.launch.train import make_batch_fn
from repro_torch.models import build_model, resolve_device
from repro_torch.optim import AdamWConfig, init_adamw
from repro_torch.runtime import FaultPolicy, TrainSupervisor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' trains on the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    model = build_model(cfg)
    print(f"training {cfg.name} ({cfg.num_params()/1e6:.1f}M params, "
          f"family={cfg.family}) for {args.steps} steps on {device}")

    params = model.init(seed=0, device=device, param_dtype=torch.float32)
    opt = init_adamw(params)
    step = make_train_step(
        model,
        AdamWConfig(peak_lr=3e-3, warmup_steps=args.steps // 10,
                    decay_steps=args.steps),
        step_cfg=TrainStepConfig(microbatches=args.microbatches))
    stream = TokenStream(DataConfig(vocab=cfg.vocab,
                                    global_batch=args.batch,
                                    seq_len=args.seq))
    make_batch = make_batch_fn(cfg, stream, 1, device)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=2)
        sup = TrainSupervisor(mgr, FaultPolicy(checkpoint_every=100))
        try:
            state = sup.run(step, {"params": params, "opt": opt, "step": 0},
                            make_batch, args.steps, log_every=25)
        finally:
            mgr.close()
    print(f"done at step {state['step']}")
    return state


if __name__ == "__main__":
    main()
