"""gemma-7b training steps (4 of 28 layers, its bf16, 8 x 256 tokens) on
a (data, model) = (2, 2) NCCL mesh of four cards, for the package under
``$TIME_SRC`` (a checkout's ``src``): rank 0's wall and host ms of each
step and their medians past the first two.  Run it for two checkouts in
one call, alternating (A, B, B, A), to compare their meshed steps:

    TIME_SRC=src python3 tools/mesh_time.py
    TIME_SRC=build/parent/src python3 tools/mesh_time.py

(`REPRO_TORCH_BUILD_DIR` shared between them builds the kernels once.)
"""
import dataclasses
import json
import os
import statistics
import sys

sys.path.insert(0, os.environ["TIME_SRC"])


def rank(r, world):
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=4,
                              remat="full")
    rep = train.main(["--arch", "gemma-7b", "--batch", "8", "--seq", "256",
                      "--steps", "8", "--log-every", "0", "--mesh-shape",
                      "2,2"], cfg=cfg)
    return {k: rep[k] for k in ("step_ms", "host_step_ms", "losses")}


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_world
    got = spawn_world(rank, 4, backend="nccl", timeout=600)[0]
    print("TIMING", os.environ["TIME_SRC"], json.dumps({
        "wall_ms": statistics.median(got["step_ms"][2:]),
        "host_ms": statistics.median(got["host_step_ms"][2:]),
        **got}), flush=True)
