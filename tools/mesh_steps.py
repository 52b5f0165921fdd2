#!/usr/bin/env python3
"""Each step's loss and grad norm of `chip_smoke.py`'s ``[mesh]`` (a) on
several cards, beside one card's.

    python3 tools/mesh_steps.py CHECKOUT [float32]

Spawns one NCCL rank per card of a (data, model) = (2, 2) mesh
(`repro_torch.launch.mesh.spawn_world`) running
``chip_smoke._mesh_rank_nccl`` of the checkout at ``CHECKOUT`` (an
absolute or relative path; spawned ranks re-import this file, so it
changes no directory): gemma-7b at published width, 4 of 28 layers, 3
steps of 8 x 256 tokens, meshed and then unmeshed on rank 0's card.
With ``float32`` both runs compute in float32 (TF32 off) in place of
the config's bfloat16, to tell a fault of the meshed step from bf16's
rounding.  Prints the two runs' losses and grad norms and the largest
relative difference of each."""
import os
import sys

TREE = os.path.abspath(sys.argv[1])
sys.path[:0] = [TREE, os.path.join(TREE, "src")]


def rank(rank, world, dtype):
    import chip_smoke
    if dtype == "float32":
        import dataclasses
        import torch
        from repro_torch import configs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        get = configs.get_config
        configs.get_config = lambda arch: dataclasses.replace(
            get(arch), dtype="float32")
    return chip_smoke._mesh_rank_nccl(rank, world, "gemma-7b", 4, "2,2")


def _rel(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_world
    dtype = sys.argv[2] if len(sys.argv) > 2 else "bfloat16"
    a = spawn_world(rank, 4, dtype, backend="nccl", timeout=150)[0]
    p = a["plain"]
    print(f"[mesh-steps] {sys.argv[1]} {dtype}: meshed losses {a['losses']} "
          f"grad norms {a['grad_norms']} | one card losses {p['losses']} "
          f"grad norms {p['grad_norms']} | rel err losses "
          f"{_rel(a['losses'], p['losses']):.3g}, grad norms "
          f"{_rel(a['grad_norms'], p['grad_norms']):.3g}", flush=True)
