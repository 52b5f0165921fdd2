"""Four gloo ranks sharing one card: which collective on CUDA tensors
finishes, raises or hangs.

    PYTHONPATH=src python tools/gloo_cuda.py [--timeout 90]

Each probe runs in a four-rank gloo world of its own (`launch.mesh.
spawn_world`; every rank's tensors on ``cuda:0``), one world after
another, so that a hang ends only its world: it is stopped after
``--timeout`` seconds, its ranks' start-up included.  The control
first: DTensor's all-gather on CPU tensors; then the process group's
own collectives on CUDA tensors, up to DTensor's all-gather on a (2, 2)
mesh of ``cuda`` device type (the gather ``[mesh]`` (b) needs).
Prints one line a probe and the torch version; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

PROBES = ("dtensor_full_tensor_cpu", "all_reduce", "all_gather_into_tensor",
          "reduce_scatter_tensor", "funcol_all_gather",
          "dtensor_full_tensor_cuda")


def probe(rank: int, world: int, name: str) -> str:
    """One probe on this rank: a short description of its result."""
    import torch
    import torch.distributed as dist
    dev = "cpu" if name.endswith("_cpu") else "cuda:0"
    x = torch.full((4, 8), float(rank + 1), device=dev)
    if name == "all_reduce":
        dist.all_reduce(x)
        got = x
    elif name == "all_gather_into_tensor":
        got = torch.empty((4 * world, 8), device=dev)
        dist.all_gather_into_tensor(got, x)
    elif name == "reduce_scatter_tensor":
        got = torch.empty((1, 8), device=dev)
        dist.reduce_scatter_tensor(got, x)
    elif name == "funcol_all_gather":
        import torch.distributed._functional_collectives as funcol
        got = funcol.all_gather_tensor(x, 0, dist.group.WORLD)
        got = got.wait() if hasattr(got, "wait") else got
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor
        mesh = init_device_mesh("cpu" if dev == "cpu" else "cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        whole = torch.arange(16 * 8, dtype=torch.float32,
                             device=dev).reshape(16, 8)
        d = distribute_tensor(whole, mesh, [Shard(0), Shard(1)],
                              src_data_rank=None)
        got = d.full_tensor()
        if not torch.equal(got, whole):
            return "wrong values"
    if dev != "cpu":
        torch.cuda.synchronize()
    return f"ok {tuple(got.shape)} sum {float(got.sum()):g}"


def run(name: str, timeout: float) -> str:
    from repro_torch.launch.mesh import spawn_world
    try:
        out = spawn_world(probe, 4, name, backend="gloo", timeout=timeout)
        return out[0]
    except TimeoutError:
        return f"hung: no result within {timeout:.0f} s"
    except RuntimeError as e:
        last = [ln for ln in str(e).strip().splitlines() if ln.strip()]
        return f"raised: {last[-1][:200] if last else e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=90.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[gloo_cuda] no CUDA device: nothing to probe", flush=True)
        return 2
    print(f"[gloo_cuda] torch {torch.__version__}, CUDA {torch.version.cuda}"
          f", {torch.cuda.get_device_name(0)}; four gloo ranks on cuda:0",
          flush=True)
    for name in PROBES:
        print(f"[gloo_cuda] {name}: {run(name, args.timeout)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
