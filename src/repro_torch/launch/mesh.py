"""Device meshes: the production mesh factory, the counterpart of
``jax.make_mesh``, and the process worlds a mesh stands on.

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices; the ``pod`` axis
is pure data parallelism over the slower inter-pod tier.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the reference's axis names.  Where JAX fakes
every device of a mesh in one process, a torch mesh holds one rank per
device, so it needs a default process group of the mesh's size: a real
one (``torchrun``, or `spawn_world`), or the dry-run's fake one
(`launch.dryrun`).  Building a mesh is a function, never a module
constant: importing this module touches no process group.
"""
from __future__ import annotations

import math
import os
import socket
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple

__all__ = ["make_production_mesh", "make_mesh", "mesh_num_chips",
           "ici_links", "init_world", "spawn_world"]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (whose size must be ``prod(shape)``).  ``device_type``
    defaults to ``cuda`` when the group's backend is NCCL, else
    ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs a process group of one rank per device: "
            "run under torchrun, launch.mesh.spawn_world, or the "
            "dry-run's fake group")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the process group has {dist.get_world_size()}")
    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def mesh_num_chips(mesh) -> int:
    """Devices in the mesh: a ``DeviceMesh`` or anything with
    ``devices.shape`` (the reference's mesh)."""
    shape = (mesh.shape if hasattr(mesh, "mesh_dim_names")
             else mesh.devices.shape)
    return int(math.prod(shape))


def ici_links(mesh=None, spec=None) -> int:
    """Links per chip for the collective roofline term.  Under a TPU
    target the spec's ICI topology (v5e/v6e 2D torus -> 4, v4/v5p 3D
    torus -> 6), as the reference; under the H100 its NVLink 4 link
    count.  ``spec=None`` uses the process-default target; the link
    count is a chip property, not a mesh property."""
    from repro_torch.core.hw import HopperSpec, require_tpu, resolve_target
    s = resolve_target(spec)
    if isinstance(s, HopperSpec):
        return s.nvlink_links
    return require_tpu(s, "launch.mesh.ici_links").ici_links


# ---------------------------------------------------------------------------
# process worlds
# ---------------------------------------------------------------------------


def init_world(device: str = "cuda") -> Tuple[int, int]:
    """Join the process group that ``torchrun`` (or `spawn_world`)
    describes in ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` (without them, a world of this one process): NCCL
    on the card, where each rank takes ``LOCAL_RANK``'s device, gloo on
    the CPU.  Returns (rank, world size)."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:      # a lone process
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                              MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(_free_port()))
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return dist.get_rank(), dist.get_world_size()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world_entry(rank, world, port, backend, fn, args, q):
    import torch
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        if backend == "nccl":           # one card a rank, as init_world
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, rank=rank, world_size=world,
                                init_method=f"tcp://127.0.0.1:{port}")
        out = fn(rank, world, *args)
        dist.barrier()
        q.put((rank, True, out))
    except Exception:                   # reported to the parent, which raises
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn: Callable[..., Any], world_size: int, *args,
                backend: str = "gloo", timeout: float = 120.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one process group on this host (IPv4 loopback:
    ``localhost`` may resolve to an address the store does not listen
    on); returns every
    rank's result, in rank order.  ``fn`` must be importable (a module-
    level function).  A rank that raises, or a world that outlives
    ``timeout`` seconds, raises here, and every process is stopped."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_world_entry,
                         args=(r, world_size, port, backend, fn, args, q))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: dict = {}
    try:
        while len(results) < world_size:
            try:
                rank, ok, out = q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"a {world_size}-rank world did not "
                                   f"finish within {timeout:.0f} s")
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]
