"""The per-device work, memory and collectives of the port's meshed
steps against the reference's compiled SPMD program for the three
widest archs — starcoder2-7b, qwen1.5-110b and chameleon-34b — at
``train_4k`` and ``decode_32k`` on the pod256 (16 x 16) production
mesh, both cut to two layers, under the assertions of
``test_torch_mesh_work.py`` (`torch_mesh_worlds.check_cell`).  A file
of its own, with its own reference subprocess, so that a worker takes
it apart from the other seven archs."""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import mesh_work  # noqa: E402
from torch_mesh_worlds import check_cell  # noqa: E402

ARCHS = ("starcoder2-7b", "qwen1.5-110b", "chameleon-34b")
SHAPES = ("train_4k", "decode_32k")
LAYERS = 2
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


@pytest.fixture(scope="module")
def reference():
    """The reference's records of every cell, from one subprocess that
    compiles while the port's cells trace in this process."""
    proc = mesh_work.start_reference(CELLS, LAYERS)
    got = {}

    def records():
        if not got:
            got.update(mesh_work.reference_records(proc, timeout=900))
        return got
    yield records
    if proc.poll() is None:
        proc.kill()
        proc.communicate()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_the_widest_archs_match_the_reference(reference, arch, shape):
    check_cell(mesh_work.port_record(arch, shape, LAYERS),
               reference()[arch, shape])
