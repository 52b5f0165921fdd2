"""The per-device work of the port's meshed steps against the
reference's compiled SPMD program (``tools/mesh_work.py``).

For seven archs at ``train_4k`` and ``decode_32k`` on the pod256
(16 x 16) production mesh, both cut to two layers: the port's dry-run
record (`repro_torch.launch.dryrun.dryrun_cell` with ``cfg=``, a fake
process group of 256 ranks, the traced per-device program) and the
reference's (``repro.launch.dryrun.dryrun_cell`` compiled in one
subprocess on 512 host devices; its ``make_production_mesh`` patched
there to Auto axes and its ``get_config`` to the same two-layer cut).

* port ``flops`` / reference ``flops`` (each the per-device mix's
  ``mxu_flops``) lies in [0.8, 1.25] for every cell: the MoE experts,
  the SSD blocks and the heads the model dim does not divide are
  partitioned as the reference partitions them, not run whole on every
  rank;
* the port's ``memory_analysis`` has the reference's keys, its
  ``argument_bytes`` equal to ``arg_bytes_per_device``, and its peak
  (arguments + temporaries) is at most 1.25 x the reference's; the
  record names the storages held at the peak (``peak_storages``);
* the collective bytes, port over reference, lie in [0.5, 2.0], both
  sides counted alike (each collective's output, the reference's at
  the width its program holds; `mesh_work.program_collectives`); where
  the reference's program has collectives the port does not by design
  (`mesh_work.BY_DESIGN`: the op and what the port does instead), the
  named ops are present and the ratio holds without them.

`check_cell` (``torch_mesh_worlds``) makes the assertions;
``test_torch_mesh_work_wide.py`` holds the other three archs.
"""
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import mesh_work  # noqa: E402
from torch_mesh_worlds import check_cell  # noqa: E402

ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "mamba2-1.3b",
         "hymba-1.5b", "starcoder2-3b", "gemma-7b", "whisper-tiny")
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
def test_per_device_flops_match_the_reference(reference, arch, shape):
    port = mesh_work.port_record(arch, shape, LAYERS)
    ref = reference()[arch, shape]
    check_cell(port, ref)
