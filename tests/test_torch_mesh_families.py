"""The port's meshed train step on the MoE and SSD families against the
reference's.

As `test_torch_mesh.py`: the port in one spawned 4-rank gloo world on a
(2, 1, 2) ``pod`` x ``data`` x ``model`` mesh, the reference in a
subprocess on 4 host devices with an Auto-axis (2, 1, 2) mesh, both
from the reference's initial parameters and the same batches.  float32
copies of qwen2-moe smoke (its routing runs on whole operands on every
rank) and mamba2 smoke (its SSD block on each rank's batch shard), at
microbatches 1 and 2, two AdamW steps: loss and grad norm within 1e-5
relative, every parameter within 1e-4 absolute.
"""
import pytest

import torch_mesh_worlds as worlds

CASES = [dict(arch=a, dtype="float32", mb=mb, compress=False)
         for a in ("qwen2-moe-a2.7b", "mamba2-1.3b") for mb in (1, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.run_train_cases(str(tmp_path_factory.mktemp("families")),
                                  CASES)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[worlds.case_id(c) for c in CASES])
def test_meshed_train_steps_match_the_reference(runs, i):
    (ref_metrics, ref_final), port = runs[i]
    worlds.assert_case_matches(CASES[i], ref_metrics, ref_final, port)
