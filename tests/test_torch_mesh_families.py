"""The port's meshed train step on the MoE, SSD, hybrid, encoder-decoder
and head_dim-fallback families against the reference's.

As `test_torch_mesh.py`: the port in spawned gloo worlds, the reference
in a subprocess on 4 host devices with Auto-axis meshes, both from the
reference's initial parameters and the same batches (whisper's stub
frames made from a seed with numpy), two AdamW steps; float32 smoke
configs: loss and grad norm within 1e-5 relative, every parameter within
1e-4 absolute.

* (pod, data, model) = (2, 1, 2), four ranks, microbatches 1 and 2:
  qwen2-moe (its flat dispatch partitioned as the rule tables say:
  experts or their widths over model, capacity over pod and data) and
  mamba2 (its SSD heads over model);
* (data, model) = (2, 2), four ranks: qwen2-moe flat (expert widths
  over model, capacity over data) and grouped (per sequence, its batch
  over data), mamba2's and hymba's SSD heads, starcoder2's and
  whisper's heads over model;
* (data, model) = (1, 3), three ranks, which divides none of them: the
  heads take the reference's ``head_dim`` fallback, hymba's SSD
  in-projection is split on zero-padded columns, and the vocab stays
  whole (the lm head's weight gradient split by rows).
"""
import pytest

import torch_mesh_worlds as worlds

LAYOUTS = (("qwen2-moe-a2.7b", {}),
           ("qwen2-moe-a2.7b", {"dispatch": "grouped"}),
           ("mamba2-1.3b", {}), ("hymba-1.5b", {}), ("whisper-tiny", {}),
           ("starcoder2-3b", {}))
MESHES = (((2, 2), ("data", "model")), ((1, 3), ("data", "model")))
CASES = [dict(arch=a, dtype="float32", mb=mb, compress=False)
         for a in ("qwen2-moe-a2.7b", "mamba2-1.3b") for mb in (1, 2)] + [
    dict(arch=a, dtype="float32", mb=1, compress=False, mesh=m, **kw)
    for m in MESHES for a, kw in LAYOUTS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.run_train_cases(str(tmp_path_factory.mktemp("families")),
                                  CASES, timeout=600)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[worlds.case_id(c) for c in CASES])
def test_meshed_train_steps_match_the_reference(runs, i):
    (ref_metrics, ref_final), port = runs[i]
    worlds.assert_case_matches(CASES[i], ref_metrics, ref_final, port)
