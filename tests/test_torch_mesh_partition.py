"""The partitioned meshed step against the port's own unmeshed step.

The layouts the reference's rule tables give on two more meshes than
`test_torch_mesh.py`'s (2, 1, 2): (data, model) = (2, 2), four gloo
ranks, and (1, 3), three.  There each smoke config's products run on
their shards (`sharding.shard_einsum`): qwen2-moe's experts over model
and its capacity over data (2, 2), or, dispatched per sequence, its
batch over data; mamba2's and hymba's SSD heads and
starcoder2's and whisper's head_dim shards over model; on (1, 3) the
model dim divides none of them, so the SSD in-projection is split on
zero-padded columns, the vocab stays whole (the lm head's weight
gradient split by rows) and the MoE experts and widths stay whole.
Two float32 train steps from the same seed-0 parameters: losses and
grad norms within 1e-5 relative of the unmeshed steps', parameters
within 1e-5.
"""
import pytest

import torch_mesh_worlds as worlds

ARCHS = ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b+grouped", "mamba2-1.3b",
         "hymba-1.5b", "whisper-tiny", "starcoder2-3b")
SHAPES = ((2, 2), (1, 3))


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import spawn_world
    return {shape: spawn_world(worlds.meshed_and_plain, shape[0] * shape[1],
                               shape, ARCHS, timeout=600)[0]
            for shape in SHAPES}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_a_partitioned_step_equals_the_unmeshed_one(runs, shape, arch):
    r = runs[shape][arch]
    for (loss, norm), (want_loss, want_norm) in zip(r["mesh"], r["plain"]):
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert norm == pytest.approx(want_norm, rel=1e-5)
    assert r["params"] <= 1e-5
