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
                               shape, ("gemma-7b",) + ARCHS, timeout=600)[0]
            for shape in SHAPES}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_a_partitioned_step_equals_the_unmeshed_one(runs, shape, arch):
    r = runs[shape][arch]
    for (loss, norm), (want_loss, want_norm) in zip(r["mesh"], r["plain"]):
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert norm == pytest.approx(want_norm, rel=1e-5)
    assert r["params"] <= 1e-5


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gemma_s_partitioned_losses_and_grad_norms_equal_the_unmeshed_ones(
        runs, shape):
    """gemma's embed dim sharded over data on (2, 2): its embedding
    looked up in each rank's columns and moved onto the batch by an
    all-to-all, its vocab's loss on shards.  Losses and grad norms as
    the other archs'; its parameters after two AdamW steps are recorded
    within 1e-4, not 1e-5: AdamW's first, sign-like updates carry the
    float32 reordering of near-zero gradients to a whole step's size."""
    r = runs[shape]["gemma-7b"]
    for (loss, norm), (want_loss, want_norm) in zip(r["mesh"], r["plain"]):
        assert loss == pytest.approx(want_loss, rel=1e-5)
        assert norm == pytest.approx(want_norm, rel=1e-5)
    assert r["params"] <= 1e-4
