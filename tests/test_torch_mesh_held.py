"""The meshed training step from a shared state, and its host cost.

* one meshed step restored from an unmeshed checkpoint (the port's
  `CheckpointManager`, ``restore(step, mesh=)``) equals the unmeshed
  step from the same state: gemma-smoke and qwen2-moe-smoke in
  float32 on a (2, 2) gloo world, the restored parameters the
  checkpoint's bit for bit, losses and grad norms within 1e-5
  relative, parameters within 1e-4 (AdamW's sign-like updates) — the
  CPU counterpart of chip_smoke's held four-card gate;
* the meshed step runs as one local program per rank: in one step of
  each arch on a (2, 2) world no op of its body (the batch's layout,
  the loss, its backward and the gradients' reduction) passes through
  DTensor's dispatcher, and the whole step's count, the optimizer's
  update included, stays at or below `STEP_DISPATCH_CEILING`: 0 for
  both, the update too running on local shards (the DTensor step
  counted 658 for gemma-smoke and 871 for qwen2-moe-smoke, of which 423
  and 502 in its body; the local body with the update on DTensors 233
  and 366: the same `torch_mesh_worlds.dtensor_dispatches` run on each
  tree's package);
* serving on a mesh runs the local program too: a prefill of 4 x 16
  tokens and one greedy decode step of each arch on a (2, 2) world pass
  no op through DTensor (`make_serve_fns(mesh=)` takes the parameters'
  local shards at its edge, and its logits leave whole).
"""
import pytest

import torch_mesh_worlds as worlds

ARCHS = ("gemma-7b", "qwen2-moe-a2.7b")
# the whole step's DTensor dispatches, the optimizer's update included
STEP_DISPATCH_CEILING = {"gemma-7b": 0, "qwen2-moe-a2.7b": 0}


@pytest.mark.parametrize("arch", ARCHS)
def test_a_meshed_step_from_an_unmeshed_checkpoint_is_the_unmeshed_step(
        arch, tmp_path):
    from repro_torch.launch.mesh import spawn_world
    r = spawn_world(worlds.held_step_case, 4, arch, str(tmp_path),
                    timeout=300)[0]
    assert r["step"] == 1 and r["restored_exact"]
    assert r["mesh"][0] == pytest.approx(r["plain"][0], rel=1e-5)
    assert r["mesh"][1] == pytest.approx(r["plain"][1], rel=1e-5)
    assert r["params"] <= 1e-4


@pytest.fixture(scope="module")
def dispatches():
    from repro_torch.launch.mesh import spawn_world
    return spawn_world(worlds.dtensor_dispatches, 4, ARCHS, timeout=300)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_step_s_body_passes_no_op_through_dtensor(dispatches, arch):
    assert dispatches[arch][0] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_the_step_s_dtensor_dispatches_stay_under_their_ceiling(
        dispatches, arch):
    assert dispatches[arch][1] <= STEP_DISPATCH_CEILING[arch]


@pytest.fixture(scope="module")
def serve_dispatches():
    from repro_torch.launch.mesh import spawn_world
    return spawn_world(worlds.serve_dispatches, 4, ARCHS, timeout=300)[0]


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_serving_passes_no_op_through_dtensor(serve_dispatches, arch,
                                                     phase):
    assert serve_dispatches[arch][("prefill", "decode").index(phase)] == 0
