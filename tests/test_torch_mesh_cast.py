"""The meshed training step moves each weight in the type the reference's
compiled program moves it.

The reference casts a weight to the compute type where it computes
(``p["wq"].value.astype(x.dtype)``), and its compiled program gathers
the cast shard, reduces the bf16 gradient and widens it on the shard:
in `tools/mesh_work.py`'s reading of gemma-7b ``train_4k`` on pod256,
every weight all-gather of a ``dot_general`` holds bf16 and the gains'
(``mul``) all-gathers float32, and the gains' gradients are float32
``reduce_sum`` results (the compile only combines them into a promoted
tuple all-reduce with the bf16 ones).  The port casts with
`sharding.cast` before the collective:

* a cast keeps a tagged local's layout and its key (a parameter's index,
  which its data-parallel reduction is recorded under); a float32 tensor
  cast to float32 is itself;
* a cast shard's pending reduction is recorded in its type, and a
  float32 use of the same parameter widens it;
* in a bf16 step on a (2, 2) gloo world (gemma-smoke and
  qwen2-moe-smoke) every weight a product takes — the projections, the
  MLP's and the experts', the lm head — and every bias moves in bf16 and
  takes its gradient back in bf16; qwen2's biases, whole over the data
  dim, are reduced after the backward in bf16; the gains and the router
  move in float32, as the reference computes with them;
* in a float32 step nothing is cast: every move is float32.
"""
import pytest
import torch
from torch.distributed.tensor import Replicate

import torch_mesh_worlds as worlds
from repro_torch.distributed.sharding import (Lay, cast, layout,
                                              pending_reductions, relayout,
                                              tag)

# the weights the reference casts to the compute type where it uses them
CAST = {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_up", "w_gate",
        "w_down", "lm_head", "w_in", "w_out", "conv_w", "conv_b",
        "beta_a", "beta_m", "enc_pos"}
CASES = (("gemma-7b", "bfloat16"), ("qwen2-moe-a2.7b", "bfloat16"),
         ("gemma-7b", "float32"))


def _shard(key=7):
    # a parameter's shard on a mesh of one dim (the mesh is never read:
    # nothing moves)
    return tag(torch.ones(2, 3), Lay(None, (Replicate(),), (2, 3), key))


def test_a_cast_keeps_its_parameters_layout_and_key():
    w = _shard()
    c = cast(w, torch.bfloat16)
    assert c.dtype == torch.bfloat16 and layout(c) == layout(w)
    assert layout(c).key == 7
    assert cast(w, torch.float32) is w


def test_a_cast_shards_pending_reduction_is_recorded_in_its_type():
    w = _shard()
    with pending_reductions() as pend:
        # used whole along mesh dim 0, over which the site's work is split
        y = relayout(cast(w, torch.bfloat16), (Replicate(),), pgrad=(0,))
    assert layout(y).key == 7
    assert pend == {7: {0: torch.bfloat16}}
    with pending_reductions() as pend:
        relayout(cast(w, torch.bfloat16), (Replicate(),), pgrad=(0,))
        relayout(w, (Replicate(),), pgrad=(0,))       # a float32 use
    assert pend == {7: {0: torch.float32}}


@pytest.fixture(scope="module")
def moved():
    from repro_torch.launch.mesh import spawn_world
    return spawn_world(worlds.moved_widths, 4, CASES,
                       timeout=worlds.WORLD_TIMEOUT)[0]


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-moe-a2.7b"])
def test_a_bf16_step_moves_each_weight_in_the_reference_s_type(moved,
                                                               arch):
    got = moved[arch, "bfloat16"]
    cast_leaves = [k for k in got if k.split(".")[-1] in CAST]
    assert cast_leaves and len(cast_leaves) < len(got)
    for path, rec in got.items():
        want = ("torch.bfloat16" if path.split(".")[-1] in CAST
                else "torch.float32")
        assert set(rec["forward"]) <= {want}, (path, rec)
        assert set(rec["backward"]) <= {want}, (path, rec)
        assert set(rec["pending"].values()) <= {want}, (path, rec)
        if rec["forward"]:
            assert rec["backward"] == [want], (path, rec)


def test_qwen2_s_biases_are_reduced_after_the_backward_in_bf16(moved):
    got = moved["qwen2-moe-a2.7b", "bfloat16"]
    for name in ("bq", "bk", "bv"):
        assert got[f"blocks.attn.{name}"]["pending"] == {
            0: "torch.bfloat16"}


def test_a_float32_step_casts_nothing(moved):
    got = moved["gemma-7b", "float32"]
    assert got
    for path, rec in got.items():
        assert set(rec["forward"]) | set(rec["backward"]) \
            | set(rec["pending"].values()) == {"torch.float32"}, path
