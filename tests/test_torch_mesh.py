"""The port's meshed train step and elastic restore against the
reference's.

The port runs in one spawned 4-rank gloo world on the CPU (a (2, 1, 2)
``pod`` x ``data`` x ``model`` DeviceMesh); the reference in a
subprocess on 4 host devices, on a (2, 1, 2) mesh the test builds with
Auto axes (the reference's own ``make_production_mesh`` builds Explicit
axes under jax 0.9, where its sharding constraints raise).  Both start
from the reference's initial parameters (``PRNGKey(0)``, crossed through
numpy) and see the same `TokenStream` batches (4 x 32).  Tolerances, over
two AdamW steps:

* float32 gemma-smoke at microbatches 1 and 2: loss and grad norm
  within 1e-5 relative, every parameter within 1e-4 absolute of the
  reference's meshed step (the MoE and SSD families:
  `test_torch_mesh_families.py`);
* gemma-smoke in bf16 compute: loss within 5e-4 relative (the reference
  itself moves its bf16 loss by about 1.4e-4 when it shards);
* a checkpoint saved on (2, 1, 2) restores onto (1, 2, 2), each leaf laid
  out by the weight rules there, and onto no mesh, with identical
  arrays;
* serving on the mesh (`make_serve_fns(model, mesh)`, one local
  program per rank): gemma-smoke's float32 prefill logits and two
  greedy decode steps equal the unmeshed path's within 1e-5, with
  tuned layers off and on — on a mesh a tuned op sees whole operands,
  as the reference's serve functions run their Pallas calls on an Auto
  mesh of host devices — and so do qwen2-moe-smoke's, and those of
  mamba2, hymba and whisper with a vocab the model dim does not divide;
* a rank of a spawned NCCL world takes card ``rank`` before it joins
  (card count and calls mocked).
"""
import numpy as np
import pytest

import torch_mesh_worlds as worlds
from repro_torch.launch.mesh import spawn_world

CASES = [dict(arch="gemma-7b", dtype="float32", mb=mb, compress=False)
         for mb in (1, 2)] + [dict(arch="gemma-7b", dtype="bfloat16", mb=1,
                                   compress=False)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.run_train_cases(str(tmp_path_factory.mktemp("mesh")),
                                  CASES)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[worlds.case_id(c) for c in CASES])
def test_meshed_train_steps_match_the_reference(runs, i):
    (ref_metrics, ref_final), port = runs[i]
    worlds.assert_case_matches(CASES[i], ref_metrics, ref_final, port)


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    return spawn_world(worlds.checkpoint_case, 4, str(d),
                       timeout=worlds.WORLD_TIMEOUT)


@pytest.mark.parametrize("target", ["on_122", "host"])
def test_a_checkpoint_restores_onto_another_mesh_and_onto_none(elastic,
                                                                target):
    for r in elastic:                       # every rank sees the same
        assert sorted(r[target]) == sorted(r["saved"])
        for k, v in r["saved"].items():
            assert np.array_equal(r[target][k], v), k
        assert r["step"] == 3


def test_restored_leaves_take_the_weight_rules_layout_of_the_new_mesh(
        elastic):
    r = elastic[0]
    assert r["placements"] and all(shape == "(1, 2, 2)" for shape, _ in
                                   r["placements"].values())
    assert {k: pl for k, (_, pl) in r["placements"].items()} == r["want"]
    assert any("Shard" in " ".join(pl) for pl in r["want"].values())
    assert all(np.all(v == 0) for v in r["moments_on_122"].values())


class MeshStandIn:
    def __init__(self, shape, names=worlds.MESH_AXES):
        self.axis_names = names
        self.devices = np.empty(shape)


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import NamedSharding
    s = NamedSharding(MeshStandIn((2, 2, 2)), (("pod", "data"), None,
                                               "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    # a mesh dim of size 1 holds the whole tensor: Replicate
    s1 = NamedSharding(MeshStandIn((2, 1, 2)), (("pod", "data"), "model"))
    assert s1.placements == (Shard(0), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        NamedSharding(MeshStandIn((2, 2, 2)), (("data", "pod"),)).placements


def test_the_sharder_passes_through_without_a_mesh_and_names_weights_on_one():
    import torch
    from repro_torch.distributed.sharding import (Sharder, WEIGHT_RULES,
                                                  named_sharding)
    x = torch.ones(4, 8)
    assert Sharder().act(x, ("batch", "embed")) is x
    assert Sharder().cache(x, ("batch", "embed")) is x
    assert Sharder().weight_sharding(("embed", "mlp"), (8, 16)) is None
    mesh = MeshStandIn((16, 16), ("data", "model"))
    got = Sharder(mesh).weight_sharding(("embed", "mlp"), (32, 64))
    assert got == named_sharding(("embed", "mlp"), (32, 64), WEIGHT_RULES,
                                 mesh)
    assert got.spec == ("data", "model")


@pytest.fixture(scope="module")
def served():
    return {tuned: spawn_world(worlds.serve_case, 4, "gemma-7b", tuned,
                               timeout=worlds.WORLD_TIMEOUT)[0]
            for tuned in (False, True)}


@pytest.mark.parametrize("tuned", [False, True])
def test_serving_on_a_mesh_matches_the_unmeshed_path(served, tuned):
    (meshed, m_tokens), (plain, p_tokens) = served[tuned]
    for a, b in zip(meshed, plain):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(m_tokens, p_tokens):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b",
                                  "whisper-tiny"])
def test_serving_an_indivisible_vocab_on_a_mesh_matches_the_unmeshed_path(
        arch):
    """A vocab of 509 the model dim does not divide, on (pod, data,
    model) = (1, 2, 2): the decode step's lm head contracts each rank's
    embed rows against its vocab chunk with the batch's tokens
    gathered, the embedding is looked up in each rank's columns, and
    hymba's in-projection gathers its column chunk alone; logits and
    greedy tokens as the unmeshed path's."""
    (meshed, m_tokens), (plain, p_tokens) = spawn_world(
        worlds.serve_case, 4, arch, False, 509, (1, 2, 2),
        timeout=worlds.WORLD_TIMEOUT)[0]
    for a, b in zip(meshed, plain):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(m_tokens, p_tokens):
        assert np.array_equal(a, b)


def test_serving_an_moe_on_a_mesh_matches_the_unmeshed_path():
    """qwen2-moe-smoke on (pod, data, model) = (2, 1, 2): the prefill's
    and two decode steps' routing, dispatch and expert products in the
    local program, the caches tagged local shards from the prefill to
    the decode; logits and greedy tokens as the unmeshed path's."""
    (meshed, m_tokens), (plain, p_tokens) = spawn_world(
        worlds.serve_case, 4, "qwen2-moe-a2.7b", False,
        timeout=worlds.WORLD_TIMEOUT)[0]
    for a, b in zip(meshed, plain):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(m_tokens, p_tokens):
        assert np.array_equal(a, b)


def test_tree_shardings_resolve_each_leaf_by_its_dims():
    import torch
    from repro_torch.distributed.sharding import (WEIGHT_RULES,
                                                  named_sharding,
                                                  tree_shardings)
    mesh = MeshStandIn((16, 16), ("data", "model"))
    shapes = {"a": torch.empty(32, 48, device="meta"),
              "b": {"c": torch.empty(7, 64, device="meta")}}
    dims = {"a": ("embed", "mlp"), "b": {"c": ("embed", "vocab")}}
    got = tree_shardings(mesh, shapes, dims, WEIGHT_RULES)
    assert got["a"] == named_sharding(("embed", "mlp"), (32, 48),
                                      WEIGHT_RULES, mesh)
    assert got["a"].spec == ("data", "model")
    assert got["b"]["c"].spec == (None, "model")   # 7 rows: no data shard



class _Queue(list):
    put = list.append


@pytest.mark.parametrize("backend,rank", [("nccl", 0), ("nccl", 3),
                                          ("gloo", 1)])
def test_a_spawned_nccl_rank_takes_its_own_card(monkeypatch, backend, rank):
    """`spawn_world`'s entry joins an NCCL world only after the rank's
    card is the current device (four cards, mocked: no card here); a
    gloo rank leaves the card alone."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh

    current, events = [None], []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: (current.append(d), events.append("set")))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda b, **kw: events.append(b))
    monkeypatch.setattr(dist, "barrier", lambda: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):       # undone after the test: the entry
        monkeypatch.setenv(k, "")   # sets them for the process
    q = _Queue()
    mesh._world_entry(rank, 4, 29500, backend, lambda r, w: current[-1],
                      (), q)
    if backend == "nccl":
        assert q == [(rank, True, rank)] and events == ["set", "nccl"]
    else:
        assert q == [(rank, True, None)] and events == ["gloo"]
