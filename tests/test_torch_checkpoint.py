"""The port's checkpoint manager and fault supervisor
(`repro_torch.checkpoint`, `repro_torch.runtime`).

* The six checkpoint and supervisor cases of the reference's
  ``tests/test_checkpoint_fault.py`` on the port (round trip and
  retention, async save, a partial ``.tmp`` directory, a restart after
  a fault, too many faults, and resume determinism: ten straight steps
  against five + checkpoint + restore + five, equal within the
  reference test's 1e-6);
* for the same state, the reference's and the port's ``arrays.npz``
  carry the same keys (the reference's ``keystr`` paths) and equal
  arrays, bit for bit;
* a snapshot is taken in `save`'s caller, so an in-place update right
  after an async save does not reach the file;
* the ``scheduled_fault`` adapter of the reference's
  ``test_tuning_service.py``, on the port.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.models import ModelConfig as RefModelConfig
from repro.models import Param as RefParam
from repro.models import build_model as ref_build_model
from repro.optim import init_adamw as ref_init_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, TokenStream
from repro_torch.distributed import make_train_step
from repro_torch.models import (ModelConfig, Param, build_model,
                                from_numpy_tree)
from repro_torch.models.params import tree_leaves
from repro_torch.optim import AdamWConfig, init_adamw
from repro_torch.runtime import (FaultPolicy, FaultSchedule,
                                 TrainSupervisor, scheduled_fault)

CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv=2, d_ff=64, vocab=128)


def _setup():
    model = build_model(CFG)
    params = model.init(seed=0, device="cpu", param_dtype=torch.float32)
    opt = init_adamw(params)
    step = make_train_step(model, AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                              decay_steps=50))
    stream = TokenStream(DataConfig(vocab=128, global_batch=4, seq_len=32))
    make_batch = lambda s: {k: torch.from_numpy(v)
                            for k, v in stream.make_batch(s).items()}
    return model, params, opt, step, make_batch


def _clone(tree):
    """A deep copy: the train step updates its state in place."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, Param):
        return Param(tree.value.clone(), tree.dims)
    return tree.clone()


def _leaves(tree):
    return [(leaf.value if isinstance(leaf, Param) else leaf)
            for _, leaf in tree_leaves(tree)]


@pytest.mark.parametrize("async_save", [False, True])
def test_roundtrip_and_retention(tmp_path, async_save):
    _, params, opt, _, _ = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=async_save)
    for s in (10, 20, 30):
        mgr.save(s, {"params": params, "opt": opt, "step": s})
    mgr.wait()
    assert mgr.all_steps() == [20, 30]          # retention
    back = mgr.restore()
    assert back["step"] == 30
    for a, b in zip(_leaves(params), _leaves(back["params"])):
        assert b.device.type == "cpu" and torch.equal(a, b)
    assert back["opt"]["count"].dtype == torch.int32
    # Param dims metadata survives the round trip
    dims = lambda t: [p.dims for _, p in tree_leaves(t)]
    assert dims(params) == dims(back["params"])
    assert dims(opt["m"]) == dims(back["opt"]["m"])
    assert mgr.meta(30)["step"] == 30 and mgr.meta(30)["complete"]
    mgr.close()


def test_async_save_and_wait(tmp_path):
    _, params, opt, _, _ = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(1, {"params": params, "opt": opt, "step": 1})
    mgr.wait()
    assert mgr.latest_step() == 1
    mgr.close()
    assert not mgr._worker.is_alive()


def test_partial_tmp_dir_is_ignored(tmp_path):
    _, params, opt, _, _ = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(5, {"params": params, "opt": opt, "step": 5})
    # an interrupted save
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.latest_step() == 5


def test_the_snapshot_is_taken_before_save_returns(tmp_path):
    """An async save of CPU tensors, then the next step's in-place
    update before the write: the file holds the values at save time."""
    _, params, opt, _, _ = _setup()
    want = [t.clone() for t in _leaves(params)]
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"params": params, "opt": opt, "step": 1})
    for t in _leaves(params):
        t.add_(1.0)
    mgr.wait()
    for a, b in zip(want, _leaves(mgr.restore(1)["params"])):
        assert torch.equal(a, b)
    mgr.close()


def test_bfloat16_leaves_round_trip_and_meshes_wait_for_a8b(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    x = torch.randn(3, 5).to(torch.bfloat16)
    mgr.save(2, {"params": {"w": Param(x, ("embed", None))}, "step": 2})
    back = mgr.restore(2)
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"].value, x)
    assert back["params"]["w"].dims == ("embed", None)
    assert back["step"] == 2
    # the name predates the mesh slice: a restore onto a mesh (here one
    # rank's) now places each Param leaf by the weight rules
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method="tcp://localhost:0",
                            rank=0, world_size=1)
    try:
        on_mesh = mgr.restore(2, mesh=make_mesh((1, 1), ("data", "model")))
        w = on_mesh["params"]["w"]
        assert isinstance(w.value, DTensor) and w.dims == ("embed", None)
        assert torch.equal(w.value.full_tensor(), x)
        assert on_mesh["step"] == 2
    finally:
        dist.destroy_process_group()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


@pytest.mark.parametrize("fault,outcome", [("once", "resumes"),
                                           ("always", "gives_up")])
def test_supervisor_restarts_after_a_fault(tmp_path, fault, outcome):
    _, params, opt, step, make_batch = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    armed = {"on": True}

    def inject(s):
        if fault == "once" and s == 7 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected node failure")
        if fault == "always" and s >= 6:
            raise RuntimeError("persistent failure")

    sup = TrainSupervisor(mgr, FaultPolicy(checkpoint_every=5,
                                           max_restarts=2),
                          inject_fault=inject)
    state0 = {"params": params, "opt": opt, "step": 0}
    if outcome == "gives_up":
        with pytest.raises(RuntimeError, match="max_restarts"):
            sup.run(step, state0, make_batch, num_steps=12)
        return
    state = sup.run(step, state0, make_batch, num_steps=12)
    assert state["step"] == 12
    assert mgr.latest_step() in (10, 12)


def test_a_fault_right_after_an_async_save_restarts_from_it(tmp_path,
                                                           monkeypatch):
    """The save of step 5 has returned but its writer is still busy when
    the fault before step 6 fires: the restart waits for it."""
    import time
    write = CheckpointManager._write
    monkeypatch.setattr(CheckpointManager, "_write", lambda self, *a: (
        time.sleep(0.5), write(self, *a))[1])
    _, params, opt, step, make_batch = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    sup = TrainSupervisor(mgr, FaultPolicy(checkpoint_every=5),
                          inject_fault=scheduled_fault(
                              FaultSchedule(after=6, every=0)))
    try:
        state = sup.run(step, {"params": params, "opt": opt, "step": 0},
                        make_batch, num_steps=7)
    finally:
        mgr.close()
    assert state["step"] == 7 and mgr.latest_step() == 5


def test_a_fault_before_the_first_checkpoint_is_fatal(tmp_path):
    _, params, opt, step, make_batch = _setup()
    sup = TrainSupervisor(CheckpointManager(str(tmp_path),
                                            async_save=False),
                          FaultPolicy(checkpoint_every=5),
                          inject_fault=scheduled_fault(
                              FaultSchedule(after=2)))
    with pytest.raises(RuntimeError, match="before first checkpoint"):
        sup.run(step, {"params": params, "opt": opt, "step": 0},
                make_batch, num_steps=4)


def test_resume_is_deterministic(tmp_path):
    """Train 10 straight vs train 5 + checkpoint + resume 5."""
    _, params, opt, step, make_batch = _setup()

    p1, o1 = _clone(params), _clone(opt)
    for s in range(10):
        p1, o1, _ = step(p1, o1, make_batch(s))

    p2, o2 = _clone(params), _clone(opt)
    for s in range(5):
        p2, o2, _ = step(p2, o2, make_batch(s))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, {"params": p2, "opt": o2, "step": 5})
    back = mgr.restore()
    p3, o3 = back["params"], back["opt"]
    for s in range(5, 10):
        p3, o3, _ = step(p3, o3, make_batch(s))

    for a, b in zip(_leaves(p1), _leaves(p3)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_both_managers_write_the_same_arrays(tmp_path):
    ref_cfg = RefModelConfig(name="t", family="moe", n_layers=2, d_model=32,
                             n_heads=4, n_kv=2, d_ff=64, vocab=128,
                             n_experts=4, top_k=2, n_shared=1,
                             d_ff_expert=16, first_dense_layers=1)
    params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    opt = ref_init_adamw(params)
    RefManager(str(tmp_path / "ref"), async_save=False).save(
        3, {"params": params, "opt": opt, "step": 3})
    as_np = lambda t: jax.tree.map(
        lambda p: (np.asarray(p.value), p.dims)
        if isinstance(p, RefParam) else np.asarray(p), t,
        is_leaf=lambda x: isinstance(x, RefParam))
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        3, {"params": from_numpy_tree(as_np(params), device="cpu"),
            "opt": from_numpy_tree(as_np(opt), device="cpu"), "step": 3})
    with np.load(tmp_path / "ref" / "step_00000003" / "arrays.npz") as r, \
            np.load(tmp_path / "port" / "step_00000003" / "arrays.npz") as p:
        assert sorted(p.files) == sorted(r.files)
        assert "['params']['blocks']['attn']['wk'][<flat index 0>]" in p.files
        assert "['opt']['count']" in p.files and "['step']" in p.files
        for k in r.files:
            assert p[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)


def test_scheduled_fault_adapts_to_train_supervisor_hook():
    inject = scheduled_fault(FaultSchedule(after=3, every=0),
                             exc=lambda step: OSError(f"step {step}"))
    inject(10)
    inject(11)
    with pytest.raises(OSError, match="step 12"):
        inject(12)
    inject(13)          # budget-less after=3, every=0: fires exactly once
