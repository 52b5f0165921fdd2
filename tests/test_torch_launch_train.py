"""The port's training entry point, ``python -m repro_torch.launch.train``
(and ``repro_torch.examples.train_lm``), on the CPU.

* ``--smoke --device cpu`` trains and the loss falls (as the reference's
  ``tests/test_system.py::test_training_loss_decreases``: by more than
  0.2 nats, every loss finite);
* through ``--checkpoint-dir``, a fault after the first checkpoint and a
  restart from it give the uninterrupted run's parameters bit for bit
  (the CPU's kernels repeat their bits), for a decoder-only config and
  for whisper's frames front end;
* without ``--device cpu`` and without a card it raises instead of
  training on the CPU; ``--mesh single|multi`` in a world smaller than
  the production mesh, and ``--compress-pod-grads`` without a mesh,
  raise;
* the timed steps run under no dispatch mode, and a step taken after
  them with the run's ``train_step`` (chip_smoke's `counted_step`) runs
  under ``CommDebugMode``: ``[mesh]`` (a) counts collectives there and
  times the meshed and the unmeshed steps the same way;
* under ``torchrun`` with two ranks on gloo, ``--mesh-shape 1,2`` trains
  gemma-smoke on a (data, model) mesh, only rank 0 printing, its first
  loss within 2e-3 relative of the unmeshed run's (bf16 compute).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train
from repro_torch.models.params import tree_leaves
from repro_torch.runtime import FaultSchedule, scheduled_fault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--log-every", "0"]


def test_smoke_training_on_the_cpu_lowers_the_loss():
    rep = train.main(["--arch", "gemma-7b", "--smoke", "--steps", "20",
                      "--batch", "8", "--seq", "64", *CPU])
    losses = rep["losses"]
    assert rep["device"] == "cpu" and rep["steps"] == 20
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, losses[::5]
    assert all(np.isfinite(rep["grad_norms"]))
    assert rep["peak_bytes"] is None          # no card: nothing measured
    for _, leaf in tree_leaves(rep["state"]["params"]):
        assert leaf.dtype == torch.float32    # f32 masters


@pytest.mark.parametrize("arch", ["gemma-7b", "whisper-tiny"])
def test_a_fault_and_restart_give_the_uninterrupted_parameters(tmp_path,
                                                               arch):
    argv = ["--arch", arch, "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "32", "--checkpoint-every", "2", *CPU]
    clean = train.main(argv + ["--checkpoint-dir", str(tmp_path / "a")])
    # the hook's 4th call (before step 3) fires once, after the
    # checkpoint of step 2: step 2 runs again from it
    faulted = train.main(argv + ["--checkpoint-dir", str(tmp_path / "b")],
                         inject_fault=scheduled_fault(FaultSchedule(
                             after=4, every=0)))
    assert clean["steps"] == faulted["steps"] == 6
    assert len(faulted["losses"]) == len(clean["losses"]) + 1
    for (path, a), (_, b) in zip(
            tree_leaves(clean["state"]["params"]),
            tree_leaves(faulted["state"]["params"])):
        assert torch.equal(a.value, b.value), path
    assert torch.equal(clean["state"]["opt"]["count"],
                       faulted["state"]["opt"]["count"])


def test_the_timed_steps_run_under_no_dispatch_mode():
    import unittest.mock as mock
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    import chip_smoke
    from repro_torch import distributed

    modes = []

    def recording(*a, **k):
        step = make_step(*a, **k)

        def run(*args):
            modes.append((
                [type(m).__name__ for m in _get_current_dispatch_mode_stack()],
                [type(m).__name__ for m in
                 torch.overrides._get_current_function_mode_stack()]))
            return step(*args)
        return run

    make_step = distributed.make_train_step
    with mock.patch.object(distributed, "make_train_step", recording):
        rep = train.main(["--arch", "gemma-7b", "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "16", *CPU])
    assert rep["steps"] == 3 and modes == [([], [])] * 3
    assert rep["host_ms_per_step"] <= rep["ms_per_step"]
    assert chip_smoke.counted_step(rep) == {}       # no mesh: none
    assert len(modes) == 4 and "CommDebugMode" in modes[3][0]


def test_without_a_card_it_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "gemma-7b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("flags", [["--mesh", "single"], ["--mesh", "multi"],
                                   ["--compress-pod-grads"]])
def test_mesh_flags_wait_for_a8b(flags):
    # the name predates the mesh slice: the flags now run, and refuse a
    # world smaller than the production mesh or compression without one
    import torch.distributed as dist
    try:
        with pytest.raises(ValueError,
                           match="needs 256 ranks|needs 512 ranks|needs a "
                                 "mesh"):
            train.main(["--arch", "gemma-7b", "--smoke", *CPU, *flags])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_torchrun_trains_on_a_two_rank_mesh():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    args = ["--arch", "gemma-7b", "--smoke", "--steps", "3", "--batch", "4",
            "--seq", "32", "--device", "cpu", "--log-every", "1"]
    from repro_torch.launch.mesh import _free_port
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), "-m", "repro_torch.launch.train", *args,
         "--mesh-shape", "1,2"],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "mesh {'data': 1, 'model': 2}" in out.stdout
    steps = [ln for ln in out.stdout.splitlines()
             if ln.startswith("[train] step=")]
    assert len(steps) == 3                    # rank 0 alone prints
    meshed = float(steps[0].split("loss=")[1].split()[0])
    plain = train.main(args[:-2] + ["--log-every", "0"])["losses"][0]
    assert meshed == pytest.approx(plain, rel=2e-3)


def test_the_cli_and_the_example_run():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-1.3b", "--smoke", "--steps", "4", "--batch", "2",
         "--seq", "32", "--device", "cpu", "--log-every", "2"],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "[train] step=4 loss=" in out.stdout
    from repro_torch.examples import train_lm
    state = train_lm.main(["--arch", "qwen2-moe-a2.7b", "--steps", "4",
                           "--batch", "4", "--seq", "32", "--device", "cpu"])
    assert state["step"] == 4
