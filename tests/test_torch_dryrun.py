"""The port's multi-pod dry-run (``python -m repro_torch.launch.dryrun``)
against the reference's ``dryrun_cell``.

* The analytic fields of gemma-7b ``train_4k`` on pod256 and pod512 —
  ``chips``, ``microbatches``, ``arg_bytes_per_device``, ``model_flops``,
  ``n_params``, ``n_active_params`` — equal the reference's, computed in
  a subprocess on 512 host devices from its ``cell_inputs``,
  ``tree_bytes_per_device`` and ``recommended_microbatches`` (the
  fields its ``dryrun_cell`` records; no compile).  A full-attention
  arch at ``long_500k`` is skipped with the reference's reason.
* A traced cell (depth cut to one layer; a fake process group of 256
  or 512 ranks, meta DTensors, nothing allocated) records the
  per-device mix and the collectives: finite positive flops and bytes,
  collective counts equal to ``CommDebugMode``'s, the H100 roofline's
  terms from them, the trace's memory under the reference's keys, and
  the XLA-only fields null with their reason.
* ``main`` writes one JSON record per cell.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYTIC = ("chips", "microbatches", "arg_bytes_per_device", "model_flops",
            "n_params", "n_active_params")

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import get_config
from repro.distributed.train import recommended_microbatches
from repro.launch.mesh import make_production_mesh, mesh_num_chips
from repro.launch.specs import cell_inputs, tree_bytes_per_device
from repro.models import build_model
from repro.models.config import LM_SHAPES
out = {}
for tag, multi in (("pod256", False), ("pod512", True)):
    mesh = make_production_mesh(multi_pod=multi)
    cfg = get_config("gemma-7b")
    model = build_model(cfg)
    shape = LM_SHAPES["train_4k"]
    args = cell_inputs(model, shape, mesh)
    out[tag] = dict(
        chips=mesh_num_chips(mesh),
        microbatches=recommended_microbatches(cfg, shape, mesh),
        arg_bytes_per_device=int(tree_bytes_per_device(args, mesh)),
        model_flops=model.model_flops(shape), n_params=cfg.num_params(),
        n_active_params=cfg.num_active_params())
    ok, why = model.supports_shape(LM_SHAPES["long_500k"])
    out["long_500k"] = [ok, why]
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


@pytest.fixture
def fake_world():
    """Drop the dry-run's fake process group after the test."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("tag", ["pod256", "pod512"])
def test_the_analytic_fields_match_the_reference(ref, tag, fake_world):
    rec = dryrun.dryrun_cell("gemma-7b", "train_4k", tag == "pod512",
                             trace=False)
    assert rec["status"] == "ok"
    assert {k: rec[k] for k in ANALYTIC} == ref[tag]
    assert rec["flops"] is None and "traced" in rec["why"]


def test_a_full_attention_arch_skips_long_500k_as_the_reference(ref):
    rec = dryrun.dryrun_cell("gemma-7b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert [False, rec["reason"]] == ref["long_500k"]


@pytest.mark.parametrize("arch,shape,multi", [
    ("gemma-7b", "train_4k", False), ("gemma-7b", "decode_32k", True),
    ("mamba2-1.3b", "prefill_32k", False),
    ("qwen2-moe-a2.7b", "train_4k", True)])
def test_a_traced_cell_records_the_per_device_mix_and_collectives(
        arch, shape, multi, fake_world):
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, first_dense_layers=0)
    rec = dryrun.dryrun_cell(arch, shape, multi, cfg=cfg)
    assert rec["status"] == "ok" and rec["chips"] == (512 if multi else 256)
    for k in ("flops", "bytes_accessed", "vpu_flops", "collective_bytes"):
        assert 0 < rec[k] < float("inf"), k
    assert rec["collective_bytes"] == sum(rec["collectives_by_kind"].values())
    names = {"all-reduce": "c10d_functional.all_reduce",
             "all-gather": "c10d_functional.all_gather_into_tensor",
             "reduce-scatter": "c10d_functional.reduce_scatter_tensor",
             "all-to-all": "c10d_functional.all_to_all_single"}
    assert {names[k]: int(v) for k, v in rec["collective_counts"].items()} \
        == rec["comm_debug_counts"]
    roof = rec["roofline"]
    assert roof["spec"] == "h100-sxm" and rec["ici_links"] == 18
    assert roof["t_collective"] == rec["collective_bytes"] / (18 * 50e9)
    assert roof["t_memory"] == rec["bytes_accessed"] / 3.35e12
    for k in ("hlo_instructions", "xla_cost_analysis"):
        assert rec[k] is None and rec["why"][k]
    # the trace's memory under the reference's keys: the arguments'
    # local bytes are the analytic residency, the step's own storages
    # peak above nothing, and there is no generated code
    mem = rec["memory_analysis"]
    assert sorted(mem) == ["argument_bytes", "generated_code_bytes",
                           "output_bytes", "temp_bytes"]
    assert mem["argument_bytes"] == rec["arg_bytes_per_device"]
    assert mem["temp_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["generated_code_bytes"] is None \
        and rec["why"]["generated_code_bytes"]
    # the per-device program: a step's flops are a shard's, not the
    # whole cell's (model_flops counts every layer of the full depth),
    # the MoE experts' included (each rank runs its own experts or
    # expert-MLP shard on its capacity slots)
    assert rec["flops"] < rec["model_flops"] / rec["chips"] * 4


def test_main_writes_one_record_per_cell(tmp_path, fake_world):
    dryrun.main(["--arch", "gemma-7b", "--shape", "train_4k", "--multi-pod",
                 "--analytic-only", "--out-dir", str(tmp_path)])
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert sorted(recs) == ["gemma-7b_train_4k_pod256.json",
                            "gemma-7b_train_4k_pod512.json"]
    assert all(r["status"] == "ok" for r in recs.values())
