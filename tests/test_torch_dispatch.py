"""Dispatch parity with the reference, and the port's H100 dispatch.

* For the four serving-path kernels, at the gemma-smoke and gemma-7b
  serve signatures and at their ``pretune`` grids, under ``tpu-v5e`` and
  ``kepler_k20``: the port's `lookup_or_tune` returns the reference's
  params and builds the reference's cache key.
* Freeze / thaw behave as the reference's do.
* Under ``h100`` every winner of the gemma-7b serve instances is a
  compiled instantiation that fits the card's limits.
* The port imports neither JAX nor the reference package.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401
from repro import tuning_cache as ref_tc
from repro.core.autotuner import GraphTuner as RefGraphTuner
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.core.target import use_target as ref_use_target
from repro.kernels import api as ref_api
from repro_torch import tuning_cache as tc
from repro_torch.core import hw
from repro_torch.core.target import use_target
from repro_torch.kernels import api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("matmul", "rms_norm", "flash_attention", "mlp_matmul")


def _serve_signatures():
    """(kernel, signature) instances the reference's serving path
    dispatches for gemma-smoke and gemma-7b (batch 4, prompt 64)."""
    out = []
    for cfg in (ref_get_smoke("gemma-7b"), ref_get_config("gemma-7b")):
        rep = RefGraphTuner.tune_config(cfg, batch=4, prompt_len=64,
                                        tune=False)
        out += [(i["kernel"], i["signature"]) for i in rep["instances"]]
    return out


SERVE = _serve_signatures()
PRETUNE = [(k, s) for k in KERNELS for s in ref_api.get_spec(k).pretune]
CASES = SERVE + PRETUNE
_IDS = [f"{k}-{'-'.join(str(v) for v in s.values())}" for k, s in CASES]


@pytest.fixture(autouse=True)
def _fresh_dbs():
    ref_tc.set_default_db(ref_tc.TuningDatabase())
    tc.set_default_db(tc.TuningDatabase())
    yield
    ref_tc.reset_default_db()
    tc.reset_default_db()


def test_serve_instances_are_the_four_kernels():
    assert len(SERVE) == 14
    assert {k for k, _ in SERVE} == set(KERNELS)


@pytest.mark.parametrize("target", ["tpu-v5e", "kepler_k20"])
@pytest.mark.parametrize("kernel_id,sig", CASES, ids=_IDS)
def test_lookup_or_tune_and_key_match_reference(kernel_id, sig, target):
    ref_db, db = ref_tc.TuningDatabase(), tc.TuningDatabase()
    want = ref_tc.lookup_or_tune(kernel_id, spec=target, db=ref_db, **sig)
    got = tc.lookup_or_tune(kernel_id, spec=target, db=db, **sig)
    assert got == want
    (rk,), (pk,) = ([r.key for r in d.snapshot()] for d in (ref_db, db))
    assert pk.to_dict() == rk.to_dict()
    assert pk.digest == rk.digest


def test_default_path_memo_and_freeze_match_reference():
    """Same signature sequence through both packages' default paths: the
    same params, the same frozen-entry count, the same frozen answers,
    and the same thaw on a database bulk mutation."""
    sigs = [(k, s) for k, s in SERVE[:7]]
    with ref_use_target("tpu-v5e"), use_target("tpu-v5e"):
        for k, s in sigs:
            assert tc.lookup_or_tune(k, **s) == ref_tc.lookup_or_tune(k, **s)
        # both default databases hold the same records; the reference's
        # also holds its shipped pretuned JSONL, the port ships none
        ref_tc.get_default_db().clear()
        for k, s in sigs:
            ref_tc.lookup_or_tune(k, **s)
        n_ref, n = ref_tc.freeze(), tc.freeze()
        assert n == n_ref == 7
        assert tc.is_frozen() and ref_tc.is_frozen()
        for k, s in sigs:
            assert tc.frozen_lookup(k, s) == ref_tc.frozen_lookup(k, s)
        tc.get_default_db().clear()
        ref_tc.get_default_db().clear()
        assert not tc.is_frozen() and not ref_tc.is_frozen()


def test_set_default_target_thaws_like_the_reference():
    from repro.core.target import set_default_target as ref_set
    from repro_torch.core.target import set_default_target
    with use_target("tpu-v5e"):
        tc.lookup_or_tune("rms_norm", m=256, d=64, dtype="float32")
    tc.freeze()
    assert tc.is_frozen()
    try:
        set_default_target("tpu-v6e")
        assert not tc.is_frozen()
        ref_set("tpu-v6e")
        assert not ref_tc.is_frozen()
    finally:
        set_default_target(None)
        ref_set(None)


def test_ops_dispatch_counts_frozen_on_cpu_tensors():
    import torch
    from repro_torch.kernels import ops
    x = torch.ones(8, 64)
    w = torch.ones(64)
    with use_target("tpu-v5e"):
        api.reset_dispatch_stats()
        ops.rms_norm(x, w)
        assert api.dispatch_stats()["live"] == 1
        tc.freeze()
        ops.rms_norm(x, w)
        st = api.dispatch_stats()
    assert st["frozen"] == 1 and st["total"] == 2 and st["fallback"] == 0


def test_pipeline_model_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="pipeline"):
        tc.lookup_or_tune("rms_norm", spec="tpu-v5e", model="pipeline",
                          db=tc.TuningDatabase(), m=8, d=64,
                          dtype="float32")


# ---------------------------------------------------------------------------
# the H100 launch space
# ---------------------------------------------------------------------------

GEMMA_7B = SERVE[7:]


@pytest.mark.parametrize("kernel_id,sig", GEMMA_7B,
                         ids=[f"{k}-{s.get('m', s.get('b'))}"
                              for k, s in GEMMA_7B])
def test_h100_winner_is_a_compiled_feasible_instantiation(kernel_id, sig):
    p = tc.lookup_or_tune(kernel_id, spec="h100", db=tc.TuningDatabase(),
                          **sig)
    spec = api.get_spec(kernel_id)
    vid = p.get("variant")
    space = spec._hopper[vid]
    assert p["tile"] in space.tiles
    info = space.info([p["tile"]], sig, hw.H100_SXM)
    assert bool(info.feasible[0])
    assert int(info.occupancy.active_blocks[0]) >= 1
    assert int(info.smem[0]) <= hw.H100_SXM.shmem_per_block
    assert np.isfinite(info.pipe[0])


def test_h100_keys_carry_the_launch_space_digest():
    db = tc.TuningDatabase()
    tc.lookup_or_tune("matmul", spec="h100", db=db, m=4, n=3072,
                      k=24576, dtype="bfloat16")
    (rec,) = db.snapshot()
    assert '"hopper":' in rec.key.signature
    assert rec.key.spec_fingerprint.startswith("h100-sxm@")
    assert "hopper-roofline-h100-sxm" in rec.key.signature


def test_h100_space_restricts_each_variant_to_its_own_tiles():
    spec = api.get_spec("mlp_matmul")
    space = spec.hopper_space(m=4, d=3072, f=24576, act="gelu",
                              dtype="bfloat16")
    rows = space.enumerate()
    assert len(rows) == sum(len(h.tiles) for h in spec._hopper.values())
    for p in rows:
        assert p["tile"] in spec._hopper[p["variant"]].tiles


def test_stream_is_ruled_out_where_its_panels_do_not_fit():
    """At gemma's D = 3072 only the smallest whole-D panels of the SIMT
    rows fit 227 KB; the GEMV rows hold x's panel only, which fits."""
    spec = api.get_spec("mlp_matmul")
    h = spec._hopper["stream"]
    sig = dict(m=256, d=3072, f=24576, act="gelu", dtype="float32")
    feas = h.info(h.tiles, sig, hw.H100_SXM).feasible
    assert feas.tolist() == [True, False, False, False] + [True] * 6


@pytest.mark.parametrize("target", ["tpu-v5e", "kepler_k20"])
def test_non_hopper_params_launch_the_variants_fallback_tile(target):
    spec = api.get_spec("flash_attention")
    sig = dict(b=4, h=16, sq=64, skv=64, d=256, causal=True,
               dtype="bfloat16")
    p = tc.lookup_or_tune("flash_attention", spec=target,
                          db=tc.TuningDatabase(), **sig)
    fn, launch, complete = spec._launch(p, sig)
    assert launch["tile"] in (spec._hopper["flash"].tiles
                              + spec._hopper["blocked"].tiles)
    # TPU params name the variant and cover its axes; the Table I
    # GPUs' {"threads": ...} name none, so the fallback fills in
    assert complete == (target == "tpu-v5e")


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' "
            "or n.startswith('jax.') or n == 'repro' "
            "or n.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_no_port_file_imports_jax_or_the_reference():
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append((os.path.relpath(path, REPO), n))
    assert not bad, bad


@pytest.mark.parametrize("kernel_id,sig", GEMMA_7B[:4],
                         ids=[k for k, _ in GEMMA_7B[:4]])
def test_fallback_params_name_a_feasible_primary_tile(kernel_id, sig):
    spec = api.get_spec(kernel_id)
    p = spec.fallback_params(**sig)
    vid = p.get("variant")
    assert vid == (spec.primary_variant if spec.variant_ids() else None)
    space = spec._hopper[vid]
    assert bool(space.info([p["tile"]], sig, hw.H100_SXM).feasible[0])
