"""The port's GraphTuner (graph-level knobs, scored with the 3-term
roofline, no execution) against the reference's.

* Under ``tpu-v5e``, with the reference's own compiled artifacts as
  ``lower_fn``'s result (starcoder2-smoke's meshed train step at
  microbatches 1 and 2 on an 8-device (2, 2, 2) Auto-axis mesh, lowered
  and compiled in a subprocess, their ``cost_analysis()`` and
  ``as_text()`` carried over): the same scores, the same pick, the same
  terms and the same tuning-database key as the reference's GraphTuner.
* Under the H100, ``lower_fn`` returning the port's own `LoweredStep`
  (a traced meshed step on a fake 8-rank process group): every
  candidate scored finite with the NVLink collective term, an
  infeasible candidate scored +inf, and a database hit returns the
  stored pick without lowering.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.core import GraphTuner, SearchSpace
from repro_torch.core.hw import H100_SXM
from repro_torch.core.roofline import RooflineTerms
from repro_torch.core.target import use_target
from repro_torch.tuning_cache import TuningDatabase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_smoke
    from repro.core import GraphTuner, SearchSpace
    from repro.distributed import TrainStepConfig, make_train_step
    from repro.launch.specs import cell_inputs
    from repro.models import build_model
    from repro.models.config import ShapeSpec
    from repro.optim import AdamWConfig
    from repro.tuning_cache import TuningDatabase

    out_dir = sys.argv[1]
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    model = build_model(get_smoke("starcoder2-3b"))
    shape = ShapeSpec("t", 64, 8, "train")
    args = cell_inputs(model, shape, mesh)
    arts = {}

    def lower_fn(params):
        step = make_train_step(
            model, AdamWConfig(), mesh=mesh,
            step_cfg=TrainStepConfig(microbatches=params["mb"]))
        with mesh:
            lowered = jax.jit(step).lower(*args)
        compiled = lowered.compile()
        arts[params["mb"]] = {"cost": dict(compiled.cost_analysis() or {}),
                              "text": compiled.as_text()}
        return lowered

    db = TuningDatabase()
    tuner = GraphTuner(SearchSpace({"mb": (1, 2)}), lower_fn, chips=8,
                       model_flops=model.model_flops(shape), spec="tpu-v5e",
                       db=db, cache_signature={"arch": "starcoder2-3b",
                                               "batch": 8, "seq": 64})
    best, terms, hist = tuner.tune()
    json.dump({"best": best, "terms": dataclasses.asdict(terms),
               "hist": [[p, t] for p, t in hist],
               "key": tuner._cache_key().to_dict(),
               "model_flops": model.model_flops(shape),
               "arts": {str(k): {"cost": {c: float(x) for c, x in
                                          v["cost"].items()},
                                 "text": v["text"]}
                        for k, v in arts.items()}},
              open(os.path.join(out_dir, "ref.json"), "w"))
""")


class _Compiled:
    def __init__(self, art):
        self.art = art

    def cost_analysis(self):
        return self.art["cost"]

    def as_text(self):
        return self.art["text"]


class _Lowered:
    def __init__(self, art):
        self.art = art

    def compile(self):
        return _Compiled(self.art)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF, str(d)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads((d / "ref.json").read_text())


@pytest.fixture(scope="module")
def port(ref):
    db = TuningDatabase()
    tuner = GraphTuner(SearchSpace({"mb": (1, 2)}),
                       lambda p: _Lowered(ref["arts"][str(p["mb"])]),
                       chips=8, model_flops=ref["model_flops"],
                       spec="tpu-v5e", db=db,
                       cache_signature={"arch": "starcoder2-3b", "batch": 8,
                                        "seq": 64})
    return tuner, db, tuner.tune()


def test_the_tpu_scores_match_the_reference(ref, port):
    _, _, (_, _, hist) = port
    assert [[p, t] for p, t in hist] == ref["hist"]


def test_the_tpu_pick_and_terms_match_the_reference(ref, port):
    _, _, (best, terms, _) = port
    assert best == ref["best"]
    assert isinstance(terms, RooflineTerms)
    assert terms.as_dict() == ref["terms"]


def test_the_database_key_matches_the_reference(ref, port):
    tuner, db, (best, terms, _) = port
    assert tuner._cache_key().to_dict() == ref["key"]
    # a second tune is a database hit: the stored pick, no lowering
    hit = GraphTuner(tuner.space, lambda p: pytest.fail("lowered"),
                     chips=8, model_flops=ref["model_flops"],
                     spec="tpu-v5e", db=db,
                     cache_signature=tuner.cache_signature).tune()
    assert hit[0] == best and hit[2] == []
    assert hit[1].as_dict() == terms.as_dict()


def _h100_world():
    """A fake 8-rank world on a (2, 2, 2) mesh."""
    from repro_torch.launch.dryrun import _fake_world
    from repro_torch.launch.mesh import make_mesh
    _fake_world(8)
    return make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")


def test_the_h100_scores_traced_steps_with_the_nvlink_term():
    import torch.distributed as dist
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import TrainStepConfig, make_train_step
    from repro_torch.launch.dryrun import lower_step
    from repro_torch.launch.specs import cell_inputs, to_dtensors
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig
    try:
        mesh = _h100_world()
        model = build_model(get_smoke("starcoder2-3b"))
        shape = ShapeSpec("t", 64, 8, "train")

        def lower_fn(params):
            if params["mb"] == 3:
                raise ValueError("8 rows do not split into 3")
            step = make_train_step(
                model, AdamWConfig(), mesh=mesh,
                step_cfg=TrainStepConfig(microbatches=params["mb"]))
            return lower_step(step, *to_dtensors(cell_inputs(model, shape,
                                                             mesh)))

        tuner = GraphTuner(SearchSpace({"mb": (1, 2, 3)}), lower_fn,
                           chips=8, model_flops=model.model_flops(shape),
                           spec=H100_SXM)
        assert tuner.ici_links == 18
        best, terms, hist = tuner.tune()
    finally:
        dist.destroy_process_group()
    scores = dict((p["mb"], t) for p, t in hist)
    assert scores[3] == float("inf")
    assert 0 < scores[1] < float("inf") and 0 < scores[2] < float("inf")
    assert best["mb"] in (1, 2) and scores[best["mb"]] == min(scores.values())
    assert terms.collective_bytes > 0
    assert terms.t_collective == terms.collective_bytes / (18 * 50e9)


def test_the_graph_tuner_refuses_a_table_one_gpu():
    with pytest.raises(TypeError):
        GraphTuner(SearchSpace({"mb": (1,)}), lambda p: None, chips=1,
                   model_flops=1.0, spec="kepler-k20")
