"""`chip_smoke.mesh_verdict`: the decision of ``[mesh]`` (a), held to
the figures four H100s gave for gemma-7b (4 of 28 layers, 3 steps of
8 x 256 on a (2, 2) mesh, against one card's run).

* on several cards the float32 run is the gate: a sound tree's float32
  run (losses 3.99e-6, grad norms 5.24e-4 off one card's) passes; one
  1e-2 off fails, by losses or by grad norms;
* the bf16 run's grad norms are recorded, not gated: the sound tree's
  0.375 at step 3 passes and stands in the record; its losses are held
  at 1e-2, and a loss that is not finite, or a run cut short, fails;
* an MoE's gates hold its first two steps, the first update's effect
  included, and record the third, where a routing flip parts the runs:
  qwen2-moe-a2.7b's four-card readings (float32 step 3 1.43e-4 and
  5.57e-3 off, bf16 losses step 3 3.08e-2 off, steps 1-2 within the
  gates) pass as an MoE and fail as a dense model; a step 1 or 2
  past the float32 gate, or a bf16 loss of step 2 past 1e-2, fails;
* on one card the meshed step must be the unmeshed one (losses and
  grad norms 1e-5, parameters 1e-4), as before.
"""
import math

import pytest

import chip_smoke

ONE_CARD = {"losses": [12.900411605834961, 22.923717498779297,
                       15.443204879760742],
            "grad_norms": [11.50206184387207, 118.73838806152344,
                           12.0975]}


def run(loss_rel=(0.0, 0.0, 0.0), norm_rel=(0.0, 0.0, 0.0),
        param_err=0.0, plain=ONE_CARD):
    """A meshed run whose steps sit ``loss_rel`` / ``norm_rel`` (each
    step's relative difference) off the unmeshed ``plain``."""
    return {"losses": [x * (1 + r) for x, r in zip(plain["losses"],
                                                   loss_rel)],
            "grad_norms": [x * (1 + r) for x, r in zip(plain["grad_norms"],
                                                       norm_rel)],
            "param_err": param_err, "plain": dict(plain)}


# a sound tree on four H100s: float32 losses 3.99e-6 and grad norms
# 5.24e-4 off (step 3: 12.1038 against 12.0975); bf16 losses 1.66e-3,
# grad norms 0.375 off at step 3 (10.91 against 17.46)
F32_WITNESS = run((1e-6, 2e-6, 3.99e-6), (8e-8, 6e-8, 5.24e-4))
BF16_PLAIN = {"losses": [12.9006, 22.8845, 15.4525],
              "grad_norms": [11.5373, 119.5291, 17.46]}
BF16_WITNESS = run((3.5e-5, 1.66e-3, 1e-6), (1.2e-4, 6.5e-5, -0.375),
                   param_err=0.02, plain=BF16_PLAIN)


# qwen2-moe-a2.7b (2 of 24 layers) on four H100s, (2, 2): float32,
# then bf16 (losses 1.74e-4, 8.15e-4, 3.08e-2 off, grad norms 3.57e-4,
# 2.37e-2, 0.157)
MOE_PLAIN = {"losses": [12.502090454101562, 12.383186340332031,
                        18.56220817565918],
             "grad_norms": [5.787273406982422, 4.4499831199646,
                            27.81087303161621]}
MOE_F32 = run((0.0, -7.16e-6, -1.43e-4), (-1.65e-7, -3.92e-5, 5.57e-3),
              param_err=0.002, plain=MOE_PLAIN)
MOE_BF16_PLAIN = {"losses": [12.500016212463379, 12.388114929199219,
                             15.021921157836914],
                  "grad_norms": [5.80676794052124, 4.223000526428223,
                                 18.458782196044922]}
MOE_BF16 = run((1.74e-4, -8.15e-4, 3.08e-2), (-3.57e-4, 2.37e-2, 0.157),
               param_err=0.00719, plain=MOE_BF16_PLAIN)


def test_the_sound_tree_s_four_card_runs_pass_and_are_recorded():
    faults, record = chip_smoke.mesh_verdict(
        4, {"float32": F32_WITNESS, "bfloat16": BF16_WITNESS})
    assert faults == []
    assert record["bfloat16"]["grad_norms"][2] == pytest.approx(0.375)
    assert record["float32"]["grad_norms"][2] == pytest.approx(5.24e-4)
    assert record["bfloat16"]["param_err"] == 0.02


@pytest.mark.parametrize("off", ["losses", "grad_norms"])
def test_a_float32_run_1e_2_off_fails(off):
    bad = (run(loss_rel=(0.0, 1e-2, 0.0)) if off == "losses"
           else run(norm_rel=(0.0, 1e-2, 0.0)))
    faults, _ = chip_smoke.mesh_verdict(4, {"float32": bad,
                                            "bfloat16": BF16_WITNESS})
    assert len(faults) == 1 and "float32" in faults[0] and off.replace(
        "_", " ") in faults[0]


def test_the_float32_gate_is_tighter_than_the_bf16_one():
    assert chip_smoke.MESH_F32_LOSS_RTOL == 1e-5
    assert chip_smoke.MESH_F32_NORM_RTOL == 1e-3
    assert chip_smoke.MESH_MULTI_RTOL == 1e-2
    just_past = run((0.0, 0.0, 1.1e-5), (0.0, 0.0, 0.0))
    assert chip_smoke.mesh_verdict(4, {"float32": just_past})[0]


@pytest.mark.parametrize("where", ["meshed", "unmeshed"])
def test_a_non_finite_bf16_loss_fails(where):
    bad = run((3.5e-5, 1.66e-3, 1e-6), plain=BF16_PLAIN)
    if where == "meshed":
        bad["losses"][1] = math.nan
    else:
        bad["plain"] = dict(BF16_PLAIN, losses=[12.9, math.inf, 15.4])
    faults, _ = chip_smoke.mesh_verdict(4, {"float32": F32_WITNESS,
                                            "bfloat16": bad})
    assert len(faults) == 1 and "not finite" in faults[0]


def test_a_run_cut_short_fails():
    short = run()
    short["losses"] = short["losses"][:2]
    assert chip_smoke.mesh_verdict(4, {"float32": short})[0]


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_bf16_losses_past_1e_2_on_step_3_fail_a_dense_model_only(moe):
    faults, record = chip_smoke.mesh_verdict(
        4, {"float32": F32_WITNESS, "bfloat16": MOE_BF16}, moe=moe)
    assert bool(faults) is not moe
    assert record["bfloat16"]["losses"][2] == pytest.approx(3.08e-2)
    assert record["bfloat16"]["grad_norms"][2] == pytest.approx(0.157)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_bf16_losses_past_1e_2_on_step_2_fail_every_model(moe):
    bf16 = run((1.74e-4, 2e-2, 0.0), plain=BF16_PLAIN)
    faults, _ = chip_smoke.mesh_verdict(
        4, {"float32": F32_WITNESS, "bfloat16": bf16}, moe=moe)
    assert len(faults) == 1 and "bfloat16" in faults[0] and \
        "losses" in faults[0]


def test_one_card_must_be_the_unmeshed_step():
    assert chip_smoke.mesh_verdict(1, {"bfloat16": run()}) == (
        [], {"bfloat16": {"losses": [0.0] * 3, "grad_norms": [0.0] * 3,
                          "param_err": 0.0}})
    for bad in (run(norm_rel=(0.0, 2e-5, 0.0)), run(param_err=2e-4),
                run(loss_rel=(2e-5, 0.0, 0.0))):
        assert chip_smoke.mesh_verdict(1, {"bfloat16": bad})[0]


@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense"])
def test_an_moe_s_float32_gate_holds_its_first_two_steps(moe):
    faults, record = chip_smoke.mesh_verdict(4, {"float32": MOE_F32},
                                             moe=moe)
    assert bool(faults) is not moe
    assert chip_smoke.MESH_MOE_STEPS == 2
    assert record["float32"]["losses"][1] == pytest.approx(7.16e-6)
    assert record["float32"]["grad_norms"][2] == pytest.approx(5.57e-3)


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_an_moe_s_gated_step_past_the_float32_gate_fails(step):
    norm = [0.0, 0.0, 0.0]
    norm[step] = 2e-3
    faults, _ = chip_smoke.mesh_verdict(4, {"float32": run(
        (0.0, 0.0, 0.0), norm, plain=MOE_PLAIN)}, moe=True)
    assert len(faults) == 1 and "steps 1-2" in faults[0]


def test_the_moe_s_four_card_readings_pass_as_an_moe():
    assert chip_smoke.mesh_verdict(
        4, {"float32": MOE_F32, "bfloat16": MOE_BF16}, moe=True)[0] == []
