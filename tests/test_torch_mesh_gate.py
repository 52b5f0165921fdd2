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
  grad norms 1e-5, parameters 1e-4), as before;
* on several cards every step of the float32 run is also held from one
  shared state (the unmeshed run's state before it, restored on the
  mesh): losses 1e-5, grad norms 1e-3 and each leaf's parameters after
  the update 1e-2 of the unmeshed update's norm, on every step of
  every model, an MoE's third step included; the sound tree's four-card
  readings of both archs pass (qwen2-moe-a2.7b's key bias 1.0e-3 off at
  step 1, gemma-7b's embedding 3.68e-4); a reading past a bound at
  any step fails and names the step, as do missing readings and a
  restored state that is not its checkpoint bit for bit; the planted
  update fault (rank 1 skips its expert shards' AdamW update), which
  the chained gate first fails at step 2, fails the held gate at step
  1, on the parameters;
* `chip_smoke.mesh_serve_verdict`, ``[mesh]`` (s), serving on the mesh:
  on one card the meshed logits must be the unmeshed ones bit for bit;
  on several, finite and within 1e-4 x (1 + the row's largest) at the
  prefill and every decode step, a greedy token parted only at a tie.
"""
import math

import pytest

import chip_smoke

ONE_CARD = {"losses": [12.900411605834961, 22.923717498779297,
                       15.443204879760742],
            "grad_norms": [11.50206184387207, 118.73838806152344,
                           12.0975]}


def held(plain, loss_rel=(0.0, 0.0, 0.0), norm_rel=(0.0, 0.0, 0.0),
         param_rel=(1e-5, 1e-5, 1e-5), exact=(True, True)):
    """The steps held from one shared state, ``loss_rel`` / ``norm_rel``
    off the unmeshed ``plain``, each step's parameters ``param_rel``."""
    return {"losses": [x * (1 + r) for x, r in zip(plain["losses"],
                                                   loss_rel)],
            "grad_norms": [x * (1 + r) for x, r in zip(plain["grad_norms"],
                                                       norm_rel)],
            "param_rel": list(param_rel),
            "param_leaf": ["blocks.moe.w_up"] * len(param_rel),
            "restored_exact": list(exact)}


def run(loss_rel=(0.0, 0.0, 0.0), norm_rel=(0.0, 0.0, 0.0),
        param_err=0.0, plain=ONE_CARD, held_run=None):
    """A meshed run whose steps sit ``loss_rel`` / ``norm_rel`` (each
    step's relative difference) off the unmeshed ``plain``, with the
    steps held from one shared state ``held_run`` (a sound one by
    default)."""
    return {"losses": [x * (1 + r) for x, r in zip(plain["losses"],
                                                   loss_rel)],
            "grad_norms": [x * (1 + r) for x, r in zip(plain["grad_norms"],
                                                       norm_rel)],
            "param_err": param_err, "plain": dict(plain),
            "held": held_run or held(plain)}


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


# the held check on a float32 run of several cards: every step, every
# model
HELD_KEYS = ("losses", "grad_norms", "param_rel")


def _held_off(key: str, step: int, by: float, plain=MOE_PLAIN):
    vals = {k: [0.0, 0.0, 0.0] for k in HELD_KEYS}
    vals["param_rel"] = [1e-5, 1e-5, 1e-5]
    vals[key][step] = by
    return held(plain, vals["losses"], vals["grad_norms"],
                vals["param_rel"])


@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense"])
def test_every_step_of_an_moe_is_held_from_its_shared_state(moe):
    # the chained run parts at step 3 (a routing flip, recorded for an
    # MoE); the step held from the shared state must still agree
    within = dict(MOE_F32, held=_held_off("losses", 2, 9e-6))
    faults, record = chip_smoke.mesh_verdict(4, {"float32": within},
                                             moe=moe)
    assert bool(faults) is not moe
    assert record["float32"]["held"]["losses"][2] == pytest.approx(9e-6)
    past = dict(MOE_F32, held=_held_off("losses", 2, 2e-5))
    faults, _ = chip_smoke.mesh_verdict(4, {"float32": past}, moe=True)
    assert len(faults) == 1 and "step 3 held" in faults[0]


@pytest.mark.parametrize("step", [0, 1, 2], ids=["step1", "step2", "step3"])
@pytest.mark.parametrize("key,by", [("losses", 2e-5), ("grad_norms", 2e-3),
                                    ("param_rel", 2e-2)])
def test_a_held_reading_past_its_bound_fails_at_its_step(key, by, step):
    bad = run(plain=MOE_PLAIN, held_run=_held_off(key, step, by))
    for moe in (True, False):
        faults, _ = chip_smoke.mesh_verdict(4, {"float32": bad}, moe=moe)
        assert len(faults) == 1 and f"step {step + 1} held" in faults[0]
    assert chip_smoke.MESH_F32_PARAM_RTOL == 1e-2


def test_a_held_reading_just_within_its_bound_passes():
    ok = run(plain=MOE_PLAIN, held_run=held(
        MOE_PLAIN, (9e-6,) * 3, (9e-4,) * 3, (9e-3,) * 3))
    assert chip_smoke.mesh_verdict(4, {"float32": ok}, moe=True)[0] == []


@pytest.mark.parametrize("what", ["missing", "short", "nan", "restore"])
def test_held_readings_missing_or_wrong_fail(what):
    bad = run(plain=MOE_PLAIN)
    if what == "missing":
        del bad["held"]
    elif what == "short":
        bad["held"]["param_rel"] = bad["held"]["param_rel"][:2]
    elif what == "nan":
        bad["held"]["grad_norms"][1] = math.nan
    else:
        bad["held"]["restored_exact"] = [True, False]
    faults, _ = chip_smoke.mesh_verdict(4, {"float32": bad}, moe=True)
    assert len(faults) == 1


def test_one_card_and_bf16_runs_are_not_held():
    no_held = run()
    del no_held["held"]
    assert chip_smoke.mesh_verdict(1, {"bfloat16": no_held})[0] == []
    faults, record = chip_smoke.mesh_verdict(
        4, {"float32": F32_WITNESS, "bfloat16": dict(BF16_WITNESS,
                                                      held=None)})
    assert faults == [] and "held" not in record["bfloat16"]


# the planted update fault on four H100s (rank 1 skips adamw_kernel on its
# shards of qwen2-moe-a2.7b's expert weights, NCCL only), this gate's
# run: the chained run parts by 7.63e-8 / 7.33e-4 / 1.43e-3 (losses) and
# 1.65e-7 / 2.78e-3 / 5.86e-2 (grad norms), which the chained gate first
# fails at step 2; held from the shared state its losses and grad norms
# agree (steps 1-3 1.54e-7 at most), and its parameters part by 0.626,
# 0.549, 0.524 of the update (the expert gate's weights)
FAULT_PLAIN = {"losses": [12.502090454101562, 12.383186340332031,
                          18.56220817565918],
               "grad_norms": [5.787273406982422, 4.4499831199646,
                              27.81087303161621]}
FAULT = {"losses": [12.502089500427246, 12.392269134521484,
                    18.58875274658203],
         "grad_norms": [5.7872724533081055, 4.437631130218506,
                        29.441425323486328],
         "param_err": 0.00379, "plain": FAULT_PLAIN,
         "held": {"losses": [12.502089500427246, 12.383184432983398,
                             18.56220817565918],
                  "grad_norms": [5.7872724533081055, 4.449982643127441,
                                 27.810869216918945],
                  "param_rel": [0.626, 0.549, 0.524],
                  "param_leaf": ["blocks.moe.w_gate"] * 3,
                  "restored_exact": [True, True]}}


def test_the_planted_update_fault_fails_the_held_gate_at_step_1():
    faults, record = chip_smoke.mesh_verdict(4, {"float32": FAULT},
                                             moe=True)
    held_faults = [f for f in faults if "held" in f]
    assert held_faults and "step 1 held" in held_faults[0] and \
        "parameters" in held_faults[0]
    assert record["float32"]["held"]["param_rel"][0] == 0.626
    chained = [f for f in faults if "held" not in f]
    assert chained and "steps 1-2's" in chained[0]
    # the chained gate alone passes step 1
    assert record["float32"]["losses"][0] < 1e-5
    assert record["float32"]["grad_norms"][0] < 1e-3


# the sound tree on four H100s, (2, 2), float32: each arch's chained run
# and its steps held from one shared state, as the gate read them (the
# parameters' readings printed to three figures)
GEMMA_PLAIN = {"losses": [12.900411605834961, 22.923717498779297,
                          15.443204879760742],
               "grad_norms": [11.502060890197754, 118.73838806152344,
                              12.097465515136719]}
GEMMA_SOUND = {"losses": [12.900411605834961, 22.92380714416504,
                          15.443236351013184],
               "grad_norms": [11.502060890197754, 118.73746490478516,
                              12.103246688842773],
               "param_err": 0.000542, "plain": GEMMA_PLAIN,
               "held": {"losses": list(GEMMA_PLAIN["losses"]),
                        "grad_norms": list(GEMMA_PLAIN["grad_norms"]),
                        "param_rel": [0.000368, 1.27e-05, 2.14e-05],
                        "param_leaf": ["embed"] * 3,
                        "restored_exact": [True, True]}}
QWEN_SOUND = {"losses": [12.502089500427246, 12.383097648620605,
                         18.559553146362305],
              "grad_norms": [5.7872724533081055, 4.4498066902160645,
                             27.965667724609375],
              "param_err": 0.002, "plain": FAULT_PLAIN,
              "held": {"losses": [12.502089500427246, 12.383184432983398,
                                  18.56220817565918],
                       "grad_norms": [5.7872724533081055, 4.449982643127441,
                                      27.810869216918945],
                       "param_rel": [0.001, 0.000425, 6.97e-05],
                       "param_leaf": ["blocks.attn.bk"] * 3,
                       "restored_exact": [True, True]}}


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-moe-a2.7b"])
def test_the_sound_tree_s_held_readings_pass(arch):
    sound, moe = ((GEMMA_SOUND, False) if arch == "gemma-7b"
                  else (QWEN_SOUND, True))
    faults, record = chip_smoke.mesh_verdict(4, {"float32": sound}, moe=moe)
    assert faults == []
    held_rec = record["float32"]["held"]
    assert max(held_rec["param_rel"]) == sound["held"]["param_rel"][0]
    assert max(held_rec["losses"]) < 2e-7
    # the key bias's reading sits a decade inside the bound; the planted
    # fault's smallest, fifty times past it
    assert 10 * max(held_rec["param_rel"]) <= \
        chip_smoke.MESH_F32_PARAM_RTOL < min(FAULT["held"]["param_rel"]) / 50


def served(bitwise=False, finite=True, pre=(1e-6, True), dec=(1e-6, True),
           parts=()):
    """A rank 0 comparison of `chip_smoke._mesh_serve_rank`."""
    return {"bitwise": bitwise, "finite": finite,
            "prefill_max_abs_err": pre[0], "prefill_within_tol": pre[1],
            "decode_max_abs_err": dec[0], "decode_within_tol": dec[1],
            "parts": list(parts)}


def test_serving_on_one_card_must_be_the_unmeshed_path_bit_for_bit():
    assert chip_smoke.mesh_serve_verdict(1, served(bitwise=True)) == []
    faults = chip_smoke.mesh_serve_verdict(1, served(bitwise=False))
    assert faults and "bit for bit" in faults[0]


@pytest.mark.parametrize("rec,what", [
    (served(pre=(3e-3, False)), "logits off"),
    (served(dec=(3e-3, False)), "logits off"),
    (served(finite=False), "not finite"),
    (served(parts=[{"row": 1, "step": 2, "gap": 0.5, "top1_top2": 0.5,
                    "tie": False}]), "off a tie")])
def test_serving_on_several_cards_fails_past_its_tolerance(rec, what):
    faults = chip_smoke.mesh_serve_verdict(4, rec)
    assert len(faults) == 1 and what in faults[0]


def test_serving_on_several_cards_passes_within_tolerance_and_at_ties():
    tie = {"row": 0, "step": 3, "gap": 2e-5, "top1_top2": 2e-5,
           "tie": True}
    assert chip_smoke.mesh_serve_verdict(4, served(parts=[tie])) == []
    assert chip_smoke.mesh_serve_verdict(4, served(bitwise=True)) == []
