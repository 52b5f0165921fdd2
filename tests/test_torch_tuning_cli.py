"""The port's tuning-database CLI and shipped pretuned databases against
the reference, on the CPU.

* ``pretune --verify --all-targets`` regenerates every shipped file bit
  for bit, the H100's included.
* The six reference targets' files are the reference's, byte for byte.
* ``tune`` / ``export`` / ``import`` / ``show`` store and print the
  reference CLI's records; ``pretune --config`` ranks the reference's
  serving instances; ``_parse_sig`` parses as the reference's.
* The default database warms the target's shipped file.
"""
import json
import os

import pytest

import repro.kernels  # noqa: F401  (registers every reference kernel)
import repro_torch.kernels  # noqa: F401
from repro import tuning_cache as ref_tc
from repro.tuning_cache import cli as ref_cli
from repro_torch import tuning_cache as tc
from repro_torch.core.target import use_target
from repro_torch.tuning_cache import cli

REF_FILES = ("tpu_v5e.jsonl", "tpu_v5p.jsonl", "tpu_v6e.jsonl",
             "m2050.jsonl", "k20.jsonl", "m40.jsonl")


@pytest.fixture(autouse=True)
def _fresh_dbs():
    ref_tc.set_default_db(ref_tc.TuningDatabase())
    tc.set_default_db(tc.TuningDatabase())
    yield
    ref_tc.reset_default_db()
    tc.reset_default_db()


def _records(path):
    """A JSONL's records with the creation time (the one field a rank
    does not determine) normalized."""
    with open(path, encoding="utf-8") as f:
        return sorted(json.dumps({**json.loads(line), "created_unix": 0.0},
                                 sort_keys=True) for line in f)


def test_shipped_targets_add_the_h100():
    assert cli.SHIPPED_TARGETS == ref_cli.SHIPPED_TARGETS + ("h100-sxm",)
    assert sorted(os.listdir(tc.pretuned_dir())) == sorted(
        REF_FILES + ("h100_sxm.jsonl",))
    assert tc.pretuned_path("h100") == os.path.join(tc.pretuned_dir(),
                                                    "h100_sxm.jsonl")


def test_pretune_verify_all_targets(tmp_path, capsys):
    assert cli.main(["--db", str(tmp_path / "db"), "pretune", "--verify",
                     "--all-targets"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " verify " in ln]
    assert len(lines) == 7
    for target, line in zip(cli.SHIPPED_TARGETS, lines):
        assert ": OK (models: " in line and " x86)" in line, line
    assert "hopper-roofline-h100-sxm@" in lines[-1]


@pytest.mark.parametrize("name", REF_FILES)
def test_shipped_file_is_the_references(name):
    with open(os.path.join(tc.pretuned_dir(), name), "rb") as f:
        got = f.read()
    with open(os.path.join(ref_tc.pretuned_dir(), name), "rb") as f:
        want = f.read()
    assert got == want


def test_verify_reports_a_changed_file(tmp_path, capsys):
    """A shipped file one byte off fails the diff and names the line."""
    with open(tc.pretuned_path("tpu-v5e"), encoding="utf-8") as f:
        lines = f.read().splitlines(keepends=True)
    lines[3] = lines[3].replace('"static"', '"Static"')
    bad = tmp_path / "tpu_v5e.jsonl"
    bad.write_text("".join(lines))
    with pytest.raises(SystemExit, match="tpu-v5e"):
        cli.main(["--db", str(tmp_path / "db"), "pretune", "--verify",
                  "--target", "tpu-v5e", "--out", str(bad)])
    assert "first diff at line 4" in capsys.readouterr().out


def test_h100_file_holds_launchable_h100_picks():
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels import api
    db = tc.TuningDatabase()
    assert db.warm_jsonl(tc.pretuned_path("h100-sxm")) == 86
    for rec in db.records():
        assert rec.key.spec_fingerprint.startswith("h100-sxm@")
        sig = {k: v for k, v in json.loads(rec.key.signature).items()
               if k not in ("model", "hopper", "variants")}
        info = api.get_spec(rec.key.kernel_id).hopper_static_info(
            rec.params, H100_SXM, **sig)
        assert info.feasible(), (rec.key.kernel_id, sig, rec.params)


def test_cli_tune_export_import_show_match_the_reference(tmp_path, capsys):
    out, ref_out = {}, {}
    for main, root, res in ((cli.main, tmp_path / "port", out),
                            (ref_cli.main, tmp_path / "ref", ref_out)):
        dbdir, dbdir2 = str(root / "db"), str(root / "db2")
        jsonl = str(root / "out.jsonl")
        for sig, target in ((["m=512", "n=512", "dtype=float32"], []),
                            (["m=512", "n=512"], ["--target", "k20"]),
                            (["m=1024", "n=1024"],
                             ["--target", "tpu-v6e", "--model",
                              "pipeline"])):
            assert main(["--db", dbdir, "tune", "--kernel", "matvec",
                         "--sig", *sig, *target]) == 0
        assert main(["--db", dbdir, "export", "--out", jsonl]) == 0
        assert main(["--db", dbdir2, "import", "--path", jsonl]) == 0
        capsys.readouterr()
        assert main(["--db", dbdir2, "show"]) == 0
        res["show"] = sorted(capsys.readouterr().out.splitlines())
        res["records"] = _records(jsonl)
    assert len(out["records"]) == 3
    assert out == ref_out


@pytest.mark.parametrize("target", ["tpu-v5e", "h100-sxm"])
def test_pretune_config_ranks_the_serving_instances(tmp_path, capsys,
                                                    target):
    """``pretune --config gemma-7b --smoke``: the instances the port's
    serving path dispatches, ranked into the database (under tpu-v5e the
    reference CLI's records, key for key)."""
    dbdir = str(tmp_path / "db")
    jsonl = str(tmp_path / "g.jsonl")
    assert cli.main(["--db", dbdir, "pretune", "--config", "gemma-7b",
                     "--smoke", "--target", target, "--batch", "4"]) == 0
    head = capsys.readouterr().out.splitlines()[0]
    assert "7 unique instances tuned" in head
    assert cli.main(["--db", dbdir, "export", "--out", jsonl]) == 0
    got = _records(jsonl)
    assert len(got) == 7
    if target == "tpu-v5e":
        ref_jsonl = str(tmp_path / "ref.jsonl")
        assert ref_cli.main(["--db", str(tmp_path / "ref"), "pretune",
                             "--config", "gemma-7b", "--smoke", "--target",
                             target, "--batch", "4"]) == 0
        assert ref_cli.main(["--db", str(tmp_path / "ref"), "export",
                             "--out", ref_jsonl]) == 0
        assert got == _records(ref_jsonl)


def test_pretune_model_pipeline_matches_the_reference(tmp_path):
    outs = []
    for main, root in ((cli.main, tmp_path / "port"),
                       (ref_cli.main, tmp_path / "ref")):
        path = str(tmp_path / f"{root.name}.jsonl")
        assert main(["--db", str(root), "pretune", "--kernels",
                     "matmul,rms_norm", "--target", "tpu-v5p", "--model",
                     "pipeline", "--out", path]) == 0
        with open(path, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and outs[0].count(b"\n") == 18


def test_cli_sig_parses_bools_as_the_reference():
    pairs = ["m=64", "causal=false", "other=True", "dtype=float32",
             "act=gelu"]
    assert cli._parse_sig(pairs) == ref_cli._parse_sig(pairs) == {
        "m": 64, "causal": False, "other": True, "dtype": "float32",
        "act": "gelu"}


def test_default_db_warms_the_targets_shipped_file():
    """The default database starts with the default target's shipped
    records, and another target's file warms on its first dispatch,
    once — as the reference's."""
    tc.reset_default_db()
    ref_tc.reset_default_db()
    with use_target("tpu-v5e"):
        db = tc.get_default_db()
    assert len(db) == 86 and db.warmed_targets == {"tpu-v5e"}
    sig = dict(m=1024, n=1024, dtype="float32")
    with use_target("h100"):
        p = tc.lookup_or_tune("matvec", **sig)
    assert "h100-sxm" in db.warmed_targets and len(db) == 2 * 86
    assert db.stats.tunes == 0              # a shipped instance: no rank
    shipped = tc.TuningDatabase()
    shipped.warm_jsonl(tc.pretuned_path("h100"))
    assert p in [r.params for r in shipped.records()
                 if r.key.kernel_id == "matvec"]
    assert tc.warm_pretuned(db, "h100") == 0        # once per target
    with use_target("tpu-v5e"):
        tc.lookup_or_tune("matvec", **sig)
    assert db.stats.tunes == 0
    assert tc.freeze() == ref_tc.freeze() + 86      # the H100's records
