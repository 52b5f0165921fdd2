"""The serving example (``python -m repro_torch.examples.serve_lm``), the
port of the reference's ``examples/serve_lm.py``: graph pretune, freeze,
serving through the tuned kernel path (their plain versions on the CPU)
with every dispatch frozen and no runtime tune, then the plain fallback
path fed the tuned tokens, whose greedy choices must equal the tuned
stream or part from it only at a tie (the cases below match exactly)."""
import pytest

from repro_torch.examples import serve_lm


@pytest.mark.parametrize("arch", ["gemma-7b", "whisper-tiny"])
def test_tuned_and_fallback_serving_emit_the_same_tokens(arch, capsys):
    rep = serve_lm.main(["--device", "cpu", "--arch", arch, "--gen", "4",
                         "--prompt-len", "16"])
    out = capsys.readouterr().out
    assert rep["match"] and "greedy tokens MATCH" in out
    assert rep["runtime_tunes"] == 0
    st = rep["dispatch"]
    assert st["total"] > 0 and st["frozen"] == st["total"]
    assert st["live"] == 0 and st["fallback"] == 0
    assert len(rep["tokens"]) == 2 and len(rep["tokens"][0]) == 5
    for step in ("pretune:", "frozen:", "tuned serve:", "plain fallback:"):
        assert step in out


def test_without_a_card_the_example_refuses_to_fall_back(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Exception, match="(?i)cuda|card|device"):
        serve_lm.main(["--gen", "1"])


@pytest.mark.parametrize("case", ["match", "tie", "off_a_tie", "too_far"])
def test_the_fallback_check_tells_a_tie_from_a_disagreement(case):
    """`serve_lm.compare` on hand-made streams: equal choices match;
    choices that part where the plain path's two top logits are within
    bf16's tolerance are a tie; a parting off a tie, or logits apart by
    more than the tolerance, are not."""
    import torch
    plain = torch.tensor([[[4.0, 1.0, 0.0], [0.0, 3.0, 2.99]]])
    tuned = plain.clone()
    toks_plain = torch.tensor([[0, 1]])
    toks_tuned = toks_plain.clone()
    if case == "tie":
        toks_tuned[0, 1] = 2
    elif case == "off_a_tie":
        toks_tuned[0, 0] = 1
    elif case == "too_far":
        tuned[0, 0, 0] += 0.2
    got = serve_lm.compare(toks_tuned, tuned, toks_plain, plain)
    assert got["match"] == (case in ("match", "too_far"))
    assert got["within_tol"] == (case != "too_far")
    assert all(p["tie"] for p in got["parts"]) == (case != "off_a_tie")
    if case == "tie":
        (p,) = got["parts"]
        assert (p["row"], p["step"]) == (0, 1)
        assert p["gap"] == pytest.approx(0.01, abs=1e-6)
