"""The plain reference against the program at small sizes on the CPU,
in float32: a prefill's logits at every position, and decode steps past
the prompt-long cache (its last slot rewritten, its length a sliding
window), dense and MoE (capacity, dropped rows, shared experts)."""
import dataclasses

import pytest
import torch

from perfbench.reference.model import Reference, gap_summary, weight_layout
from perfbench.weights import make_weights, served_dtype

SMOKE = {
    "dense": {"name": "t-dense", "family": "dense", "n_layers": 2,
              "d_model": 64, "n_heads": 4, "n_kv": 2, "d_ff": 160,
              "vocab": 300, "act": "silu_glu", "qkv_bias": True,
              "rope_theta": 10000.0, "norm_eps": 1e-6, "dtype": "float32"},
    "moe": {"name": "t-moe", "family": "moe", "n_layers": 2, "d_model": 64,
            "n_heads": 4, "n_kv": 4, "d_ff": 160, "d_ff_expert": 32,
            "n_experts": 6, "top_k": 2, "n_shared": 2,
            "capacity_factor": 1.25, "vocab": 300, "act": "silu_glu",
            "qkv_bias": True, "rope_theta": 10000.0, "norm_eps": 1e-6,
            "dtype": "float32"},
}


def _program(m, seed):
    from perfbench.harness import _model_config, _params
    from repro_torch.distributed import make_serve_fns
    from repro_torch.models import build_model
    model = build_model(_model_config(m))
    weights = make_weights(m, seed, torch.device("cpu"))
    prefill, decode = make_serve_fns(model)
    return weights, _params(model.init(device="meta"), weights), prefill, \
        decode


def _logits(ref, hidden):
    return torch.cat([lg for _, lg in ref.head_rows(hidden)])


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_reference_matches_the_program_in_float32(family):
    m = SMOKE[family]
    torch.manual_seed(0)
    weights, params, prefill, decode = _program(m, 11)
    ref = Reference(m, weights)
    s = 12
    tokens = torch.randint(0, m["vocab"], (3, s))
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": tokens})
        want = ref.prefill_hidden(tokens)
        for b in range(3):
            torch.testing.assert_close(logits[b], _logits(ref, want[b]),
                                       rtol=1e-4, atol=1e-4)
        # decode 2 * s + 2 steps: past the point where the cache's
        # window leaves no slot
        tok, fed, got = logits[:, -1:].argmax(-1), [], []
        for _ in range(2 * s + 2):
            fed.append(tok)
            lg, cache = decode(params, cache, tok)
            got.append(lg[:, -1])
            tok = lg[:, -1:].argmax(-1)
        pos = torch.arange(s, 3 * s + 2)
        for b in range(3):
            inp = torch.cat([f[b] for f in fed])
            want = _logits(ref, ref.decode_hidden(tokens[b], inp, pos))
            torch.testing.assert_close(torch.stack([g[b] for g in got]),
                                       want, rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops_rows():
    """The reference's MoE keeps at most ``capacity`` rows an expert:
    with one expert favoured by every token, rows are dropped, and the
    program drops the same ones."""
    m = dict(SMOKE["moe"], capacity_factor=0.25)
    weights, params, prefill, _ = _program(m, 5)
    weights["blocks.moe.router"][:, :, 0] += 10.0    # every token -> 0
    ref = Reference(m, weights)
    tokens = torch.randint(0, m["vocab"], (4, 40))
    with torch.inference_mode():
        logits, _ = prefill(params, {"tokens": tokens})
        want = ref.prefill_hidden(tokens)
    for b in range(4):
        torch.testing.assert_close(logits[b], _logits(ref, want[b]),
                                   rtol=1e-4, atol=1e-4)


def test_weights_follow_the_layout_and_the_seed():
    m = dict(SMOKE["moe"], dtype="bfloat16")
    a = make_weights(m, 2**31 + 3, torch.device("cpu"))
    b = make_weights(m, 2**31 + 3, torch.device("cpu"))
    c = make_weights(m, 2**31 + 4, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in a.items()} == weight_layout(m)
    for k, v in a.items():
        assert v.dtype == served_dtype(k, m)
        assert v.storage_offset() * v.element_size() % 128 == 0
        assert torch.equal(v, b[k]) and not torch.equal(v, c[k])
    gains = a["blocks.ln1"].float()
    assert 0.5 < float(gains.mean()) < 1.5 and float(gains.std()) > 0.01


def test_control_and_gap_summary():
    """The control rounds the products' weights to float8 and so departs
    from the reference; the summary reads gaps as they are."""
    m = SMOKE["dense"]
    weights, *_ = _program(m, 3)
    tokens = torch.randint(0, m["vocab"], (2, 16))
    ref, ctl = Reference(m, weights), Reference(m, weights, quant="fp8")
    with torch.inference_mode():
        hid = ref.prefill_hidden(tokens).flatten(0, 1)
        exact = gap_summary(ref.gaps(hid, ref.argmax(hid)))
        low = gap_summary(ref.gaps(
            hid, ctl.argmax(ctl.prefill_hidden(tokens).flatten(0, 1))))
    assert exact["gap_max"] == 0.0 and exact["positions"] == 32
    assert low["gap_max"] > 0.0 and 0.0 < low["miss_share"] < 1.0
    g = gap_summary(torch.tensor([0.0, 0.5, 1.5, 0.0]))
    assert (g["gap_max"], g["gap_mean"], g["miss_share"]) == (1.5, 0.5, 0.5)
