"""The traffic kinds' schedules from a seed (CPU; no program run)."""
import collections
import importlib.util
from pathlib import Path

import pytest

FOLDER = Path(__file__).resolve().parent


def _kind(name):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_test_{name}", FOLDER / "traffic" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MIX = {"kind": "prefill_batches", "batch": 4,
       "block": [[512, 4], [1024, 3], [2048, 2], [4096, 1]]}
SEEDS = [0, 7, 2**31 + 5, 2**33 + 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_blocks_hold_the_mix_in_its_proportions(seed):
    pb = _kind("prefill_batches")
    gen = pb.blocks(MIX, seed)
    want = collections.Counter({512: 4, 1024: 3, 2048: 2, 4096: 1})
    blocks = [next(gen) for _ in range(6)]
    for b in blocks:
        assert collections.Counter(b) == want
    assert len({tuple(b) for b in blocks}) > 1      # reshuffled each time
    again = pb.blocks(MIX, seed)
    assert [next(again) for _ in range(6)] == blocks  # the seed decides
    assert pb.shapes(MIX) == [(4, 512), (4, 1024), (4, 2048), (4, 4096)]


@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_sample_holds_the_longest_batch(seed):
    pb = _kind("prefill_batches")
    first = next(pb.blocks(MIX, seed))
    got = pb.sample(MIX, {"longest_rows": 1, "other_rows": 4}, seed)
    assert got == pb.sample(MIX, {"longest_rows": 1, "other_rows": 4}, seed)
    (i_long, rows_long), (i_other, rows_other) = sorted(
        got.items(), key=lambda kv: -first[kv[0]])
    assert first[i_long] == 4096 and len(rows_long) == 1
    assert i_other != i_long and rows_other == [0, 1, 2, 3]
    assert all(0 <= r < 4 for r in rows_long)


def test_prefill_samples_differ_between_seeds():
    pb = _kind("prefill_batches")
    picks = {str(sorted(pb.sample(MIX, {"longest_rows": 1,
                                        "other_rows": 1}, s).items()))
             for s in range(20)}
    assert len(picks) > 5


@pytest.mark.parametrize("seed", SEEDS)
def test_decode_requests_and_sample(seed):
    ds = _kind("decode_stream")
    mix = {"kind": "decode_stream", "batch": 16, "prompt": 2048,
           "request_tokens": 64}
    assert ds.shapes(mix) == [(16, 2048)]
    rows = ds.sample(mix, {"rows": 6}, seed)
    assert rows == ds.sample(mix, {"rows": 6}, seed)
    assert len(set(rows)) == 6 and all(0 <= r < 16 for r in rows)
