"""The port's token pipeline (`repro_torch.data`) against the
reference's: numpy alone draws both, so every batch is the reference's
bit for bit for every ``(seed, step, host_count, host_index)``, and the
stream resumes from a step integer (the counterpart of the reference's
``test_data_stream_resumable_and_deterministic``)."""
import itertools

import numpy as np
import pytest

from repro.data import DataConfig as RefDataConfig
from repro.data import TokenStream as RefTokenStream
from repro_torch.data import DataConfig, TokenStream

CASES = [  # (vocab, global_batch, seq_len, seed, host_count)
    (977, 4, 64, 3, 1), (128, 8, 32, 0, 2), (256000, 8, 256, 0, 1),
    (51865, 6, 48, 7, 3), (50, 2, 16, 1, 1)]


@pytest.mark.parametrize("vocab,batch,seq,seed,hosts", CASES)
def test_batches_are_bit_identical(vocab, batch, seq, seed, hosts):
    for host in range(hosts):
        got = TokenStream(DataConfig(vocab, batch, seq, seed), hosts, host)
        want = RefTokenStream(RefDataConfig(vocab, batch, seq, seed), hosts,
                              host)
        assert got.host_batch() == want.host_batch() == batch // hosts
        np.testing.assert_array_equal(got._motifs, want._motifs)
        for step in (0, 1, 17, 12345):
            g, w = got.make_batch(step), want.make_batch(step)
            assert g.keys() == w.keys() == {"tokens"}
            assert g["tokens"].dtype == w["tokens"].dtype == np.int32
            np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_resumable_and_deterministic():
    cfg = DataConfig(vocab=977, global_batch=4, seq_len=64, seed=3)
    s1, s2 = TokenStream(cfg), TokenStream(cfg)
    np.testing.assert_array_equal(s1.make_batch(17)["tokens"],
                                  s2.make_batch(17)["tokens"])
    assert not np.array_equal(s1.make_batch(17)["tokens"],
                              s1.make_batch(18)["tokens"])
    # resuming at step 5 gives the straight run's batches 5, 6, 7
    straight = list(itertools.islice(s1.iter_from(0), 8))[5:]
    resumed = list(itertools.islice(s2.iter_from(5), 3))
    for a, b in zip(straight, resumed):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_hosts_draw_different_slices_and_the_batch_must_split():
    cfg = DataConfig(vocab=128, global_batch=8, seq_len=32)
    a = TokenStream(cfg, 2, 0).make_batch(0)["tokens"]
    b = TokenStream(cfg, 2, 1).make_batch(0)["tokens"]
    assert a.shape == b.shape == (4, 32) and not np.array_equal(a, b)
    with pytest.raises(ValueError, match="split"):
        TokenStream(cfg, 3)


def test_the_stream_has_learnable_structure():
    """Motifs are pasted into every row: each row holds at least one
    whole motif from the bank."""
    s = TokenStream(DataConfig(vocab=977, global_batch=4, seq_len=64))
    toks = s.make_batch(0)["tokens"]
    motifs = {tuple(m) for m in s._motifs}
    for row in toks:
        windows = {tuple(row[i:i + 16]) for i in range(64 - 15)}
        assert windows & motifs
