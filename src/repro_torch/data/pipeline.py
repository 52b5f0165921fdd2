"""Deterministic synthetic token pipeline, the reference's.

Every batch is a pure function of ``(seed, step, host_count,
host_index)`` drawn with numpy alone, so the port's batches are the
reference's bit for bit and the pipeline is resumable by construction:
its only state is the integer step, which the checkpoint persists.  A
host materialises only its slice of the global batch (``host_batch``).

The stream mixes Zipf-ish unigram draws with short repeated motifs, so
small models visibly learn (the loss falls); uniform noise has no
learnable structure.  Batches are numpy arrays; the trainer moves them
to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "TokenStream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64


class TokenStream:
    """make_batch(step) is pure; state = step only."""

    def __init__(self, cfg: DataConfig, host_count: int = 1,
                 host_index: int = 0):
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.host_count = host_count
        self.host_index = host_index
        # fixed motif bank (seed-derived, step-independent)
        rng = np.random.default_rng(cfg.seed)
        zipf = 1.0 / np.arange(1, cfg.vocab + 1) ** 1.1
        self._probs = zipf / zipf.sum()
        self._motifs = rng.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len))

    def host_batch(self) -> int:
        return self.cfg.global_batch // self.host_count

    def make_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = self.host_batch()
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 17 + self.host_index)
        toks = rng.choice(cfg.vocab, p=self._probs,
                          size=(b, cfg.seq_len)).astype(np.int32)
        # paste motifs at random offsets (learnable bigram structure)
        n_paste = max(1, cfg.seq_len // (2 * cfg.motif_len))
        for i in range(b):
            ids = rng.integers(0, cfg.n_motifs, size=n_paste)
            offs = rng.integers(0, max(cfg.seq_len - cfg.motif_len, 1),
                                size=n_paste)
            for m, o in zip(ids, offs):
                toks[i, o:o + cfg.motif_len] = self._motifs[m]
        return {"tokens": toks}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.make_batch(step)
            step += 1
