"""Closed-loop prefill traffic: one batch in flight, the next sent when
the last one's first tokens are on the host.

A mix file gives ``batch`` (requests a batch, one prompt length each)
and ``block``: [length, batches] pairs.  The block's batches are
shuffled by the seed and the block repeated, reshuffled each time; a
window runs whole blocks, so it holds the mix in its proportions.
Token ids are uniform over the vocabulary.  Each request returns one
token, greedy, from the prefill's logits at its last position.

The check draws, from the seed, a batch of the longest length and
another batch of the first block (both finish in any window), and the
rows of each it compares (the cell's ``sample``).  For those batches
the timed path keeps the greedy token at every position; the reference
recomputes the rows (a MoE's whole batch, since an expert's capacity
counts every token of it) and reads, at every position, how far the
kept token's logit lies below its best.
"""
from __future__ import annotations

import random
import time
from typing import Dict, Iterator, List, Tuple

import torch

_TOKEN_SALT = 0x5EED


def lengths(mix: Dict) -> List[int]:
    return sorted({int(length) for length, _ in mix["block"]})


def shapes(mix: Dict) -> List[Tuple[int, int]]:
    """(batch, prompt length) of every prefill the traffic sends."""
    return [(int(mix["batch"]), length) for length in lengths(mix)]


def blocks(mix: Dict, seed: int) -> Iterator[List[int]]:
    """The lengths of each block's batches, in order."""
    rng = random.Random(seed)
    base = [int(length) for length, n in mix["block"] for _ in range(n)]
    while True:
        order = list(base)
        rng.shuffle(order)
        yield order


def sample(mix: Dict, sample_spec: Dict, seed: int) -> Dict[int, List[int]]:
    """{batch index in the first block: rows compared}: a batch of the
    longest length and another batch, and rows of each, from the seed."""
    first = next(blocks(mix, seed))
    rng = random.Random(seed ^ 0xC0FFEE)
    b = int(mix["batch"])
    longest = [i for i, n in enumerate(first) if n == max(first)]
    out = {rng.choice(longest): sorted(rng.sample(range(b),
                                                  sample_spec["longest_rows"]))}
    n_other = int(sample_spec.get("other_rows", 0))
    if n_other:
        rest = [i for i in range(len(first)) if i not in out]
        out[rng.choice(rest)] = sorted(rng.sample(range(b), n_other))
    return out


class Traffic:
    def __init__(self, mix: Dict, cell: Dict, seed: int, prog):
        self.mix, self.prog, self.seed = mix, prog, seed
        self.batch = int(mix["batch"])
        self.sampled = sample(mix, cell["sample"], seed)
        self.gen = torch.Generator(device=prog.device)
        self.gen.manual_seed(seed ^ _TOKEN_SALT)
        self.kept: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._blocks = blocks(mix, seed)

    def _tokens(self, length: int) -> torch.Tensor:
        return torch.randint(0, self.prog.m["vocab"], (self.batch, length),
                             generator=self.gen, device=self.prog.device)

    def _serve(self, tokens: torch.Tensor, keep: bool):
        logits, _ = self.prog.prefill(tokens)
        if keep:
            greedy = logits.argmax(-1)
            first = greedy[:, -1]
        else:
            greedy, first = None, logits[:, -1].argmax(-1)
        first = first.cpu()
        return greedy, first

    def setup(self) -> None:
        """One prefill of each length, the longest first; their prompts
        come from a generator of their own, so the window's are the
        seed's whatever the warm-up drew."""
        gen = torch.Generator(device=self.prog.device)
        gen.manual_seed(self.seed)
        for length in reversed(lengths(self.mix)):
            t = torch.randint(0, self.prog.m["vocab"], (self.batch, length),
                              generator=gen, device=self.prog.device)
            self._serve(t, keep=False)

    def window(self, seconds: float) -> Dict:
        requests: List[Dict] = []
        work: List[Tuple] = []
        n = 0
        t0 = time.perf_counter()
        t = t0
        while t - t0 < seconds:
            for length in next(self._blocks):
                tokens = self._tokens(length)
                keep = n in self.sampled
                due = time.perf_counter()
                greedy, _ = self._serve(tokens, keep)
                t = time.perf_counter()
                if keep:
                    self.kept[n] = (tokens, greedy)
                requests += [{"prompt": length, "output": 1,
                              "ttft_s": t - due}] * self.batch
                work.append(("prefill", self.batch, length))
                n += 1
        return {"requests": requests, "window_s": t - t0, "work": work,
                "batches": n}

    def stretch(self) -> Dict:
        """One more block, for the profile."""
        work = []
        for length in next(self._blocks):
            self._serve(self._tokens(length), keep=False)
            work.append(("prefill", self.batch, length))
        return {"work": work}

    def release(self) -> None:
        """Nothing of the program's is held past the window but the
        sampled batches' prompts and greedy tokens."""

    def judge(self, ref, control=None) -> Dict[str, float]:
        """How far, at every position of the sampled rows, the chosen
        token's logit lies below the reference's best (`gap_summary`);
        the chosen token is the program's, or the control's."""
        from perfbench.reference.model import gap_summary
        moe = self.prog.m["family"] == "moe"
        out = []
        for i, rows in sorted(self.sampled.items()):
            tokens, greedy = self.kept[i]
            idx = torch.tensor(rows, device=tokens.device)
            inp = tokens if moe else tokens[idx]
            pick = idx if moe else torch.arange(len(rows),
                                                device=tokens.device)
            hid = ref.prefill_hidden(inp)[pick]
            if control is None:
                chosen = greedy[idx]
            else:
                chosen = control.argmax(
                    control.prefill_hidden(inp)[pick].flatten(0, 1)
                ).view(len(rows), -1)
            out.append(ref.gaps(hid.flatten(0, 1), chosen.flatten()))
            del hid
        return gap_summary(torch.cat(out))
