"""Decode traffic over a long cache: ``batch`` sequences whose prompts
of ``prompt`` tokens are prefilled in set-up (as serving builds the
cache), then decoded greedily, one token a sequence a step, back to
back.  A request is one sequence's next ``request_tokens`` tokens; a
window runs whole requests.

Each step's tokens go to the host as serving streams them: copied
without blocking, and read after the next step is enqueued.  A step
ends, for the gaps between tokens, at a CUDA event recorded after its
greedy choice.

The check draws ``sample.rows`` sequences from the seed and compares
every token they were served in the window: the reference recomputes
each step from the prompt and the token fed in, and reads how far the
served token's logit lies below its best.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

_TOKEN_SALT = 0xD0C0DE


def shapes(mix: Dict) -> List[Tuple[int, int]]:
    return [(int(mix["batch"]), int(mix["prompt"]))]


def sample(mix: Dict, sample_spec: Dict, seed: int) -> List[int]:
    rng = random.Random(seed ^ 0xC0FFEE)
    return sorted(rng.sample(range(int(mix["batch"])),
                             int(sample_spec["rows"])))


class Traffic:
    def __init__(self, mix: Dict, cell: Dict, seed: int, prog):
        self.mix, self.prog = mix, prog
        self.batch, self.prompt = int(mix["batch"]), int(mix["prompt"])
        self.per_request = int(mix["request_tokens"])
        self.rows = sample(mix, cell["sample"], seed)
        self.gen = torch.Generator(device=prog.device)
        self.gen.manual_seed(seed ^ _TOKEN_SALT)
        self.tokens = self.cache = self.tok = None
        self.fed: List[np.ndarray] = []        # the token fed at each step
        self.served: List[np.ndarray] = []     # the token it returned
        self.pos: List[int] = []

    def _steps(self, n: int):
        """``n`` decode steps; returns their end events (on a card)."""
        ev: List = []
        pending = None
        for _ in range(n):
            # the benchmark's count, not the program's: step k after the
            # prefill feeds position prompt + k
            self.pos.append(self.prompt + len(self.pos))
            fed = self.tok
            logits, self.cache = self.prog.decode_step(self.cache, fed)
            self.tok = logits[:, -1:].argmax(-1)
            host = (fed.view(-1).to("cpu", non_blocking=True),
                    self.tok.view(-1).to("cpu", non_blocking=True))
            done = torch.cuda.Event(enable_timing=True) \
                if self.prog.device.type == "cuda" else None
            if done is not None:
                done.record()
                ev.append(done)
            if pending is not None:
                self._deliver(*pending)
            pending = (done, host)
        if pending is not None:
            self._deliver(*pending)
        return ev

    def _deliver(self, done, host) -> None:
        if done is not None:
            done.synchronize()
        self.fed.append(host[0].numpy().copy())
        self.served.append(host[1].numpy().copy())

    def setup(self) -> None:
        """The context fill (one prefill of every prompt), then the warm
        decode steps."""
        self.tokens = torch.randint(0, self.prog.m["vocab"],
                                    (self.batch, self.prompt),
                                    generator=self.gen,
                                    device=self.prog.device)
        logits, self.cache = self.prog.prefill(self.tokens)
        self.tok = logits[:, -1:].argmax(-1)
        del logits
        self._steps(int(self.mix.get("warm_steps", 2)))
        self.prog.sync()

    def window(self, seconds: float) -> Dict:
        first = len(self.served)
        ev: List = []
        blocks = 0
        t0 = time.perf_counter()
        t = t0
        while t - t0 < seconds:
            ev += self._steps(self.per_request)
            blocks += 1
            t = time.perf_counter()
        self.window_steps = (first, len(self.served))
        gaps = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        n = self.batch * blocks
        return {"requests": [{"prompt": 0, "output": self.per_request}] * n,
                "window_s": t - t0, "itl_ms": gaps,
                "work": [("decode", self.batch, self.prompt)]
                * (blocks * self.per_request),
                "batches": blocks}

    def stretch(self) -> Dict:
        """One more request's steps, for the profile."""
        self._steps(self.per_request)
        self.prog.sync()
        return {"work": [("decode", self.batch, self.prompt)]
                * self.per_request}

    def release(self) -> None:
        self.cache = self.tok = None

    def judge(self, ref, control=None) -> Dict[str, float]:
        """How far, at every window step of the sampled sequences, the
        served token's logit (or the control's choice at the same step)
        lies below the reference's best (`gap_summary`)."""
        lo, hi = self.window_steps
        fed = np.stack(self.fed[lo:hi])
        served = np.stack(self.served[lo:hi])
        pos = torch.tensor(self.pos[lo:hi], device=self.prog.device)
        from perfbench.reference.model import gap_summary
        out = []
        for r in self.rows:
            prompt = self.tokens[r]
            inp = torch.from_numpy(fed[:, r]).to(self.prog.device)
            hid = ref.decode_hidden(prompt, inp, pos)
            if control is None:
                chosen = torch.from_numpy(served[:, r]).to(self.prog.device)
            else:
                chosen = control.argmax(control.decode_hidden(prompt, inp,
                                                              pos))
            out.append(ref.gaps(hid, chosen))
        return gap_summary(torch.cat(out))
