"""The measured window: a closed loop of one client that runs converged
solves back to back, and the sample of them that the check compares.

Each solve's wall time runs from the call to the device's synchronize.
The window closes at the first solve boundary after ``seconds``.  With a
trace, torch.profiler records the first solves of the window, whole ones,
until ``TRACE_SECONDS`` have passed, inside the host annotation the trace
reader looks for; the rest of the window runs untraced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import torch

from . import trace as trace_mod


@dataclasses.dataclass
class Solve:
    index: int
    iters: int
    res: float
    seconds: float


@dataclasses.dataclass
class Held:
    """A sampled solve's result: its field copied into one of the sampler's
    slots, its history on the host."""
    x: torch.Tensor
    iters: int
    res: float
    history: torch.Tensor


class Sampler:
    """A sample of the finished solves drawn from the seed: ``k`` by
    reservoir sampling, and one of those with the most iterations.  With
    ``like``, each kept field is copied into one of ``k + 1`` fields made
    before the window, so that keeping a solve allocates nothing on the
    device; without it the results are held as they are."""

    def __init__(self, k: int, seed: int, like=None):
        self.rng = random.Random(f"czbench-sample:{seed}")
        self.k, self.seen, self.kept = k, 0, []
        self.longest, self.most, self.ties = None, -1, 0
        self.slots = (None if like is None
                      else [torch.empty_like(like) for _ in range(k + 1)])

    def _hold(self, slot: int, index: int, result):
        if self.slots is None:
            return index, result
        x = self.slots[slot]
        x.copy_(result.x)
        return index, Held(x, result.iters, result.res, result.history.cpu())

    def offer(self, index: int, result):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(self._hold(len(self.kept), index, result))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = self._hold(j, index, result)
        if result.iters > self.most:
            self.most, self.ties = result.iters, 1
            self.longest = self._hold(self.k, index, result)
        elif result.iters == self.most:
            self.ties += 1
            if self.rng.randrange(self.ties) == 0:
                self.longest = self._hold(self.k, index, result)

    def sample(self) -> list:
        """[(index, result)] in index order."""
        picked = dict(self.kept)
        if self.longest is not None:
            picked.setdefault(*self.longest)
        return sorted(picked.items(), key=lambda ir: ir[0])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


TRACE_SECONDS = 4.0  # the traced part of a --trace 1 window


def run(program, inputs, seconds: float, sampler: Sampler, trace_path=None):
    """Run the window.  Returns (solves, window seconds, traced solves).
    With ``trace_path`` the traced solves' chrome trace is written there."""
    solves = []
    t0 = time.perf_counter()

    def one(label):
        index = len(solves)
        with label("czbench.inputs"):
            x0 = inputs.start(index)
        ts = time.perf_counter()
        with label("czbench.solve"):
            r = program.solve(x0, inputs.rhs)
            sync(inputs.device)
        te = time.perf_counter()
        solves.append(Solve(index, r.iters, r.res, te - ts))
        sampler.offer(index, r)
        return te - t0

    traced = 0
    if trace_path is not None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(inputs.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        label = torch.profiler.record_function
        with torch.profiler.profile(activities=acts) as prof:
            with label(trace_mod.WINDOW):
                while one(label) < min(TRACE_SECONDS, seconds):
                    pass
        traced = len(solves)
    elapsed = time.perf_counter() - t0
    while elapsed < seconds:
        elapsed = one(contextlib.nullcontext)
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    return solves, elapsed, traced
