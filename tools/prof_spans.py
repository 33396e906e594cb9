"""Cost of the port's spans (cubez_tpu_torch/perf/spans.py) on the card.

    python3 tools/prof_spans.py [--root DIR] [--n 124] [--solves 40]
                                [--seed S] [--rounds 2] [--modes off ...]

Times converged sor2sma solves (omega 1.5, eps 1e-5, float32) of the
checkout at ``--root`` (default: this one) on an n^3 grid, each from its own
uniform [0, 1) interior drawn from (seed, i), in three modes taken in
turns, ``--rounds`` times: 'off' (no profiler, no recording), 'recording'
(inside ``spans.recording()``, no profiler; skipped by a checkout without
perf/spans.py) and 'traced' (all the mode's solves inside one
torch.profiler run, CPU and CUDA activities); ``--modes`` takes a
subset.  Every mode solves the same starts.  A solve's time runs from the
call to the device's synchronize.  Prints one JSON line: the card, its
power limit, and per
mode the median, quartiles and mean ms and the iterations a solve; for
'recording' also the means of the records' syncs, device idle across
them (ms) and host µs a launch.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except OSError:
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--n", type=int, default=124)
    ap.add_argument("--solves", type=int, default=40)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--modes", nargs="+", default=("off", "traced", "recording"),
                    choices=("off", "traced", "recording"))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)

    import dataclasses

    import torch
    from cubez_tpu_torch.core.problem import Problem
    from cubez_tpu_torch.solvers.api import solve
    try:
        from cubez_tpu_torch.perf import spans
    except ImportError:
        spans = None

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    prob = Problem.poisson_cube(args.n, torch.float32, device=dev)
    inner = (slice(1, -1),) * 3

    def start(i):
        g = torch.Generator(device=dev).manual_seed(args.seed * 1000 + i)
        x0 = prob.x0.clone()
        x0[inner] = torch.rand(x0[inner].shape, generator=g, device=dev,
                               dtype=x0.dtype)
        return dataclasses.replace(prob, x0=x0)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    starts = [start(i) for i in range(args.solves)]
    solve(starts[0], "sor2sma", omega=1.5, itr_max=10000)  # build, warm
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):  # the profiler's start-up
        solve(starts[0], "sor2sma", omega=1.5, itr_max=10000)
        sync()
    modes = {"off": contextlib.nullcontext,
             "traced": lambda: torch.profiler.profile(activities=acts)}
    if spans is not None:
        modes["recording"] = spans.recording
    modes = {m: ctx for m, ctx in modes.items() if m in args.modes}
    times = {m: [] for m in modes}
    iters = {m: [] for m in modes}
    recs = []
    for _ in range(args.rounds):
        for mode, ctx in modes.items():
            with ctx():
                for p in starts:
                    t = time.perf_counter()
                    r = solve(p, "sor2sma", omega=1.5, itr_max=10000)
                    sync()
                    times[mode].append(1e3 * (time.perf_counter() - t))
                    iters[mode].append(r.iters)
                    if mode == "recording":
                        recs.append(spans.solves()[-1])
    import cubez_tpu_torch

    out = {"package": cubez_tpu_torch.__file__, "n": args.n,
           "solves": args.solves, "rounds": args.rounds,
           "card": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "power_limit_w": power_limit() if cuda else None, "modes": {}}
    for mode, t in times.items():
        q = statistics.quantiles(t, n=4)
        out["modes"][mode] = {
            "median_ms": statistics.median(t), "q1_ms": q[0], "q3_ms": q[2],
            "mean_ms": statistics.fmean(t),
            "iters": statistics.fmean(iters[mode])}
    if recs and cuda:
        out["modes"]["recording"].update(
            syncs=statistics.fmean(r.syncs for r in recs),
            sync_idle_ms=statistics.fmean(1e3 * r.sync_idle_s for r in recs),
            host_us_per_launch=1e-3 * sum(r.step_self_ns() for r in recs)
            / sum(r.launches for r in recs))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
