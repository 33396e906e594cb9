"""One run of a cell: set-up, the window, the check and the metrics.

Set-up, timed as ``setup_s`` from the caller's start: the program's import
and kernels, the cell's ``Problem`` on the card, and the short solves of
the configuration's ``warmup`` (each an ``eps`` and an optional
``itr_max``): one at a loose eps, which stops at its first check and
replays the stopping chunk, and one at eps 0 for a few iterations, which
reaches BiCGSTAB's second iteration and the driver's chunk loop; with a
trace, one more solve at a loose eps under a profiler, whose own start-up
then stays out of the traced window.  The sample's fields are made before
the window (czb/window.py), so that the window allocates no field.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import check, spec, trace as trace_mod, window
from .inputs import DTYPES, Inputs
from .work import card_peaks

# modules that may not be loaded in a run, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "cubez_tpu")
LOOSE_EPS = 1e9  # a solve that stops after its first check


def segments(device) -> int:
    """The device segments the caching allocator has made (cudaMalloc
    calls) so far; 0 off the card."""
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit():
    """The card's power limit in W as nvidia-smi reads it, else None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def trace_file(workload: str, seed: int) -> Path:
    d = Path(tempfile.gettempdir()) / "czbench"
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{workload}.{seed}.trace.json"


def say(msg: str):
    print(msg, file=sys.stderr)


def run_cell(cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start=None, n=None, marks=()):
    """Run ``cell`` once; returns the result's dict.  ``n`` stands for the
    traffic's grid (the CPU tests run at 16^3); ``marks`` are the caller's
    (phase, perf_counter) marks of set-up, printed with this one's."""
    from .program import Program

    if t_start is None:
        t_start = time.perf_counter()
    marks = [("start", t_start), *marks]
    cfg = cell.config
    n = n or cell.traffic["n"]
    cuda = torch.device(device).type == "cuda"
    inputs = Inputs(n, DTYPES[cfg["dtype"]], device, seed)
    window.sync(device)
    marks.append(("inputs", time.perf_counter()))
    program = Program(cfg, n, device)
    window.sync(device)
    marks.append(("problem", time.perf_counter()))
    for i, w in enumerate(cfg["warmup"]):
        program.solve(inputs.start(-1 - i), inputs.rhs, **w)
    if trace:  # the profiler's own start-up, out of the traced window
        with torch.profiler.profile():
            program.solve(inputs.start(-9), inputs.rhs, eps=LOOSE_EPS)
    sampler = window.Sampler(cell.check["sample"], seed, like=inputs.rhs)
    window.sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    say(f"setup {setup_s:.3f} s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])))

    path = trace_file(cell.name, seed) if trace else None
    made = segments(device)
    solves, window_s, traced = window.run(program, inputs, seconds, sampler,
                                          path)
    made = segments(device) - made
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    sample = sampler.sample()
    del sampler, program
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    say(f"window {window_s:.3f} s, {len(solves)} solves ({traced} traced), "
        f"{made} device segments allocated in it")
    tr = trace_mod.read(path) if trace else None
    if path is not None:
        say(f"trace {path} read in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()

    correct, checks, readings = check.check_sample(
        cfg, inputs, sample, cell.check["limits"])
    for (index, r), rd in zip(sample, readings):
        say(f"sample solve {index}: {r.iters} iterations, "
            + ", ".join(f"{k} {v!r}" for k, v in rd.items()))
    del sample
    say(f"check {time.perf_counter() - t:.3f} s")

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    facts = {
        "config": cfg, "n": n, "setup_s": setup_s, "window_s": window_s,
        "solves": solves, "traced": solves[:traced], "trace": tr,
        "peaks": card_peaks(kind) if cuda else None,
    }
    metrics = {}
    for m in cell.metrics(trace):
        v = spec.reader(m["name"], cell.here)(facts)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
    if cuda:
        dev["power_limit_w"] = power_limit()
    out = {
        "correct": correct, "attempted": len(solves),
        "failed": sum(1 for s in solves
                      if s.iters == 0 or not s.res < cfg["eps"]),
        "metrics": metrics, "device": dev,
    }
    if tr is not None:
        out["breakdown"] = tr["breakdown"]
    out["checks"] = checks
    return out
