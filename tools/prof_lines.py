#!/usr/bin/env python3
"""Profile the port's line solvers at 128^3 float32 on one NVIDIA GPU:
device time per iteration by kernel, and the busy share (device kernel
time over the solve's wall time).

    python3 tools/prof_lines.py

For each of pcr_rb (K5), pcr_rb_maf (K5-MAF) and pcr_j_esa at omega 1.0
(K6's line-Jacobi) it runs one warm-up solve, three timed solves, and one
solve under ``torch.profiler``; then 60 fixed sweeps of K10's entry point
(``make_fused_pcr_step('pcr_rb')``, constant and MAF) under the profiler.
It prints the card's name and power limit, one summary line and the top
device rows per run, and the summaries as one JSON object on the last
line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from cubez_tpu_torch import Problem, solve  # noqa: E402
from cubez_tpu_torch.cuda_kernels import _build  # noqa: E402
from cubez_tpu_torch.cuda_kernels import pcr as k10  # noqa: E402
from cubez_tpu_torch.solvers.driver import fixed_sweeps  # noqa: E402

N = 128
SOLVES = (("pcr_rb", 1.5), ("pcr_rb_maf", 1.5), ("pcr_j_esa", 1.0))


def _device_rows(prof):
    """(name, calls, device us) of the device's own events (kernels and
    copies), largest first; the host ops that launched them also carry
    their device time, so they are left out, not to count it twice."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        if t > 0:
            rows.append((ev.key[:70], ev.count, t))
    if not rows:
        raise SystemExit("the profiler recorded no device time")
    return sorted(rows, key=lambda row: -row[2])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    _build.load()
    out = {"card": card, "n": N}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, omega in SOLVES:
        p = Problem.poisson_cube(N, device="cuda",
                                 maf=name.endswith("_maf"))
        solve(p, name, omega=omega, itr_max=20)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            solve(p, name, omega=omega, itr_max=10000)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            r = solve(p, name, omega=omega, itr_max=10000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = _device_rows(prof)
        dev_us = sum(row[2] for row in rows)
        s = {"iters": r.iters, "walls_s": walls, "wall_profiled_s": wall,
             "device_ms": dev_us / 1e3, "busy_share": dev_us / 1e6 / wall,
             "device_us_per_iteration": dev_us / r.iters}
        print(f"== {name}: {json.dumps(s)}  [{card}]")
        for key, cnt, t in rows[:10]:
            print(f"   {key:70s} n={cnt:6d} total {t / 1e3:9.3f} ms  "
                  f"per call {t / cnt:8.2f} us")
        out[name] = s
    for maf in (False, True):
        p = Problem.poisson_cube(N, device="cuda", maf=maf)
        step = k10.make_fused_pcr_step("pcr_rb", p.grid.shape_kij, omega=1.5,
                                       b_is_zero=True, mc=p.mc)
        fixed_sweeps(step, step.pad(p.x0), None, 6)  # warm-up
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fixed_sweeps(step, step.pad(p.x0), None, 60)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = _device_rows(prof)
        dev_us = sum(row[2] for row in rows)
        name = "K10 pcr_rb" + (" MAF" if maf else "")
        s = {"sweeps": 60, "wall_profiled_s": wall, "device_ms": dev_us / 1e3,
             "busy_share": dev_us / 1e6 / wall,
             "device_us_per_iteration": dev_us / 60}
        print(f"== {name}: {json.dumps(s)}  [{card}]")
        for key, cnt, t in rows[:4]:
            print(f"   {key:70s} n={cnt:6d} total {t / 1e3:9.3f} ms  "
                  f"per call {t / cnt:8.2f} us")
        out[name] = s
    print(json.dumps(out))


if __name__ == "__main__":
    main()
