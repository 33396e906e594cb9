#!/usr/bin/env python3
"""Profile the port's distributed solves (solve_dist) at 128^3 float32 on
one NVIDIA GPU, the blocks of the mesh all on that card: device time per
iteration by kernel, the launches, and the busy share (device time over
the solve's wall time).

    python3 tools/prof_dist.py [solver ...]

Over a (2, 2, 2) mesh of eight blocks: sor2sma pack (K7), sor2sma_maf
pack (K7-MAF), sor2sma 'color' and 'overlap' (K8), jacobi at omega 0.8
(K8), and the line solvers pcr_rb and pcr_rb_maf at omega 1.5 and
pcr_j_esa at 1.0 (K9's 'pcr' form); over (1, 2, 2) the same three line
solvers (K9's 'fastdiag' form).  Solver names on the command line keep
only those solves.  For each it runs one warm-up solve, three timed solves
and one solve under ``torch.profiler``.  It prints the
card's name and power limit, one summary line and the top device rows per
solve, and the summaries as one JSON object on the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from cubez_tpu_torch import Problem, make_mesh, solve_dist  # noqa: E402
from cubez_tpu_torch.cuda_kernels import _build  # noqa: E402
from prof_lines import _device_rows  # noqa: E402

N = 128
# (solver, omega, sync, mesh division)
SOLVES = tuple((n, w, s, (2, 2, 2)) for n, w, s in (
    ("sor2sma", 1.5, "pack"), ("sor2sma_maf", 1.5, "pack"),
    ("sor2sma", 1.5, "color"), ("sor2sma", 1.5, "overlap"),
    ("jacobi", 0.8, "auto"))) + tuple(
    (n, w, "auto", div) for div in ((2, 2, 2), (1, 2, 2))
    for n, w in (("pcr_rb", 1.5), ("pcr_rb_maf", 1.5), ("pcr_j_esa", 1.0)))


def main(names=()):
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
    for name, omega, sync, div in SOLVES:
        if names and name not in names:
            continue
        p = Problem.poisson_cube(N, device="cuda", maf=name.endswith("_maf"))
        cm = make_mesh((N, N, N), devices=["cuda:0"] * (div[0] * div[1] * div[2]),
                       div=div)

        def run(itr_max):
            r = solve_dist(p, cm, name, omega=omega, itr_max=itr_max, sync=sync)
            torch.cuda.synchronize()
            return r

        run(20)  # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(10000)
            walls.append(time.perf_counter() - t0)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            r = run(10000)
            wall = time.perf_counter() - t0
        rows = _device_rows(prof)
        dev_us = sum(row[2] for row in rows)
        s = {"iters": r.iters, "walls_s": walls, "wall_profiled_s": wall,
             "device_ms": dev_us / 1e3, "busy_share": dev_us / 1e6 / wall,
             "device_us_per_iteration": dev_us / r.iters,
             "device_launches_per_iteration":
                 sum(row[1] for row in rows) / r.iters}
        label = f"{name} {sync} {div}"
        print(f"== {label}: {json.dumps(s)}  [{card}]")
        for key, cnt, t in rows[:8]:
            print(f"   {key:70s} n={cnt:6d} total {t / 1e3:9.3f} ms  "
                  f"per call {t / cnt:8.2f} us")
        out[label] = s
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
