#!/usr/bin/env python3
"""Profile the port's line solvers at 128^3 float32 on one NVIDIA GPU:
device time per iteration by kernel, and the busy share (device kernel
time over the solve's wall time).

    python3 tools/prof_lines.py [--fixed] [--tiles]

For each of pcr_rb (K5), pcr_rb_maf (K5-MAF) and pcr_j_esa at omega 1.0
(K6's line-Jacobi) it runs one warm-up solve, three timed solves, and one
solve under ``torch.profiler``; then 60 fixed sweeps of K10's entry point
(``make_fused_pcr_step('pcr_rb')``, constant and MAF) under the profiler.
It prints the card's name and power limit, one summary line and the top
device rows per run, and the summaries as one JSON object on the last
line.

``--fixed`` runs fixed sweeps instead, at 128^3 and 512^3, of K5 (the
pcr_rb step, constant and MAF), K6's line-Jacobi (the pcr_j_esa step at
omega 1.0, constant and MAF) and K6's red-black form (the pcr_rb step at
odd I, (N, N-1, N) as (K, I, J), constant and MAF): the device
microseconds a kernel launch under the profiler, and the microseconds an
iteration by CUDA events (long minus short, host cost included).  The
step builders' interface is the same in earlier trees, so a copy of the
script in another checkout measures that checkout.  ``--tiles`` (with
``--fixed``) repeats the kernel rows at several tile settings
(``lines.TILE_LINES``, ``lines.TILE_THREADS``).
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
from cubez_tpu_torch.cuda_kernels import lines as k6  # noqa: E402
from cubez_tpu_torch.cuda_kernels import pcr as k10  # noqa: E402
from cubez_tpu_torch.cuda_kernels import rblines as k5  # noqa: E402
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


ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
# (label, kernel name, builder(n, mc) -> step); K6's red-black form runs
# where K5's packed layout refuses, odd I
FIXED = (
    ("K5 rbl", "rbl_color_kernel",
     lambda n, mc: k5.make_rbl_step((n, n, n), omega=1.5, b_is_zero=True,
                                    mc=mc)),
    ("K6 line_j", "line_jacobi_kernel",
     lambda n, mc: k6.make_line_step("pcr_j", (n, n, n), omega=1.0,
                                     b_is_zero=True, mc=mc)),
    ("K6 line_rb", "line_rb_color_kernel",
     lambda n, mc: k6.make_line_step("pcr_rb", (n, n - 1, n), omega=1.5,
                                     b_is_zero=True, mc=mc)),
)
# fixed sweeps: (events short, long; profiled)
SWEEPS = {128: (20, 200, 100), 512: (4, 24, 12)}
# (TILE_LINES, TILE_THREADS) of --tiles, the default first
TILES = ((32, 256), (32, 128), (16, 256), (16, 128), (64, 256), (8, 128))


def _events_ms(step, x, count):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fixed_sweeps(step, x, None, count)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def fixed(card, tiles: bool):
    """Device microseconds a launch and microseconds an iteration of the
    line kernels over fixed sweeps at 128^3 and 512^3."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    settings = TILES if tiles else (None,)
    for n in (128, 512):
        short, long, prof_n = SWEEPS[n]
        for label, kname, build in FIXED:
            for maf in (False, True):
                shape = (n, n - 1, n) if "line_rb" in label else (n, n, n)
                mc = None
                if maf:
                    K, I, J = shape
                    mc = Problem.poisson_cube((I, J, K), device="cuda",
                                              maf=True).mc
                for st in settings:
                    if st is not None:
                        k6.TILE_LINES, k6.TILE_THREADS = st
                    step = build(n, mc)
                    x = step.pad(torch.rand(shape, device="cuda", generator=gen))
                    fixed_sweeps(step, x, None, 3)  # warm-up
                    torch.cuda.synchronize()
                    ts = {c: min(_events_ms(step, x, c) for _ in range(2))
                          for c in (short, long)}
                    it_us = (ts[long] - ts[short]) / (long - short) * 1e3
                    with torch.profiler.profile(activities=ACTS) as prof:
                        fixed_sweeps(step, x, None, prof_n)
                        torch.cuda.synchronize()
                    rows = [r for r in _device_rows(prof) if kname in r[0]]
                    if not rows:
                        raise SystemExit(f"{label}: no {kname} on the device")
                    calls = sum(r[1] for r in rows)
                    dev_us = sum(r[2] for r in rows)
                    name = f"{label}{' MAF' if maf else ''} {n}^3"
                    s = {"launch_device_us": dev_us / calls,
                         "launches_per_iteration": calls / prof_n,
                         "iteration_us": it_us}
                    if st is not None:
                        L, threads, _ = k6.tile_plan(
                            "line_j", shape, torch.float32, maf)
                        s["tile"] = {"L": L, "threads": threads}
                        name += f" L<={st[0]} threads={st[1]}"
                    print(f"== {name}: {json.dumps(s)}  [{card}]", flush=True)
                    out[name] = s
                    del step, x
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    _build.load()
    if "--fixed" in sys.argv[1:]:
        out = {"card": card, "fixed": fixed(card, "--tiles" in sys.argv[1:])}
        print(json.dumps(out))
        return
    out = {"card": card, "n": N}
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
        with torch.profiler.profile(activities=ACTS) as prof:
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
        with torch.profiler.profile(activities=ACTS) as prof:
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
