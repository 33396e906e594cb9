#!/usr/bin/env python3
"""Profile K4's paths and the distributed pack path (K7) on one NVIDIA GPU,
float32: per iteration the wall, the device time, the device launches, the
busy share and the kernels' device microseconds a launch; and, with
``--solves``, one whole solve.

    python3 tools/prof_k4.py [--solves] [--tiles] [path ...]

Paths (their labels; names on the command line keep only those):

* ``jacobi 128``, ``jacobi_maf 128`` at omega 0.8 (K4's Jacobi step),
  ``jacobi 512``;
* ``sor2sma 125``, ``sor2sma_maf 125`` at omega 1.5: odd I, so K4's
  red-black step;
* ``pack 128``, ``pack_maf 128``, ``pack 512``, ``pack_maf 512``:
  solve_dist sor2sma / sor2sma_maf at omega 1.5 over a (2, 2, 2) mesh
  whose eight blocks share the card.

Each path solves with eps 0 from distinct seeded random starts, so that it
takes exactly itr_max iterations through run_iterative as a solve does
(chunks, history, snapshot): the wall of a short and of a long run, twice
each in turns (short, long, long, short), gives the wall an iteration
(long minus short, the least of each); one more run under
``torch.profiler`` gives the device time, the device's own events
(kernels, copies) and the busy share (device time over that run's wall)
an iteration, and the device microseconds a launch of each kernel.
``--solves`` times one solve from the problem's start to eps 1e-5 (not
for ``jacobi 512``, some 10^5 iterations).  Only the public entry points
are used, so a copy of the script in another checkout measures that
checkout (the parent against the change in one call).

``--tiles`` (this tree's K4 only) first times K4's launches at 128^3 and
512^3 over several tile settings (``sweeps.REGION_ROWS``,
``sweeps.MIN_KCHUNK``, and at 512^3 the k chunks a tile) for the Jacobi
step (n = ``sweeps.JACOBI_N``; and MAF), its single form (n = 1) and the
red-black step: device microseconds a launch and an iteration under the
profiler, and the co-resident CTAs of each kernel.

It prints the card's name and power limit, one line a path and its top
device rows, and all summaries as one JSON object on the last line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from cubez_tpu_torch import Problem, make_mesh, solve, solve_dist  # noqa: E402
from cubez_tpu_torch.cuda_kernels import _build  # noqa: E402

ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
SEED = 20261017
# (label, solver, omega, size, mesh division or None, iterations: short,
# long, profiled; multiples of every step's chunk: 16, and 18 for the pack
# step's n = 6 calls)
PATHS = (
    ("jacobi 128", "jacobi", 0.8, 128, None, (144, 720, 288)),
    ("jacobi_maf 128", "jacobi_maf", 0.8, 128, None, (144, 720, 288)),
    ("sor2sma 125", "sor2sma", 1.5, 125, None, (144, 720, 288)),
    ("sor2sma_maf 125", "sor2sma_maf", 1.5, 125, None, (144, 720, 288)),
    ("jacobi 512", "jacobi", 0.8, 512, None, (144, 432, 144)),
    ("pack 128", "sor2sma", 1.5, 128, (2, 2, 2), (144, 720, 288)),
    ("pack_maf 128", "sor2sma_maf", 1.5, 128, (2, 2, 2), (144, 720, 288)),
    ("pack 512", "sor2sma", 1.5, 512, (2, 2, 2), (144, 432, 144)),
    ("pack_maf 512", "sor2sma_maf", 1.5, 512, (2, 2, 2), (144, 432, 144)),
)


def device_rows(prof):
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


def profile_path(card, label, solver, omega, n, div, counts, solves):
    short, long, profiled = counts
    maf = solver.endswith("_maf")
    shape = (n, n, n)  # odd I at 125: K4's red-black step
    p0 = Problem.poisson_cube(shape, device="cuda", maf=maf)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cm = None
    if div is not None:
        cm = make_mesh(shape, devices=["cuda:0"] * (div[0] * div[1] * div[2]),
                       div=div)

    def run(p, itr_max, eps=0.0):
        if cm is None:
            r = solve(p, solver, omega=omega, itr_max=itr_max, eps=eps)
        else:
            r = solve_dist(p, cm, solver, omega=omega, itr_max=itr_max,
                           eps=eps, sync="pack")
        torch.cuda.synchronize()
        return r

    def start():
        x = p0.x0 + torch.rand(shape, device="cuda", generator=gen) * p0.msk
        return dataclasses.replace(p0, x0=x)

    run(start(), 32)  # warm-up
    walls = {short: [], long: []}
    for count in (short, long, long, short):
        p = start()
        t0 = time.perf_counter()
        run(p, count)
        walls[count].append(time.perf_counter() - t0)
    p = start()
    with torch.profiler.profile(activities=ACTS) as prof:
        t0 = time.perf_counter()
        run(p, profiled)
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    dev_us = sum(row[2] for row in rows)
    s = {"wall_us_per_iteration":
             (min(walls[long]) - min(walls[short])) / (long - short) * 1e6,
         "device_us_per_iteration": dev_us / profiled,
         "device_launches_per_iteration": sum(r[1] for r in rows) / profiled,
         "busy_share": dev_us / 1e6 / wall,
         "kernels_us_per_launch": {r[0]: r[2] / r[1] for r in rows[:4]},
         "kernel_launches_per_iteration": {r[0]: r[1] / profiled
                                           for r in rows[:4]}}
    if solves and label != "jacobi 512":
        t0 = time.perf_counter()
        r = run(p0, 200000, 1e-5)
        s.update(solve_s=time.perf_counter() - t0, iters=r.iters)
    print(f"== {label}: {json.dumps(s)}  [{card}]", flush=True)
    for key, cnt, t in rows[:6]:
        print(f"   {key:70s} n={cnt:6d} total {t / 1e3:9.3f} ms  "
              f"per call {t / cnt:8.2f} us", flush=True)
    return s


def tiles(card):
    """Device us a K4 launch and an iteration at several tile settings."""
    from cubez_tpu_torch.cuda_kernels import sweeps as k4
    from cubez_tpu_torch.solvers.driver import fixed_sweeps

    keep = (k4.REGION_ROWS, k4.MIN_KCHUNK, k4.tile_plan)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    # (region rows, at most csrc/sweeps.cu kRegionRows; least k chunk; k
    # chunks a tile, None for tile_plan's own choice); the default first
    settings = ((32, 4, None), (32, 2, None), (32, 8, None), (16, 4, None),
                (24, 4, None))
    chunks = tuple((32, 4, nkc) for nkc in (1, 2, 3, 4, 6, 8, 9, 13, 16, 24))

    def forced(nkc):
        """tile_plan with ``nkc`` k chunks a tile (through the slots it is
        handed once the card's are known)."""
        def plan(kind, shape, n=1, itemsize=4, slots=None, sms=132):
            p = keep[2](kind, shape, n, itemsize, slots=slots, sms=sms)
            if slots is None:
                return p
            return keep[2](kind, shape, n, itemsize,
                           slots=nkc * p.tiles_i * p.tiles_j)
        return plan

    for size in (128, 512):
        for kind, single, maf in (("jacobi", True, False),
                                  ("jacobi", False, False),
                                  ("jacobi", False, True),
                                  ("sor2sma", False, False)):
            shape = (size, size - 1, size) if kind == "sor2sma" else (size,) * 3
            mc = (Problem.poisson_cube(size, device="cuda", maf=True).mc
                  if maf else None)
            iters = 96 if size == 128 else 24
            for rows, kc, nkc in settings + (chunks if size == 512 else ()):
                k4.REGION_ROWS, k4.MIN_KCHUNK = rows, kc
                k4.tile_plan = keep[2] if nkc is None else forced(nkc)
                step = k4.make_fused_sweep(kind, shape, omega=0.8,
                                           b_is_zero=True, mc=mc)
                step = step.single if single else step
                n = step.iters_per_call
                label = (f"K4 {kind}{' MAF' if maf else ''} n={n} {size}^3 "
                         f"rows {rows} min_kchunk {kc}"
                         + ("" if nkc is None else f" k chunks {nkc}"))
                try:
                    x = step.pad(torch.rand(shape, device="cuda", generator=gen))
                    fixed_sweeps(step, x, None, 8)
                except (RuntimeError, ValueError) as e:
                    print(f"{label}: {e}")
                    continue
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=ACTS) as prof:
                    fixed_sweeps(step, x, None, iters)
                    torch.cuda.synchronize()
                rows_ = [r for r in device_rows(prof) if "tile_kernel" in r[0]]
                us = sum(r[2] for r in rows_) / sum(r[1] for r in rows_)
                out[label] = {"launch_us": us, "iteration_us": us / n}
                print(f"{label}: {us:.2f} us a launch, {us / n:.2f} us an "
                      f"iteration [{card}]", flush=True)
                del step, x
            k4.REGION_ROWS, k4.MIN_KCHUNK, k4.tile_plan = keep
    # co-resident CTAs of each kernel (kind, n, MAF, aligned rows, shared
    # memory bytes, dtype, device) on the card
    out["slots"] = {str(k): v for k, v in k4._MAX_BLOCKS.items()}
    print("K4 co-resident CTAs:", out["slots"], flush=True)
    return out


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    names = [a for a in argv if not a.startswith("--")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.load()
    out = {"card": card, "tree": str(Path(__file__).resolve().parent.parent)}
    if "--tiles" in argv:
        out["tiles"] = tiles(card)
    for label, solver, omega, n, div, counts in PATHS:
        if names and not any(label.startswith(nm) for nm in names):
            continue
        out[label] = profile_path(card, label, solver, omega, n, div, counts,
                                  "--solves" in argv)
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
