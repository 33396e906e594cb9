#!/usr/bin/env python3
"""Profile the port's distributed solves (solve_dist) at 128^3 float32 on
one NVIDIA GPU, the blocks of the mesh all on that card: per iteration the
wall, the device time, the device launches and the busy share.

    python3 tools/prof_dist.py [--solves] [--tiles] [--k9 [--lines L ...]]
        [--big] [--no-paths] [solver ...]

Over a (2, 2, 2) mesh of eight blocks: sor2sma pack (K7), sor2sma_maf
pack (K7-MAF), sor2sma 'color', 'iter' and 'overlap' (K8), jacobi at
omega 0.8 (K8), and the line solvers pcr_rb and pcr_rb_maf at omega 1.5
and pcr_j_esa at 1.0 (K9's 'pcr' form); over (1, 2, 2) the same three line
solvers (K9's 'fastdiag' form).  Solver names on the command line keep
only those paths.

Each path runs solve_dist with eps 0, so that it takes exactly itr_max
iterations through run_iterative as a solve does (chunks, history,
snapshot):
the wall of 144 and of 720 iterations, twice each, gives the wall an
iteration (long minus short, the least of each), and one run of 288 under
``torch.profiler`` the device time, the device's own events (kernels,
copies) and the busy share (device time over that run's wall) an
iteration.  ``--solves`` also times one whole solve to eps 1e-5.  It
prints the card's name and power limit, one summary line and the top
device rows per path, and the summaries as one JSON object on the last
line.  The script imports the package from the tree it sits in, so a copy
of it in another checkout measures that checkout.

``--tiles`` first times K8's one launch over the eight blocks of 128^3 and
of 512^3 over (2, 2, 2) (a colour pass and the Jacobi pass) at several
CTAs per SM (dist_sweeps.CTAS_PER_SM, which sets the k-chunk a thread
walks): device microseconds a launch under the profiler.

``--k9`` times K9's one launch over all the blocks of a mesh, colour 0
and the line-Jacobi pass, constant and MAF, zero b: 'pcr' over the eight
blocks of 128^3 and of 512^3 (2, 2, 2) and the four of 128^3 (1, 2, 2),
'fastdiag' over those four; ms a call by CUDA events (the least of two
runs of back-to-back calls) and device us a launch under the profiler.
``--lines L ...`` repeats the constant 'pcr' rows with L lines a CTA
(``dist_pcr.tab_lines`` patched to return L; a tree that has it).  ``--big`` adds the line
solvers over (2, 2, 2) at 512^3 to the paths (32 and 160 iterations, 64
profiled); ``--no-paths`` leaves out the paths.  These use only entry
points the parent trees share, so a copy of this script in another
checkout measures that checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from cubez_tpu_torch import Problem, make_mesh, solve_dist  # noqa: E402
from cubez_tpu_torch.cuda_kernels import _build  # noqa: E402

N = 128
# multiples of run_iterative's chunks (16 iterations; 18 for the pack step's
# n = 6 calls), so that each run takes exactly this many iterations
SHORT, LONG, PROFILED = 144, 720, 288
# (solver, omega, sync, mesh division)
SOLVES = tuple((n, w, s, (2, 2, 2)) for n, w, s in (
    ("sor2sma", 1.5, "pack"), ("sor2sma_maf", 1.5, "pack"),
    ("sor2sma", 1.5, "color"), ("sor2sma", 1.5, "iter"),
    ("sor2sma", 1.5, "overlap"), ("jacobi", 0.8, "auto"))) + tuple(
    (n, w, "auto", div) for div in ((2, 2, 2), (1, 2, 2))
    for n, w in (("pcr_rb", 1.5), ("pcr_rb_maf", 1.5), ("pcr_j_esa", 1.0)))


def device_rows(prof):
    """(name, calls, device us) of the device's own events (kernels and
    copies), largest first; the host ops that launched them also carry
    their device time, and the solver labels are mirrored on the card as
    user annotations whose ranges span the kernels, so both are left out,
    not to count that time twice."""
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        if t > 0:
            rows.append((ev.key[:70], ev.count, t))
    if not rows:
        raise SystemExit("the profiler recorded no device time")
    return sorted(rows, key=lambda row: -row[2])


def k8_tiles(card):
    """Device us a K8 launch over all eight blocks at several CTAs per SM."""
    from cubez_tpu_torch.cuda_kernels import dist_halo
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    acts = [torch.profiler.ProfilerActivity.CUDA]
    keep = k8.CTAS_PER_SM
    out = {}
    for n in (128, 512):
        cm = make_mesh((n, n, n), devices=["cuda:0"] * 8, div=(2, 2, 2))
        bs = cm.block_shape((n, n, n))
        xs = [torch.rand(k8.block_layout(bs), device="cuda") for _ in range(8)]
        outs = [torch.empty_like(x) for x in xs]
        res = dist_halo.Residual("cuda:0")
        for kind, colour in (("sor2sma", 0), ("jacobi", None)):
            for per_sm in (1, 2, 4, 8, 16):
                k8.CTAS_PER_SM = per_sm
                launch = k8.BlockSweeps(kind, colour, 1.5, cm.offsets((n, n, n)),
                                        (n, n, n))
                kchunk, grid = k8.launch_geometry(8, bs, xs[0].device)
                for _ in range(3):  # warm-up
                    res.start()
                    launch(xs, None, outs if colour is None else None, res)
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=acts) as prof:
                    for _ in range(20):
                        res.start()
                        launch(xs, None, outs if colour is None else None, res)
                    torch.cuda.synchronize()
                us = [r[2] / r[1] for r in device_rows(prof) if "sweep" in r[0]]
                label = f"K8 {kind} {n}^3 (2, 2, 2) CTAs/SM {per_sm}"
                out[label] = {"kchunk": kchunk, "ctas": grid, "device_us": us[0]}
                print(f"{label}: k-chunk {kchunk}, {grid} CTAs, {us[0]:.2f} us "
                      f"a launch [{card}]", flush=True)
        del xs, outs
    k8.CTAS_PER_SM = keep
    return out


def k9_launches(card, lines=()):
    """ms a call (events) and device us a launch (profiler) of K9's launch
    over all the blocks of a mesh, f32, zero b."""
    from cubez_tpu_torch.cuda_kernels import dist_halo
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9

    acts = [torch.profiler.ProfilerActivity.CUDA]
    out = {}
    cases = [(128, (2, 2, 2), "pcr", None), (128, (1, 2, 2), "pcr", None),
             (128, (1, 2, 2), "fastdiag", None), (512, (2, 2, 2), "pcr", None)]
    cases += [(n, div, "pcr", L) for L in lines
              for n, div in ((128, (2, 2, 2)), (512, (2, 2, 2)))]
    for n, div, form, L in cases:
        gsz = (n,) * 3
        cm = make_mesh(gsz, devices=["cuda:0"] * (div[0] * div[1] * div[2]), div=div)
        bs, orgs = cm.block_shape(gsz), cm.offsets(gsz)
        gen = torch.Generator(device="cuda").manual_seed(5)
        xs = [torch.rand(tuple(v + 2 for v in bs), device="cuda", generator=gen)
              for _ in orgs]
        outs = [torch.empty_like(x) for x in xs]
        mc = Problem.poisson_cube(n, device="cuda", maf=True).mc
        res = dist_halo.Residual("cuda:0")
        for maf in ((False,) if L else (False, True)):
            tabs = None
            if maf:
                tabs = [k9.block_maf_tables(mc, o, bs, gsz, torch.float32,
                                            form).to("cuda") for o in orgs]
            for colour in (0, None):
                if L:
                    keep = k9.tab_lines
                    k9.tab_lines = lambda n, dtype, L=L: L
                launch = k9.BlockPcr(form, colour, 1.5, orgs, gsz, 0, tabs)
                o = None if colour == 0 else outs

                def call():
                    res.start()
                    launch(xs, None, o, res)

                reps = 50 if n == 128 else 10
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                ms = []
                for _ in range(2):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    for _ in range(reps):
                        call()
                    e1.record()
                    e1.synchronize()
                    ms.append(e0.elapsed_time(e1) / reps)
                rows = []
                for _ in range(3):  # the profiler now and then records nothing
                    with torch.profiler.profile(activities=acts) as prof:
                        for _ in range(reps):
                            call()
                        torch.cuda.synchronize()
                    try:
                        rows = [r for r in device_rows(prof) if "block_" in r[0]]
                        break
                    except SystemExit:
                        continue
                if L:
                    k9.tab_lines = keep
                if not rows:
                    raise SystemExit("the profiler recorded no K9 launch")
                us = sum(r[2] for r in rows) / sum(r[1] for r in rows)
                name = k9.variant(form, maf)
                label = (f"K9 {name} {n}^3 {div} "
                         f"{'colour 0' if colour == 0 else 'line-Jacobi'}"
                         + (f" L {L}" if L else ""))
                out[label] = {"ms": min(ms), "device_us": us,
                              "kernel": rows[0][0]}
                print(f"{label}: {min(ms):.4f} ms a call, {us:.2f} device us a "
                      f"launch ({rows[0][0]}) [{card}]", flush=True)
        del xs, outs, mc
    return out


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    solves = "--solves" in argv
    names = [a for a in argv if not a.startswith("--") and not a.isdigit()]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.load()
    out = {"card": card, "n": N, "tree": str(Path(__file__).resolve().parent.parent)}
    if "--tiles" in argv:
        out["k8_tiles"] = k8_tiles(card)
    if "--k9" in argv:
        lines = []
        if "--lines" in argv:
            for a in argv[argv.index("--lines") + 1:]:
                if not a.isdigit():
                    break
                lines.append(int(a))
        out["k9"] = k9_launches(card, lines)
    solves_list = list(SOLVES)
    if "--big" in argv:
        solves_list += [(n, w, "auto", (2, 2, 2), 512) for n, w in (
            ("pcr_rb", 1.5), ("pcr_rb_maf", 1.5), ("pcr_j_esa", 1.0))]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for name, omega, sync, div, *size in solves_list:
        if "--no-paths" in argv or (names and name not in names):
            continue
        n = size[0] if size else N
        short, long, profiled = (SHORT, LONG, PROFILED) if n == N else (32, 160, 64)
        p = Problem.poisson_cube(n, device="cuda", maf=name.endswith("_maf"))
        cm = make_mesh((n, n, n), devices=["cuda:0"] * (div[0] * div[1] * div[2]),
                       div=div)

        def run(itr_max, eps=0.0):
            r = solve_dist(p, cm, name, omega=omega, itr_max=itr_max, eps=eps,
                           sync=sync)
            torch.cuda.synchronize()
            return r

        run(20)  # warm-up
        walls = {short: [], long: []}
        for count in (short, long, long, short):
            t0 = time.perf_counter()
            run(count)
            walls[count].append(time.perf_counter() - t0)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run(profiled)
            wall = time.perf_counter() - t0
        rows = device_rows(prof)
        dev_us = sum(row[2] for row in rows)
        s = {"wall_us_per_iteration":
                 (min(walls[long]) - min(walls[short])) / (long - short) * 1e6,
             "device_us_per_iteration": dev_us / profiled,
             "device_launches_per_iteration":
                 sum(row[1] for row in rows) / profiled,
             "busy_share": dev_us / 1e6 / wall}
        if solves:
            t0 = time.perf_counter()
            r = run(20000, 1e-5)
            s.update(solve_s=time.perf_counter() - t0, iters=r.iters)
        label = f"{name} {sync} {div}" + ("" if n == N else f" {n}^3")
        print(f"== {label}: {json.dumps(s)}  [{card}]", flush=True)
        for key, cnt, t in rows[:6]:
            print(f"   {key:70s} n={cnt:6d} total {t / 1e3:9.3f} ms  "
                  f"per call {t / cnt:8.2f} us")
        out[label] = s
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
