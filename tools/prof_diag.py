#!/usr/bin/env python3
"""Time the exact serial orders' kernels on the card: P1 (psor,
csrc/psor.cu) by chunk height ``psor.ROWS`` and sweeps a launch, and P2
(pcr, csrc/pcr_gs.cu) by line form and sweeps a launch; ms a sweep by
CUDA events over back-to-back launches on one seeded field (in place),
after a warm-up launch.  The field after one launch of n sweeps is
checked bit for bit against n one-sweep launches of the default plan.

    python3 tools/prof_diag.py [--rows 4 2 1] [--sweeps 1 2 4 8 16 32]
                               [--sizes 128 64 256]
    python3 tools/prof_diag.py --solves

``--solves`` times whole solves instead, through the public ``solve``
only (so a copy of this script in an older checkout times that
checkout): psor and pcr at 128^3 float32, the reference's omegas, the
wall of each after a warm-up solve, three times in turn.

Shapes: 128^3 and 256^3 float32, 64^3 float64, constant and MAF.  Prints
the card's name and power limit first.  Needs one CUDA card; a few
minutes after the kernels' build.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import cubez_tpu_torch as czt  # noqa: E402

SIZES = {128: torch.float32, 64: torch.float64, 256: torch.float32}


def events_ms(fn, reps):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def time_launcher(launch, S, B, reps=5):
    """(ms a launch, the field after one launch from S)."""
    once = S.clone()
    launch(once, B)
    work = once.clone()
    launch(work, B)  # warm-up
    ms = min(events_ms(lambda: launch(work, B), reps),
             events_ms(lambda: launch(work, B), reps))
    torch.cuda.synchronize()
    return ms, once


def solves(dev):
    """Walls of the 128^3 float32 psor and pcr solves, three rounds."""
    for rnd in range(3):
        for name, omega in (("psor", 1.1), ("pcr", 1.5)):
            p = czt.Problem.poisson_cube(128, device=dev)
            czt.solve(p, name, omega=omega, itr_max=20)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = czt.solve(p, name, omega=omega, itr_max=20000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"solve {name} 128^3 f32 round {rnd}: {r.iters} iterations, "
                  f"wall {wall:.4f} s ({wall / r.iters * 1e3:.4f} ms an "
                  f"iteration), res {r.res:e}", flush=True)


def kernels(dev, args):
    from cubez_tpu_torch.cuda_kernels import pcr_gs as p2
    from cubez_tpu_torch.cuda_kernels import psor as p1
    from cubez_tpu_torch.ops import psor_scan

    gen = torch.Generator(device=dev).manual_seed(7)
    rows0 = p1.ROWS
    for n in args.sizes:
        dtype = SIZES[n]
        skew, _, _ = psor_scan.make_skew((n,) * 3)
        S, B = (skew(torch.rand((n,) * 3, device=dev, generator=gen, dtype=dtype)
                     * 2 - 1) for _ in range(2))
        for maf in (False, True):
            mc = (czt.Problem.poisson_cube(n, dtype=dtype, device=dev, maf=True).mc
                  if maf else None)
            label = f"{n}^3 {str(dtype)[6:]} {'MAF' if maf else 'constant'}"
            for kname, omega in (("P1", 1.1), ("P2", 1.5)):
                one = (p1.PsorSweep(omega, mc) if kname == "P1"
                       else p2.PcrGsSweep(omega, mc))
                refs = {0: S}  # the field after k one-sweep launches

                def ref(k):
                    for m in range(max(refs), k):
                        nxt = refs[m].clone()
                        one(nxt, B)
                        refs[m + 1] = nxt
                    return refs[k]

                variants = ([(rows, None) for rows in args.rows] if kname == "P1"
                            else [(None, form) for form in (None, "tile")])
                for rows, form in variants:
                    for sweeps in args.sweeps:
                        if rows is not None:
                            p1.ROWS = rows
                        try:
                            launch = (p1.PsorSweep(omega, mc, sweeps)
                                      if kname == "P1" else
                                      p2.PcrGsSweep(omega, mc, form, sweeps))
                            ms, once = time_launcher(launch, S, B)
                        except ValueError as e:
                            print(f"{kname} {label} rows={rows} form={form} "
                                  f"n={sweeps}: {e}", flush=True)
                            continue
                        finally:
                            p1.ROWS = rows0
                        same = torch.equal(once, ref(sweeps))
                        plan = (launch.plan if kname == "P1" else
                                f"{launch.plan.form} form, {launch.grid} CTAs")
                        print(f"{kname} {label} rows={rows} n={sweeps} "
                              f"[{plan}]: {ms / sweeps:.4f} ms a sweep "
                              f"({ms:.4f} a launch), field "
                              f"{'bitwise' if same else 'DIFFERS from'} {sweeps} "
                              "one-sweep launches'", flush=True)
                        if not same:
                            raise SystemExit(f"prof_diag: {kname}'s schedules disagree")
                del refs
        del S, B


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 2, 1],
                    help="P1 chunk heights to time")
    ap.add_argument("--sweeps", type=int, nargs="+", default=[1, 2, 4, 8, 16, 32],
                    help="sweeps a launch to time")
    ap.add_argument("--sizes", type=int, nargs="+", default=list(SIZES),
                    choices=list(SIZES), help="cube sizes (128, 256: f32; 64: f64)")
    ap.add_argument("--solves", action="store_true",
                    help="time the 128^3 psor and pcr solves instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_diag: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    if args.solves:
        solves(dev)
    else:
        kernels(dev, args)


if __name__ == "__main__":
    main()
