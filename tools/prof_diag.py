#!/usr/bin/env python3
"""Time the exact serial orders' kernels on the card: P1 (psor,
csrc/psor.cu) by its chunk height ``psor.ROWS`` and P2 (pcr,
csrc/pcr_gs.cu) in its two forms, ms a sweep by CUDA events over
back-to-back sweeps of one seeded field (in place), after a warm-up
sweep; each variant's field is checked bit for bit against the first
variant's (every schedule respects the serial order).

    python3 tools/prof_diag.py [--rows 8 4 2 1]

Shapes: 128^3 and 256^3 float32, 64^3 float64, constant and MAF.  Prints
the card's name and power limit first.  Needs one CUDA card; about a
minute after the kernels' build.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import cubez_tpu_torch as czt  # noqa: E402
from cubez_tpu_torch.cuda_kernels import pcr_gs as p2  # noqa: E402
from cubez_tpu_torch.cuda_kernels import psor as p1  # noqa: E402
from cubez_tpu_torch.ops import psor_scan  # noqa: E402

SHAPES = ((128, torch.float32), (64, torch.float64), (256, torch.float32))


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
    """(ms a sweep, the field after one sweep from S)."""
    once = S.clone()
    launch(once, B)
    work = once.clone()
    launch(work, B)  # warm-up
    ms = min(events_ms(lambda: launch(work, B), reps),
             events_ms(lambda: launch(work, B), reps))
    torch.cuda.synchronize()
    return ms, once


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[8, 4, 2, 1],
                    help="P1 chunk heights to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof_diag: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    rows0 = p1.ROWS
    for n, dtype in SHAPES:
        skew, _, _ = psor_scan.make_skew((n,) * 3)
        S, B = (skew(torch.rand((n,) * 3, device=dev, generator=gen, dtype=dtype)
                     * 2 - 1) for _ in range(2))
        for maf in (False, True):
            mc = (czt.Problem.poisson_cube(n, dtype=dtype, device=dev, maf=True).mc
                  if maf else None)
            label = f"{n}^3 {str(dtype)[6:]} {'MAF' if maf else 'constant'}"
            ref = None
            for rows in args.rows:
                p1.ROWS = rows
                try:
                    launch = p1.PsorSweep(1.1, mc)
                    ms, once = time_launcher(launch, S, B)
                finally:
                    p1.ROWS = rows0
                same = ref is None or torch.equal(once, ref)
                ref = once if ref is None else ref
                print(f"P1 {label} ROWS={rows} {launch.plan}: {ms:.4f} ms a sweep, "
                      f"field {'bitwise' if same else 'DIFFERS from'} the first "
                      "variant's", flush=True)
                if not same:
                    raise SystemExit("prof_diag: P1's schedules disagree")
            ref = None
            for form in (None, "tile"):
                launch = p2.PcrGsSweep(1.5, mc, form=form)
                ms, once = time_launcher(launch, S, B)
                same = ref is None or torch.equal(once, ref)
                ref = once if ref is None else ref
                print(f"P2 {label} {launch.plan.form} form, {launch.grid} CTAs: "
                      f"{ms:.4f} ms a sweep, field {'bitwise' if same else 'DIFFERS from'}"
                      " the first form's", flush=True)
                if not same:
                    raise SystemExit("prof_diag: P2's forms disagree")
        del S, B


if __name__ == "__main__":
    main()
