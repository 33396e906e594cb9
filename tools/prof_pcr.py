#!/usr/bin/env python3
"""Profile K10, the line-PCR pass (cuda_kernels/pcr.py), on one NVIDIA GPU.

    python3 tools/prof_pcr.py [--forms] [--sass] [--out DIR]

At 128^3 and 512^3, constant coefficients and MAF (float32; float64 too
at 128^3), it drives K10's entry point, ``make_fused_pcr_step`` 'pcr_rb'
(both colours) and 'pcr' (the line-Jacobi pass), for fixed sweeps and
prints for each:

- ``call_us``: microseconds a call by CUDA events over back-to-back calls
  (host cost included);
- under ``torch.profiler`` over a window of calls: device microseconds a
  call, device launches a call, device microseconds a launch of each
  kernel, and the busy share (device time over the window's wall);
- at 128^3 float32, ``sweeps60_s``: the wall of 60 fixed sweeps from the
  problem's start, chip_smoke.py's K10 path (phase 17).

Only that entry point is used, so a copy of the script in another checkout
measures that checkout (the parent against the change in one call).
``--forms`` (a tree with ``pcr._force_plan``) adds 256^3 and 512^3 with
each form forced, float32 and float64: where the line form's registers run
out, this says which form to take (``pcr.MAF_SLABS``).  ``--sass`` counts the
instructions of each K10 kernel in the built library (``cuobjdump -sass``):
in all, shuffles, barriers, shared loads and stores, global loads and
stores, and a row: the line form's in all over the M rows a lane's
unrolled solve holds (its slabs), the tile form's stage loop over its
one row a pass (static counts).

It prints the card's name and power limit, one line a measurement, and
every summary as one JSON object on the last line; with ``--out DIR`` also
``DIR/prof_pcr.json`` and the kernels' SASS in ``DIR/sass_pcr.txt``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from cubez_tpu_torch import Problem  # noqa: E402
from cubez_tpu_torch.cuda_kernels import _build  # noqa: E402
from cubez_tpu_torch.cuda_kernels import pcr as k10  # noqa: E402
from cubez_tpu_torch.solvers.driver import fixed_sweeps  # noqa: E402

ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
SEED = 20261017
OMEGA = {"pcr_rb": 1.5, "pcr": 1.0}
# (size, dtype, calls timed by events, calls under the profiler)
RUNS = ((128, torch.float32, 200, 100), (128, torch.float64, 100, 50),
        (512, torch.float32, 10, 5))
# --forms: (size, calls timed, calls profiled), each form forced, f32 and f64
FORM_RUNS = ((256, 40, 20), (512, 10, 5))


def say(msg):
    print(msg, flush=True)


def device_rows(prof):
    """(name, calls, device us) of the device's own events, largest first."""
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


def measure(card, label, size, dtype, maf, kind, reps, prof_n):
    shape = (size,) * 3
    p = Problem.poisson_cube(size, dtype=dtype, device="cuda", maf=maf)
    step = k10.make_fused_pcr_step(kind, shape, dtype, omega=OMEGA[kind],
                                   b_is_zero=True, mc=p.mc if maf else None)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = (torch.rand(shape, device="cuda", generator=gen, dtype=dtype) * 2 - 1)
    held = [x]

    def call():
        held[0], _ = step(held[0], None)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        call()
    z.record()
    torch.cuda.synchronize()
    call_us = a.elapsed_time(z) / reps * 1e3
    with torch.profiler.profile(activities=ACTS) as prof:
        t0 = time.perf_counter()
        for _ in range(prof_n):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    dev_us = sum(r[2] for r in rows)
    s = {"call_us": call_us, "device_us_per_call": dev_us / prof_n,
         "device_launches_per_call": sum(r[1] for r in rows) / prof_n,
         "busy_share": dev_us / 1e6 / wall,
         "kernels_us_per_launch": {r[0]: r[2] / r[1] for r in rows[:3]}}
    launcher = getattr(step, "launcher", None)  # the parent's steps have none
    if launcher is not None:
        s["form"] = launcher.plan.form
    if size == 128 and dtype == torch.float32:
        x0 = step.pad(p.x0)
        fixed_sweeps(step, x0, None, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fixed_sweeps(step, x0, None, 60)
        torch.cuda.synchronize()
        s["sweeps60_s"] = time.perf_counter() - t0
    say(f"== {label}: {json.dumps(s)}  [{card}]")
    return s


def sass():
    """Instruction counts of each K10 kernel in the built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = next(_build.BUILD_DIR.glob("libcz_*.so"))
    dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, keep, name = {}, [], None
    for ln in dump.splitlines():
        m = re.match(r"\s+Function : (\S+)", ln)
        if m:
            name = m.group(1) if re.search(r"(pcr_lines|fused_pcr)_kernel",
                                           m.group(1)) else None
            if name:
                funcs[name] = []
        if name:
            keep.append(ln)
            ins = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if ins:
                funcs[name].append((int(ins.group(1), 16), ins.group(2)))
    out = {}
    for fn, ins in funcs.items():
        ops = [op.split()[0] if not op.startswith("@") else op.split()[1]
               for _, op in ins]

        def n_of(*prefixes):
            return sum(any(o.startswith(p) for p in prefixes) for o in ops)

        row = None
        m = re.search(r"pcr_lines_kernelI[fd]Lb[01]ELi(\d+)E", fn)
        if m:  # the line form: its unrolled solve holds M rows a lane
            row = len(ins) / int(m.group(1))
        else:  # the tile form: the longest loop (the stage loop) per row
            at = {addr: i for i, (addr, _) in enumerate(ins)}
            loops = [i - at[int(b.group(1), 16)] + 1 for i, (_, op) in enumerate(ins)
                     for b in [re.search(r"BRA (0x[0-9a-f]+)", op)]
                     if b and int(b.group(1), 16) in at and at[int(b.group(1), 16)] < i]
            row = max(loops) if loops else None
        out[fn] = {"instructions": len(ins), "per_row": row,
                   "shfl": n_of("SHFL"), "bar": n_of("BAR"),
                   "lds": n_of("LDS"), "sts": n_of("STS"),
                   "ldg": n_of("LDG"), "stg": n_of("STG")}
        say(f"sass {json.dumps(out[fn])}  {fn}")
    return out, "\n".join(keep)


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    out_dir = None
    if "--out" in argv:
        out_dir = Path(argv[argv.index("--out") + 1]).resolve()
        out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say(card)
    _build.load()
    out = {"card": card, "tree": str(ROOT)}
    if "--sass" in argv:
        out["sass"], text = sass()
        if out_dir is not None:
            (out_dir / "sass_pcr.txt").write_text(text)
    runs = [(size, dt, reps, prof_n, None) for size, dt, reps, prof_n in RUNS]
    if "--forms" in argv and hasattr(k10, "_force_plan"):
        runs += [(size, dt, reps, prof_n, form)
                 for size, reps, prof_n in FORM_RUNS
                 for dt in (torch.float32, torch.float64)
                 for form in ("lines", "tile")]
    for size, dt, reps, prof_n, form in runs:
        for maf in (False, True):
            for kind in ("pcr_rb", "pcr"):
                label = (f"{kind} {size}^3 {'f64' if dt == torch.float64 else 'f32'}"
                         f"{' MAF' if maf else ''}"
                         + ("" if form is None else f" form={form}"))
                if form is not None:
                    k10._force_plan = {"form": form}
                try:
                    out[label] = measure(card, label, size, dt, maf, kind, reps,
                                         prof_n)
                except (ValueError, RuntimeError) as e:  # a form that does not fit
                    say(f"{label}: {e}")
                finally:
                    k10._force_plan = {}
                torch.cuda.empty_cache()
    if out_dir is not None:
        (out_dir / "prof_pcr.json").write_text(json.dumps(out))
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
