#!/usr/bin/env python3
"""Profile the packed red-black paths (K1, K2 and K3) on one NVIDIA GPU,
float32: per iteration the wall, the device time, the device launches, the
busy share and the kernels' device microseconds a launch; with
``--solves``, one whole solve each.

    python3 tools/prof_rbpack.py [--solves] [--depths] [--single] [--sass]
                                 [--out DIR] [path ...]

Paths (their labels; names on the command line keep only those):
``sor2sma 128``, ``sor2sma 512``, ``sor2sma_maf 128`` and ``sor2sma_maf
512``: the zero-b window chain (K3; MAF, the MAF chain) at the depth and
in the form the dispatch takes, at omega 1.5.

Each path solves with eps 0 from distinct seeded random starts, so that it
takes exactly itr_max iterations through run_iterative as a solve does:
the wall of a short and a long run, twice each in turns (short, long, long,
short), gives the wall an iteration (long minus short, the least of each);
one more run under ``torch.profiler`` gives the device time, the device's
own events and the busy share an iteration, and the device microseconds a
launch of each kernel.  ``--solves`` times one solve from the problem's
start to eps 1e-5.  Only the public entry points are used, so a copy of the
script in another checkout measures that checkout (the parent against the
change in one call).

``--depths`` (this tree only) times ``rb_sweeps_n``'s launches with CUDA
events over back-to-back calls: at 128^3 and 512^3 both forms, n = 2, 3,
4, 6, constant and MAF with a zero b and the MAF pair with b (K2), and the
tile form also at forced region rows; at the sizes between (``SIZES``),
either side of the plan's switch, and in float64 (``SIZES_F64``), the
zero-b chain's two forms at their depths.  It prints device microseconds
a launch and an iteration beside the plan.  This is what chooses the forms'
depths and the plan.  ``--single`` times K1, the single iteration the
driver's exact-stop replays run (``make_packed_sweep``'s step, one call an
iteration, as the replay calls it), at 128^3, 256^3 and 512^3, float32 and
float64, constant and MAF, with a zero and a streamed b: microseconds a
call by CUDA events over back-to-back calls (host cost included), and
under ``torch.profiler`` the device microseconds and device launches a
call and the busy share; in a tree with K1's two forms, each form forced
(``rbpack._force_plan``), which is what sets ``SINGLE_TILE_BYTES``.  It
uses only the step's public builder, so a copy in another checkout (whose
single sweep is two colour launches) measures that checkout.  ``--sass``
counts the instructions of each K1/K2/K3
kernel in the built library (``cuobjdump -sass``), and of the hot loop an
update in the constant-coefficient forms (in a copy in another checkout,
that checkout's kernels).

It prints the card's name and power limit, one line a measurement, and the
paths' summaries as one JSON object on the last line.  With ``--out DIR``
it also keeps the lines in ``DIR/prof_rbpack.log``, every summary in
``DIR/prof_rbpack.json`` and the kernels' SASS in
``DIR/sass_rbpack.txt``.
"""

from __future__ import annotations

import dataclasses
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
from cubez_tpu_torch import Problem, solve  # noqa: E402
from cubez_tpu_torch.cuda_kernels import _build  # noqa: E402

OUT = None  # --out: where the log, the summaries and the SASS go
ACTS = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
SEED = 20261018
OMEGA = 1.5
# (label, solver, size, iterations: short, long, profiled; multiples of
# every step's chunk: 16, 18 for n = 6 or 3, 20 for n = 4 or 5)
PATHS = (
    ("sor2sma 128", "sor2sma", 128, (720, 2880, 720)),
    ("sor2sma_maf 128", "sor2sma_maf", 128, (720, 2880, 720)),
    ("sor2sma 512", "sor2sma", 512, (180, 540, 180)),
    ("sor2sma_maf 512", "sor2sma_maf", 512, (180, 540, 180)),
)
# --depths: the sizes (N^3) in float32 and in float64
SIZES = (128, 160, 192, 224, 256, 288, 320, 384, 448, 512)
SIZES_F64 = (128, 160, 192, 256, 320)


def say(msg):
    """Print a line, and keep it in OUT/prof_rbpack.log with --out."""
    print(msg, flush=True)
    if OUT is not None:
        with open(OUT / "prof_rbpack.log", "a") as f:
            f.write(msg + "\n")


def device_rows(prof):
    """(name, calls, device us) of the device's own events (kernels and
    copies), largest first."""
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


def profile_path(card, label, solver, n, counts, solves):
    short, long, profiled = counts
    shape = (n, n, n)
    p0 = Problem.poisson_cube(shape, device="cuda", maf=solver.endswith("_maf"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def run(p, itr_max, eps=0.0):
        r = solve(p, solver, omega=OMEGA, itr_max=itr_max, eps=eps)
        torch.cuda.synchronize()
        return r

    def start():
        x = p0.x0 + torch.rand(shape, device="cuda", generator=gen) * p0.msk
        return dataclasses.replace(p0, x0=x)

    run(start(), 36)  # warm-up
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
    if solves:
        t0 = time.perf_counter()
        r = run(p0, 200000, 1e-5)
        s.update(solve_s=time.perf_counter() - t0, iters=r.iters)
    say(f"== {label}: {json.dumps(s)}  [{card}]")
    for key, cnt, t in rows[:6]:
        say(f"   {key:70s} n={cnt:6d} total {t / 1e3:9.3f} ms  "
            f"per call {t / cnt:8.2f} us")
    return s


def events_us(fn, reps):
    """Device microseconds a call over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / reps * 1e3


def depths(card):
    """Device us a launch of rb_sweeps_n over forms, depths and plans."""
    from cubez_tpu_torch.cuda_kernels import rbpack as rb

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, f64 = torch.float32, torch.float64
    for dtype, size in [(f32, n) for n in SIZES] + [(f64, n) for n in SIZES_F64]:
        shape = (size,) * 3
        x, b = (rb.pack_rb(torch.rand(shape, device="cuda", generator=gen,
                                      dtype=dtype) * 2 - 1) for _ in range(2))
        res = torch.empty_like(x)
        tab = rb.maf_tables(Problem.poisson_cube(size, dtype=dtype, device="cuda",
                                                 maf=True).mc, shape, dtype)
        reps = max(3, 20 * 128**3 // size**3)
        ends = dtype == f32 and size in (128, 512)
        # (label, MAF tables, b, depths)
        kinds = (("const b=0", None, None, (2, 3, 4, 6) if ends else (2, 6)),
                 ("MAF b=0", tab, None, (2, 3, 4, 6) if ends else (2, 6)))
        kinds += (("MAF b", tab, b, (2,)),) if ends else ()
        settings = [("rows", None), ("tile", None)]
        settings += [("tile", 16)] if ends else []
        for label, t, bb, ns in kinds:
            for n in ns:
                # the tile form is built for n = TILE_N only
                for form, rows in [s for s in settings
                                   if s[0] == "rows" or n == rb.TILE_N]:
                    name = (f"{size}^3{' f64' if dtype == f64 else ''} "
                            f"{label} n={n} {form}"
                            + ("" if form == "rows" else f" rows={rows or 'max'}"))
                    # the plan forced through rbpack's hook for the launch
                    # that makes it (the first)
                    rb._force_plan = dict(form=form, rows=rows)
                    try:
                        launch = rb.RbSweeps(n, OMEGA, 0, t)
                        us = events_us(lambda: launch(x, bb, res), reps)
                    except (ValueError, RuntimeError) as e:
                        say(f"{name}: {e}")
                        continue
                    finally:
                        rb._force_plan = {}
                    out[name] = {"launch_us": us, "iteration_us": us / n,
                                 "grid": launch.grid,
                                 "plan": dataclasses.asdict(launch.plan)}
                    say(f"{name}: {us:.1f} us a launch, {us / n:.2f} us an "
                        f"iteration, grid {launch.grid}, plan "
                        f"{launch.plan} [{card}]")
        del x, b, res, tab
        torch.cuda.empty_cache()
    return out


def single(card):
    """K1's iteration: make_packed_sweep's step, by size, dtype, MAF, b and
    form; microseconds a call by events, device time, launches and busy
    share a call under the profiler."""
    from cubez_tpu_torch.cuda_kernels import rbpack as rb

    forms = rb.FORMS if hasattr(rb, "rb_single") else (None,)
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for size, reps, prof_n in ((128, 200, 50), (256, 50, 20), (512, 10, 5)):
        for dtype in (torch.float32, torch.float64):
            shape = (size,) * 3
            x, b = (rb.pack_rb(torch.rand(shape, device="cuda", generator=gen,
                                          dtype=dtype) * 2 - 1) for _ in range(2))
            mc = Problem.poisson_cube(size, dtype=dtype, device="cuda",
                                      maf=True).mc
            for maf in (False, True):
                for with_b in (False, True):
                    for form in forms:
                        name = (f"single {size}^3 "
                                f"{'f64' if dtype == torch.float64 else 'f32'}"
                                f"{' MAF' if maf else ''} b={'b' if with_b else '0'}"
                                + ("" if form is None else f" {form}"))
                        rb._force_plan = {} if form is None else {"form": form}
                        try:
                            step = rb.make_packed_sweep(
                                shape, dtype, omega=OMEGA, b_is_zero=not with_b,
                                mc=mc if maf else None)
                            held = [x.clone()]

                            def call(step=step, held=held):
                                held[0], _ = step(held[0], b)
                            call()  # the plan is made at the first call
                        finally:
                            rb._force_plan = {}
                        us = events_us(call, reps)
                        with torch.profiler.profile(activities=ACTS) as prof:
                            t0 = time.perf_counter()
                            for _ in range(prof_n):
                                call()
                            torch.cuda.synchronize()
                            wall = time.perf_counter() - t0
                        rows = device_rows(prof)
                        dev_us = sum(r[2] for r in rows)
                        launcher = getattr(step, "launcher", None)
                        s = {"call_us": us, "device_us_per_call": dev_us / prof_n,
                             "device_launches_per_call":
                                 sum(r[1] for r in rows) / prof_n,
                             "busy_share": dev_us / 1e6 / wall,
                             "kernels_us_per_launch":
                                 {r[0]: r[2] / r[1] for r in rows[:2]},
                             "form": (launcher.plan.form if launcher is not None
                                      else "two colour launches")}
                        out[name] = s
                        say(f"{name}: {json.dumps(s)} [{card}]")
                        del step, held
            del x, b, mc
            torch.cuda.empty_cache()
    return out


def sass(card):
    """Instructions of each K2/K3 kernel's SASS in the built library, and
    of its constant-coefficient float32 forms an update: the smallest loop
    (a backward branch and its target) holding the update's fma by 1/6,
    over the number of those fmas in it (the updates one pass of the loop
    makes; a static count)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = next(_build.BUILD_DIR.glob("libcz_*.so"))
    dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    keep, funcs, name = [], {}, None
    for ln in dump.splitlines():
        m = re.match(r"\s+Function : (\S+)", ln)
        if m:
            name = m.group(1) if re.search(
                r"\d(rb_(row_|tile_)?sweeps|rb_color)_kernel", m.group(1)) else None
            if name:
                funcs[name] = []
        if name:
            keep.append(ln)
            ins = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if ins:
                funcs[name].append((int(ins.group(1), 16), ins.group(2)))
    if OUT is not None:
        (OUT / "sass_rbpack.txt").write_text("\n".join(keep))
    out = {}
    for fn, ins in funcs.items():
        at = {addr: i for i, (addr, _) in enumerate(ins)}
        upd = [i for i, (_, op) in enumerate(ins)
               if "FFMA" in op and "0.16666667" in op]
        loops = []
        for i, (_, op) in enumerate(ins):
            m = re.search(r"BRA (0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) in at and at[int(m.group(1), 16)] < i:
                lo = at[int(m.group(1), 16)]
                hits = sum(lo <= u <= i for u in upd)
                if hits:
                    loops.append((i - lo + 1, hits))
        per = min(loops)[0] / min(loops)[1] if loops else None
        out[fn] = {"instructions": len(ins), "per_update": per}
        say(f"sass {len(ins):6d} instructions"
            + (f", {per:.1f} an update (hot loop)" if per else "") + f"  {fn}")
    return out


def main(argv):
    global OUT
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    if "--out" in argv:
        at = argv.index("--out")
        OUT = Path(argv[at + 1]).resolve()
        OUT.mkdir(parents=True, exist_ok=True)
        argv = argv[:at] + argv[at + 2:]
    names = [a for a in argv if not a.startswith("--")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say(card)
    _build.load()
    out = {"card": card, "tree": str(ROOT)}
    if "--sass" in argv:
        out["sass"] = sass(card)
    if "--depths" in argv:
        out["depths"] = depths(card)
    if "--single" in argv:
        out["single"] = single(card)
    for label, solver, n, counts in PATHS:
        if names and not any(label.startswith(nm) for nm in names):
            continue
        if ("--depths" in argv or "--single" in argv) and not names:
            continue
        out[label] = profile_path(card, label, solver, n, counts,
                                  "--solves" in argv)
        torch.cuda.empty_cache()
    if OUT is not None:
        (OUT / "prof_rbpack.json").write_text(json.dumps(out))
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("depths", "sass", "single")}))


if __name__ == "__main__":
    main(sys.argv[1:])
