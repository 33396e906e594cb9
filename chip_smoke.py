#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cubez_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports only the port, builds its CUDA kernels from ``cubez_tpu_torch/
csrc``, and raises (exit code != 0, no result line) on any failure:

1. prints the card's name and power limit (nvidia-smi);
2. builds the kernels and prints the build time;
3. holds every kernel against its plain PyTorch twin on the card at 128^3,
   124^3 and a ragged (37, 22, 45) (K, I, J): the single sweep with zero and
   seeded b, the pair with b, n = 3, 4, 6, offsets 0 and 1; float32 fields
   bitwise equal, float64 within 1e-14, residuals to rtol 1e-5;
4. the main path, ``solve(Problem.poisson_cube(128, device="cuda"),
   "sor2sma", omega=1.5, itr_max=10000)``, with the kernels' launch counts
   zeroed just before: 1777-1849 iterations (the f32 oracle's 1813 +-2%),
   history to rtol 1e-3, every kernel launched, and the same Error max as a
   plain-twin solve on the card (1e-5);
5. float64 at 128^3: the f64 oracle's count +-1%, history to rtol 1e-6;
6. float32 at 512^3: within 2% of the f64 oracle's 5781 iterations;
7. the CLI in a subprocess, ``124 124 124 sor2sma 10000 1.5``;
8. times the kernel path and the plain path at 128^3 and 512^3 (CUDA
   events, distinct random starts, long-minus-short differencing).

The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HIST = ROOT / "tests" / "ref_histories"
OMEGA = 1.5
SEED = 20261016


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def load_history(name):
    rows = (HIST / name).read_text().splitlines()[1:]
    return [float(r.split(",")[1]) for r in rows]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    from cubez_tpu_torch import Grid, Problem, max_error_loc, solve
    from cubez_tpu_torch.cuda_kernels import _build
    from cubez_tpu_torch.cuda_kernels import rbpack as rb
    from cubez_tpu_torch.solvers.driver import fixed_sweeps
    from cubez_tpu_torch.solvers.fused_cache import get_fused_step

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    # ---- 1. the card ------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    tag = f"[{card}]"

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load(rebuild=True)
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            print("  " + ln.strip())

    # ---- 3. kernels vs plain twins ------------------------------------------
    gen = torch.Generator().manual_seed(SEED)

    def rand(shape, dtype):
        return (torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1).to(dtype)

    err = {"rb_color": 0.0, "rb_sweeps_n": 0.0}
    cases = [
        ("single b=0", "rb_color",
         lambda sh, dt, off, pl: rb.make_packed_sweep(
             sh, dt, omega=OMEGA, offset=off, b_is_zero=True, plain=pl)),
        ("single b", "rb_color",
         lambda sh, dt, off, pl: rb.make_packed_sweep(
             sh, dt, omega=OMEGA, offset=off, b_is_zero=False, plain=pl)),
        ("pair b", "rb_sweeps_n",
         lambda sh, dt, off, pl: rb.make_packed_sweep2x(
             sh, dt, omega=OMEGA, offset=off, b_is_zero=False, plain=pl)),
    ] + [
        (f"n={n}", "rb_sweeps_n",
         lambda sh, dt, off, pl, n=n: rb.make_packed_sweepnx(
             sh, dt, omega=OMEGA, n=n, offset=off, plain=pl))
        for n in (3, 4, 6)
    ]
    n_cmp = 0
    for shape in ((128, 128, 128), (124, 124, 124), (37, 22, 45)):
        for dtype in (torch.float32, torch.float64):
            tol = 0.0 if dtype == torch.float32 else 1e-14
            for offset in (0, 1):
                x0 = rb.pack_rb(rand(shape, dtype), offset).to(dev)
                b0 = rb.pack_rb(rand(shape, dtype), offset).to(dev)
                for label, kern, build in cases:
                    ks = build(shape, dtype, offset, False)
                    ps = build(shape, dtype, offset, True)
                    xk, xp = x0.clone(), x0.clone()
                    for _ in range(2):
                        xk, rk = ks(xk, b0)
                        xp, rp = ps(xp, b0)
                    sync()
                    e = float((xk - xp).abs().max())
                    err[kern] = max(err[kern], e)
                    rel = float(((rk - rp).abs() / rp.abs()).max())
                    where = f"{label} {shape} {dtype} offset={offset}"
                    check(torch.isfinite(xk).all(), f"non-finite field: {where}")
                    check(e <= tol, f"field differs by {e}: {where}")
                    check(rel <= 1e-5, f"residual differs by rtol {rel}: {where}")
                    n_cmp += 1
    print(f"kernels vs plain twins: {n_cmp} comparisons passed; "
          f"max |field diff| rb_color {err['rb_color']:.3e}, "
          f"rb_sweeps_n {err['rb_sweeps_n']:.3e} (f32 bitwise, f64 <= 1e-14)",
          flush=True)

    # ---- 4. the main path ------------------------------------------------------
    prob = Problem.poisson_cube(128, dtype=torch.float32, device="cuda")
    sync()
    rb.rb_color.launches = 0
    rb.rb_sweeps_n.launches = 0
    t0 = time.perf_counter()
    res = solve(prob, "sor2sma", omega=OMEGA, itr_max=10000)
    sync()
    wall = time.perf_counter() - t0
    launches = {"rb_color": rb.rb_color.launches,
                "rb_sweeps_n": rb.rb_sweeps_n.launches}
    ref = load_history("f32_sor2sma_128_w1.5.txt")
    check(res.x.shape == (128, 128, 128) and bool(torch.isfinite(res.x).all()),
          "main path: field of the wrong shape or not finite")
    check(1777 <= res.iters <= 1849, f"main path: {res.iters} iterations")
    m = min(res.iters, len(ref)) - 1
    hist = res.history.cpu().tolist()
    worst = max(abs(h / r - 1) for h, r in zip(hist[:m], ref[:m]))
    check(worst <= 1e-3, f"main path: history off the f32 oracle by rtol {worst}")
    for k, v in launches.items():
        check(v > 0, f"main path: {k} was not launched")
    err_k, loc_k = max_error_loc(prob.grid, res.x)
    res_p = solve(prob, "sor2sma", omega=OMEGA, itr_max=10000, impl="plain")
    err_p, loc_p = max_error_loc(prob.grid, res_p.x)
    check(res_p.iters == res.iters, f"plain solve: {res_p.iters} iterations")
    check(abs(err_k - err_p) <= 1e-5, f"Error max {err_k} vs plain {err_p}")
    print(f"main path 128^3 f32: {res.iters} iterations (f32 oracle "
          f"{len(ref)}), res {res.res:e}, history rtol {worst:.2e}, "
          f"wall {wall:.3f} s, launches {launches}, Error max {err_k:e} at "
          f"{loc_k} (plain twin: {err_p:e} at {loc_p}) {tag}", flush=True)

    # ---- 5. float64 at 128^3 -------------------------------------------------
    prob64 = Problem.poisson_cube(128, dtype=torch.float64, device="cuda")
    res64 = solve(prob64, "sor2sma", omega=OMEGA, itr_max=10000)
    ref64 = load_history("f64_sor2sma_128_w1.5.txt")
    check(abs(res64.iters - len(ref64)) <= len(ref64) // 100,
          f"f64 128^3: {res64.iters} vs oracle {len(ref64)}")
    m = min(res64.iters, len(ref64))
    h64 = res64.history.cpu().tolist()
    worst64 = max(abs(h / r - 1) for h, r in zip(h64[:m], ref64[:m]))
    check(worst64 <= 1e-6, f"f64 128^3: history rtol {worst64}")
    print(f"f64 128^3: {res64.iters} iterations (f64 oracle {len(ref64)}), "
          f"history rtol {worst64:.2e}", flush=True)
    del prob64, res64

    # ---- 6. float32 at 512^3 ---------------------------------------------------
    prob512 = Problem.poisson_cube(512, dtype=torch.float32, device="cuda")
    sync()
    t0 = time.perf_counter()
    res512 = solve(prob512, "sor2sma", omega=OMEGA, itr_max=20000)
    sync()
    wall512 = time.perf_counter() - t0
    check(bool(torch.isfinite(res512.x).all()), "512^3: field not finite")
    check(abs(res512.iters - 5781) <= 5781 * 2 // 100,
          f"512^3: {res512.iters} iterations vs the f64 oracle's 5781")
    print(f"512^3 f32: {res512.iters} iterations (f64 oracle 5781), "
          f"res {res512.res:e}, wall {wall512:.3f} s {tag}", flush=True)
    del prob512, res512

    # ---- 7. the CLI ------------------------------------------------------------
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    with tempfile.TemporaryDirectory() as tmp:
        cli = subprocess.run(
            [sys.executable, "-m", "cubez_tpu_torch.cli", "124", "124", "124",
             "sor2sma", "10000", "1.5"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300,
        )
        check(cli.returncode == 0, f"CLI exited {cli.returncode}:\n{cli.stderr}")
        hist_file = Path(tmp) / "sor2sma.txt"
        check(hist_file.exists(), "CLI wrote no sor2sma.txt")
        check(hist_file.read_text().startswith("Itration      Residual\n"),
              "CLI history header")
        check("Error max" in cli.stdout, "CLI printed no Error max")
    for ln in cli.stdout.splitlines():
        if ln.startswith(("Iter =", "wall =", "Error max")):
            print(f"CLI 124^3: {ln.strip()}")

    # ---- 8. timing ------------------------------------------------------------
    def events_ms(fn, reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    dgen = torch.Generator(device=dev).manual_seed(SEED)

    def per_iter_ms(step, shape, short, long, reps=3):
        """Long-minus-short ms per iteration over distinct random starts."""
        starts = [rb.pack_rb(torch.rand(shape, device=dev, generator=dgen))
                  for _ in range(reps + 1)]
        fixed_sweeps(step, starts[-1], None, short)  # warm-up
        med = {}
        for count in (short, long, long, short):
            ts = []
            for s in starts[:reps]:
                x = s.clone()
                ts.append(events_ms(lambda: fixed_sweeps(step, x, None, count), 1))
            med.setdefault(count, []).append(statistics.median(ts))
        return (min(med[long]) - min(med[short])) / (long - short)

    timing = {}
    for n, (ks, kl), (ps, pl) in ((128, (60, 600), (6, 36)),
                                  (512, (12, 72), (6, 18))):
        g = Grid(n, n, n, torch.float32, dev)
        for impl, (short, long) in (("kernel", (ks, kl)), ("plain", (ps, pl))):
            step = get_fused_step("sor2sma", g, OMEGA, plain=impl == "plain",
                                  b_is_zero=True)
            ms = per_iter_ms(step, g.shape_kij, short, long)
            check(ms > 0, f"timing {impl} {n}^3: non-positive difference")
            timing[(impl, n)] = ms
            print(f"timing sor2sma {n}^3 f32 {impl} path (n={step.iters_per_call}"
                  f" per call): {ms * 1e3:.3f} us/iteration, "
                  f"{g.num_inner / (ms * 1e-3) / 1e6:.1f} Mcell-updates/s {tag}",
                  flush=True)
        del g

    # per-call kernel times at the main path's shape (128^3 f32), each
    # against its plain twin, in turns: plain, kernel, kernel, plain
    xs = rb.pack_rb(rand((128, 128, 128), torch.float32)).to(dev)
    calls = {
        "rb_color": (lambda: rb.rb_color(xs, None, 0, OMEGA),
                     lambda: rb.rb_color_plain(xs, None, 0, OMEGA)),
        "rb_sweeps_n": (lambda: rb.rb_sweeps_n(xs, None, 6, OMEGA),
                        lambda: rb.packed_sweeps_plain(xs, None, 6, OMEGA)),
    }
    per_call = {}
    for name, (kfn, pfn) in calls.items():
        kfn(), pfn()
        sync()
        p1 = events_ms(pfn, 5)
        k1 = events_ms(kfn, 50)
        k2 = events_ms(kfn, 50)
        p2 = events_ms(pfn, 5)
        per_call[name] = (min(k1, k2), min(p1, p2))
        print(f"per call at 128^3 f32: {name} {per_call[name][0]:.4f} ms, "
              f"plain twin {per_call[name][1]:.4f} ms {tag}")
    check(bool(torch.isfinite(xs).all()), "timing field not finite")

    source = "cubez_tpu_torch/csrc/rbpack.cu"
    replaces = {"rb_color": "cubez_tpu/pallas_kernels/rbpack.py:732",
                "rb_sweeps_n": "cubez_tpu/pallas_kernels/sweeps2x.py:480"}
    kernels = [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": per_call[name][0],
         "plain_ms": per_call[name][1]}
        for name in ("rb_color", "rb_sweeps_n")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
