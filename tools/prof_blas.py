#!/usr/bin/env python3
"""Profile the Krylov loop's operator and vector passes on one NVIDIA GPU.

    python3 tools/prof_blas.py [--root DIR] [--calls 50] [--spans]
                               [--host N] [--seed S] [--out DIR]

Times one application of the constant-coefficient 7-point operator, A x
(``calc_ax``) and b - A x (``calc_rk``), at 256^3 float64 (the Krylov
cell's grid) and 128^3 float32, on fields with a uniform [-1, 1) interior
and the standard mask: the kernel pass (cuda_kernels/blas.py, csrc/blas.cu)
and its plain twin (ops/blas.py, torch's eager ops), each by CUDA events
over ``--calls`` back-to-back calls after a warm-up (host cost included),
and by torch.profiler the device microseconds and device launches a call.
Beside them the byte bound: 3 fields (p and msk read, the result written;
4 with b) at the card's 3.35 TB/s.  It checks that the kernel equals the
twin bit for bit.  A checkout without the pass (``--root`` at an older
one) times the twin alone.

The same for each vector pass of the BiCGSTAB loop (bicg_1, dot2, triad,
dots_t, update_xr, and cg's axpy and dot1) at both shapes, on six fields
uniform in [-1, 1) on the inner nodes and 0-d scalars on the card: the
pass against its twin's eager ops, beside its byte bound (the fields it
reads, the mask included, and writes, over 3.35 TB/s); its maps must equal
the twin's bit for bit, and the largest relative gap of its dots to the
twin's sums is printed.  A checkout without the passes times the twins
alone.

``--spans``: one traced pbicgstab solve at 256^3 float64 (the sor2sma
preconditioner at omega 1.1, eps 1e-5, from a uniform [0, 1) interior
drawn from ``--seed``, after one warm-up solve), its device time split by
the innermost program span (perf/spans.py: ``cz.ax``, ``cz.blas``,
``cz.precon``, ``cz.fetch``, ...) that launched each device record, read
from torch.profiler's chrome trace: a record's launching runtime call
(by correlation id) lies inside the span on the host's thread.  Records
launched outside any span are ``(none)``.

``--host N``: 2 N more such solves, in turns one recorded by
``spans.recording()`` alone and one traced by torch.profiler, each from a
start of its own (the same starts in any checkout): the host's own time
by span from the program's records (``spans.solves()``), a solve's
``host_us_per_launch`` (the step calls' self time over the wrappers'
launches, as the benchmark's metric reads it) and each span's self ms an
iteration, with the medians of each mode.

It prints the card's name and power limit, one line a measurement, and
every summary as one JSON object on the last line (with ``--out DIR`` also
in ``DIR/prof_blas.json``).  Only public entry points are used, so
``--root`` at another checkout measures that checkout (the parent against
the change in one call).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

BW = 3.35e12  # H100 SXM HBM3, bytes/s (perf/pmlib.py CARDS)
SHAPES = ((256, "float64"), (128, "float32"))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except OSError:
        return None


def event_ms(fn, calls, torch):
    """ms a call of ``fn()`` by CUDA events over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def device_per_call(fn, calls, torch):
    """(device us, device records) a call of ``fn()`` under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        us += ev.self_cuda_time_total if t is None else t
        n += ev.count
    if n == 0:
        raise SystemExit("the profiler recorded no device time")
    return us / calls, n / calls


def time_operator(torch, calls, say):
    import cubez_tpu_torch as czt
    from cubez_tpu_torch.ops import blas as twin
    try:
        from cubez_tpu_torch.cuda_kernels import blas as kernel
    except ImportError:
        kernel = None
    out = []
    for n, dtype in SHAPES:
        dt = getattr(torch, dtype)
        prob = czt.Problem.poisson_cube(n, dt, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(n)
        p, b = (torch.rand((n, n, n), generator=gen, device="cuda", dtype=dt) * 2 - 1
                for _ in range(2))
        msk = prob.msk
        field = p.numel() * p.element_size()
        for op, fields in (("calc_ax", 3), ("calc_rk", 4)):
            args = (p, msk) if op == "calc_ax" else (p, b, msk)
            row = {"op": op, "n": n, "dtype": dtype,
                   "bound_ms": fields * field / BW * 1e3}
            sides = {"twin": getattr(twin, op)}
            if kernel is not None:
                sides["kernel"] = getattr(kernel, op)
                row["bitwise"] = bool(torch.equal(sides["kernel"](*args),
                                                  sides["twin"](*args)))
            for side, fn in sides.items():
                row[f"{side}_ms"] = event_ms(lambda: fn(*args), calls, torch)
                dev_us, recs = device_per_call(lambda: fn(*args), 10, torch)
                row[f"{side}_device_ms"] = dev_us * 1e-3
                row[f"{side}_launches"] = recs
            if kernel is not None:
                row["kernel_roofline_pct"] = 100 * row["bound_ms"] / row["kernel_device_ms"]
            say(json.dumps(row))
            out.append(row)
    return out


# pass: fields read (the mask included) and written, arguments before msk
# from the fields f and scalars a, b, o, and its maps (the rest are dots)
VECTOR_PASSES = (
    ("bicg_1", 5, lambda f, a, b, o: (f[0], f[1], f[2], b, o), 1),
    ("dot2", 3, lambda f, a, b, o: (f[0], f[1]), 0),
    ("triad", 4, lambda f, a, b, o: (f[0], f[1], a), 1),
    ("dots_t", 3, lambda f, a, b, o: (f[0], f[1]), 0),
    ("update_xr", 9, lambda f, a, b, o: (*f, a, o), 2),
    ("axpy", 4, lambda f, a, b, o: (f[0], a, f[1]), 1),
    ("dot1", 2, lambda f, a, b, o: (f[0],), 0),
)


def time_vector(torch, calls, say):
    import cubez_tpu_torch as czt
    from cubez_tpu_torch.cuda_kernels import blas as kernel
    from cubez_tpu_torch.ops import blas as twin
    if not hasattr(kernel, "vector_pass"):
        return []
    out = []
    for n, dtype in SHAPES:
        dt = getattr(torch, dtype)
        msk = czt.Problem.poisson_cube(n, dt, device="cuda").msk
        gen = torch.Generator(device="cuda").manual_seed(n + 1)
        f = [(torch.rand((n, n, n), generator=gen, device="cuda", dtype=dt) * 2 - 1)
             * msk for _ in range(6)]
        a, b, o = (torch.tensor(v, dtype=dt, device="cuda")
                   for v in (0.7310585786300049, -1.2599210498948732,
                             0.4142135623730951))
        field = f[0].numel() * f[0].element_size()
        for op, fields, make, maps in VECTOR_PASSES:
            args = (*make(f, a, b, o), msk)
            row = {"op": op, "n": n, "dtype": dtype,
                   "bound_ms": fields * field / BW * 1e3}
            sides = {"twin": getattr(twin, op), "kernel": getattr(kernel, op)}
            got, want = ((v if isinstance(v, tuple) else (v,))
                         for v in (sides["kernel"](*args), sides["twin"](*args)))
            row["bitwise"] = all(torch.equal(g, w)
                                 for g, w in zip(got[:maps], want[:maps]))
            row["dot_rel_gap"] = max((abs(float(g) / float(w) - 1) for g, w in
                                      zip(got[maps:], want[maps:])), default=None)
            for side, fn in sides.items():
                row[f"{side}_ms"] = event_ms(lambda: fn(*args), calls, torch)
                dev_us, recs = device_per_call(lambda: fn(*args), 10, torch)
                row[f"{side}_device_ms"] = dev_us * 1e-3
                row[f"{side}_launches"] = recs
            row["kernel_roofline_pct"] = 100 * row["bound_ms"] / row["kernel_device_ms"]
            say(json.dumps(row))
            out.append(row)
        del f, msk
    return out


def span_split(trace_path):
    """{span: [device ms, device records]} of a chrome trace: each device
    record under the innermost ``cz.`` span around its launching runtime
    call on that call's thread."""
    with open(trace_path) as f:
        evs = json.load(f)["traceEvents"]
    spans_by_thread = defaultdict(list)
    launch_at = {}
    records = []
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith("cz.") \
                and not name.startswith("cz.solve_id"):
            spans_by_thread[(e["pid"], e["tid"])].append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), name))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch_at[corr] = ((e["pid"], e["tid"]), float(e["ts"]))
        elif cat in DEVICE_CATS and corr is not None:
            records.append((corr, float(e.get("dur", 0))))
    starts = {}
    for key, sp in spans_by_thread.items():
        sp.sort()
        starts[key] = [s[0] for s in sp]
    split = defaultdict(lambda: [0.0, 0])
    for corr, dur in records:
        where = "(none)"
        if corr in launch_at:
            key, ts = launch_at[corr]
            sp = spans_by_thread.get(key, [])
            # the innermost span holding ts: the latest start at or before
            # it whose end is after it
            for s0, s1, name in reversed(sp[:bisect.bisect_right(starts.get(key, []), ts)]):
                if s1 >= ts:
                    where = name
                    break
        split[where][0] += dur * 1e-3
        split[where][1] += 1
    return dict(sorted(split.items(), key=lambda kv: -kv[1][0]))


def krylov_cell(torch, seed):
    """(start, run): ``start(i)`` the 256^3 float64 problem from the i-th
    seeded [0, 1) interior, ``run(p)`` its pbicgstab solve, synchronized."""
    import dataclasses

    import cubez_tpu_torch as czt
    from cubez_tpu_torch.solvers.api import solve
    n = 256
    prob = czt.Problem.poisson_cube(n, torch.float64, device="cuda")

    def start(i):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        x0 = prob.x0.clone()
        x0[1:-1, 1:-1, 1:-1] = torch.rand((n - 2,) * 3, generator=g,
                                          device="cuda", dtype=x0.dtype)
        return dataclasses.replace(prob, x0=x0)

    def run(p):
        r = solve(p, "pbicgstab", omega=1.1, itr_max=4000, eps=1e-5,
                  precond="sor2sma")
        torch.cuda.synchronize()
        return r

    return start, run


def traced_solve(torch, start, run, say, out_dir):
    run(start(0))  # build, warm
    p = start(1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r = run(p)
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", dir=out_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        split = span_split(path)
    finally:
        os.unlink(path)
    busy = sum(v[0] for v in split.values())
    out = {"iters": r.iters, "traced_wall_ms": wall * 1e3,
           "device_ms": busy, "records": sum(v[1] for v in split.values()),
           "by_span": {k: {"device_ms": v[0], "share_pct": 100 * v[0] / busy,
                           "records": v[1], "ms_per_iter": v[0] / r.iters}
                       for k, v in split.items()}}
    say(json.dumps(out))
    return out


def host_split(torch, start, run, n, say):
    """The host's own time by span of 2 ``n`` solves, in turns recorded by
    spans.recording() alone and traced by torch.profiler (``--host``)."""
    import statistics

    from cubez_tpu_torch.perf import spans
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    runs = {"recorded": [], "traced": []}
    for i in range(n):
        for k, mode in enumerate(runs):
            p = start(10 + 2 * i + k)
            if mode == "traced":
                with torch.profiler.profile(activities=acts):
                    run(p)
            else:
                with spans.recording():
                    run(p)
            rec = spans.solves()[-1]
            row = {"mode": mode, "iters": rec.iters, "launches": rec.launches,
                   "host_us_per_launch": rec.step_self_ns() * 1e-3 / rec.launches,
                   "self_ms_per_iter": {k_: v.self_ns * 1e-6 / rec.iters
                                        for k_, v in rec.spans.items()}}
            say(json.dumps(row))
            runs[mode].append(row)
    out = {}
    for mode, rows in runs.items():
        names = sorted({k_ for r in rows for k_ in r["self_ms_per_iter"]})
        out[mode] = {
            "host_us_per_launch": statistics.median(
                r["host_us_per_launch"] for r in rows),
            "host_us_per_launch_range": [min(r["host_us_per_launch"] for r in rows),
                                         max(r["host_us_per_launch"] for r in rows)],
            "launches_per_iter": statistics.median(
                r["launches"] / r["iters"] for r in rows),
            "self_ms_per_iter": {k_: statistics.median(
                r["self_ms_per_iter"].get(k_, 0.0) for r in rows) for k_ in names}}
    say(json.dumps({"host": out}))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--spans", action="store_true")
    ap.add_argument("--host", type=int, default=0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 22)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prof_blas.py measures the card: no CUDA device")
    out_dir = Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)

    def say(msg):
        print(msg, flush=True)

    import cubez_tpu_torch
    card = torch.cuda.get_device_name(0)
    say(f"card {card}, power limit {power_limit()} W, package "
        f"{cubez_tpu_torch.__file__}")
    summary = {"package": cubez_tpu_torch.__file__, "card": card,
               "power_limit_w": power_limit(),
               "operator": time_operator(torch, args.calls, say),
               "vector": time_vector(torch, args.calls, say)}
    if args.spans or args.host:
        start, run = krylov_cell(torch, args.seed)
    if args.spans:
        summary["spans"] = traced_solve(torch, start, run, say,
                                        None if out_dir is None else str(out_dir))
    if args.host:
        if not args.spans:
            run(start(0))  # build, warm
        summary["host"] = host_split(torch, start, run, args.host, say)
    line = json.dumps(summary)
    if out_dir is not None:
        (out_dir / "prof_blas.json").write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
