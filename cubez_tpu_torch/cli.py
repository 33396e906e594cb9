"""CLI with the reference's positional interface (src/main.cpp:19-30):

    python -m cubez_tpu_torch.cli gsz_x gsz_y gsz_z solver ItrMax coef \\
        [precond] [gdv_x gdv_y gdv_z] [--dist] [--fp64] [--eps E] \\
        [--device cuda|cpu] [--impl auto|plain] [--profile] \\
        [--dump FILE.sph]

A process division ``gdv_x gdv_y gdv_z`` (or ``--dist``, the automatic
division) runs ``solve_dist`` over a block mesh, for every solver the port
runs, the line solvers and the Krylov solvers included: blocks go
round-robin over the visible CUDA devices (``--device cpu``: the host).
``pbicgstab`` takes the preconditioner "none" unless ``precond`` names
one, as the JAX package's CLI does.

Writes ``<solver>.txt`` (cz_Evaluate.cpp:210-218), prints the iteration and
residual banner (cz_Evaluate.cpp:492-496) and the analytic ``Error max``
check (cz_Evaluate.cpp:550-563).  ``--dump FILE.sph`` writes the solution
field as an SPH scalar file (fileout_t, cz_utility.f90:17-47; pitch (p, p,
p), step = the iterations; utils/sph.py).  ``--profile`` writes
``profiling.txt``, the PMlib-style report of perf/profile.py's
``profile_solve`` over min(50, iterations) iterations of the solve's step
(its sweep and the driver's overhead; on a mesh the halo exchange, the
residual fold and the block sweep), plus ``solve_total``, the solve's
wall; %SoL is taken against the card's entry in perf/pmlib.py's table.
It then runs the solve once more under torch.profiler with its spans
recorded (perf/spans.py) and writes ``profile_trace.json`` (the chrome
trace) and ``spans.txt`` (per span: calls, total and self ms; the host
syncs, the device's idle across them, host µs a launch, sweeps an
iteration).
For pbicgstab, cg, mg, fmg and fd, which are no sweep, it profiles
``sor2sma`` on the same problem, as the JAX package's CLI does.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import torch

def build_argparser():
    ap = argparse.ArgumentParser(
        prog="czx-torch",
        description="PyTorch/CUDA port of the CubeZ iterative-solver platform",
    )
    ap.add_argument("gsz", nargs=3, type=int, help="global node counts x y z")
    ap.add_argument("solver", type=str)
    ap.add_argument("itr_max", type=int)
    ap.add_argument("coef", type=float, help="acceleration coefficient omega")
    ap.add_argument("rest", nargs="*", help="[precond] [gdv_x gdv_y gdv_z]")
    ap.add_argument("--fp64", action="store_true", help="REAL_IS_DOUBLE build parity")
    ap.add_argument("--eps", type=float, default=1.0e-5)
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the fields live (cuda: the CUDA kernels; cpu: the plain "
        "twins)",
    )
    ap.add_argument(
        "--impl", choices=("auto", "plain"), default="auto",
        help="auto: the kernels on CUDA; plain: the plain PyTorch twins",
    )
    ap.add_argument(
        "--warmup", action="store_true",
        help="run a one-chunk solve first so the reported wall time excludes "
        "the kernel build and first launches",
    )
    ap.add_argument("--dist", action="store_true",
                    help="distributed solve over an automatic block division")
    ap.add_argument(
        "--profile", action="store_true",
        help="write profiling.txt (PMlib-style timing/flops/roofline report)",
    )
    ap.add_argument("--dump", default=None, metavar="FILE.sph",
                    help="write the solution field as an SPH scalar file")
    return ap


def trace_solve(run, device):
    """One more solve, ``run()``, under torch.profiler (the host, and the
    card on CUDA) inside ``spans.recording()``: writes
    ``profile_trace.json``, the chrome trace with the program's spans
    (perf/spans.py) on the device's clock, and ``spans.txt``, the solve's
    spans and counters (``spans.report``)."""
    from .perf import spans

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with spans.recording(), torch.profiler.profile(activities=acts) as prof:
        run()
        if device == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace("profile_trace.json")
    with open("spans.txt", "w") as f:
        f.write(spans.report(spans.solves()[-1]))
    print("profile_trace.json and spans.txt written")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available")

    from .core.grid import max_error_loc
    from .core.problem import Problem
    from .parallel import make_mesh, solve_dist
    from .solvers.api import solve
    from .solvers.steps import parse_name

    precond = None
    rest = list(args.rest)
    if rest and not rest[0].isdigit():
        precond = rest.pop(0)
    gdv = None
    if len(rest) == 3 and all(r.isdigit() for r in rest):
        gdv = tuple(int(r) for r in rest)
        rest = []
    if rest:
        print(f"unexpected trailing args: {rest}", file=sys.stderr)
        return 2
    kind, is_maf = parse_name(args.solver)  # validate early
    if kind == "pbicgstab" and precond is None:
        precond = "none"

    gx, gy, gz = args.gsz
    dtype = torch.float64 if args.fp64 else torch.float32
    prob = Problem.poisson_cube((gx, gy, gz), dtype=dtype, device=args.device,
                                maf=is_maf)
    run = functools.partial(solve, prob, args.solver)
    cm = None
    if args.dist or gdv:
        nblocks = None if gdv is None else gdv[0] * gdv[1] * gdv[2]
        ndev = torch.cuda.device_count() if args.device == "cuda" else 1
        devices = [args.device if args.device == "cpu" else f"cuda:{b % ndev}"
                   for b in range(nblocks or ndev)]
        # argv order x, y, z -> the mesh's z, x, y
        div = (gdv[2], gdv[0], gdv[1]) if gdv else None
        cm = make_mesh((gz, gx, gy), devices=devices, div=div)
        print(f"mesh division (z,x,y) = {cm.div} on {len(set(devices))} "
              "device(s)")
        run = functools.partial(solve_dist, prob, cm, args.solver)
    print(f"Iterative Method = {args.solver}")
    if kind == "pbicgstab":
        print(f"Preconditioner = {precond}")

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    if args.warmup:
        run(omega=args.coef, itr_max=args.itr_max, eps=1e9, precond=precond,
            impl=args.impl)
        sync()

    t0 = time.perf_counter()
    res = run(omega=args.coef, itr_max=args.itr_max, eps=args.eps,
              precond=precond, history_path=f"{args.solver}.txt",
              impl=args.impl)
    sync()
    dt = time.perf_counter() - t0

    print("\n=================================")
    print(f"Iter = {res.iters}  Res = {res.res:e}")
    print("=================================")
    cells = prob.grid.num_inner * res.iters
    print(f"wall = {dt:.3f} s   {cells / dt / 1e6:.1f} Mcell-updates/s")

    if args.profile:
        # measured per-phase sections (sweep / halo / allreduce / driver)
        # with analytic flops+bytes — the PMlib report with real timings
        from .perf.pmlib import CALC
        from .perf.profile import profile_solve

        pm = profile_solve(
            prob,
            args.solver
            if kind not in ("pbicgstab", "cg", "mg", "fmg", "fd")
            else "sor2sma",
            omega=args.coef, iters=min(50, max(res.iters, 1)), cmesh=cm,
            impl=args.impl,
        )
        pm.add("solve_total", dt, kind=CALC, calls=res.iters)
        pm.sections["solve_total"].exclusive = False
        pm.write("profiling.txt")
        print("profiling.txt written")
        trace_solve(functools.partial(
            run, omega=args.coef, itr_max=args.itr_max, eps=args.eps,
            precond=precond, impl=args.impl), args.device)

    if args.dump:
        from .utils.sph import write_sph

        p = prob.grid.pitch
        write_sph(args.dump, res.x, pitch=(p, p, p), step=res.iters)
        print(f"{args.dump} written")

    if gx == gy == gz:
        err, (ei, ej, ek) = max_error_loc(prob.grid, res.x)
        print(f"\nError max = {err:e} at ({ei} {ej} {ek})\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
