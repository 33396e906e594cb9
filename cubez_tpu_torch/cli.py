"""CLI with the reference's positional interface (src/main.cpp:19-30):

    python -m cubez_tpu_torch.cli gsz_x gsz_y gsz_z solver ItrMax coef \\
        [precond] [--fp64] [--eps E] [--device cuda|cpu] [--impl auto|plain]

Writes ``<solver>.txt`` (cz_Evaluate.cpp:210-218), prints the iteration and
residual banner (cz_Evaluate.cpp:492-496) and the analytic ``Error max``
check (cz_Evaluate.cpp:550-563).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

# options of the JAX package's CLI that later slices of the port bring
_LATER = {
    "dist": "slice 9 (multi-GPU)",
    "profile": "slice 8 (perf)",
    "dump": "slice 7 (extensions)",
}


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
    ap.add_argument("--dist", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    for opt, where in _LATER.items():
        if getattr(args, opt):
            raise NotImplementedError(
                f"--{opt} is not ported to PyTorch yet: {where} of ROADMAP.md"
            )
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available")

    from .core.grid import max_error_loc
    from .core.problem import Problem
    from .solvers.api import solve
    from .solvers.steps import require_ported

    precond = None
    rest = list(args.rest)
    if rest and not rest[0].isdigit():
        precond = rest.pop(0)
    if len(rest) == 3:
        raise NotImplementedError(
            "a process division (gdv_x gdv_y gdv_z) is slice 9 (multi-GPU) "
            "of ROADMAP.md"
        )
    if rest:
        print(f"unexpected trailing args: {rest}", file=sys.stderr)
        return 2
    require_ported(args.solver)  # validate early

    gx, gy, gz = args.gsz
    dtype = torch.float64 if args.fp64 else torch.float32
    prob = Problem.poisson_cube((gx, gy, gz), dtype=dtype, device=args.device)
    print(f"Iterative Method = {args.solver}")

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    if args.warmup:
        solve(prob, args.solver, omega=args.coef, itr_max=args.itr_max,
              eps=1e9, precond=precond, impl=args.impl)
        sync()

    t0 = time.perf_counter()
    res = solve(
        prob,
        args.solver,
        omega=args.coef,
        itr_max=args.itr_max,
        eps=args.eps,
        precond=precond,
        history_path=f"{args.solver}.txt",
        impl=args.impl,
    )
    sync()
    dt = time.perf_counter() - t0

    print("\n=================================")
    print(f"Iter = {res.iters}  Res = {res.res:e}")
    print("=================================")
    cells = prob.grid.num_inner * res.iters
    print(f"wall = {dt:.3f} s   {cells / dt / 1e6:.1f} Mcell-updates/s")

    if gx == gy == gz:
        err, (ei, ej, ek) = max_error_loc(prob.grid, res.x)
        print(f"\nError max = {err:e} at ({ei} {ej} {ek})\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
