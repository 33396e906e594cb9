"""Preconditioned Conjugate Gradient (PyTorch port of
``cubez_tpu/solvers/cg.py``; an extension beyond the reference).

The constant-coefficient 7-point operator (blas.calc_ax: ap = sum(neighbors)
- 6 p, cz_blas.f90:579-644) is symmetric negative-definite on the inner
nodes with Dirichlet boundaries, so CG runs on the negated system
(-A) x = (-b): one A x product, one preconditioner application and two dots
an iteration, against BiCGSTAB's 2, 2 and 5.

CG needs a symmetric positive-definite preconditioner.  A fixed number of
damped-Jacobi sweeps from a zero start is a polynomial in A (D = 6 I), so
it is admissible, and so is one application of fd, the exact inverse
(solvers/direct.py); the red-black and line sweeps are not symmetric and
are refused.  The sweeps are linear in b from a zero start, so -precon(-r) ==
precon(r) and the negated system needs no sign plumbing.  The loop runs on
the host with one host sync an iteration, as bicgstab.py's, over the same
``VectorOps``.
"""

from __future__ import annotations

import math

import torch

from ..core.problem import Problem
from ..perf import spans
from . import steps as steps_mod
from .bicgstab import (FLT_MIN, VectorOps, _guard, fetch, is_identity,
                       make_precon, res_of, spanned)
from .driver import SolveResult

# preconditioners that are symmetric for the constant-coefficient operator
SYMMETRIC_PRECONDS = ("jacobi", "fd")


def check_cg(problem: Problem, precond):
    """ValueError for what CG cannot run: a problem with MAF coefficients
    (the pivot-scaled MAF operator is nonsymmetric) and a nonsymmetric
    preconditioner."""
    if problem.mc is not None:
        raise ValueError(
            "cg supports the constant-coefficient operator only "
            "(the pivot-scaled MAF operator is nonsymmetric); use pbicgstab_maf"
        )
    if is_identity(precond):
        return
    kind, p_maf = steps_mod.parse_name(precond)
    if p_maf or kind not in SYMMETRIC_PRECONDS:
        raise ValueError(
            f"cg requires a symmetric preconditioner "
            f"({', '.join(SYMMETRIC_PRECONDS)} or none); "
            f"'{precond}' is nonsymmetric — use pbicgstab with it"
        )


def run_cg(ops: VectorOps, x0, b, itr_max: int, eps: float,
           res_normal: float) -> SolveResult:
    """The CG loop over ``ops``'s vectors, with bicgstab.run_bicgstab's
    iteration limit, history and breakdown rules (a breakdown leaves x
    as it is and reports 0 iterations), and its spans."""
    n = max(int(itr_max) - 1, 1)
    ops, rec = spanned(ops)
    hist = torch.zeros(n, dtype=torch.float64, device=ops.device)
    one = ops.scalar(1.0)
    x = x0
    r = ops.neg(ops.rk(x0, b))  # rbar = -(b - A x)
    z = ops.precon(r)
    p = z
    rho = ops.dot2(r, z)
    rho_h, res, itr, stop = spans.wait(float, rho), math.inf, 0, False
    while itr < n and (itr == 0 or res >= eps):
        if abs(rho_h) < FLT_MIN:
            stop = True
            break
        if rec is not None:
            rec.enter("cz.iter")
        q = ops.neg(ops.ax(p))
        alpha = rho / _guard(ops.dot2(p, q), one)
        x = ops.axpy(x, alpha, p)
        r = ops.triad(q, r, -alpha)
        res_t = res_of(ops.dot1(r), res_normal)
        hist[itr] = res_t
        z = ops.precon(r)
        rho_new = ops.dot2(r, z)
        p = ops.triad(p, z, rho_new / rho)
        rho = rho_new
        if rec is not None:
            rec.enter("cz.fetch")
        res, rho_h = fetch(res_t, rho)
        if rec is not None:
            rec.exit(2)
        itr += 1
    return SolveResult(x=x, iters=0 if stop else itr, res=float(res),
                       history=hist[:itr])


def make_cg(problem: Problem, omega: float, precond, impl: str = "auto"):
    """``solve(x0, b, itr_max, eps, res_normal) -> SolveResult``; the
    preconditioner is built as bicgstab.make_precon builds it, and ``impl``
    picks its route and the operator's (VectorOps)."""
    check_cg(problem, precond)
    ops = VectorOps(problem, None, make_precon(problem, precond, omega, impl),
                    impl)

    def solve(x0, b, itr_max, eps, res_normal):
        return run_cg(ops, x0, b, itr_max, eps, res_normal)

    return solve
