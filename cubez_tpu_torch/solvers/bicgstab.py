"""Preconditioned BiCGSTAB (PyTorch port of ``cubez_tpu/solvers/bicgstab.py``;
CZ::PBiCGSTAB, cz_Poisson.cpp:332-504).

The JAX package runs the whole Krylov loop on the device in one
``lax.while_loop``.  Here the loop runs on the host with one host sync an
iteration: the iteration's residual and the next rho (computed at its end,
on the device) come back in one transfer, and the host decides there
whether to stop (``res < eps``) or to break down (``|rho| < FLT_MIN``).
Scalars stay 0-d tensors of the field's dtype on the device throughout.

The vector operations go through a ``VectorOps``: this module's works on
(K, I, J) fields, ``parallel/krylov.py``'s ``BlockOps`` on the block lists
of a mesh, so the loop below (and cg.py's) is written once.

The preconditioner is a fixed 8 sweeps of the named relaxation solver from
a zero start with the Krylov vector as b, with no convergence check
(lc_max = 8, cz_Poisson.cpp:280); "none" and "copy" pass the vector
through (cz_Poisson.cpp:320).  The extensions apply once at omega 1.0, as
in the JAX package: mg and fmg one V-cycle of mg (K4 on the finest level),
fd one direct solve (``precon_plan``).  It takes the route the port's ``solve``
takes for that name with a streamed b (solvers/api.py): the kernel step of
``get_fused_step`` with the standard mask (sor2sma: K2's pair, or K4's
one-pass red-black step for odd I; jacobi: K4; pcr_rb: K5, or K6's
red-black form for odd I; pcr_j_esa: K6's line-Jacobi form; psor: P1;
pcr, pcr_eda, pcr_esa: P2, those two in the step's own diagonal layout
through its ``pad``/``unpad``), in float32 and float64, constant and MAF
alike; otherwise ``steps.make_step`` (which refuses psor and pcr with a
non-standard mask, as the JAX package does).  The JAX package's
preconditioner hands its unskewed vector to the skewed psor/pcr steps
(its bicgstab.py:127-135, a fault of the reference package, ROADMAP.md);
the port does not copy that.  The JAX package fuses it only for float32
and non-MAF names (its _fused_precon): the port follows its own dispatch
on purpose, as ``solve`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.problem import Problem
from ..ops import blas
from ..ops import maf as maf_ops
from . import steps as steps_mod
from .driver import SolveResult, fixed_sweeps
from .fused_cache import relaxation_route

FLT_MIN = float(np.finfo(np.float32).tiny)  # rho breakdown (cz_Poisson.cpp:379)
PRECOND_SWEEPS = 8


class VectorOps:
    """The Krylov loops' vector operations on (K, I, J) fields, the masked
    forms of ops/blas.py (and ops/maf.py's operator where ``mc``, the
    MafCoeffs of a ``_maf`` name, is given), and ``precon``.  Subclasses
    change ``_map``, ``_dot``, ``ax`` and ``rk`` only (parallel/krylov.py's
    BlockOps)."""

    def __init__(self, problem: Problem, mc, precon):
        self.msk = problem.msk
        self.mc = mc
        self.pvt = problem.pvt
        self.dtype = problem.grid.dtype
        self.device = problem.x0.device
        self.precon = precon

    def scalar(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def _map(self, fn, *vs):
        """``fn(*vs, msk)`` elementwise over the vectors ``vs``."""
        return fn(*vs, self.msk)

    def _dot(self, fn, *vs):
        """The 0-d field-dtype sum ``fn(*vs, msk)`` over the vectors."""
        return fn(*vs, self.msk)

    def dot1(self, v):
        return self._dot(blas.dot1, v)

    def dot2(self, v, w):
        return self._dot(blas.dot2, v, w)

    def triad(self, x, y, a):
        return self._map(lambda x, y, m: blas.triad(x, y, a, m), x, y)

    def bicg_1(self, p, r, q, beta, omega):
        return self._map(lambda p, r, q, m: blas.bicg_1(p, r, q, beta, omega, m),
                         p, r, q)

    def bicg_2(self, z, x, y, a, b):
        return self._map(lambda z, x, y, m: blas.bicg_2(z, x, y, a, b, m),
                         z, x, y)

    def axpy(self, x, a, p):
        """x + a p on inner nodes (cg.py's update of x)."""
        return self._map(lambda x, p, m: x + blas.scalar(a, x) * p * m, x, p)

    def neg(self, v):
        return self._map(lambda v, m: -v, v)

    def ax(self, p):
        if self.mc is not None:
            return maf_ops.calc_ax_maf(p, self.msk, self.mc, self.pvt)
        return blas.calc_ax(p, self.msk)

    def rk(self, p, b):
        if self.mc is not None:
            return maf_ops.calc_rk_maf(p, b, self.msk, self.mc, self.pvt)
        return blas.calc_rk(p, b, self.msk)


def _zeros_like(v):
    if isinstance(v, list):
        return [torch.zeros_like(t) for t in v]
    return torch.zeros_like(v)


def _clone(v):
    if isinstance(v, list):
        return [t.clone() for t in v]
    return v.clone()


def is_identity(precond) -> bool:
    """True for no preconditioner: None, "none" or "copy"."""
    return not precond or precond.lower() in ("none", "copy")


def check_precond(precond: str) -> str:
    """The kind of a preconditioner name, a relaxation, line or extension
    solver; ValueError for a Krylov driver."""
    kind, _ = steps_mod.parse_name(precond)
    if kind in steps_mod.KRYLOV:
        raise ValueError(f"'{precond}' is a Krylov driver, not a preconditioner")
    return kind


def precon_plan(precond: str, omega: float):
    """(name, omega, sweeps) of a preconditioner's step: PRECOND_SWEEPS
    sweeps of the name at ``omega`` (the reference's fixed 8); for the
    extensions one application at omega 1.0, one V-cycle for mg (and for
    fmg, whose F-cycle initializes a solve and is affine in b, not a
    linear operator) and one direct solve for fd, as the JAX package's
    bicgstab.py and cg.py do."""
    kind = check_precond(precond)
    if kind in steps_mod.EXTENSIONS:
        return precond.lower().replace("fmg", "mg"), 1.0, 1
    return precond, omega, PRECOND_SWEEPS


def sweeps_precon(step, pad=None, unpad=None, sweeps: int = PRECOND_SWEEPS):
    """``precon(v)``: ``sweeps`` sweeps of ``step`` from zero with ``v`` as
    b, through the step's layout converters ``pad``/``unpad``.  The result
    is a vector of its own: a step that alternates between buffers it owns
    returns one of them, which the next application would overwrite
    (BiCGSTAB reads precon(p) after precon(s) has run), so it is copied
    out."""
    ipc = getattr(step, "iters_per_call", 1)
    if sweeps % ipc:
        raise ValueError(
            f"a step of {ipc} iterations a call cannot run the "
            f"preconditioner's {sweeps} sweeps")

    def precon(v):
        bp = v if pad is None else pad(v)
        x0 = _zeros_like(bp)
        xp = fixed_sweeps(step, x0, bp, sweeps)
        x = xp if unpad is None else unpad(xp)
        # unpad made a new vector, or the step updated our x0 in place
        return _clone(x) if x is xp and xp is not x0 else x

    return precon


def make_precon(problem: Problem, precond, omega: float, impl: str = "auto"):
    """The serial preconditioner of a Krylov solve (see the module
    docstring); a ``_maf`` name takes ``problem.mc``."""
    if is_identity(precond):
        return lambda v: v
    precond, omega, sweeps = precon_plan(precond, omega)
    return sweeps_precon(*relaxation_route(problem, precond, omega, impl,
                                           b_arg_is_problem_rhs=False,
                                           divides=sweeps),
                         sweeps=sweeps)


def _guard(den, one, absolute=True):
    """den where it is safe to divide by, else 1 (the |den| < FLT_MIN
    guards, cz_Poisson.cpp)."""
    small = (den.abs() if absolute else den) < FLT_MIN
    return torch.where(small, one, den)


def fetch(res, rho):
    """(res, rho) as Python floats in one device-to-host transfer."""
    return torch.stack([res, rho.to(torch.float64)]).tolist()


def res_of(ops, r, res_normal: float):
    """The history's float64 residual sqrt(dot1(r) * res_normal)."""
    return torch.sqrt(ops.dot1(r).to(torch.float64) * res_normal)


def run_bicgstab(ops: VectorOps, x0, b, itr_max: int, eps: float,
                 res_normal: float) -> SolveResult:
    """The BiCGSTAB loop over ``ops``'s vectors; ``x`` of the result is in
    their form (a field, or blocks).  The reference loops itr = 1 ..
    ItrMax - 1 (cz_Poisson.cpp:373): at most max(itr_max - 1, 1)
    iterations.  A rho breakdown stops before the iteration touches any
    state and reports 0 iterations (cz_Poisson.cpp:379-383), with the
    history of those that ran."""
    n = max(int(itr_max) - 1, 1)
    hist = torch.zeros(n, dtype=torch.float64, device=ops.device)
    one = ops.scalar(1.0)
    rho_old, alpha, omega = one, ops.scalar(0.0), one  # cz_Poisson.cpp:368
    x = x0
    r = ops.rk(x0, b)
    r0 = r
    p = q = None
    rho = ops.dot2(r, r0)
    rho_h, res, itr, stop = float(rho), math.inf, 0, False
    while itr < n and (itr == 0 or res >= eps):
        if abs(rho_h) < FLT_MIN:
            stop = True
            break
        if itr == 0:
            p = r
        else:
            beta = rho / rho_old * alpha / omega
            p = ops.bicg_1(p, r, q, beta, omega)
        p_ = ops.precon(p)
        q = ops.ax(p_)
        alpha = rho / _guard(ops.dot2(q, r0), one)
        s = ops.triad(q, r, -alpha)
        s_ = ops.precon(s)
        t_ = ops.ax(s_)
        omega = ops.dot2(t_, s) / _guard(ops.dot1(t_), one, absolute=False)
        x = ops.bicg_2(x, p_, s_, alpha, omega)
        r = ops.triad(t_, s, -omega)
        res_t = res_of(ops, r, res_normal)
        hist[itr] = res_t
        rho_old, rho = rho, ops.dot2(r, r0)
        res, rho_h = fetch(res_t, rho)
        itr += 1
    return SolveResult(x=x, iters=0 if stop else itr, res=float(res),
                       history=hist[:itr])


def make_bicgstab(problem: Problem, name: str, omega: float, precond,
                  impl: str = "auto"):
    """``solve(x0, b, itr_max, eps, res_normal) -> SolveResult`` on the
    problem's fields; ``name`` 'pbicgstab' or 'pbicgstab_maf' (which takes
    ``problem.mc`` and ``problem.pvt``)."""
    ops = VectorOps(problem, steps_mod.maf_coeffs(problem, name),
                    make_precon(problem, precond, omega, impl))

    def solve(x0, b, itr_max, eps, res_normal):
        return run_bicgstab(ops, x0, b, itr_max, eps, res_normal)

    return solve
