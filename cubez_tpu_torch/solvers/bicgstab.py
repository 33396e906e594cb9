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
from ..cuda_kernels import blas as cuda_blas
from ..ops import blas
from ..ops import maf as maf_ops
from ..perf import spans
from . import steps as steps_mod
from .driver import SolveResult, fixed_sweeps
from .fused_cache import relaxation_route

FLT_MIN = float(np.finfo(np.float32).tiny)  # rho breakdown (cz_Poisson.cpp:379)
PRECOND_SWEEPS = 8


class VectorOps:
    """The Krylov loops' vector operations on (K, I, J) fields, the masked
    forms of ops/blas.py (and ops/maf.py's operator where ``mc``, the
    MafCoeffs of a ``_maf`` name, is given), and ``precon``.  The constant
    operator and every vector operation but ``neg`` and ``bicg_2`` go
    through cuda_kernels/blas.py, which runs a pass of csrc/blas.cu on the
    card under ``impl`` 'auto' and the plain twin otherwise; ``dots_t`` and
    ``update_xr`` fuse what BiCGSTAB's iteration does after its second
    operator application into one pass each on the card.
    parallel/krylov.py's BlockOps runs the same operations on block lists,
    each composed of its per-block ``_map`` and ``_dot``."""

    def __init__(self, problem: Problem, mc, precon, impl: str = "auto"):
        self.msk = problem.msk
        self.mc = mc
        self.impl = impl
        self.pvt = problem.pvt
        self.dtype = problem.grid.dtype
        self.device = problem.x0.device
        self.precon = precon

    def scalar(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=self.dtype, device=self.device)

    def dot1(self, v):
        return cuda_blas.dot1(v, self.msk, self.impl)

    def dot2(self, v, w):
        return cuda_blas.dot2(v, w, self.msk, self.impl)

    def dots_t(self, t, s):
        """(dot2(t, s), dot1(t))."""
        return cuda_blas.dots_t(t, s, self.msk, self.impl)

    def triad(self, x, y, a):
        return cuda_blas.triad(x, y, a, self.msk, self.impl)

    def bicg_1(self, p, r, q, beta, omega):
        return cuda_blas.bicg_1(p, r, q, beta, omega, self.msk, self.impl)

    def bicg_2(self, z, x, y, a, b):
        return blas.bicg_2(z, x, y, a, b, self.msk)

    def update_xr(self, x, p_, s_, t_, s, r0, alpha, omega):
        """(x + alpha p_ + omega s_, r = s - omega t_, dot1(r), dot2(r, r0)):
        BiCGSTAB's iteration end."""
        return cuda_blas.update_xr(x, p_, s_, t_, s, r0, alpha, omega,
                                   self.msk, self.impl)

    def axpy(self, x, a, p):
        """x + a p on inner nodes (cg.py's update of x)."""
        return cuda_blas.axpy(x, a, p, self.msk, self.impl)

    def neg(self, v):
        return -v

    def ax(self, p):
        if self.mc is not None:
            return maf_ops.calc_ax_maf(p, self.msk, self.mc, self.pvt)
        return cuda_blas.calc_ax(p, self.msk, self.impl)

    def rk(self, p, b):
        if self.mc is not None:
            return maf_ops.calc_rk_maf(p, b, self.msk, self.mc, self.pvt)
        return cuda_blas.calc_rk(p, b, self.msk, self.impl)


class SpannedOps:
    """``ops`` with each call inside a span of the recorded solve ``rec``
    (perf/spans.py): ``cz.precon`` a preconditioner application, ``cz.ax``
    an operator application (``ax``, and ``rk``'s b - A x), ``cz.blas``
    every other call; attributes that are no call pass through."""

    SPANS = {"precon": "cz.precon", "ax": "cz.ax", "rk": "cz.ax"}

    def __init__(self, ops: VectorOps, rec):
        self._ops, self._rec = ops, rec

    def __getattr__(self, name):
        attr = getattr(self._ops, name)
        if not callable(attr):
            return attr
        span, rec = self.SPANS.get(name, "cz.blas"), self._rec

        def call(*args):
            rec.enter(span)
            try:
                return attr(*args)
            finally:
                rec.exit()

        return call


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
    """(res, rho) as Python floats in one device-to-host transfer (a
    ``spans.wait``)."""
    return spans.wait(torch.Tensor.tolist,
                      torch.stack([res, rho.to(torch.float64)]))


def res_of(rr, res_normal: float):
    """The history's float64 residual sqrt(rr * res_normal) of rr =
    dot1(r)."""
    return torch.sqrt(rr.to(torch.float64) * res_normal)


def spanned(ops):
    """(ops, the recorded solve's Recorder): ``ops`` in a SpannedOps where
    the solve is recorded (perf/spans.py), else as it is and None."""
    rec = spans.current
    return (ops, None) if rec is None else (SpannedOps(ops, rec), rec)


def run_bicgstab(ops: VectorOps, x0, b, itr_max: int, eps: float,
                 res_normal: float) -> SolveResult:
    """The BiCGSTAB loop over ``ops``'s vectors; ``x`` of the result is in
    their form (a field, or blocks).  The reference loops itr = 1 ..
    ItrMax - 1 (cz_Poisson.cpp:373): at most max(itr_max - 1, 1)
    iterations.  A rho breakdown stops before the iteration touches any
    state and reports 0 iterations (cz_Poisson.cpp:379-383), with the
    history of those that ran.  In a recorded solve (perf/spans.py) each
    iteration is a span ``cz.iter``, its host sync ``cz.fetch``, and the
    vector operations are spans of their own (``SpannedOps``)."""
    n = max(int(itr_max) - 1, 1)
    ops, rec = spanned(ops)
    hist = torch.zeros(n, dtype=torch.float64, device=ops.device)
    one = ops.scalar(1.0)
    rho_old, alpha, omega = one, ops.scalar(0.0), one  # cz_Poisson.cpp:368
    x = x0
    r = ops.rk(x0, b)
    r0 = r
    p = q = None
    rho = ops.dot2(r, r0)
    rho_h, res, itr, stop = spans.wait(float, rho), math.inf, 0, False
    while itr < n and (itr == 0 or res >= eps):
        if abs(rho_h) < FLT_MIN:
            stop = True
            break
        if rec is not None:
            rec.enter("cz.iter")
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
        ts, tt = ops.dots_t(t_, s)
        omega = ts / _guard(tt, one, absolute=False)
        x, r, rr, rho_next = ops.update_xr(x, p_, s_, t_, s, r0, alpha, omega)
        res_t = res_of(rr, res_normal)
        hist[itr] = res_t
        rho_old, rho = rho, rho_next
        if rec is not None:
            rec.enter("cz.fetch")
        res, rho_h = fetch(res_t, rho)
        if rec is not None:
            rec.exit(2)
        itr += 1
    return SolveResult(x=x, iters=0 if stop else itr, res=float(res),
                       history=hist[:itr])


def make_bicgstab(problem: Problem, name: str, omega: float, precond,
                  impl: str = "auto"):
    """``solve(x0, b, itr_max, eps, res_normal) -> SolveResult`` on the
    problem's fields; ``name`` 'pbicgstab' or 'pbicgstab_maf' (which takes
    ``problem.mc`` and ``problem.pvt``); ``impl`` picks the preconditioner's
    route and the constant operator's (VectorOps)."""
    ops = VectorOps(problem, steps_mod.maf_coeffs(problem, name),
                    make_precon(problem, precond, omega, impl), impl)

    def solve(x0, b, itr_max, eps, res_normal):
        return run_bicgstab(ops, x0, b, itr_max, eps, res_normal)

    return solve
