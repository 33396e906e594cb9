"""Plain preconditioned BiCGSTAB, the reference's ``pbicgstab`` (CubeZ
CZ::PBiCGSTAB, cz_Poisson.cpp:332-504, with the preconditioner of
cz_Poisson.cpp:280-321), in plain PyTorch.

This file imports nothing but torch and the benchmark's own plain
references; it takes nothing from the program under test.

The operator is the 7-point Laplacian on the inner nodes, A x = sum of the
six neighbours - 6 x (blas_calc_ax, cz_blas.f90:579-644); the Dirichlet
data enter through the start field's shell, r = b - A x0 on the inner
nodes.  Work vectors are zero on the shell.  The preconditioner is a fixed
8 iterations of the named relaxation from a zero field with the vector as
the right-hand side.  Every scalar is computed in the fields' type; the
residual of an iteration is sqrt(sum r^2 / N_inner), and the loop runs at
most itr_max - 1 iterations (cz_Poisson.cpp:373).  A |rho| under FLT_MIN
stops the solve before the iteration and reports 0 iterations
(cz_Poisson.cpp:379-383); the two divisions are guarded the reference's
way.
"""

from __future__ import annotations

import importlib
import math

import torch

FLT_MIN = 1.1754943508222875e-38
PRECOND_SWEEPS = 8


def apply_a(p):
    """A p on the inner nodes, zero on the shell."""
    out = torch.zeros_like(p)
    o = out[1:-1, 1:-1, 1:-1]
    o.copy_(p[:-2, 1:-1, 1:-1])
    o += p[2:, 1:-1, 1:-1]
    o += p[1:-1, :-2, 1:-1]
    o += p[1:-1, 2:, 1:-1]
    o += p[1:-1, 1:-1, :-2]
    o += p[1:-1, 1:-1, 2:]
    o.sub_(p[1:-1, 1:-1, 1:-1], alpha=6.0)
    return out


def residual(x, b) -> float:
    """The true residual sqrt(sum (b - A x)^2 / N_inner) of a field, in
    float64: the quantity the solve's stopping test bounds by eps."""
    x, b = x.double(), b.double()
    r = (b - apply_a(x))[1:-1, 1:-1, 1:-1]
    return math.sqrt(float(torch.sum(r * r)) / r.numel())


def solve(x0, b, *, omega: float, itr_max: int, eps: float, precond: str,
          **_):
    """Returns (iterations, float64 residual history, field)."""
    relax = importlib.import_module(f".{precond}", __package__)

    def precon(v):
        return relax.sweeps(v, omega=omega, count=PRECOND_SWEEPS)

    def dot(p, q):
        return torch.sum(p * q)

    n_inner = math.prod(s - 2 for s in x0.shape)
    x = x0.clone()
    r = torch.zeros_like(x0)
    r[1:-1, 1:-1, 1:-1] = (b - apply_a(x0))[1:-1, 1:-1, 1:-1]
    r0 = r.clone()
    one = torch.ones((), dtype=x0.dtype, device=x0.device)
    rho_old, alpha, om = one, one * 0, one
    rho = dot(r, r0)
    p = q = None
    hist = []
    res = math.inf
    itr = 0
    n = max(int(itr_max) - 1, 1)
    while itr < n and (itr == 0 or res >= eps):
        if abs(float(rho)) < FLT_MIN:
            return 0, torch.tensor(hist, dtype=torch.float64), x
        if itr == 0:
            p = r.clone()
        else:
            beta = rho / rho_old * alpha / om
            p = r + beta * (p - om * q)
        p_ = precon(p)
        q = apply_a(p_)
        den = dot(q, r0)
        alpha = rho / torch.where(den.abs() < FLT_MIN, one, den)
        s = r - alpha * q
        s_ = precon(s)
        t_ = apply_a(s_)
        den = dot(t_, t_)
        om = dot(t_, s) / torch.where(den < FLT_MIN, one, den)
        x = x + alpha * p_ + om * s_
        r = s - om * t_
        res = math.sqrt(float(dot(r, r)) / n_inner)
        hist.append(res)
        rho_old, rho = rho, dot(r, r0)
        itr += 1
    return itr, torch.tensor(hist, dtype=torch.float64), x
