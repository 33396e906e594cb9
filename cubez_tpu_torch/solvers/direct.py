"""Fast-diagonalization direct solver, solver names ``fd`` and ``fd_maf``
(PyTorch port of ``_axis_tables`` and ``make_fd_step`` of
``cubez_tpu/solvers/direct.py``; an extension beyond the reference).

The cube operator is a separable Kronecker sum for both coefficient
families: constant (A x = sum(nbr) - 6 x, so -A = Dz (+) Dx (+) Dy with
D = tridiag(-1, 2, -1) an axis) and MAF (M = Dz (+) Dx (+) Dy with
Dz = tridiag(-wzm, 2 c3, -wzp), and so on).  Each axis is diagonalized
once a step, on the host in float64, and the whole cube solves as

    e = Vz Vx Vy [ (Vy^-1 Vx^-1 Vz^-1 r) / (mu_z + mu_x + mu_y) ]

six dense contractions, here six ``torch.matmul`` calls (the JAX package
computes them with ``jnp.einsum`` at HIGHEST precision outside any Pallas
kernel).  In float32 they run in IEEE FP32: TF32 is held off inside the
step and the caller's setting restored after it.

One iteration of the driver is one direct solve applied as iterative
refinement (x += M^-1 (b - M x)); it stops on the omega = 1
Jacobi-equivalent update, as mg does, summed in float64.

The JAX package's ``make_dist_minv``, the all-to-all transpose pipeline of
a sharded solve, is not ported: ``solve_dist`` runs this serial step on
the gathered field.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.grid import Grid
from ..ops import blas
from ..ops.fastdiag import tridiag_eig


def _axis_tables(grid: Grid, mc):
    """(V, Vinv, mu) for the (K, I, J) inner extents, float64 numpy.

    Constant: D = tridiag(-1, 2, -1) (so M = -A).  MAF: the per-axis
    tridiagonals of the separable metric operator from c3/c9, c1/c7 and
    c2/c8.  ValueError where a MAF coefficient is not a per-axis 1D table
    of n + 2 entries (a non-separable operator)."""
    nk, ni, nj = grid.nk - 2, grid.ni - 2, grid.nj - 2
    if mc is None:
        return [tridiag_eig(np.full(n - 1, -1.0), np.full(n, 2.0),
                            np.full(n - 1, -1.0)) for n in (nk, ni, nj)]

    def w(c_lo, c_hi, n, axis):
        c = np.asarray(c_lo.detach().cpu(), np.float64).reshape(-1)
        g = np.asarray(c_hi.detach().cpu(), np.float64).reshape(-1)
        if c.size != n + 2 or g.size != n + 2:
            raise ValueError(
                f"fd_maf needs per-axis 1D metric tables; axis {axis} "
                f"coefficient has {c.size} entries, expected {n + 2} — "
                f"a non-separable MafCoeffs cannot be fast-diagonalized"
            )
        c, g = c[1:n + 1], g[1:n + 1]
        wm = c - 0.5 * g  # weight toward the index - 1 neighbour
        wp = c + 0.5 * g  # weight toward the index + 1 neighbour
        return tridiag_eig(-wm[1:], 2.0 * c, -wp[:-1])

    return [w(mc.c3, mc.c9, nk, "K"), w(mc.c1, mc.c7, ni, "I"),
            w(mc.c2, mc.c8, nj, "J")]


@contextlib.contextmanager
def ieee_fp32():
    """CUDA float32 matmuls in IEEE FP32 (no TF32) inside; the caller's
    setting, whether made with ``torch.set_float32_matmul_precision`` or
    the backend's flags, is restored on the way out."""
    mm = torch.backends.cuda.matmul
    old = mm.fp32_precision
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = old


def minv(r, tabs):
    """M^-1 r on the inner (n0, n1, n2) grid: each axis into mode space
    (V^-1), the division by the eigenvalue sums, and back (V).  ``tabs``:
    ((Vz, Vzi, muz), (Vx, Vxi, mux), (Vy, Vyi, muy)) in r's dtype and on
    its device.  Call under :func:`ieee_fp32`."""
    (Vz, Vzi, muz), (Vx, Vxi, mux), (Vy, Vyi, muy) = tabs
    n0, n1, n2 = r.shape
    u = (Vzi @ r.reshape(n0, n1 * n2)).reshape(n0, n1, n2)
    u = Vxi @ u
    u = u @ Vyi.T
    u = u / (muz[:, None, None] + mux[None, :, None] + muy[None, None, :])
    u = u @ Vy.T
    u = Vx @ u
    return (Vz @ u.reshape(n0, n1 * n2)).reshape(n0, n1, n2)


def make_fd_step(problem, maf: bool = False):
    """``step(x, b) -> (x_new, r2)``: one direct solve applied as iterative
    refinement, and the float64 sum of the squared Jacobi-equivalent
    update (``rn / 6``, MAF ``rn / dd``).  x is only read.  The problem's
    mask must be the standard one (steps.make_step checks it)."""
    g = problem.grid
    mc = problem.mc if maf else None
    if maf and mc is None:
        raise ValueError("fd_maf requested but Problem has no MafCoeffs")
    dt, dev = g.dtype, problem.x0.device
    msk = problem.msk
    tabs = [tuple(torch.tensor(a, dtype=dt, device=dev) for a in t)
            for t in _axis_tables(g, mc)]
    inner = (slice(1, -1),) * 3
    r6 = torch.tensor(1.0 / 6.0, dtype=dt, device=dev)
    # r = b - M_sign A x: constant A e = r with A = -M, so e = -M^-1 r;
    # MAF M e = r
    sgn = torch.tensor(1.0 if maf else -1.0, dtype=dt, device=dev)

    if maf:
        dd = mc.dd

        def residual(x, b):
            return (b - (dd * x - mc.nbr_weighted(x))) * msk
    else:
        def residual(x, b):
            return blas.calc_rk(x, b, msk)

    def step(x, b):
        r = residual(x, b)
        with ieee_fp32():
            e = sgn * minv(r[inner], tabs)
        x = x.clone()
        x[inner] += e
        rn = residual(x, b)
        rn = rn / dd if maf else rn * r6
        return x, (rn * rn).sum(dtype=torch.float64)

    # each iteration is a whole direct solve (it stops after one or two)
    step.check_every_default = 1
    return step
