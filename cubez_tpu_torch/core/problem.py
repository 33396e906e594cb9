"""Problem setup: grid plus solution/RHS/mask fields and the MAF metric
coefficients (PyTorch port of ``cubez_tpu/core/problem.py``; the IC/BC
phase of CZ::Evaluate, cz_Evaluate.cpp:222-390).

There are no weights in this system: the fields are the state.
``Problem.from_arrays`` takes them as numpy arrays, and
``MafCoeffs.from_numpy`` the coefficients, so that the JAX package and the
port can be driven from the same data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.maf import MafCoeffs
from ..perf import spans
from .grid import Grid


@dataclasses.dataclass(frozen=True)
class Problem:
    grid: Grid
    x0: torch.Tensor
    rhs: torch.Tensor
    msk: torch.Tensor
    mc: Optional[MafCoeffs] = None
    # 1 / max |row coefficient| (MafCoeffs.pivot), for the MAF Krylov
    # solvers
    pvt: Optional[torch.Tensor] = None
    # True when rhs == 0 on every inner node (the reference Laplace problem):
    # the packed sweeps then skip the RHS entirely
    rhs_inner_zero: bool = False

    def rhs_is_inner_zero(self) -> bool:
        """The ``rhs_inner_zero`` hint, verified against the array (the flag
        survives ``dataclasses.replace(prob, rhs=...)`` unchanged)."""
        if not self.rhs_inner_zero:
            return False
        return not spans.wait(bool, torch.any(self.rhs * self.msk))

    def msk_is_standard(self) -> bool:
        """True when msk is the standard cube inner mask (1 inside, 0 on the
        boundary shell), the only mask the packed kernels synthesize.  The
        ones are counted in int64: a float32 count is inexact above 2^24."""
        m = self.msk
        if m is self.grid.inner_mask:
            return True
        inner = m[1:-1, 1:-1, 1:-1]
        return (
            spans.wait(bool, torch.all(inner == 1))
            and spans.wait(int, torch.count_nonzero(m)) == self.grid.num_inner
        )

    @classmethod
    def poisson_cube(cls, n, dtype=torch.float32, *, device,
                     maf: bool = False) -> "Problem":
        """The reference's problem: Laplace on the unit cube with the
        sin*sin K-face Dirichlet profile (cz_Evaluate.cpp:15-18,374-390).
        ``maf`` adds the metric coefficients of the uniform coordinates,
        which the ``_maf`` solvers need."""
        if isinstance(n, int):
            n = (n, n, n)
        ni, nj, nk = n
        grid = Grid(ni=ni, nj=nj, nk=nk, dtype=dtype, device=device)
        mc = pvt = None
        if maf:
            mc = MafCoeffs.from_coords(grid.xc, grid.yc, grid.zc)
            pvt = mc.pivot()
        return cls(
            grid=grid,
            x0=grid.initial_p(),
            rhs=grid.initial_rhs(),
            msk=grid.inner_mask,
            mc=mc,
            pvt=pvt,
            rhs_inner_zero=True,
        )

    @classmethod
    def manufactured_stretched(cls, n, dtype=torch.float64,
                               family: str = "relax", *, device):
        """Manufactured-solution Poisson problem on stretched tensor-product
        coordinates, the discretization test the reference's driver cannot
        run (it fills uniform coordinates only, cz_Evaluate.cpp:342-363).

        tanh clustering in x and z (two strengths) and a sinusoidal
        perturbation in y; exact solution u = sin(pi x) sin(pi y)
        sin(pi z), zero on every face, so -lap(u) = 3 pi^2 u.  ``family``
        picks the reference's RHS sign convention: "relax" (the point
        sweeps take ``rp + b``, cz_maf.f90:94-105, so b = 3 pi^2 u) or
        "krylov" (the line solvers and BiCGSTAB solve L x = b, so
        b = -3 pi^2 u).  Returns (problem, exact field)."""
        if isinstance(n, int):
            n = (n, n, n)
        ni, nj, nk = n

        def tanh_stretch(m, beta):
            t = np.linspace(0.0, 1.0, m)
            return 0.5 * (1.0 + np.tanh(beta * (2.0 * t - 1.0)) / np.tanh(beta))

        def sine_stretch(m, amp=0.08):
            t = np.linspace(0.0, 1.0, m)
            return t - amp * np.sin(2.0 * np.pi * t) / (2.0 * np.pi)

        xs = tanh_stretch(ni, 1.8)
        ys = sine_stretch(nj)
        zs = tanh_stretch(nk, 1.2)
        grid = Grid(
            ni=ni, nj=nj, nk=nk, dtype=dtype, device=device,
            coords_i=tuple(float(v) for v in xs),
            coords_j=tuple(float(v) for v in ys),
            coords_k=tuple(float(v) for v in zs),
        )
        mc = MafCoeffs.from_coords(grid.xc, grid.yc, grid.zc)
        u = (
            np.sin(np.pi * zs)[:, None, None]
            * np.sin(np.pi * xs)[None, :, None]
            * np.sin(np.pi * ys)[None, None, :]
        )
        b = 3.0 * np.pi**2 * u
        if family == "krylov":
            b = -b
        elif family != "relax":
            raise ValueError(f"unknown family {family!r}")
        msk = grid.inner_mask
        prob = cls(
            grid=grid,
            x0=torch.zeros(grid.shape_kij, dtype=dtype, device=grid.device),
            rhs=grid._tensor(b) * msk,
            msk=msk,
            mc=mc,
            pvt=mc.pivot(),
            rhs_inner_zero=False,
        )
        return prob, grid._tensor(u)

    @classmethod
    def from_arrays(cls, shape_kij, dtype, x0, rhs, msk=None,
                    rhs_inner_zero: bool = False, *, device, coords=None,
                    mc: Optional[MafCoeffs] = None) -> "Problem":
        """A problem on the grid of ``shape_kij`` = (K, I, J) from (K, I, J)
        numpy arrays, e.g. ``np.asarray(jax_problem.x0)``.  ``msk`` None
        means the standard inner mask.  ``coords`` = (along I, along J,
        along K) sets custom node coordinates; ``mc`` the MAF coefficients
        (``MafCoeffs.from_numpy`` carries the JAX package's across)."""
        nk, ni, nj = shape_kij
        cc = {}
        if coords is not None:
            cc = {f"coords_{a}": tuple(float(v) for v in np.asarray(c))
                  for a, c in zip("ijk", coords)}
        grid = Grid(ni=ni, nj=nj, nk=nk, dtype=dtype, device=device, **cc)

        def field(a):
            a = np.asarray(a)
            if a.shape != tuple(shape_kij):
                raise ValueError(f"field shape {a.shape} != {tuple(shape_kij)}")
            # a copy: the packed steps update state in place
            return torch.tensor(a, dtype=dtype, device=grid.device)

        return cls(
            grid=grid,
            x0=field(x0),
            rhs=field(rhs),
            msk=grid.inner_mask if msk is None else field(msk),
            mc=mc,
            pvt=None if mc is None else mc.pivot(),
            rhs_inner_zero=rhs_inner_zero,
        )
