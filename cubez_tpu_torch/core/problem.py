"""Problem setup: grid plus solution/RHS/mask fields (PyTorch port of
``cubez_tpu/core/problem.py``; the IC/BC phase of CZ::Evaluate,
cz_Evaluate.cpp:222-390).

There are no weights in this system: the fields are the state.
``Problem.from_arrays`` takes them as numpy arrays so that the JAX package
and the port can be driven from the same fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .grid import Grid


@dataclasses.dataclass(frozen=True)
class Problem:
    grid: Grid
    x0: torch.Tensor
    rhs: torch.Tensor
    msk: torch.Tensor
    # True when rhs == 0 on every inner node (the reference Laplace problem):
    # the packed sweeps then skip the RHS entirely
    rhs_inner_zero: bool = False

    def rhs_is_inner_zero(self) -> bool:
        """The ``rhs_inner_zero`` hint, verified against the array (the flag
        survives ``dataclasses.replace(prob, rhs=...)`` unchanged)."""
        if not self.rhs_inner_zero:
            return False
        return not bool(torch.any(self.rhs * self.msk))

    def msk_is_standard(self) -> bool:
        """True when msk is the standard cube inner mask (1 inside, 0 on the
        boundary shell), the only mask the packed kernels synthesize.  The
        ones are counted in int64: a float32 count is inexact above 2^24."""
        m = self.msk
        if m is self.grid.inner_mask:
            return True
        inner = m[1:-1, 1:-1, 1:-1]
        return (
            bool(torch.all(inner == 1))
            and int(torch.count_nonzero(m)) == self.grid.num_inner
        )

    @classmethod
    def poisson_cube(cls, n, dtype=torch.float32, *, device,
                     maf: bool = False) -> "Problem":
        """The reference's problem: Laplace on the unit cube with the
        sin*sin K-face Dirichlet profile (cz_Evaluate.cpp:15-18,374-390)."""
        if maf:
            raise NotImplementedError(
                "MAF coefficients are slice 2 of the port (ROADMAP.md)"
            )
        if isinstance(n, int):
            n = (n, n, n)
        ni, nj, nk = n
        grid = Grid(ni=ni, nj=nj, nk=nk, dtype=dtype, device=device)
        return cls(
            grid=grid,
            x0=grid.initial_p(),
            rhs=grid.initial_rhs(),
            msk=grid.inner_mask,
            rhs_inner_zero=True,
        )

    @classmethod
    def from_arrays(cls, shape_kij, dtype, x0, rhs, msk=None,
                    rhs_inner_zero: bool = False, *, device) -> "Problem":
        """A problem on the unit-cube grid of ``shape_kij`` = (K, I, J) from
        (K, I, J) numpy arrays, e.g. ``np.asarray(jax_problem.x0)``.  ``msk``
        None means the standard inner mask."""
        nk, ni, nj = shape_kij
        grid = Grid(ni=ni, nj=nj, nk=nk, dtype=dtype, device=device)

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
            rhs_inner_zero=rhs_inner_zero,
        )
