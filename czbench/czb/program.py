"""The system under test: ``cubez_tpu_torch``'s public ``solve``.

The only file of the benchmark that imports the program.  The cell's
``Problem`` is made once; each solve hands the program the benchmark's own
start and right-hand side in place of the problem's, and runs the entry a
user calls, ``solvers.api.solve``, with no history file.
"""

from __future__ import annotations

import dataclasses

from .inputs import DTYPES


class Program:
    """``solve(x0, rhs, eps=None, itr_max=None) -> SolveResult`` of one
    configuration on an n^3 grid (``eps`` and ``itr_max`` stand for the
    configuration's in the warm-up)."""

    def __init__(self, config: dict, n: int, device):
        from cubez_tpu_torch.core.problem import Problem
        from cubez_tpu_torch.solvers.api import solve

        self.config = config
        self._solve = solve
        self.problem = Problem.poisson_cube(
            n, DTYPES[config["dtype"]], device=device)

    def solve(self, x0, rhs, eps=None, itr_max=None):
        c = self.config
        p = dataclasses.replace(self.problem, x0=x0, rhs=rhs)
        if itr_max is None:
            itr_max = c["itr_max"]
        return self._solve(p, c["solver"], omega=c["omega"], itr_max=itr_max,
                           eps=c["eps"] if eps is None else eps,
                           precond=c.get("precond"))
