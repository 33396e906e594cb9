"""cubez_tpu_torch: the PyTorch/CUDA port of cubez_tpu.

The same solver framework for the cube Poisson problem, on PyTorch tensors,
with the JAX package's Pallas kernels rewritten as CUDA kernels for the
NVIDIA H100 (csrc/).  This package imports torch and never jax; the JAX
package ``cubez_tpu`` beside it is the reference it is tested against.

    import cubez_tpu_torch as czt
    prob = czt.Problem.poisson_cube(128, device="cuda")
    r = czt.solve(prob, "sor2sma", omega=1.5, itr_max=10000)
    print(r.iters, r.res, czt.max_error(prob.grid, r.x))
"""

from .core.grid import Grid, max_error, max_error_loc
from .core.problem import Problem
from .solvers.api import SOLVERS, solve
from .solvers.driver import SolveResult

__all__ = [
    "Grid",
    "Problem",
    "SOLVERS",
    "SolveResult",
    "max_error",
    "max_error_loc",
    "solve",
]
