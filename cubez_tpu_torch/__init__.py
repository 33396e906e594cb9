"""cubez_tpu_torch: the PyTorch/CUDA port of cubez_tpu.

The same solver framework for the cube Poisson problem, on PyTorch tensors,
with the JAX package's Pallas kernels rewritten as CUDA kernels for the
NVIDIA H100 (csrc/).  This package imports torch and never jax; the JAX
package ``cubez_tpu`` beside it is the reference it is tested against.

    import cubez_tpu_torch as czt
    prob = czt.Problem.poisson_cube(128, device="cuda")
    r = czt.solve(prob, "sor2sma", omega=1.5, itr_max=10000)
    print(r.iters, r.res, czt.max_error(prob.grid, r.x))

    # the same solve over a (2, 2, 2) block mesh, eight blocks on one card
    cm = czt.make_mesh(prob.grid.shape_kij, devices=["cuda:0"] * 8)
    r = czt.solve_dist(prob, cm, "sor2sma", omega=1.5, itr_max=10000)

    # the PMlib-style profile of the solve's step (the CLI's --profile)
    from cubez_tpu_torch.perf.profile import profile_solve
    print(profile_solve(prob, "sor2sma", omega=1.5).report())
"""

from .core.grid import Grid, max_error, max_error_loc
from .core.problem import Problem
from .parallel import CubeMesh, make_mesh, solve_dist
from .solvers.api import SOLVERS, solve
from .solvers.driver import EPS_DEFAULT, SolveResult

__version__ = "0.3.0"

__all__ = [
    "CubeMesh",
    "EPS_DEFAULT",
    "Grid",
    "Problem",
    "SOLVERS",
    "SolveResult",
    "max_error",
    "make_mesh",
    "max_error_loc",
    "solve",
    "solve_dist",
    "__version__",
]
