"""Top-level solve API (PyTorch port of ``cubez_tpu/solvers/api.py``; the
solver dispatch of CZ::Evaluate, cz_Evaluate.cpp:414-489).

    result = solve(Problem.poisson_cube(128, device="cuda"), "sor2sma",
                   omega=1.5, itr_max=10000)
    result = solve(Problem.poisson_cube(128, device="cuda"), "pcr_rb",
                   omega=1.5, itr_max=10000)
"""

from __future__ import annotations

from typing import Optional

from ..core.problem import Problem
from . import steps as steps_mod
from .driver import EPS_DEFAULT, SolveResult, run_iterative
from .fused_cache import get_fused_step

SOLVERS = steps_mod.ALL_SOLVERS
IMPLS = ("auto", "plain")


def solve(
    problem: Problem,
    solver: str,
    omega: float,
    itr_max: int,
    eps: float = EPS_DEFAULT,
    precond: Optional[str] = None,
    history_path: Optional[str] = None,
    impl: str = "auto",
    check_every: Optional[int] = None,
) -> SolveResult:
    """Solve ``problem`` with ``solver`` on the device its fields live on.

    ``impl``: 'auto' runs the kernel steps (solvers/fused_cache.py), whose
    wrappers launch the CUDA kernels for CUDA tensors and run the plain
    twins for CPU tensors; 'plain' runs the plain twins on any device
    (same builders, layout and iterations per call).  A ``_maf`` solver
    takes ``problem.mc`` (ValueError without it).  The kernels synthesize
    the standard mask from the indices, so a mask other than the standard
    one runs the plain unpacked sweep (ops/stencil.py, ops/maf.py, or the
    line twins with the mask): on the CPU or with 'plain', and on CUDA
    under 'auto' a NotImplementedError, since no masked kernel is ported.
    So does a line solver with fewer than two inner points along K, which
    has no kernel step (the JAX package's n = K - 2 < 2).  ``precond`` is
    accepted for signature parity and, as in the JAX package, unused by
    relaxation solvers.  ``check_every``: see driver.run_iterative;
    counts, histories and the returned field do not depend on it."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    kind, _ = steps_mod.require_ported(solver)
    mc = steps_mod.maf_coeffs(problem, solver)
    g = problem.grid
    step = pre = post = None
    if not problem.msk_is_standard():
        why = ("a non-standard mask needs a masked sweep; the kernels "
               "synthesize the standard mask from the indices and no masked "
               "kernel is ported")
    else:
        step = get_fused_step(kind, g, omega, mc=mc, plain=impl == "plain",
                              b_is_zero=problem.rhs_is_inner_zero())
        why = (f"'{solver}' has no kernel step at (K, I, J) = {g.shape_kij}: "
               "the line kernels need K - 2 >= 2")
    if step is not None:
        pre, post = step.pad, step.unpad
    elif problem.x0.is_cuda and impl == "auto":
        raise NotImplementedError(
            f"{why}; impl='plain' runs the plain PyTorch sweep")
    else:
        step = steps_mod.make_step(problem, solver, omega)
    result = run_iterative(
        step, problem.x0, problem.rhs, g.res_normal, itr_max, eps,
        check_every=check_every, pre=pre, post=post,
    )
    if history_path:
        result.write_history(history_path)
    return result
