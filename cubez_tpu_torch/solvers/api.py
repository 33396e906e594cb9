"""Top-level solve API (PyTorch port of ``cubez_tpu/solvers/api.py``; the
solver dispatch of CZ::Evaluate, cz_Evaluate.cpp:414-489).

    result = solve(Problem.poisson_cube(128, device="cuda"), "sor2sma",
                   omega=1.5, itr_max=10000)
    result = solve(Problem.poisson_cube(128, device="cuda"), "pcr_rb",
                   omega=1.5, itr_max=10000)
    result = solve(Problem.poisson_cube(256, device="cuda"), "pbicgstab",
                   omega=1.1, itr_max=4000, precond="sor2sma")
    result = solve(Problem.poisson_cube(128, device="cuda"), "psor",
                   omega=1.1, itr_max=10000)
"""

from __future__ import annotations

from typing import Optional

from ..core.problem import Problem
from . import steps as steps_mod
from .bicgstab import make_bicgstab
from .cg import make_cg
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
    takes ``problem.mc`` (ValueError without it).  Two configurations have
    no kernel step, and run the plain unpacked sweep of steps.make_step
    (ops/stencil.py, ops/maf.py, or the line twins with the mask) on the
    fields' device under either ``impl``, as the JAX package runs its jnp
    step for them (its get_jnp_step): a mask other than the standard one
    (the kernels synthesize the standard mask from the indices), and a
    line solver with fewer than two inner points along K (the JAX
    package's n = K - 2 < 2, where no tiling fits).  The exact serial
    orders (psor, pcr, pcr_eda, pcr_esa and their MAF forms) take the
    standard mask only and raise ValueError for another, as the JAX
    package's steps do; with it they run kernels P1 and P2 on the diagonal
    layout, one launch a sweep and a host check a sweep.  The route is
    chosen from the configuration before anything launches, never on a
    kernel's failure: a CUDA kernel that fails to build or launch raises.
    The kernels' launch counters show that none ran.

    The Krylov drivers ``pbicgstab``/``pbicgstab_maf`` (solvers/
    bicgstab.py) and ``cg`` (solvers/cg.py) run their loop with one host
    sync an iteration; ``precond`` names the relaxation solver of their
    preconditioner (None or "none": none), which runs on the route this
    function gives that name, with the Krylov vector as b.  For the
    relaxation solvers ``precond`` is accepted for signature parity and,
    as in the JAX package, unused.  ``check_every``: see run_iterative;
    counts, histories and the returned field do not depend on it (the
    Krylov loops check every iteration)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    kind, _ = steps_mod.require_ported(solver)
    mc = steps_mod.maf_coeffs(problem, solver)
    g = problem.grid
    if kind in steps_mod.KRYLOV:
        if kind == "cg":
            run = make_cg(problem, omega, precond, impl)
        else:
            run = make_bicgstab(problem, solver, omega, precond, impl)
        result = run(problem.x0, problem.rhs, itr_max, eps, g.res_normal)
    else:
        step = pre = post = None
        if problem.msk_is_standard():
            step = get_fused_step(kind, g, omega, mc=mc, plain=impl == "plain",
                                  b_is_zero=problem.rhs_is_inner_zero())
        if step is not None:
            pre, post = step.pad, step.unpad
        else:
            step = steps_mod.make_step(problem, solver, omega)
        result = run_iterative(
            step, problem.x0, problem.rhs, g.res_normal, itr_max, eps,
            check_every=check_every, pre=pre, post=post,
        )
    if history_path:
        result.write_history(history_path)
    return result
