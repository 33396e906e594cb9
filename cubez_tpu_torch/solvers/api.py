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
    result = solve(Problem.poisson_cube(128, device="cuda"), "mg",
                   omega=1.0, itr_max=100)
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.problem import Problem
from ..perf import spans
from . import steps as steps_mod
from .bicgstab import make_bicgstab
from .cg import make_cg
from .driver import EPS_DEFAULT, SolveResult, run_iterative
from .fused_cache import relaxation_route

SOLVERS = steps_mod.ALL_SOLVERS
IMPLS = ("auto", "plain")


def _initial_x(step, problem: Problem):
    """The solve's starting iterate: ``problem.x0``, or for a step with an
    ``fmg_init`` (full multigrid) the F-cycle from the RHS.  The F-cycle
    keeps x0's shell (the Dirichlet data of every level) and derives the
    interior from the RHS, so an x0 with an interior (a restart) raises
    ValueError instead of being thrown away; ``mg`` iterates from it."""
    init = getattr(step, "fmg_init", None)
    if init is None:
        return problem.x0
    if spans.wait(bool, torch.any(problem.x0 * problem.msk)):
        raise ValueError(
            "fmg derives its initial interior from the RHS and would "
            "discard this problem's x0 interior; use 'mg' to iterate "
            "from a custom or restarted x0"
        )
    return init(problem.rhs)


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

    The extensions (solvers/multigrid.py, solvers/direct.py) run the step
    of ``steps.make_step``, standard mask only: ``mg``, ``fmg`` and their
    ``_maf`` forms a V-cycle an iteration, the finest level on K4 (its
    plain twin with 'plain'), the rest plain torch; ``fd``/``fd_maf`` one
    direct solve an iteration (six FP32 matmuls).  ``fmg`` starts from its
    F-cycle (``_initial_x``).

    The Krylov drivers ``pbicgstab``/``pbicgstab_maf`` (solvers/
    bicgstab.py) and ``cg`` (solvers/cg.py) run their loop with one host
    sync an iteration; ``precond`` names the relaxation solver of their
    preconditioner (None or "none": none), which runs on the route this
    function gives that name, with the Krylov vector as b.  For the
    relaxation solvers ``precond`` is accepted for signature parity and,
    as in the JAX package, unused.  ``check_every``: see run_iterative;
    counts, histories and the returned field do not depend on it (the
    Krylov loops check every iteration).

    The solve is recorded (perf/spans.py) where a profiler records at this
    entry or it runs inside ``spans.recording()``: the root span
    ``cz.solve``, and ``cz.route`` over the route's making (the step,
    ``make_bicgstab``/``make_cg``, the initial iterate)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    kind, _ = steps_mod.parse_name(solver)
    steps_mod.maf_coeffs(problem, solver)  # a _maf name needs MafCoeffs
    rec = spans.begin(problem.x0.device)
    iters = None
    try:
        result = _solve(problem, solver, kind, omega, itr_max, eps, precond,
                        impl, check_every, rec)
        iters = result.iters
    finally:
        if rec is not None:
            spans.end(rec, iters)
    if history_path:
        result.write_history(history_path)
    return result


def _solve(problem, solver, kind, omega, itr_max, eps, precond, impl,
           check_every, rec):
    """``solve``'s route and run; ``rec`` the solve's Recorder or None."""
    g = problem.grid
    if rec is not None:
        rec.enter("cz.route")
    if kind in steps_mod.KRYLOV:
        if kind == "cg":
            run = make_cg(problem, omega, precond, impl)
        else:
            run = make_bicgstab(problem, solver, omega, precond, impl)
        if rec is not None:
            rec.exit()
        return run(problem.x0, problem.rhs, itr_max, eps, g.res_normal)
    step, pre, post = relaxation_route(problem, solver, omega, impl)
    x0 = _initial_x(step, problem)
    if rec is not None:
        rec.exit()
    return run_iterative(step, x0, problem.rhs, g.res_normal, itr_max, eps,
                         check_every=check_every, pre=pre, post=post)
