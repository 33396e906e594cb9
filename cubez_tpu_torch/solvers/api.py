"""Top-level solve API (PyTorch port of ``cubez_tpu/solvers/api.py``; the
solver dispatch of CZ::Evaluate, cz_Evaluate.cpp:414-489).

    result = solve(Problem.poisson_cube(128, device="cuda"), "sor2sma",
                   omega=1.5, itr_max=10000)
"""

from __future__ import annotations

from typing import Optional

from ..core.problem import Problem
from . import steps as steps_mod
from .driver import EPS_DEFAULT, SolveResult, run_iterative
from .fused_cache import get_fused_step, pad_unpad

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

    ``impl``: 'auto' runs the packed red-black steps, whose wrappers launch
    the CUDA kernels for CUDA tensors and run the plain twins for CPU
    tensors; 'plain' runs the plain twins on any device (same builders,
    layout and iterations per call).  Odd I, or a mask other than the
    standard one, needs the unpacked sweep: the plain one on the CPU or with
    'plain', and on CUDA under 'auto' a NotImplementedError, since its
    kernel (K4) is not ported.  ``precond`` is accepted for signature
    parity and, as in the JAX package, unused by relaxation solvers.
    ``check_every``: see driver.run_iterative; counts, histories and the
    returned field do not depend on it."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    kind, _ = steps_mod.require_ported(solver)
    g = problem.grid
    step = None
    if problem.msk_is_standard():
        step = get_fused_step(kind, g, omega, plain=impl == "plain",
                              b_is_zero=problem.rhs_is_inner_zero())
    if step is not None:
        pre, post = pad_unpad(kind, g, step)
    elif problem.x0.is_cuda and impl == "auto":
        raise NotImplementedError(
            "odd I or a non-standard mask needs the unpacked fused sweep, "
            "K4 (cubez_tpu/pallas_kernels/sweeps.py:416), which is not "
            "ported; impl='plain' runs the plain PyTorch sweep"
        )
    else:
        step = steps_mod.make_step(problem, solver, omega)
        pre = post = None
    result = run_iterative(
        step, problem.x0, problem.rhs, g.res_normal, itr_max, eps,
        check_every=check_every, pre=pre, post=post,
    )
    if history_path:
        result.write_history(history_path)
    return result
