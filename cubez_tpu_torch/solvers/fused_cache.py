"""Dispatch to the kernel steps (PyTorch port of
``cubez_tpu/solvers/fused_cache.py``).

The JAX package caches built steps because a rebuilt closure forces a jit
re-trace; PyTorch runs eagerly and the kernel library is loaded once, so
building a step is cheap and nothing is cached here.
"""

from __future__ import annotations

from ..cuda_kernels import lines, rblines, rbpack, sweeps
from ..ops.pcr_gs import make_pcr_gs_diag_step
from ..ops.psor_scan import make_psor_diag_step
from . import steps as steps_mod


def get_fused_step(kind: str, grid, omega: float, mc=None,
                   plain: bool = False, b_is_zero: bool = False):
    """The kernel step for ``kind`` in the JAX package's order, or None
    where no kernel step exists (a line solver with K - 2 < 2).

    sor2sma: with a zero RHS the packed n-window chain at
    ``rbpack.chain_depth`` (6 on the row passes, 2 on the one-pass tiles
    where ``rbpack.TILE_BYTES`` puts them; constant coefficients and MAF
    alike: the JAX package kept MAF on the pair, but on the H100 the MAF
    chain beat the pair), else the packed pair with a streamed b, else the packed
    single sweep, and where the packed layout refuses (odd I) the unpacked
    sweep K4.  jacobi: K4.  pcr_rb: the packed line step K5, and where its
    layout refuses (odd I) K6's red-black form.  pcr (pcr_j_esa): K6's
    line-Jacobi form.  psor: kernel P1, pcr_gs (pcr, pcr_eda, pcr_esa):
    kernel P2, one launch a sweep on the diagonal layout (they always read
    b).  ``mc`` selects the MAF forms.  ``plain`` makes the step run the
    plain twins on any device; otherwise the kernels run for CUDA tensors.
    Every step carries ``pad``/``unpad``, the converters to and from its
    state layout (the packed colour folds, K4's and K6's copy, or the
    diagonal skew)."""
    shape, dtype = grid.shape_kij, grid.dtype
    kw = dict(omega=omega, mc=mc, plain=plain)
    if kind == "psor":
        return make_psor_diag_step(shape, dtype, **kw)
    if kind == "pcr_gs":
        return make_pcr_gs_diag_step(shape, dtype, **kw)
    if kind == "jacobi":
        return sweeps.make_fused_sweep(kind, shape, dtype, b_is_zero=b_is_zero,
                                       **kw)
    if kind in ("pcr", "pcr_rb"):
        step = None
        if kind == "pcr_rb":
            step = rblines.make_rbl_step(shape, dtype, b_is_zero=b_is_zero, **kw)
        if step is None:
            step = lines.make_line_step("pcr_j" if kind == "pcr" else "pcr_rb",
                                        shape, dtype, b_is_zero=b_is_zero, **kw)
        return step
    if kind != "sor2sma":
        raise NotImplementedError(f"no kernel step for '{kind}'")
    step = None
    if b_is_zero:
        step = rbpack.make_packed_sweepnx(
            shape, dtype, n=rbpack.chain_depth(shape, dtype, mc is not None),
            **kw)
    if step is None:
        step = rbpack.make_packed_sweep2x(shape, dtype, b_is_zero=b_is_zero,
                                          **kw)
    if step is None:
        step = rbpack.make_packed_sweep(shape, dtype, b_is_zero=b_is_zero,
                                        **kw)
    if step is None:
        step = sweeps.make_fused_sweep(kind, shape, dtype,
                                       b_is_zero=b_is_zero, **kw)
    return step


def relaxation_route(problem, solver: str, omega: float, impl: str = "auto",
                     b_arg_is_problem_rhs: bool = True):
    """``(step, pre, post)`` of the serial step ``solve`` runs for a
    relaxation, line or extension solver name, and the preconditioners
    for theirs: with the standard mask the kernel step of
    ``get_fused_step`` with its ``pad``/``unpad``; otherwise, and where no
    kernel step exists (a line solver with K - 2 < 2), the plain unpacked
    sweep of ``steps.make_step`` (pre and post None); for the extensions
    (mg, fmg, fd) ``steps.make_step``'s step.  ``impl`` 'plain' runs the
    twins.  ``b_arg_is_problem_rhs`` False (a preconditioner, driven with
    Krylov vectors as b) keeps the steps from skipping a zero b.  The step
    carries the solver's name as its profiler label (``steps.labeled``).
    ``perf.profile.profile_solve`` times the step this returns."""
    kind, _ = steps_mod.parse_name(solver)
    plain = impl == "plain"
    pre = post = step = None
    if kind in steps_mod.EXTENSIONS:
        step = steps_mod.make_step(problem, solver, omega, plain=plain,
                                   b_arg_is_problem_rhs=b_arg_is_problem_rhs)
    else:
        if problem.msk_is_standard():
            step = get_fused_step(
                kind, problem.grid, omega,
                mc=steps_mod.maf_coeffs(problem, solver), plain=plain,
                b_is_zero=b_arg_is_problem_rhs and problem.rhs_is_inner_zero())
        if step is not None:
            pre, post = step.pad, step.unpad
        else:
            step = steps_mod.make_step(problem, solver, omega)
    return steps_mod.labeled(solver, step), pre, post
