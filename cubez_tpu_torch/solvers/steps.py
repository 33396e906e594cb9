"""Solver names and per-iteration steps (PyTorch port of
``cubez_tpu/solvers/steps.py``).

The name registry is the JAX package's, verbatim (solver-name parity with
the reference CLI, cz_Evaluate.cpp:684-803).  This port runs ``sor2sma``,
``jacobi``, the line solvers of kinds ``pcr_rb`` (``pcr_rb``,
``pcr_rb_esa``) and ``pcr`` (``pcr_j_esa``), and their ``_maf`` forms, and
the Krylov drivers ``pbicgstab``, ``pbicgstab_maf`` (solvers/bicgstab.py)
and ``cg`` (solvers/cg.py) with those sweeps as preconditioners; every
other solver, as a solver or a preconditioner, raises
``NotImplementedError`` naming the slice of ROADMAP.md that brings it.
"""

from __future__ import annotations

from ..core.problem import Problem
from ..cuda_kernels import lines
from ..cuda_kernels.rbpack import maf_tables
from ..ops import maf as maf_ops
from ..ops import stencil

# canonical kind per CLI solver name (see cubez_tpu/solvers/steps.py for
# the evidence behind each mapping)
_CANON = {
    "jacobi": "jacobi",
    "psor": "psor",
    "sor2sma": "sor2sma",
    "pcr": "pcr_gs",
    "pcr_eda": "pcr_gs",
    "pcr_esa": "pcr_gs",
    "pcr_j_esa": "pcr",
    "pcr_rb": "pcr_rb",
    "pcr_rb_esa": "pcr_rb",
}

RELAX_SOLVERS = tuple(_CANON)
ALL_SOLVERS = RELAX_SOLVERS + tuple(
    f"{k}_maf" for k in _CANON if k != "pcr_j_esa"
) + ("pbicgstab", "pbicgstab_maf")
# beyond-reference extensions; kept out of ALL_SOLVERS, which is the
# reference-parity registry
EXTENSION_SOLVERS = ("mg", "mg_maf", "fmg", "fmg_maf", "fd", "fd_maf", "cg")

# where each solver kind lands in ROADMAP.md's queue of slices
_SLICE = {
    "psor": "slice 6 (exact serial orders)",
    "pcr_gs": "slice 6 (exact serial orders)",
    "mg": "slice 7 (extensions)",
    "fmg": "slice 7 (extensions)",
    "fd": "slice 7 (extensions)",
}


def parse_name(name: str):
    n = name.lower()
    is_maf = n.endswith("_maf")
    base = n[: -len("_maf")] if is_maf else n
    if base == "pbicgstab":
        return "pbicgstab", is_maf
    if base == "cg":
        return "cg", is_maf
    if base in ("mg", "fmg", "fd"):
        return base, is_maf
    if base not in _CANON:
        raise ValueError(
            f"unknown solver '{name}' (known: "
            f"{', '.join(ALL_SOLVERS + EXTENSION_SOLVERS)})"
        )
    return _CANON[base], is_maf


# the Krylov drivers: solvers, never sweeps
KRYLOV = ("pbicgstab", "cg")
PORTED = ("sor2sma", "jacobi", "pcr", "pcr_rb") + KRYLOV


def require_ported(name: str):
    """(kind, is_maf) for a solver this port runs; NotImplementedError
    naming its slice for any other."""
    kind, is_maf = parse_name(name)
    if kind in PORTED:
        return kind, is_maf
    raise NotImplementedError(
        f"solver '{name}' is not ported to PyTorch yet: {_SLICE[kind]} of "
        "ROADMAP.md"
    )


def maf_coeffs(problem: Problem, name: str):
    """The problem's MafCoeffs for a ``_maf`` solver name, None for the
    others; ValueError when a ``_maf`` name meets a problem without them
    (as the JAX package's make_step raises)."""
    _, is_maf = parse_name(name)
    if not is_maf:
        return None
    if problem.mc is None:
        raise ValueError("MAF solver requested but Problem has no MafCoeffs")
    return problem.mc


def make_step(problem: Problem, name: str, omega: float):
    """``step(x, b) -> (x_new, r2)`` on the unpacked (K, I, J) layout: the
    plain masked sweep of ops/stencil.py or ops/maf.py, or the line twins
    of cuda_kernels/lines.py with the mask.  It carries the problem's own
    mask, so it also serves masks other than the standard one; x is never
    written.  ValueError for the Krylov drivers, which are not sweeps."""
    kind, _ = require_ported(name)
    if kind == "pbicgstab":
        raise ValueError("pbicgstab is a driver, not a sweep; see bicgstab.py")
    if kind == "cg":
        raise ValueError("cg is a driver, not a sweep; see cg.py")
    mc = maf_coeffs(problem, name)
    g = problem.grid
    msk = problem.msk
    if kind == "pcr":
        tab = maf_tables(mc, g.shape_kij, g.dtype)
        return lambda x, b: lines.line_j_plain(x, b, omega, tab, msk)
    if kind == "pcr_rb":
        tab = maf_tables(mc, g.shape_kij, g.dtype)

        def pcr_rb_step(x, b):
            x = x.clone()
            return x, lines.line_rb_plain(x, b, omega, 0, tab, msk)

        return pcr_rb_step
    if kind == "jacobi":
        if mc is not None:
            return lambda x, b: maf_ops.jacobi_maf_sweep(x, b, msk, omega, mc)
        return lambda x, b: stencil.jacobi_sweep(x, b, msk, omega)
    cmasks = stencil.color_masks(g.shape_kij, 0, g.dtype, g.device)
    if mc is not None:
        return lambda x, b: maf_ops.sor2sma_maf_sweep(x, b, msk, omega, mc,
                                                      cmasks)
    return lambda x, b: stencil.sor2sma_sweep(x, b, msk, omega, cmasks)
