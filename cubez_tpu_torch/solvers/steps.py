"""Solver names and per-iteration steps (PyTorch port of
``cubez_tpu/solvers/steps.py``).

The name registry is the JAX package's, verbatim (solver-name parity with
the reference CLI, cz_Evaluate.cpp:684-803).  This port runs ``sor2sma``;
every other solver raises ``NotImplementedError`` naming the slice of
ROADMAP.md that brings it.
"""

from __future__ import annotations

from ..core.problem import Problem
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
    "jacobi": "slice 3 (jacobi)",
    "pbicgstab": "slice 4 (Krylov)",
    "cg": "slice 4 (Krylov)",
    "pcr": "slice 5 (line solvers)",
    "pcr_rb": "slice 5 (line solvers)",
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


def require_ported(name: str):
    """(kind, is_maf) for a solver this port runs; NotImplementedError
    naming its slice for any other."""
    kind, is_maf = parse_name(name)
    if kind == "sor2sma" and is_maf:
        where = "slice 2 (MAF)"
    elif kind != "sor2sma":
        where = _SLICE[kind]
    else:
        return kind, is_maf
    raise NotImplementedError(
        f"solver '{name}' is not ported to PyTorch yet: {where} of ROADMAP.md"
    )


def make_step(problem: Problem, name: str, omega: float):
    """``step(x, b) -> (x_new, r2)`` on the unpacked (K, I, J) layout: the
    plain masked red-black sweep (ops/stencil.py).  It carries the
    problem's own mask, so it also serves masks other than the standard
    one."""
    require_ported(name)
    g = problem.grid
    cmasks = stencil.color_masks(g.shape_kij, 0, g.dtype, g.device)
    msk = problem.msk
    return lambda x, b: stencil.sor2sma_sweep(x, b, msk, omega, cmasks)
