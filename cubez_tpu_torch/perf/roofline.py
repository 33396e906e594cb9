"""Analytic per-kernel cost model (PyTorch port of
``cubez_tpu/perf/roofline.py``): flop and byte counts for roofline checks.

The point kernels and BLAS keep the JAX package's constants, which mirror
the reference's in-kernel flop accounting (jacobi/psor 18:
cz_solver.f90:238-241,315-318; sor2sma 18 per full RB pair:
cz_solver.f90:438-441; calc_ax 13 / calc_rk 14: cz_blas.f90:607-610,
686-689; triad 2 / dot 2 / bicg_1 4 / bicg_2 4: cz_blas.f90:278,341,407,
471,536; MAF point kernels 66: cz_maf.f90:50-53; PCR: cz_solver.f90:523-530,
694-701).

The line kinds depart from the JAX package, whose count is a dense T^-1
matmul on the TPU's MXU (2 Kp flops a point, doubled for MAF).  The port's
kernels do no such product; the count is what they do:

* Thomas (``thomas_flops_per_pt``): K5 (rblines.cu), K6 (lines.cu) and
  K9's 'fastdiag' form (dist_pcr.cu) run line_tile.cuh's shared-memory
  Thomas tile: the serial line solvers pcr_rb, pcr_rb_esa, pcr_j_esa and
  their MAF forms, and the distributed ones on K-unsplit meshes.
* PCR (``pcr_flops_per_pt``, the reference's count): P2 (pcr_gs.cu, the
  exact serial pcr, pcr_eda, pcr_esa), K9's 'pcr' form and K10
  (pcr_warp.cuh, pcr.cuh), and parallel/dist.py's block lines
  (ops/pcr.py::pcr_reduce_var).

Each add, multiply and division counts one operation.  Byte counts stay
the JAX package's: the minimal HBM traffic of an ideally fused kernel
(streams touched, one read or write each: x read + x written [+ b read]),
so %SoL is meaningful against them.
"""

from __future__ import annotations

import dataclasses
import math

from ..solvers.steps import parse_name


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops_per_pt: float
    streams: float  # HBM passes over the N^3 field (reads + writes)

    def flops(self, npts: int) -> float:
        return self.flops_per_pt * npts

    def bytes(self, npts: int, itemsize: int = 4) -> float:
        return self.streams * npts * itemsize


def pcr_flops_per_pt(n: int) -> float:
    """Full-plane PCR per line point (pcr, cz_solver.f90:694-701)."""
    pn = 1
    while (1 << pn) <= n:
        pn += 1
    return 6 + 14 * max(pn - 2, 0) + 74 * (2 ** max(pn - 2, 0)) / n + 6 + 6


def thomas_flops_per_pt(n: int, maf: bool = False, has_b: bool = True) -> float:
    """Operations a point of line_tile.cuh's Thomas relaxation (n inner
    rows a line).  Constant coefficients: the right-hand side 3 adds and a
    multiply (a subtract more with b), the forward step 3, the backward
    step 2, the relaxation 3 (dp = (s - x) omega, x + dp), dp^2 into the
    sum 2: 14; a line's two Dirichlet folds 4 more.  MAF: the right-hand
    side 7, the factor chain m_k, q_k, e_k 6 (one a division), the forward
    step 3, the rest as above: 23; a line's folds and its c1_i + c2_j 5
    more."""
    per = (23.0 if maf else 14.0) + (1.0 if has_b else 0.0)
    return per + (5.0 if maf else 4.0) / max(n, 1)


# streams: fused-kernel ideal (x read + x write [+ b read])
COSTS = {
    "jacobi": KernelCost(18, 3),
    "jacobi_b0": KernelCost(18, 2),
    "psor": KernelCost(18, 3),
    "sor2sma": KernelCost(18, 3),      # both colors fused: read x, b; write x
    "sor2sma_b0": KernelCost(18, 2),
    "jacobi_maf": KernelCost(66, 3),
    "psor_maf": KernelCost(66, 3),
    "sor2sma_maf": KernelCost(66, 3),
    "calc_ax": KernelCost(13, 3),
    "calc_rk": KernelCost(14, 4),
    "calc_ax_maf": KernelCost(63, 3),
    "calc_rk_maf": KernelCost(63, 4),
    "dot1": KernelCost(2, 1),
    "dot2": KernelCost(2, 2),
    "triad": KernelCost(2, 3),
    "bicg_1": KernelCost(4, 4),
    "bicg_2": KernelCost(4, 4),
}

LINE_FORMS = ("thomas", "pcr")


def line_form(name: str) -> str:
    """The line algorithm of the serial route for a line solver name:
    'pcr' for the exact serial orders pcr, pcr_eda, pcr_esa (P2), else
    'thomas' (K5, K6)."""
    kind, _ = parse_name(name)
    return "pcr" if kind == "pcr_gs" else "thomas"


def sweep_cost(name: str, shape, itemsize: int = 4, b_is_zero: bool = False,
               form: str | None = None, line_n: int | None = None):
    """(flops, bytes) for one sweep of ``name`` over grid ``shape``.

    A line solver name counts its kernel's operations (module docstring):
    ``form`` 'thomas' or 'pcr' (default: the serial route's,
    ``line_form``), over lines of ``line_n`` inner rows (default the
    shape's K - 2; a distributed route passes its block lines')."""
    key = name
    if b_is_zero and f"{name}_b0" in COSTS:
        key = f"{name}_b0"
    npts = math.prod(shape)
    if key not in COSTS and name.startswith("pcr"):
        form = form or line_form(name)
        if form not in LINE_FORMS:
            raise ValueError(f"form must be one of {LINE_FORMS}, not {form!r}")
        n = shape[0] - 2 if line_n is None else line_n
        if form == "thomas":
            per_pt = thomas_flops_per_pt(n, name.endswith("_maf"), not b_is_zero)
        else:
            per_pt = pcr_flops_per_pt(n)
        streams = 2 if b_is_zero else 3  # kernels skip the zero-RHS stream
        return per_pt * npts, streams * npts * itemsize
    c = COSTS[key]
    return c.flops(npts), c.bytes(npts, itemsize)
