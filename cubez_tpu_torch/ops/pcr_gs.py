"""Lexicographic line Gauss-Seidel on the diagonal layout, the reference's
pcr, pcr_eda and pcr_esa (PyTorch port of ``cubez_tpu/ops/pcr_gs.py``).

The reference's full-plane pcr relaxes each K-line in place inside the
lexicographic (j, i) loop (cz_solver.f90:848-856), so its serial
semantics are line Gauss-Seidel.  Line (i, j) reads lines (i - 1, j) and
(i, j - 1), new, on diagonal i + j - 1, and (i + 1, j), (i, j + 1), old, on
diagonal i + j + 1: the diagonal wavefront of ops/psor_scan.py, one level
up.  A sweep walks the diagonals of the skewed layout S[d, k, i] =
X[k, i, d - i] in order and solves each diagonal's lines as one batch by
parallel cyclic reduction: K10's table-driven solve
(cuda_kernels/pcr.py::build_tables, ``pcr_solve``) for constant
coefficients, ``ops/pcr.py::pcr_reduce_var`` under MAF.  The right-hand
sides are the JAX step's (pcr_gs.py:90-114 there; csrc/pcr_gs.cu states
them): the transverse sum ((x[i-1] + x[j-1]) + x[i+1]) + x[j+1] (MAF:
((wxp x[i+1] + wxm x[i-1]) + wyp x[j+1]) + wym x[j-1]), minus b, the
Dirichlet values folded into both ends.

``pcr_gs_diag_plain`` is the plain twin of kernel P2 (csrc/pcr_gs.cu,
cuda_kernels/pcr_gs.py), bitwise equal to it; the JAX package's PCR plan
and XLA's contractions round otherwise, so the JAX step is held within a
band, and the counts exactly.
"""

from __future__ import annotations

import torch

from ..cuda_kernels.pcr import pcr_solve, stage_tables
from ..cuda_kernels.rbpack import _R6, table_views
from .pcr import num_stage, pcr_reduce_var
from .psor_scan import diagonals, field_shape, line_range, make_skew


def line_relaxer(shape_kij, omega: float, dtype, device, tab=None):
    """``relax(S, B, d, lo, hi)``: the plain line relaxation of kernel P2 on
    the diagonal layout: lines (i, d - i), lo <= i <= hi, of diagonal d of
    ``S`` (in place, each line's right-hand side from diagonals d - 1 and
    d + 1 as they stand), returning the float64 sum of their dp^2.
    ``tab`` (``rbpack.maf_tables`` of the (K, I, J) field) selects MAF.
    Lines are independent of one another, so any split of a diagonal gives
    the same field."""
    K, I, J = shape_kij
    n = K - 2
    pn = num_stage(n)
    om = torch.tensor(omega, dtype=dtype, device=device)
    if tab is None:
        r6 = torch.tensor(_R6[dtype], dtype=dtype, device=device)
        ctab = stage_tables(n, dtype, device)
    else:
        w = table_views(tab, (K, I, J))
        half = torch.tensor(0.5, dtype=dtype, device=device)
        wzm_k, wzp_k, c3 = (w[f][1:-1, None] for f in ("wzm", "wzp", "c3"))

    def relax(S, B, d, lo, hi):
        xm1, xc, xp1 = S[d - 1], S[d], S[d + 1]
        lines = slice(lo, hi + 1)
        own = xc[1:-1, lines]
        xim, xjm = xm1[1:-1, lo - 1:hi], xm1[1:-1, lines]  # (i-1, j), (i, j-1)
        xip, xjp = xp1[1:-1, lo + 1:hi + 2], xp1[1:-1, lines]  # (i+1, j), (i, j+1)
        bb = B[d, 1:-1, lines]
        x_lo, x_hi = xc[0, lines], xc[K - 1, lines]
        if tab is None:
            t = ((xim + xjm) + xip) + xjp
            dl = (t - bb) * r6
            dl[0] = dl[0] + x_lo * r6
            dl[-1] = dl[-1] + x_hi * r6
            sol = pcr_solve(dl, ctab, pn)
        else:
            i = torch.arange(lo, hi + 1, device=device)
            j = d - i
            dw = half / ((w["c1"][i] + w["c2"][j]) + c3)  # (n, lines)
            wzm, wzp = wzm_k * dw, wzp_k * dw
            a, c = -wzm, -wzp
            a[0] = 0.0
            c[-1] = 0.0
            t = w["wxp"][i] * xip + w["wxm"][i] * xim
            t = t + w["wyp"][j] * xjp
            t = t + w["wym"][j] * xjm
            dl = (t - bb) * dw
            dl[0] = dl[0] + wzm[0] * x_lo
            dl[-1] = dl[-1] + wzp[-1] * x_hi
            sol = pcr_reduce_var(a, c, dl, pn)
        dp = (sol - own) * om
        S[d, 1:-1, lines] = own + dp
        return (dp * dp).sum(dtype=torch.float64)

    return relax


def pcr_gs_diag_plain(S, B, omega: float, tab=None):
    """Plain twin of kernel P2: one lexicographic line Gauss-Seidel sweep of
    the diagonal-layout field ``S`` with right-hand side ``B``; ``tab``
    (``rbpack.maf_tables`` of the (K, I, J) field) selects MAF.  Returns (a
    new S, float64 sum of dp^2)."""
    K, I, J = shape = field_shape(S)
    relax = line_relaxer(shape, omega, S.dtype, S.device, tab)
    S = S.clone()
    r2 = torch.zeros((), dtype=torch.float64, device=S.device)
    for d in diagonals(I, J):
        r2 = r2 + relax(S, B, d, *line_range(d, I, J))
    return S, r2


def make_pcr_gs_diag_step(shape_kij, dtype, omega: float, mc=None,
                          plain: bool = False, device=None,
                          divides: int | None = None):
    """``step(S, B) -> (S, r2)``: lexicographic line Gauss-Seidel sweeps
    (pcr, pcr_eda, pcr_esa; with ``mc`` their ``_maf`` forms) on the
    diagonal layout, the standard inner mask only.  For a CUDA ``device``
    (where the fields live) it is one launch of kernel P2, in place, of
    ``iters_per_call`` = n sweeps (``pcr_gs.sweeps_for``; ``divides`` as
    for ops/psor_scan.py's step), r2 of shape (n,), and ``single`` the
    one-sweep launch; otherwise, or with ``plain``, one sweep of the twin a
    call on any device (as for a CPU tensor), r2 0-d float64.
    ``pad``/``unpad`` convert the (K, I, J) field to and from the layout;
    ``check_every_default`` is 1: a host check a call."""
    # the kernel's module takes its twin from this one
    from ..cuda_kernels import pcr_gs as p2

    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the diagonal steps take float32 or float64, not {dtype}")

    def make(launch):
        def step(S, B):
            if plain:
                return pcr_gs_diag_plain(S, B, omega, launch.tables(S))
            return p2.pcr_gs_diag(S, B, omega, mc, launcher=launch)

        step.iters_per_call = launch.sweeps
        step.launcher = launch
        return step

    n = 1
    if not plain and device is not None and torch.device(device).type == "cuda":
        n = p2.sweeps_for(shape_kij, dtype, mc is not None, device, divides)
    step = make(p2.PcrGsSweep(omega, mc, sweeps=n))
    step.single = step if n == 1 else make(p2.PcrGsSweep(omega, mc))
    skew, unskew, _ = make_skew(shape_kij)
    step.pad, step.unpad = skew, unskew
    step.check_every_default = 1
    return step
