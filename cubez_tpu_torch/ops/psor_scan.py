"""Lexicographic point-SOR on the diagonal layout (PyTorch port of
``cubez_tpu/ops/psor_scan.py``).

The reference's psor (cz_solver.f90:207-269) is serial Gauss-Seidel in
(j, i, k) order.  Line (i, j) along K reads lines (i - 1, j) and (i, j - 1)
new and (i + 1, j) and (i, j + 1) old, so all lines on a diagonal
d = i + j can be relaxed together once diagonal d - 1 is done, and a sweep
is the 2N - 3 diagonals in order.  The state lives in the skewed layout
S[d, k, i] = X[k, i, d - i] (``make_skew``), where a diagonal is one
contiguous (K, I) slab and its lines are consecutive in i.

The JAX package solves each K-line as an affine recurrence with
``associative_scan``, which rounds otherwise than the serial loop.  The
port walks each line's k in order instead and applies the reference's point
update, so a sweep is the serial Gauss-Seidel sweep bit for bit: the
kernel P1 (csrc/psor.cu, cuda_kernels/psor.py) on the card, and the plain
twin ``psor_diag_plain`` (unskew, ``stencil.psor_sweep`` in hyperplane
order, skew) on any device.  Same dependency order as the reference, so
the same iteration counts as the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import stencil


def make_skew(shape_kij):
    """(skew, unskew, D): strided-reshape converters between (K, I, J) and
    the diagonal layout (D, K, I), D = I + J - 1, with S[d, k, i] =
    X[k, i, d - i] (zero where d - i is outside [0, J)).  The JAX
    package's converters, copy for copy: pad J to W = I + J, flatten (i,
    j) and re-read with row stride W - 1 (and back with stride W).  Both
    return new contiguous tensors."""
    nk, ni, nj = shape_kij
    W = ni + nj
    D = W - 1

    def skew(x):
        p = F.pad(x, (0, W - nj))  # (nk, ni, W)
        flat = p.reshape(nk, ni * W)[:, : ni * (W - 1)]
        s = flat.reshape(nk, ni, W - 1)  # s[k, i, d] = x[k, i, d - i]
        return s.permute(2, 0, 1).contiguous()  # (D, nk, ni)

    def unskew(s):
        c = s.permute(1, 2, 0).reshape(nk, ni * (W - 1))
        flat = F.pad(c, (0, ni))  # length ni * W
        return flat.reshape(nk, ni, W)[:, :, :nj].contiguous()

    return skew, unskew, D


def field_shape(S) -> tuple[int, int, int]:
    """(K, I, J) of the field a (D, K, I) diagonal-layout tensor holds."""
    D, K, I = S.shape
    return K, I, D - I + 1


def line_range(d: int, ni: int, nj: int) -> tuple[int, int]:
    """(first, last) i of the inner lines (i, d - i) on diagonal d:
    1 <= i <= I - 2 and 1 <= d - i <= J - 2 (first > last: none)."""
    return max(1, d - (nj - 2)), min(ni - 2, d - 1)


def diagonals(ni: int, nj: int) -> range:
    """The diagonals that hold an inner line, in sweep order: d = 2 ...
    I + J - 4."""
    return range(2, ni + nj - 3)


def psor_diag_plain(S, B, omega: float, mc=None):
    """Plain twin of kernel P1: one lexicographic point-SOR sweep of the
    diagonal-layout field ``S`` with right-hand side ``B`` (the same
    layout); ``mc`` (MafCoeffs) selects psor_maf.  Returns (a new S,
    float64 sum of dp^2).  It unskews, runs ``stencil.psor_sweep`` with
    the standard inner mask and skews again, so the zero cells of the
    layout stay zero."""
    shape = field_shape(S)
    skew, unskew, _ = make_skew(shape)
    x, b = unskew(S), unskew(B)
    msk = torch.zeros(shape, dtype=S.dtype, device=S.device)
    msk[1:-1, 1:-1, 1:-1] = 1.0
    hidx = stencil.hyperplane_index(shape, S.device)
    x, r2 = stencil.psor_sweep(x, b, msk, omega, hidx, mc)
    return skew(x), r2


def make_psor_diag_step(shape_kij, dtype, omega: float, mc=None,
                        plain: bool = False, device=None,
                        divides: int | None = None):
    """``step(S, B) -> (S, r2)``: lexicographic point-SOR sweeps (psor,
    with ``mc`` psor_maf) on the diagonal layout, the standard inner mask
    only.  For a CUDA ``device`` (where the fields live) it is one launch
    of kernel P1, in place, of ``iters_per_call`` = n sweeps
    (``psor.sweeps_for``: the plan's; with ``divides`` the most that divide
    it and fit the card, for a preconditioner's fixed sweeps), r2 of shape
    (n,), and ``single`` the one-sweep launch; otherwise, or with
    ``plain``, one sweep of the twin a call on any device (as for a CPU
    tensor), r2 0-d float64.  ``pad``/``unpad`` convert the (K, I, J)
    field to and from the layout; ``check_every_default`` is 1, as the JAX
    package's step sets it: a host check a call."""
    # the kernel's module takes its twin from this one
    from ..cuda_kernels import psor as p1

    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the diagonal steps take float32 or float64, not {dtype}")

    def make(launch):
        def step(S, B):
            if plain:
                return psor_diag_plain(S, B, omega, mc)
            return p1.psor_diag(S, B, omega, mc, launcher=launch)

        step.iters_per_call = launch.sweeps
        step.launcher = launch
        return step

    n = 1
    if not plain and device is not None and torch.device(device).type == "cuda":
        n = p1.sweeps_for(shape_kij, device, divides)
    step = make(p1.PsorSweep(omega, mc, n))
    step.single = step if n == 1 else make(p1.PsorSweep(omega, mc))
    skew, unskew, _ = make_skew(shape_kij)
    step.pad, step.unpad = skew, unskew
    step.check_every_default = 1
    return step
