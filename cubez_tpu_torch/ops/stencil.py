"""Constant-coefficient 7-point Jacobi and red-black SOR on the unpacked
(K, I, J) layout (PyTorch port of the point sweeps of
``cubez_tpu/ops/stencil.py``).

Masked dense updates: ``dp`` is computed everywhere, multiplied by the
inner mask and the colour mask, and added to ``x``, so boundary nodes never
change (psor2sma_core, cz_solver.f90:404-493).  The arithmetic is the JAX
package's jnp form, ``((ss - b) / 6 - x) * omega``, with a true division.
This sweep is independent of the packed layout: the tests hold the packed
kernels against it, and it is the path for a custom mask.  ``psor_sweep``
runs the same update in the serial (lexicographic) order, the plain twin of
kernel P1 (cuda_kernels/psor.py).
"""

from __future__ import annotations

import torch

from .maf import maf_point_delta
from .shifts import nbr6

DD = 6.0  # diagonal coefficient cf[7] (cz.h:172)


def nbr_sum(x: torch.Tensor) -> torch.Tensor:
    """Unit-coefficient 6-neighbour sum (the ``ss`` of cz_solver.f90:251-256)."""
    xm, xp, ym, yp, zm, zp = nbr6(x)
    return xm + xp + ym + yp + zm + zp


def point_delta(ss, b, x, omega):
    """The update increment ``((ss - b) / 6 - x) * omega`` from the
    neighbour sums ``ss``.  The divisor is a tensor on x's device: PyTorch
    turns a division by a CPU scalar into a multiply by its reciprocal on
    CUDA."""
    dd = torch.tensor(DD, dtype=x.dtype, device=x.device)
    om = torch.tensor(omega, dtype=x.dtype, device=x.device)
    return ((ss - b) / dd - x) * om


def jacobi_delta(x, b, msk, omega):
    """Masked update increment ``((ss - b) / 6 - x) * omega`` (cz_solver.f90:
    284-387)."""
    return point_delta(nbr_sum(x), b, x, omega) * msk


def jacobi_sweep(x, b, msk, omega):
    """One Jacobi iteration (cz_solver.f90:284-387); returns (x_new,
    sum(dp^2) in float64), the reference's res1 accumulator."""
    dp = jacobi_delta(x, b, msk, omega)
    return x + dp, (dp * dp).sum(dtype=torch.float64)


def color_masks(shape_kij, offset: int = 0, dtype=torch.float32, device="cpu"):
    """Checkerboard masks: colour ``c`` updates nodes with
    ``(i + j + k + offset + 1) % 2 == c`` in 0-based indices (the stride-2 K
    loop of psor2sma_core, cz_solver.f90:451-466)."""
    nk, ni, nj = shape_kij
    kk = torch.arange(nk, device=device)[:, None, None]
    ii = torch.arange(ni, device=device)[None, :, None]
    jj = torch.arange(nj, device=device)[None, None, :]
    par = (kk + ii + jj + offset + 1) % 2
    return (par == 0).to(dtype), (par == 1).to(dtype)


def sor_color_sweep(x, b, msk, omega, cmask):
    """One colour half-sweep; returns (x_new, sum(dp^2) in float64)."""
    dp = jacobi_delta(x, b, msk * cmask, omega)
    return x + dp, (dp * dp).sum(dtype=torch.float64)


def sor2sma_sweep(x, b, msk, omega, cmasks):
    """Full red+black iteration, the second colour on the first's update;
    the residual accumulates over both colours (cz_Poisson.cpp:194-210)."""
    x, r0 = sor_color_sweep(x, b, msk, omega, cmasks[0])
    x, r1 = sor_color_sweep(x, b, msk, omega, cmasks[1])
    return x, r0 + r1


def hyperplane_index(shape_kij, device="cpu") -> torch.Tensor:
    """The i + j + k hyperplane of every node (int64), the exact
    Gauss-Seidel order of ``psor_sweep``."""
    nk, ni, nj = shape_kij
    kk = torch.arange(nk, device=device)[:, None, None]
    ii = torch.arange(ni, device=device)[None, :, None]
    jj = torch.arange(nj, device=device)[None, None, :]
    return kk + ii + jj


def psor_sweep(x, b, msk, omega, hidx, mc=None):
    """One lexicographic point-SOR iteration in hyperplane (wavefront)
    order (psor, cz_solver.f90:207-269; with ``mc``, the MafCoeffs,
    psor_maf, cz_maf.f90:23-114, whose update takes ``rp + b``).

    For the 7-point stencil every order that respects the data dependencies
    gives the serial Gauss-Seidel result bit for bit: a node on hyperplane
    i + j + k = s (``hidx``) reads its lower neighbours (s - 1) new and its
    upper ones (s + 1) old.  The JAX package updates a hyperplane as a
    masked dense ``jacobi_delta`` over the whole field; here its nodes are
    gathered and take the same arithmetic, ``point_delta`` (``maf_delta``'s
    under MAF) times their mask value, which is the same result with
    O(N^3) work a sweep instead of O(N^4).  The nodes with a nonzero mask
    must be inner ones.  Returns (x_new, float64 sum of dp^2)."""
    nk, ni, nj = x.shape
    sk, si = ni * nj, nj  # flat strides of k and i
    m = msk.reshape(-1)
    pts = torch.nonzero(m != 0).squeeze(1)
    k, i, j = pts // sk, (pts // si) % ni, pts % nj
    if bool(((k < 1) | (k > nk - 2) | (i < 1) | (i > ni - 2) | (j < 1)
             | (j > nj - 2)).any()):
        raise ValueError("psor_sweep updates inner nodes only")
    h = hidx.reshape(-1)[pts]
    order = torch.argsort(h, stable=True)
    pts = pts[order]
    sizes = [int(c) for c in torch.bincount(h) if c > 0]
    xf = x.reshape(-1).clone()
    bf = b.reshape(-1)
    if mc is not None:
        ki, ii, ji = k[order], i[order], j[order]
        w = {f: getattr(mc, f).reshape(-1) for f in
             ("wxp", "wxm", "wyp", "wym", "wzp", "wzm")}
        ddf = mc.dd.expand(x.shape).reshape(-1)
    r2 = torch.zeros((), dtype=torch.float64, device=x.device)
    at = 0
    for n in sizes:
        p = pts[at:at + n]
        xm, xp = xf[p - si], xf[p + si]
        ym, yp = xf[p - 1], xf[p + 1]
        zm, zp = xf[p - sk], xf[p + sk]
        if mc is None:
            dp = point_delta(xm + xp + ym + yp + zm + zp, bf[p], xf[p], omega)
        else:
            pk, pi, pj = ki[at:at + n], ii[at:at + n], ji[at:at + n]
            # MafCoeffs.nbr_weighted's order
            rp = (w["wxp"][pi] * xp + w["wxm"][pi] * xm + w["wyp"][pj] * yp
                  + w["wym"][pj] * ym + w["wzp"][pk] * zp + w["wzm"][pk] * zm)
            dp = maf_point_delta(rp + bf[p], xf[p], ddf[p], omega)
        dp = dp * m[p]
        xf[p] = xf[p] + dp
        r2 = r2 + (dp * dp).sum(dtype=torch.float64)
        at += n
    return xf.reshape(x.shape), r2
