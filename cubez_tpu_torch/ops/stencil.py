"""Constant-coefficient 7-point red-black SOR on the unpacked (K, I, J)
layout (PyTorch port of the sor2sma part of ``cubez_tpu/ops/stencil.py``).

Masked dense updates: ``dp`` is computed everywhere, multiplied by the
inner mask and the colour mask, and added to ``x``, so boundary nodes never
change (psor2sma_core, cz_solver.f90:404-493).  The arithmetic is the JAX
package's jnp form, ``((ss - b) / 6 - x) * omega``, with a true division.
This sweep is independent of the packed layout: the tests hold the packed
kernels against it, and it is the CPU path for odd I or a custom mask.
"""

from __future__ import annotations

import torch

from .shifts import nbr6

DD = 6.0  # diagonal coefficient cf[7] (cz.h:172)


def nbr_sum(x: torch.Tensor) -> torch.Tensor:
    """Unit-coefficient 6-neighbour sum (the ``ss`` of cz_solver.f90:251-256)."""
    xm, xp, ym, yp, zm, zp = nbr6(x)
    return xm + xp + ym + yp + zm + zp


def jacobi_delta(x, b, msk, omega):
    """Masked update increment ``((ss - b) / 6 - x) * omega`` (cz_solver.f90:
    284-387).  The divisor is a tensor on x's device: PyTorch turns a
    division by a CPU scalar into a multiply by its reciprocal on CUDA."""
    dd = torch.tensor(DD, dtype=x.dtype, device=x.device)
    om = torch.tensor(omega, dtype=x.dtype, device=x.device)
    return ((nbr_sum(x) - b) / dd - x) * om * msk


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
