"""Grid BLAS ops for the Krylov solvers (PyTorch port of
``cubez_tpu/ops/blas.py``; the reference's src/cz_f90/cz_blas.f90).

All ops act densely over (K, I, J) tensors; operations the reference
restricts to the inner index range are masked with the inner mask instead.
Work vectors are kept identically zero on the boundary shell, which makes
masked-dense and inner-loop semantics equivalent.

Scalars enter as 0-d tensors of the field's dtype (``scalar``), as the JAX
package's ``jnp.asarray(a, x.dtype)`` makes them: a Python float would
compute the Krylov scalars in float64 and round them differently.  The
diagonal DD = 6 is exact in every dtype and enters as a Python number (a
kernel argument): a 0-d CUDA tensor made from it is a host-to-device copy,
which waits for the card.  The dots are full-tensor ``sum``s in the
field's dtype, deterministic on one device.
"""

from __future__ import annotations

import torch

from .stencil import DD, nbr_sum


def scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def dot1(p, msk):
    """sum p^2 over inner nodes (blas_dot1, cz_blas.f90:320-373)."""
    return (p * p * msk).sum()


def dot2(p, q, msk):
    """sum p*q over inner nodes (blas_dot2, cz_blas.f90:386-437)."""
    return (p * q * msk).sum()


def triad(x, y, a, msk):
    """z = a*x + y on inner nodes (blas_triad, cz_blas.f90:255-308)."""
    return (scalar(a, x) * x + y) * msk


def bicg_1(p, r, q, beta, omega, msk):
    """p = r + beta*(p - omega*q) (blas_bicg_1, cz_blas.f90:452-502)."""
    return (r + scalar(beta, p) * (p - scalar(omega, p) * q)) * msk


def bicg_2(z, x, y, a, b, msk):
    """z += a*x + b*y on inner nodes (blas_bicg_2, cz_blas.f90:517-566)."""
    return z + (scalar(a, z) * x + scalar(b, z) * y) * msk


def axpy(x, a, p, msk):
    """x + a*p on inner nodes (cg.py's update of x)."""
    return x + scalar(a, x) * p * msk


def dots_t(t, s, msk):
    """(dot2(t, s), dot1(t)): BiCGSTAB's omega = (t, s) / (t, t)."""
    return dot2(t, s, msk), dot1(t, msk)


def update_xr(x, p_, s_, t_, s, r0, alpha, omega, msk):
    """The end of a BiCGSTAB iteration: x + alpha*p_ + omega*s_ (bicg_2) and
    r = -omega*t_ + s (triad) on inner nodes, with dot1(r) and
    dot2(r, r0): (x, r, dot1(r), dot2(r, r0))."""
    x = bicg_2(x, p_, s_, alpha, omega, msk)
    r = triad(t_, s, -omega, msk)
    return x, r, dot1(r, msk), dot2(r, r0, msk)


def calc_ax(p, msk):
    """A x for the constant-coefficient 7-point operator:
    ap = sum(neighbors) - 6 p (blas_calc_ax, cz_blas.f90:579-644), masked."""
    return (nbr_sum(p) - DD * p) * msk


def calc_rk(p, b, msk):
    """r = b - A p (blas_calc_rk, cz_blas.f90:658-723), masked."""
    return (b - (nbr_sum(p) - DD * p)) * msk
