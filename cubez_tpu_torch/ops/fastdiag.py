"""Eigendecomposition of a tridiagonal matrix on the host (a copy of
``tridiag_eig`` in ``cubez_tpu/ops/fastdiag.py``), for the
fast-diagonalization direct solver (solvers/direct.py).

The JAX package's other helpers there (``const_line_inverse``,
``maf_line_coeffs``, ``maf_line_diag``, ``maf_lambda_table``) build the
dense line solves of its TPU line kernels; the port's line kernels solve
those lines with Thomas' algorithm, so nothing here needs them.
"""

from __future__ import annotations

import numpy as np


def tridiag_eig(lo, dg, up):
    """Eigendecomposition (V, Vinv, mu) of tridiag(lo, dg, up), float64.

    ``lo``: (n-1,) entries at row k, col k-1; ``up``: row k, col k+1.
    Symmetrized by a diagonal similarity when the off-diagonal products
    are positive (s_k / s_{k-1} = sqrt(lo_k / up_{k-1}), B = S^-1 D S
    symmetric), so the eigenbasis is orthogonal, the stable path; the
    general ``eig`` otherwise (still real for M-matrices)."""
    lo = np.asarray(lo, np.float64)
    up = np.asarray(up, np.float64)
    dg = np.asarray(dg, np.float64)
    prod = lo * up
    if np.all(prod > 0):
        ratio = np.sqrt(lo / up)
        s = np.concatenate([[1.0], np.cumprod(ratio)])
        off = np.sign(up) * np.sqrt(prod)
        B = np.diag(dg) + np.diag(off, 1) + np.diag(off, -1)
        mu, Q = np.linalg.eigh(B)
        V = s[:, None] * Q
        Vinv = Q.T / s[None, :]
    else:
        D = np.diag(dg) + np.diag(lo, -1) + np.diag(up, 1)
        mu, V = np.linalg.eig(D)
        mu, V = mu.real, V.real
        Vinv = np.linalg.inv(V)
    return V, Vinv, mu
