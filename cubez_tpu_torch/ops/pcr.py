"""Variable-coefficient line PCR along K (PyTorch port of the parts of
``cubez_tpu/ops/pcr.py`` that the distributed line steps use).

A K-line tridiagonal system ``a[k] x[k-1] + x[k] + c[k] x[k+1] = d[k]``
(unit diagonal) is solved for every (i, j) line at once: ``num_stage(n)
- 1`` parallel cyclic reduction stages at strides 1, 2, 4, ... and a
final 2x2 pair inversion (pcr_rb_maf, cz_maf.f90:442-668).  Shifts
zero-fill, the reference's zero-extension (cz_solver.f90:919-929): with
a[0] = 0 and c[n-1] = 0 every shifted-in value is multiplied by zero.

The arithmetic is the JAX function's, one rounding per operation and in
its order, so a run here is bitwise the JAX function run op by op (the
tests hold it so in float32 and float64).
"""

from __future__ import annotations

import torch

from .shifts import shift


def num_stage(n: int) -> int:
    """Smallest pn with 2**pn > n (getNumStage, cz.h:293-300)."""
    pn = 1
    while (1 << pn) <= n:
        pn += 1
    return pn


def _tail(v: torch.Tensor, s: int) -> torch.Tensor:
    """v[k + s] for k in [0, s), zero past the end (v has n <= 2s rows)."""
    out = torch.zeros_like(v[:s])
    out[: v.shape[0] - s] = v[s:]
    return out


def pcr_reduce_var(a, c, d, pn: int):
    """Variable-coefficient PCR: a, c, d all (n, ...) with the line along
    axis 0; returns the solution (n, ...).  ``pn`` = num_stage(n)."""
    n = d.shape[0]
    for p in range(1, pn):
        s = 2 ** (p - 1)
        al, cl, dl = shift(a, 0, -s), shift(c, 0, -s), shift(d, 0, -s)
        ar, cr, dr = shift(a, 0, +s), shift(c, 0, +s), shift(d, 0, +s)
        e = 1.0 / (1.0 - a * cl - c * ar)
        a, c, d = -e * a * al, -e * c * cr, e * (d - a * dl - c * dr)

    s = 2 ** (pn - 1)
    d_hi = _tail(d, s)
    a_hi = _tail(a, s)
    c_lo = c[:s]
    d_lo = d[:s]
    jj = 1.0 / (1.0 - a_hi * c_lo)
    x_lo = (d_lo - c_lo * d_hi) * jj
    x_hi = (d_hi - a_hi * d_lo) * jj
    return torch.cat([x_lo, x_hi], dim=0)[:n]
