"""MAF (matrix-assembly-free) variable-coefficient operators (PyTorch port of
``cubez_tpu/ops/maf.py``).

Every metric factor of the reference's MAF kernels is separable per axis
(psor_maf, cz_maf.f90:68-101): C1, C7 depend on i only, C2, C8 on j only,
C3, C9 on k only.  They are kept as six 1-D arrays shaped to broadcast over
(K, I, J):

    XG = 0.5 (X[i+1] - X[i-1]),  XGG = X[i+1] - 2 X[i] + X[i-1]
    C1 = (1/XG)^2,  C7 = -XGG * C1 / XG      (Y -> C2, C8; Z -> C3, C9)
    neighbour weights  x+-: C1 +- 0.5 C7,  y+-: C2 +- 0.5 C8,  z+-: C3 +- 0.5 C9
    diagonal           dd = 2 (C1 + C2 + C3)

``from_coords`` computes in the field dtype with the JAX package's
operation order, so the tables are bitwise the JAX package's.  The sweeps
below are the plain unpacked forms (masked dense updates); the kernels'
arithmetic contracts are in ``cuda_kernels/rbpack.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .shifts import nbr6

FIELDS = ("c1", "c7", "c2", "c8", "c3", "c9")


def _central(arr: torch.Tensor):
    """(first, second) central differences of a 1-D coordinate array; the
    edge entries use replicated neighbours and are only read at masked
    nodes."""
    ap = torch.cat([arr[1:], arr[-1:]])
    am = torch.cat([arr[:1], arr[:-1]])
    g = 0.5 * (ap - am)
    gg = ap - 2.0 * arr + am
    return g, gg


def _axis_coeffs(arr: torch.Tensor):
    g, gg = _central(arr)
    one = torch.ones_like(g)
    ginv = torch.where(g != 0, one / torch.where(g != 0, g, one),
                       torch.zeros_like(g))
    c = ginv * ginv
    c_odd = -gg * c * ginv
    return c, c_odd


@dataclasses.dataclass(frozen=True)
class MafCoeffs:
    """Separable metric coefficients, broadcast-shaped for (K, I, J)."""

    c1: torch.Tensor  # (1, ni, 1)
    c7: torch.Tensor  # (1, ni, 1)
    c2: torch.Tensor  # (1, 1, nj)
    c8: torch.Tensor  # (1, 1, nj)
    c3: torch.Tensor  # (nk, 1, 1)
    c9: torch.Tensor  # (nk, 1, 1)

    @classmethod
    def _from_axes(cls, c1, c7, c2, c8, c3, c9) -> "MafCoeffs":
        return cls(
            c1=c1.reshape(1, -1, 1), c7=c7.reshape(1, -1, 1),
            c2=c2.reshape(1, 1, -1), c8=c8.reshape(1, 1, -1),
            c3=c3.reshape(-1, 1, 1), c9=c9.reshape(-1, 1, 1),
        )

    @classmethod
    def from_coords(cls, xc, yc, zc) -> "MafCoeffs":
        """From the 1-D node coordinates along I, J and K (``grid.xc``,
        ``grid.yc``, ``grid.zc``), in their dtype and on their device."""
        c1, c7 = _axis_coeffs(xc)
        c2, c8 = _axis_coeffs(yc)
        c3, c9 = _axis_coeffs(zc)
        return cls._from_axes(c1, c7, c2, c8, c3, c9)

    @classmethod
    def from_numpy(cls, c1, c7, c2, c8, c3, c9, *, device) -> "MafCoeffs":
        """Coefficients carried across as they are, in their own dtype,
        e.g. the JAX package's ``MafCoeffs`` fields through
        ``np.asarray``."""
        return cls._from_axes(*(torch.tensor(np.asarray(a), device=device)
                                for a in (c1, c7, c2, c8, c3, c9)))

    # neighbour weights ---------------------------------------------------
    @property
    def wxp(self):
        return self.c1 + 0.5 * self.c7

    @property
    def wxm(self):
        return self.c1 - 0.5 * self.c7

    @property
    def wyp(self):
        return self.c2 + 0.5 * self.c8

    @property
    def wym(self):
        return self.c2 - 0.5 * self.c8

    @property
    def wzp(self):
        return self.c3 + 0.5 * self.c9

    @property
    def wzm(self):
        return self.c3 - 0.5 * self.c9

    @property
    def dd(self):
        """Diagonal 2 (C1 + C2 + C3), broadcastable to (K, I, J)."""
        return 2.0 * (self.c1 + self.c2 + self.c3)

    def nbr_weighted(self, x: torch.Tensor) -> torch.Tensor:
        """rp = sum of the metric-weighted neighbours (cz_maf.f90:95-101)."""
        xm, xp, ym, yp, zm, zp = nbr6(x)
        return (
            self.wxp * xp
            + self.wxm * xm
            + self.wyp * yp
            + self.wym * ym
            + self.wzp * zp
            + self.wzm * zm
        )

    def pivot(self) -> torch.Tensor:
        """pvt = 1 / max |row coefficient|, the row scaling of the MAF
        Krylov solvers (search_pivot, cz_blas.f90:947-1039)."""
        zero = torch.zeros_like(self.dd)
        m = torch.abs(self.dd + zero)
        for w in (self.wxp, self.wxm, self.wyp, self.wym, self.wzp, self.wzm):
            m = torch.maximum(m, torch.abs(w + zero))
        return 1.0 / m


# --- sweeps -----------------------------------------------------------------


def maf_delta(x, b, msk, omega, mc: MafCoeffs):
    """dp = ((rp + b) / dd - x) * omega on masked nodes (psor_maf,
    cz_maf.f90:94-105)."""
    rp = mc.nbr_weighted(x) + b
    om = torch.tensor(omega, dtype=x.dtype, device=x.device)
    return (rp / mc.dd - x) * om * msk


def jacobi_maf_sweep(x, b, msk, omega, mc):
    """jacobi_maf (cz_maf.f90:131-282); returns (x_new, sum(dp^2) in
    float64)."""
    dp = maf_delta(x, b, msk, omega, mc)
    return x + dp, (dp * dp).sum(dtype=torch.float64)


def sor2sma_maf_sweep(x, b, msk, omega, mc, cmasks):
    """psor2sma_core_maf over both colours (cz_maf.f90:301-438)."""
    dp = maf_delta(x, b, msk * cmasks[0], omega, mc)
    x = x + dp
    r2 = (dp * dp).sum(dtype=torch.float64)
    dp = maf_delta(x, b, msk * cmasks[1], omega, mc)
    return x + dp, r2 + (dp * dp).sum(dtype=torch.float64)


# --- the MAF Krylov operator ------------------------------------------------


def calc_ax_maf(p, msk, mc: MafCoeffs, pvt):
    """ap = (weighted neighbours - dd p) * pvt (calc_ax_maf,
    cz_blas.f90:845-936), masked."""
    return (mc.nbr_weighted(p) - mc.dd * p) * pvt * msk


def calc_rk_maf(p, b, msk, mc: MafCoeffs, pvt):
    """r = (b - (weighted neighbours - dd p)) * pvt (calc_rk_maf,
    cz_blas.f90:738-831), masked.  It solves L x = b, while the MAF point
    sweeps take ``rp + b`` and so solve -L x = b (Problem.
    manufactured_stretched's "krylov" and "relax" families); the sign is
    the reference's and is kept."""
    return (b - (mc.nbr_weighted(p) - mc.dd * p)) * pvt * msk
