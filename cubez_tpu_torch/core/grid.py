"""Grid specification for the cube Poisson/Laplace problem (PyTorch port of
``cubez_tpu/core/grid.py``).

Conventions are the reference's and the JAX package's:

* node-centered unit cube, node ``i`` at ``x = i * pitch`` with
  ``pitch = 1 / (nk - 1)`` isotropic (cz_Evaluate.cpp:88);
* array layout ``(K, I, J)``: K major, J contiguous (the reference is KIJ
  too, cz_solver.f90:218);
* no ghost cells on one device: the outermost node shell is the Dirichlet
  data, the inner (updated) region is ``[1, n-2]`` per axis.

The analytic fields are computed in numpy float64 exactly as the JAX
package computes them and cast once, so they are bitwise equal to it.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Grid:
    """Global cube grid of nodes.

    Attributes:
      ni, nj, nk: global node counts along I(x), J(y), K(z).
      dtype: field dtype (``torch.float32``, the reference's REAL_TYPE, or
        ``torch.float64`` for ``-D_REAL_IS_DOUBLE_`` parity).
      device: where every field this grid makes lives.
    """

    ni: int
    nj: int
    nk: int
    dtype: torch.dtype
    device: torch.device

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def shape_kij(self) -> tuple[int, int, int]:
        return (self.nk, self.ni, self.nj)

    @property
    def pitch(self) -> float:
        # isotropic, referenced to the K extent (cz_Evaluate.cpp:88)
        return 1.0 / float(self.nk - 1)

    @property
    def num_inner(self) -> int:
        # (N-2)^3 inner nodes on a physical-boundary cube
        return (self.ni - 2) * (self.nj - 2) * (self.nk - 2)

    @property
    def res_normal(self) -> float:
        # 1 / (global inner point count) (cz_Evaluate.cpp:222-224)
        return 1.0 / float(self.num_inner)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)

    def coords(self, axis: str) -> torch.Tensor:
        """Node coordinates along 'i' | 'j' | 'k', shape (n,), computed in
        the field dtype like the JAX package's ``arange * pitch``."""
        n = {"i": self.ni, "j": self.nj, "k": self.nk}[axis]
        pitch = torch.tensor(self.pitch, dtype=self.dtype)
        return (torch.arange(n, dtype=self.dtype) * pitch).to(self.device)

    @cached_property
    def inner_mask(self) -> torch.Tensor:
        """1 on updated (inner) nodes, 0 on the boundary shell (imask_k,
        cz_blas.f90:24-103)."""
        m = np.zeros(self.shape_kij, dtype=np.float64)
        m[1:-1, 1:-1, 1:-1] = 1.0
        return self._tensor(m)

    @cached_property
    def bc_field(self) -> torch.Tensor:
        """Dirichlet values on the shell, 0 inside: sin(pi x) sin(pi y) on
        the two K faces, 0 on the side walls, which overwrite the face edges
        (bc_k, cz_solver.f90:22-191)."""
        x = np.arange(self.ni) * self.pitch
        y = np.arange(self.nj) * self.pitch
        sinsin = np.outer(np.sin(np.pi * x), np.sin(np.pi * y))  # (I, J)
        f = np.zeros(self.shape_kij, dtype=np.float64)
        f[0, :, :] = sinsin
        f[-1, :, :] = sinsin
        f[:, 0, :] = 0.0
        f[:, -1, :] = 0.0
        f[:, :, 0] = 0.0
        f[:, :, -1] = 0.0
        return self._tensor(f)

    @cached_property
    def exact(self) -> torch.Tensor:
        """Separable analytic solution of the Laplace problem (exact_t,
        cz_utility.f90:52-82)."""
        x = np.arange(self.ni) * self.pitch
        y = np.arange(self.nj) * self.pitch
        z = np.arange(self.nk) * self.pitch
        r2pi = math.sqrt(2.0) * np.pi
        sinsin = np.outer(np.sin(np.pi * x), np.sin(np.pi * y))
        kprof = (np.sinh(r2pi * z) - np.sinh(r2pi * (z - 1.0))) / math.sinh(r2pi)
        return self._tensor(kprof[:, None, None] * sinsin[None, :, :])

    def initial_p(self) -> torch.Tensor:
        """Zero field with the BC applied (cz_Evaluate.cpp:374-378)."""
        return self.bc_field.clone()

    def initial_rhs(self) -> torch.Tensor:
        """Zero source; the BC profile sits on the RHS boundary planes like
        the reference's (cz_Evaluate.cpp:381-386), never read by a sweep."""
        return self.bc_field.clone()


def _abs_err(grid: Grid, p: torch.Tensor) -> torch.Tensor:
    return torch.abs(p - grid.exact) * grid.inner_mask


def max_error(grid: Grid, p: torch.Tensor) -> float:
    """Max |p - exact| over inner nodes (err_t, cz_utility.f90:86-129)."""
    return float(torch.max(_abs_err(grid, p)))


def max_error_loc(grid: Grid, p: torch.Tensor) -> tuple[float, tuple[int, int, int]]:
    """(max |p - exact|, first argmax as 1-based (i, j, k)): what the driver
    prints as 'Error max = %e at (i j k)' (cz_Evaluate.cpp:550-563)."""
    d = _abs_err(grid, p)
    flat = int(torch.argmax(d))
    k, i, j = np.unravel_index(flat, grid.shape_kij)
    return float(d.reshape(-1)[flat]), (int(i) + 1, int(j) + 1, int(k) + 1)
