"""Plain lexicographic line Gauss-Seidel, the reference's ``pcr`` (CubeZ
CZ::LSOR_PCR, the full-plane line SOR of cz_solver.f90:666-878), in plain
PyTorch.  ``pcr_eda`` and ``pcr_esa`` share its history.

This file imports nothing but torch, and takes nothing from the program
under test: the benchmark hands it the start field and the right-hand side
it handed the program, and it works out the rest itself.

The grid is (K, I, J) with the Dirichlet data on the outermost shell.  A
sweep relaxes each inner K-line (i, j), 1 <= i <= I - 2 and
1 <= j <= J - 2, in the reference's lexicographic order (j outer, i
inner), in place:

    t     = ((x[i-1, j] + x[i, j-1]) + x[i+1, j]) + x[i, j+1]   on rows k
    r     = (t - b) / 6,  and x[k = 0] / 6, x[k = K-1] / 6 added to the
            first and last inner rows (the Dirichlet ends)
    sol   = T^-1 r,  T the constant tridiagonal (-1/6, 1, -1/6) of the
            K - 2 inner rows
    dp    = omega (sol - x),  x += dp

so lines (i - 1, j) and (i, j - 1) are new and (i + 1, j) and (i, j + 1)
old.  The sweep's residual is the float64 sum of dp^2 over the inner
nodes, and a solve stops at the first sweep whose sqrt(sum dp^2 / N_inner)
is below eps (cz_Poisson.cpp:67-71), or after ``itr_max`` sweeps.

How it runs, none of which changes a line's arithmetic:

* Line (i, j) depends on lines of diagonal i + j - 1 only, and on old
  values of diagonal i + j + 1, so the lines of one diagonal d = i + j are
  relaxed together, the diagonals in order: exactly the lexicographic
  dependence.  The field is held skewed, S[d, i, k] = x[k, i, d - i]
  (zero where d - i is off the grid), so a diagonal is one (I, K) slab.
* ``LAG`` sweeps run together, sweep s + 1 two diagonals behind sweep s:
  at each step every running sweep relaxes one diagonal, and each reads
  the diagonals below its own as its own sweep left them and those above
  as the sweep before left them, as the serial order has it.  A sweep
  never reads what a later one wrote, so the first m sweeps of a group are
  the same whatever follows them; where a group's sweep m stops the solve,
  the group is run again from its start for m sweeps.
* The line solve is a product with T^-1, inverted once in float64 and
  rounded to the field's type, over a diagonal's lines at once.  TF32 is
  off around the products (``ieee_matmul``).

Where it departs from the reference: the line solve.  The reference
solves each line by parallel cyclic reduction down to a 4x4 system solved
by Cramer's rule (cz_solver.f90:796-844); the product with T^-1 is the
same solution, rounded otherwise.
"""

from __future__ import annotations

import contextlib
import math

import torch

LAG = 32  # sweeps run together


def skew(x):
    """S[d, i, k] = x[k, i, d - i] of a (K, I, J) field, (I + J - 1, I, K),
    zero where d - i is outside [0, J)."""
    K, I, J = x.shape
    d, i = _lines(I, J, x.device)
    S = x.new_zeros((I + J - 1, I, K))
    S[d, i] = x.permute(1, 2, 0)
    return S


def unskew(S, J: int):
    """The (K, I, J) field of a skewed ``S``."""
    _, I, K = S.shape
    d, i = _lines(I, J, S.device)
    return S[d, i].permute(2, 0, 1).contiguous()


def _lines(I: int, J: int, device):
    """(d, i) index tensors of shape (I, J): the diagonal and row of line
    (i, j) in the skewed layout."""
    i = torch.arange(I, device=device)[:, None]
    j = torch.arange(J, device=device)[None, :]
    return i + j, i.expand(I, J)


def inner_lines(I: int, J: int, dtype, device):
    """(I + J - 1, I - 2, 1): 1 where (i, d - i) is an inner line, for
    i = 1 .. I - 2, else 0."""
    d = torch.arange(I + J - 1, device=device)[:, None]
    i = torch.arange(1, I - 1, device=device)[None, :]
    ok = (d - i >= 1) & (d - i <= J - 2)
    return ok.to(dtype)[..., None]


def line_inverse(n: int, dtype, device):
    """T^-1 of the constant tridiagonal (-1/6, 1, -1/6) of n rows, inverted
    in float64 and rounded once to ``dtype``."""
    t = torch.eye(n, dtype=torch.float64)
    off = torch.full((n - 1,), -1.0 / 6.0, dtype=torch.float64)
    t += torch.diag(off, 1) + torch.diag(off, -1)
    return torch.linalg.inv(t).to(dtype=dtype, device=device)


@contextlib.contextmanager
def ieee_matmul():
    """Float32 products in full float32, no TF32: cuBLAS's and cuDNN's
    ``fp32_precision`` "ieee" (the flags' ``allow_tf32`` False), the
    caller's settings restored after.  The flags are set through
    ``fp32_precision``, because torch refuses to read ``allow_tf32`` in a
    process that has set the new flag."""
    backends = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, v in zip(backends, saved):
            b.fp32_precision = v


class Sweeps:
    """Lexicographic line Gauss-Seidel sweeps of skewed fields of one
    (K, I, J) shape: ``run(S, B, count)`` runs ``count`` sweeps of S in
    place, ``count`` at a time as above, and returns their float64 sums of
    dp^2 on S's device, shape (count,)."""

    def __init__(self, shape, omega: float, dtype, device):
        K, I, J = shape
        self.shape, self.omega = shape, omega
        self.tinv = line_inverse(K - 2, dtype, device)
        self.inner = inner_lines(I, J, dtype, device)
        self.last = I + J - 4  # the last diagonal with an inner line

    def relax(self, S, B, lo: int, hi: int):
        """Relax the lines of diagonals lo, lo + 2, ..., hi of S in place;
        their float64 sums of dp^2, shape ((hi - lo) // 2 + 1,)."""
        K, I, _ = self.shape
        rows, ks = slice(1, I - 1), slice(1, K - 1)
        below = S[lo - 1:hi:2]  # diagonal d - 1, new
        above = S[lo + 1:hi + 2:2]  # diagonal d + 1, old
        own = S[lo:hi + 1:2]
        x = own[:, rows, ks]
        t = ((below[:, 0:I - 2, ks] + below[:, rows, ks])
             + above[:, 2:I, ks]) + above[:, rows, ks]
        r = (t - B[lo:hi + 1:2, rows, ks]) / 6.0
        r[..., 0] += own[:, rows, 0] / 6.0
        r[..., -1] += own[:, rows, K - 1] / 6.0
        sol = torch.matmul(r, self.tinv.mT)
        dp = (sol - x) * self.omega
        dp *= self.inner[lo:hi + 1:2]
        x += dp
        return dp.double().square().sum(dim=(1, 2))

    def run(self, S, B, count: int):
        r2 = torch.zeros(count, dtype=torch.float64, device=S.device)
        with ieee_matmul():
            # step t: sweep s relaxes diagonal t - 2 s
            for t in range(2, self.last + 2 * (count - 1) + 1):
                s_lo = max(0, -(-(t - self.last) // 2))
                s_hi = min(count - 1, (t - 2) // 2)
                lo, hi = t - 2 * s_hi, t - 2 * s_lo
                r2[s_lo:s_hi + 1] += self.relax(S, B, lo, hi).flip(0)
        return r2


def solve(x0, b, *, omega: float, itr_max: int, eps: float, **_):
    """Iterate from ``x0`` to convergence; ``b`` is the right-hand side on
    the inner nodes.  Returns (iterations, float64 residual history,
    field)."""
    K, I, J = x0.shape
    n_inner = math.prod(s - 2 for s in x0.shape)
    thresh = eps * eps * n_inner  # res < eps  <=>  sum dp^2 < eps^2 N_inner
    sweeps = Sweeps(x0.shape, omega, x0.dtype, x0.device)
    S, B = skew(x0), skew(b)
    r2s = []
    while len(r2s) < itr_max:
        count = min(LAG, itr_max - len(r2s))
        start = S.clone()
        r2 = sweeps.run(S, B, count).tolist()
        stop = next((m for m, v in enumerate(r2) if v < thresh), None)
        if stop is not None:
            if stop < count - 1:  # the field of the stopping sweep
                S = start
                sweeps.run(S, B, stop + 1)
            r2 = r2[:stop + 1]
        r2s += r2
        if stop is not None:
            break
    hist = torch.sqrt(torch.tensor(r2s, dtype=torch.float64) / n_inner)
    return len(r2s), hist, unskew(S, J)
