"""Plain red-black SOR, the reference's ``sor2sma`` (CubeZ cz_Poisson.cpp:194-210,
psor2sma_core in cz_solver.f90:404-493), in plain PyTorch.

This file imports nothing but torch, and takes nothing from the program
under test: the benchmark hands it the start field and the right-hand side
it handed the program, and it works out the rest itself.

The grid is (K, I, J) with the Dirichlet data on the outermost shell; the
inner nodes [1, n-2] on each axis are updated.  One iteration relaxes the
first colour, the inner nodes whose 0-based i + j + k is odd, and then the
second on the first's update:

    dp = ((xm + xp + ym + yp + zm + zp - b) / 6 - x) * omega,   x += dp

and the residual of the iteration is the float64 sum of dp^2 over both
colours.  A solve stops at the first iteration whose residual
sqrt(sum dp^2 / N_inner) is below eps (cz_Poisson.cpp:67-71), or after
``itr_max`` iterations.

So that each colour touches only its own nodes, the field is held as its
eight sub-lattices of every other node, (k % 2, i % 2, j % 2) = (u, s, t),
each a contiguous array: the colour of a node is the parity of u + s + t,
and its six neighbours lie on the three sub-lattices that differ from its
own in one of u, s, t.
"""

from __future__ import annotations

import itertools
import math

import torch

LATTICES = tuple(itertools.product((0, 1), repeat=3))
# the first colour (i + j + k odd), then the second
COLOURS = tuple(tuple(p for p in LATTICES if sum(p) % 2 == c) for c in (1, 0))


def split(x) -> dict:
    """The eight sub-lattices of a (K, I, J) field, contiguous copies."""
    return {p: x[p[0]::2, p[1]::2, p[2]::2].contiguous() for p in LATTICES}


def merge(parts: dict, like) -> torch.Tensor:
    x = torch.empty_like(like)
    for p, a in parts.items():
        x[p[0]::2, p[1]::2, p[2]::2] = a
    return x


def _inner(u: int, n: int) -> slice:
    """The inner nodes k in [1, n - 2] of sub-lattice u (k = 2 a + u), as
    a slice of a."""
    return slice(1 - u, (n - 2 - u) // 2 + 1)


def _shift(sl: slice, d: int) -> slice:
    return slice(sl.start + d, sl.stop + d)


def rb_iteration(parts: dict, b, omega: float, shape) -> torch.Tensor:
    """One red-black iteration on the sub-lattices ``parts`` in place;
    ``b`` (the right-hand side's sub-lattices) None is zero.  Returns the
    iteration's float64 sum of dp^2."""
    r2 = torch.zeros((), dtype=torch.float64, device=parts[LATTICES[0]].device)
    for colour in COLOURS:
        for p in colour:
            box = tuple(_inner(u, n) for u, n in zip(p, shape))
            xin = parts[p][box]
            dp = None
            for axis in range(3):
                q = list(p)
                q[axis] ^= 1
                other = parts[tuple(q)]
                # the neighbour below is on q at a - 1 where u = 0, at a
                # where u = 1; the one above at a, or a + 1
                lo = -1 if p[axis] == 0 else 0
                for d in (lo, lo + 1):
                    nb = list(box)
                    nb[axis] = _shift(box[axis], d)
                    v = other[tuple(nb)]
                    dp = v.clone() if dp is None else dp.add_(v)
            if b is not None:
                dp -= b[p][box]
            dp /= 6.0
            dp -= xin
            dp *= omega
            xin += dp
            r2 += dp.square_().sum(dtype=torch.float64)
    return r2


def sweeps(v, *, omega: float, count: int):
    """``count`` iterations from a zero field with ``v`` as the right-hand
    side and zero Dirichlet data: the preconditioner form
    (cz_Poisson.cpp:66,280)."""
    z = split(torch.zeros_like(v))
    bv = split(v)
    for _ in range(count):
        rb_iteration(z, bv, omega, v.shape)
    return merge(z, v)


def solve(x0, b, *, omega: float, itr_max: int, eps: float, **_):
    """Iterate from ``x0`` to convergence; ``b`` is read on the inner nodes
    only, and skipped where it is zero there.  Returns (iterations, float64
    residual history, field)."""
    n_inner = math.prod(s - 2 for s in x0.shape)
    thresh = eps * eps * n_inner  # res < eps  <=>  sum dp^2 < eps^2 N_inner
    parts = split(x0)
    rhs = split(b) if bool(torch.any(b[1:-1, 1:-1, 1:-1] != 0)) else None
    r2s = []
    for _ in range(itr_max):
        r2 = float(rb_iteration(parts, rhs, omega, x0.shape))
        r2s.append(r2)
        if r2 < thresh:
            break
    hist = torch.sqrt(torch.tensor(r2s, dtype=torch.float64) / n_inner)
    return len(r2s), hist, merge(parts, x0)
