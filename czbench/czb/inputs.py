"""The inputs of a cell's solves, made by the benchmark from ``--seed``.

Every solve is the reference problem (CubeZ cz_Evaluate.cpp:374-390): the
unit cube, node-centred, pitch 1 / (n - 1), sin(pi x) sin(pi y) Dirichlet
data on the two K faces, zero on the side walls, and a zero right-hand
side inside.  Solve ``i`` starts from an interior of uniform noise in
[0, 1), the range of the boundary data, drawn on the device from a
generator seeded by (seed, i): no two solves share a start, and the same
seed gives the same starts.
"""

from __future__ import annotations

import hashlib
import math

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


def solve_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for solve ``index`` of a run with ``seed``
    (any whole numbers, negative ones too)."""
    h = hashlib.sha256(f"czbench:{seed}:{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def boundary_field(n: int, dtype, device) -> torch.Tensor:
    """The Dirichlet data on the shell of an n^3 (K, I, J) grid, zero
    inside; computed in float64 and rounded once."""
    x = torch.arange(n, dtype=torch.float64, device=device) / (n - 1)
    s = torch.sin(math.pi * x)
    f = torch.zeros((n, n, n), dtype=torch.float64, device=device)
    f[0] = s[:, None] * s[None, :]
    f[-1] = f[0]
    f[:, 0, :] = 0.0
    f[:, -1, :] = 0.0
    f[:, :, 0] = 0.0
    f[:, :, -1] = 0.0
    return f.to(dtype)


class Inputs:
    """The starts and the right-hand side of one run's solves."""

    def __init__(self, n: int, dtype, device, seed: int):
        self.n, self.dtype, self.device, self.seed = n, dtype, device, seed
        self.bc = boundary_field(n, dtype, device)
        self.gen = torch.Generator(device=device)
        # the reference's RHS: the boundary profile on the shell, zero inside
        self.rhs = self.bc.clone()

    def start(self, index: int) -> torch.Tensor:
        """The start of solve ``index``: the boundary data with a seeded
        uniform interior."""
        self.gen.manual_seed(solve_seed(self.seed, index))
        x = self.bc.clone()
        m = self.n - 2
        x[1:-1, 1:-1, 1:-1] = torch.rand((m, m, m), generator=self.gen,
                                         dtype=self.dtype, device=self.device)
        return x
