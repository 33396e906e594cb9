"""Red-black line relaxation on the colour-packed line layout (PyTorch/CUDA
port of ``cubez_tpu/pallas_kernels/rblines.py``, the packed line kernel
K5).

Layout: a line's red-black colour (i + j + offset) % 2 does not depend on
k, so whole lines fold by colour along I, as the point sweeps of
``rbpack.py`` fold points:

    xp[0, k, i2, j] = x[k, 2*i2 + s0(j), j],      s0 = (j + offset) % 2
    xp[1, k, i2, j] = x[k, 2*i2 + 1 - s0(j), j]

shape (2, K, I/2, J), J contiguous: the JAX package's (2, I2+4, Kp, Jp)
without its padding, transposed to the port's K-outer order.  This is not
``rbpack.pack_rb``: point colours depend on k, line colours do not.  A
line's j +- 1 neighbours are the other colour at the same row i2; its
i +- 1 neighbours the other colour at rows i2 + s and i2 + s - 1, s its
own parity (rblines.py:24-29).

One kernel (csrc/rblines.cu), ``rbl``: colour 0, then colour 1, two
launches in place, each solving its colour's lines by the Thomas pass on
the shared-memory tile of ``csrc/line_tile.cuh`` (``L`` consecutive
packed lines a CTA, ``lines.line_tile``) with the arithmetic contract of
``lines.py``, constant
coefficients or MAF (the tables indexed by the physical i), zero or
streamed b.  For a CPU tensor it runs ``rbl_plain``, which unpacks,
relaxes both colours with ``lines.line_rb_plain`` and packs back: bitwise
equal to the kernel.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .lines import launch_args, line_rb_plain, refuses, tile_plan
from .rbpack import _SUFFIX, _check, count, maf_tables, ptr, stream


def _red_even(J, offset, device):
    j = torch.arange(J, device=device)[None, None, :]
    return (j + offset) % 2 == 0  # s0 == 0: colour 0 on the even i rows


def pack_rb_lines(a: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """(K, I, J) field -> packed (2, K, I/2, J) line state.  I must be
    even.  Apply to x and b alike."""
    K, I, J = a.shape
    if I % 2:
        raise ValueError("the packed line layout needs even I")
    xe, xo = a[:, 0::2, :], a[:, 1::2, :]
    red_even = _red_even(J, offset, a.device)
    return torch.stack([torch.where(red_even, xe, xo),
                        torch.where(red_even, xo, xe)])


def unpack_rb_lines(p: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_rb_lines`."""
    K, I, J = shape
    red_even = _red_even(J, offset, p.device)
    xe = torch.where(red_even, p[0], p[1])
    xo = torch.where(red_even, p[1], p[0])
    return torch.stack([xe, xo], dim=2).reshape(K, I, J)


def rbl_plain(xp, bp, omega: float, offset: int = 0, tab=None):
    """Plain twin of ``rbl``: one red-black line iteration of the packed
    state ``xp`` in place; returns the float64 sum of dp^2 over both
    colours."""
    _, K, I2, J = xp.shape
    shape = (K, 2 * I2, J)
    x = unpack_rb_lines(xp, shape, offset)
    b = None if bp is None else unpack_rb_lines(bp, shape, offset)
    r2 = line_rb_plain(x, b, omega, offset, tab)
    xp.copy_(pack_rb_lines(x, offset))
    return r2


def rbl(xp, bp, omega: float, offset: int = 0, tab=None):
    """Launch ``rbl_color_kernel`` twice (colour 0, then 1): one red-black
    line iteration of the packed state in place; ``tab`` (``maf_tables``)
    selects MAF.  Returns the float64 sum of dp^2 (on the device).  A CPU
    tensor runs the plain twin."""
    if not xp.is_cuda:
        return rbl_plain(xp, bp, omega, offset, tab)
    _check(xp, bp, tab)
    lib, lt, maf = launch_args(xp, tab)
    _, K, I2, J = xp.shape
    L, threads, tiles = tile_plan("rbl", xp.shape, xp.dtype, maf)
    fn = getattr(lib, f"cz_rbl_color_{_SUFFIX[xp.dtype]}")
    partials = torch.empty(2, tiles, dtype=xp.dtype, device=xp.device)
    st = stream(xp)
    for c in (0, 1):
        rc = fn(xp.data_ptr(), ptr(bp), lt.data_ptr(), partials[c].data_ptr(),
                K, I2, J, c, offset, omega, maf, L, threads, tiles,
                xp.device.index, st)
        _build.check(rc, "rbl")
        count(rbl, tab)
    return partials.sum(dtype=torch.float64)


rbl.launches = rbl.maf_launches = 0


def make_rbl_step(shape, dtype=torch.float32, *, omega: float,
                  offset: int = 0, b_is_zero: bool = False, mc=None,
                  plain: bool = False):
    """``step(xp, bp) -> (xp, r2)`` on the packed line state
    (``pack_rb_lines``): one red-black line iteration in place, r2 a 0-d
    float64 tensor.  ``mc`` (MafCoeffs) selects MAF; ``b_is_zero``
    ignores ``bp``; ``plain`` runs the twin on any device.  None where the
    layout refuses (odd I) or K - 2 < 2."""
    if refuses(shape, dtype) or shape[1] % 2:
        return None
    tab = maf_tables(mc, shape, dtype)

    def step(xp, bp):
        b = None if b_is_zero else bp
        if plain:
            return xp, rbl_plain(xp, b, omega, offset, tab)
        return xp, rbl(xp, b, omega, offset, tab)

    step.iters_per_call = 1
    step.single = step
    step.pad = functools.partial(pack_rb_lines, offset=offset)
    step.unpad = functools.partial(unpack_rb_lines, shape=tuple(shape),
                                   offset=offset)
    return step
