"""Packed red-black SOR sweeps (PyTorch/CUDA port of
``cubez_tpu/pallas_kernels/rbpack.py`` and of the packed callers of
``sweeps2x.build_2x``/``build_nx``).

Layout: the (K, I, J) field folded along I into two dense colour halves,
``xp[c, k, i2, j] = x[k, 2*i2 + s_c(k, j), j]`` with
``s_red = (k + j + offset + 1) % 2`` and ``s_black = 1 - s_red`` (the JAX
package's map, rbpack.py:64-85).  Shape (2, K, I/2, J), J contiguous.  The
TPU tile padding and the K pad of 2 are dropped: the kernels mask on the
true bounds and never read outside the array.

Two kernels carry every builder (csrc/rbpack.cu):

* ``rb_color``: one colour of one iteration (K1, the single packed sweep,
  is two launches: red, then black);
* ``rb_sweeps_n``: n full iterations in one cooperative launch, with an
  optional right-hand side (K2, the pair, is n = 2 with b; K3, the window
  chain, is n >= 3 without).

Each wrapper launches its kernel for a CUDA tensor and raises on anything it
cannot take; for a CPU tensor it runs the plain twin, ``rb_color_plain`` /
``packed_sweeps_plain``, which computes the same per-point arithmetic
(bitwise equal in float32; see ``_fma_r6``).  Steps update the packed state
in place and return it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

# 1/6 as the JAX kernels see it: the Python float rounded to float32 (for
# float32 fields) or kept (for float64 fields)
_R6 = {torch.float32: float(np.float32(1.0 / 6.0)), torch.float64: 1.0 / 6.0}
_INF = float("inf")


def _red_even(K, J, offset, device):
    k = torch.arange(K, device=device)[:, None, None]
    j = torch.arange(J, device=device)[None, None, :]
    return (k + j + offset + 1) % 2 == 0  # red sits on the even i rows


def pack_rb(a: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """(K, I, J) field -> packed (2, K, I/2, J) red/black pair.  I must be
    even.  Apply to x and b alike."""
    K, I, J = a.shape
    if I % 2:
        raise ValueError("rbpack needs even I")
    xe, xo = a[:, 0::2, :], a[:, 1::2, :]
    red_even = _red_even(K, J, offset, a.device)
    return torch.stack(
        [torch.where(red_even, xe, xo), torch.where(red_even, xo, xe)]
    )


def unpack_rb(p: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_rb`."""
    K, I, J = shape
    red_even = _red_even(K, J, offset, p.device)
    xe = torch.where(red_even, p[0], p[1])
    xo = torch.where(red_even, p[1], p[0])
    return torch.stack([xe, xo], dim=2).reshape(K, I, J)


# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------


def _fma_r6(ss: torch.Tensor, cen: torch.Tensor) -> torch.Tensor:
    """``fma(ss, R6, -cen)`` rounded once, as the kernels compute it.

    The JAX kernel in interpret mode contracts ``ss * R6 - centre`` into a
    fused multiply-add, and the CUDA kernels use ``__fmaf_rn``.  For float32
    the fma is emulated exactly in float64: the product of two float32
    values is exact in float64, the sum is rounded to odd (TwoSum error,
    then the odd neighbour when inexact), and rounding that to float32 gives
    the single rounding of the exact value.  PyTorch has no fma, so float64
    fields take a separate multiply and subtract: the CUDA float64 kernel
    then differs by an ulp or so."""
    if ss.dtype == torch.float64:
        return ss * _R6[torch.float64] - cen
    p = ss.double() * _R6[torch.float32]
    c = -cen.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, _INF), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def rb_color_plain(xp, bp, colour: int, omega: float, offset: int = 0):
    """Plain PyTorch twin of ``rb_color``: update colour ``colour`` of the
    packed state ``xp`` in place; return its sum of dp^2 (float64, 0-d).
    The sums of ``_pair_update`` (rbpack.py:132-146), in its order."""
    _, K, I2, J = xp.shape
    cen = xp[colour, 1:-1, :, 1:-1]
    oth = xp[1 - colour]
    oc = oth[1:-1, :, 1:-1]
    k = torch.arange(1, K - 1, device=xp.device)[:, None, None]
    j = torch.arange(1, J - 1, device=xp.device)[None, None, :]
    sel = ((k + j + offset + 1 + colour) & 1) == 1  # physical i = 2*i2 + 1
    up = torch.zeros_like(oc)
    up[:, :-1] = oc[:, 1:]
    dn = torch.zeros_like(oc)
    dn[:, 1:] = oc[:, :-1]
    ssk = oth[:-2, :, 1:-1] + oth[2:, :, 1:-1]
    ssi = oc + torch.where(sel, up, dn)
    ssj = oth[1:-1, :, :-2] + oth[1:-1, :, 2:]
    ss = ssk + ssi + ssj
    if bp is not None:
        ss = ss - bp[colour, 1:-1, :, 1:-1]
    om = torch.tensor(omega, dtype=xp.dtype, device=xp.device)
    upd = _fma_r6(ss, cen) * om
    i2 = torch.arange(I2, device=xp.device)[None, :, None]
    inner = ((i2 > 0) | sel) & ((i2 < I2 - 1) | ~sel)  # i in [1, I-2]
    dp = torch.where(inner, upd, 0.0)
    cen += dp
    return (dp * dp).sum(dtype=torch.float64)


def packed_sweeps_plain(xp, bp, n: int, omega: float, offset: int = 0):
    """Plain twin of ``rb_sweeps_n``: n red-black iterations in place;
    returns (xp, r2) with r2 the (n,) float64 per-iteration sums."""
    r2 = torch.empty(n, dtype=torch.float64, device=xp.device)
    for it in range(n):
        r2[it] = rb_color_plain(xp, bp, 0, omega, offset) + rb_color_plain(
            xp, bp, 1, omega, offset
        )
    return xp, r2


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _cells(xp):
    """Interior points of one colour: k in [1, K-2], all i2, j in [1, J-2]."""
    _, K, I2, J = xp.shape
    return max(K - 2, 0) * I2 * max(J - 2, 0)


def _check(xp, bp):
    if not xp.is_cuda:
        raise ValueError("kernel launch needs a CUDA tensor")
    if xp.dtype not in _SUFFIX:
        raise TypeError(f"packed sweeps take float32 or float64, not {xp.dtype}")
    if xp.dim() != 4 or xp.shape[0] != 2 or not xp.is_contiguous():
        raise ValueError(f"need a contiguous (2, K, I/2, J) state, got "
                         f"{tuple(xp.shape)} contiguous={xp.is_contiguous()}")
    if xp.numel() >= 2**31:
        raise ValueError("packed state too large for 32-bit indexing")
    if bp is not None and (
        bp.shape != xp.shape or bp.dtype != xp.dtype
        or bp.device != xp.device or not bp.is_contiguous()
    ):
        raise ValueError("b must match x in shape, dtype, device and layout")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(xp):
    return torch.cuda.current_stream(xp.device).cuda_stream


def rb_color(xp, bp, colour: int, omega: float, offset: int = 0):
    """Launch ``rb_color_kernel``: colour ``colour`` of one iteration, in
    place.  Returns the float64 sum of dp^2 (0-d, on the device).  A CPU
    tensor runs the plain twin."""
    if not xp.is_cuda:
        return rb_color_plain(xp, bp, colour, omega, offset)
    _check(xp, bp)
    lib = _build.load()
    cells = _cells(xp)
    if not cells:
        return torch.zeros((), dtype=torch.float64, device=xp.device)
    nblocks = -(-cells // lib.cz_threads_per_block())
    # per-block sums of dp^2, in the field's dtype
    partials = torch.empty(nblocks, dtype=xp.dtype, device=xp.device)
    _, K, I2, J = xp.shape
    rc = getattr(lib, f"cz_rb_color_{_SUFFIX[xp.dtype]}")(
        xp.data_ptr(), _ptr(bp), partials.data_ptr(), K, I2, J, colour,
        offset, omega, cells, xp.device.index, _stream(xp),
    )
    _build.check(rc, "rb_color")
    rb_color.launches += 1
    return partials.sum(dtype=torch.float64)


rb_color.launches = 0

_MAX_BLOCKS: dict = {}


def rb_sweeps_n(xp, bp, n: int, omega: float, offset: int = 0):
    """Launch ``rb_sweeps_kernel``: n full iterations in one cooperative
    launch, in place.  Returns the (n,) float64 per-iteration sums of dp^2
    (on the device).  A CPU tensor runs the plain twin."""
    if not xp.is_cuda:
        return packed_sweeps_plain(xp, bp, n, omega, offset)[1]
    _check(xp, bp)
    lib = _build.load()
    sfx = _SUFFIX[xp.dtype]
    dev = xp.device.index
    cells = _cells(xp)
    if not cells:
        return torch.zeros(n, dtype=torch.float64, device=xp.device)
    key = (sfx, dev)
    if key not in _MAX_BLOCKS:
        out = ctypes.c_int(0)
        _build.check(
            getattr(lib, f"cz_rb_sweeps_max_blocks_{sfx}")(dev, out),
            "rb_sweeps_n occupancy",
        )
        _MAX_BLOCKS[key] = out.value
    nblocks = min(_MAX_BLOCKS[key], -(-cells // lib.cz_threads_per_block()))
    partials = torch.empty(n * 2 * nblocks, dtype=xp.dtype, device=xp.device)
    r2 = torch.empty(n, dtype=torch.float64, device=xp.device)
    _, K, I2, J = xp.shape
    rc = getattr(lib, f"cz_rb_sweeps_n_{sfx}")(
        xp.data_ptr(), _ptr(bp), partials.data_ptr(), r2.data_ptr(), K, I2, J,
        n, offset, omega, cells, nblocks, dev, _stream(xp),
    )
    _build.check(rc, "rb_sweeps_n")
    rb_sweeps_n.launches += 1
    return r2


rb_sweeps_n.launches = 0


# --------------------------------------------------------------------------
# builders (the JAX package's names and step contract)
# --------------------------------------------------------------------------


def _refuses(shape, dtype, mc) -> bool:
    """True where the JAX package's packed layout refuses: odd I, or MAF
    coefficients (slice 2).  Raises for a dtype the kernels do not take."""
    if dtype not in _SUFFIX:
        raise TypeError(f"packed sweeps take float32 or float64, not {dtype}")
    return shape[1] % 2 == 1 or mc is not None


def _attach(step, shape, offset, ipc, single=None):
    step.iters_per_call = ipc
    step.pad = functools.partial(pack_rb, offset=offset)
    step.unpad = functools.partial(unpack_rb, shape=shape, offset=offset)
    # a one-iteration step on the same layout (driver.run_iterative replays
    # the stopping chunk with it, so the field ends at the stopping sweep)
    step.single = step if single is None else single
    return step


def make_packed_sweep(shape, dtype=torch.float32, *, omega: float,
                      offset: int = 0, b_is_zero: bool = False, mc=None,
                      plain: bool = False):
    """``step(xp, bp) -> (xp, r2)``: one red-black iteration (two
    ``rb_color`` launches), r2 a 0-d float64 tensor.  None for odd I or MAF
    coefficients (slice 2).  ``plain`` runs the twin on any device."""
    if _refuses(shape, dtype, mc):
        return None
    red_black = rb_color_plain if plain else rb_color

    def step(xp, bp):
        b = None if b_is_zero else bp
        r2 = red_black(xp, b, 0, omega, offset)
        return xp, r2 + red_black(xp, b, 1, omega, offset)

    return _attach(step, shape, offset, 1)


def _make_n(shape, dtype, omega, n, offset, b_is_zero, plain):
    sweeps = (
        (lambda xp, b: packed_sweeps_plain(xp, b, n, omega, offset)[1])
        if plain else
        (lambda xp, b: rb_sweeps_n(xp, b, n, omega, offset))
    )

    def step(xp, bp):
        return xp, sweeps(xp, None if b_is_zero else bp)

    single = make_packed_sweep(shape, dtype, omega=omega, offset=offset,
                               b_is_zero=b_is_zero, plain=plain)
    return _attach(step, shape, offset, n, single)


def make_packed_sweep2x(shape, dtype=torch.float32, *, omega: float,
                        offset: int = 0, b_is_zero: bool = True, mc=None,
                        plain: bool = False):
    """Two iterations per call (``rb_sweeps_n`` with n = 2, optional b);
    r2 is a (2,) vector.  None for odd I or MAF coefficients."""
    if _refuses(shape, dtype, mc):
        return None
    return _make_n(shape, dtype, omega, 2, offset, b_is_zero, plain)


def make_packed_sweepnx(shape, dtype=torch.float32, *, omega: float,
                        n: int = 3, offset: int = 0, mc=None,
                        plain: bool = False):
    """``n`` iterations per call, zero right-hand side (``bp`` is ignored);
    r2 is an (n,) vector.  None for odd I, MAF coefficients, or n outside
    2..9 (the JAX package's bounds)."""
    if _refuses(shape, dtype, mc) or not 2 <= n <= 9:
        return None
    return _make_n(shape, dtype, omega, n, offset, True, plain)
