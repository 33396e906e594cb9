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

Both take the MAF (variable-coefficient) update too: ``maf_tables`` gives
the per-axis weight vectors, which the kernels index by the physical i of
each packed point (the fold only mixes the I tables).

Each wrapper launches its kernel for a CUDA tensor and raises on anything it
cannot take; for a CPU tensor it runs the plain twin, ``rb_color_plain`` /
``packed_sweeps_plain``, which computes the same per-point arithmetic
(bitwise equal in float32; see ``_fma`` and the contracts below).  Steps
update the packed state in place and return it.

Arithmetic contracts (those of the JAX package's interpreted kernels, where
XLA on the CPU contracts some products into fused multiply-adds):

* constant coefficients: ``ss = ((zm + zp) + (xm + xp)) + (ym + yp)``,
  ``ss -= b`` with a right-hand side, ``dp = fma(ss, 1/6, -centre) * omega``;
* MAF: ``r = fma(wzm, zm, round(wzp * zp))``, then ``r = fma(w, n, r)`` for
  (wxp, xp), (wxm, xm), (wyp, yp), (wym, ym) in that order, ``r += b`` with
  a right-hand side, ``dd = 2 ((c1 + c2) + c3)``, and
  ``dp = (r / dd - centre) * omega`` with a true division.

Then ``centre += dp``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.maf import FIELDS
from . import _build

# 1/6 as the JAX kernels see it: the Python float rounded to float32 (for
# float32 fields) or kept (for float64 fields)
_R6 = {torch.float32: float(np.float32(1.0 / 6.0)), torch.float64: 1.0 / 6.0}
_INF = float("inf")
_NP = {torch.float32: np.float32, torch.float64: np.float64}
# the weight vectors of maf_tables, in their order; each is (K,), (I,) or
# (J,) long, as its letter says
TABLES = (("wzm", "k"), ("wzp", "k"), ("c3", "k"), ("wxp", "i"), ("wxm", "i"),
          ("c1", "i"), ("wyp", "j"), ("wym", "j"), ("c2", "j"))


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


def _fma(a, b, c):
    """``a * b + c`` rounded once, as the kernels' ``fma`` computes it.

    PyTorch has no fma.  For float32 it is emulated exactly in float64: the
    product of two float32 values is exact in float64, the sum is rounded
    to odd (TwoSum error, then the odd neighbour when inexact), and
    rounding that to float32 gives the single rounding of the exact value.
    float64 takes a separate multiply and add: the CUDA float64 kernels
    then differ by an ulp or so."""
    if torch.result_type(a, c) == torch.float64:
        return a * b + c
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, _INF), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def maf_tables(mc, shape, dtype):
    """The MAF weight vectors of ``TABLES``, concatenated into one 1-D
    tensor of length 3 (K + I + J) on ``mc``'s device (None for ``mc``
    None).  They are computed on the host in ``dtype`` (``wxp = c1 +
    0.5 c7`` and so on), so they round as the JAX package's tables
    (rbpack.py ``_maf_tables``) and its interpreted kernels do."""
    if mc is None:
        return None
    if dtype not in _NP:
        raise TypeError(f"MAF tables take float32 or float64, not {dtype}")
    K, I, J = shape
    dt = _NP[dtype]
    c = {f: getattr(mc, f).reshape(-1).cpu().numpy().astype(dt)
         for f in FIELDS}
    for f, n in (("c1", I), ("c7", I), ("c2", J), ("c8", J), ("c3", K),
                 ("c9", K)):
        if c[f].shape != (n,):
            raise ValueError(f"MafCoeffs.{f} has {c[f].shape[0]} entries, "
                             f"the grid {n}")
    half = dt(0.5)
    w = {
        "wzm": c["c3"] - half * c["c9"], "wzp": c["c3"] + half * c["c9"],
        "c3": c["c3"],
        "wxp": c["c1"] + half * c["c7"], "wxm": c["c1"] - half * c["c7"],
        "c1": c["c1"],
        "wyp": c["c2"] + half * c["c8"], "wym": c["c2"] - half * c["c8"],
        "c2": c["c2"],
    }
    tab = np.concatenate([w[name] for name, _ in TABLES])
    return torch.from_numpy(tab).to(mc.c1.device)


def table_views(tab, shape) -> dict:
    """name -> 1-D view of ``tab`` (see ``maf_tables``)."""
    K, I, J = shape
    n = {"k": K, "i": I, "j": J}
    views, at = {}, 0
    for name, axis in TABLES:
        views[name] = tab[at:at + n[axis]]
        at += n[axis]
    return views


def maf_r(w, nb):
    """The MAF neighbour sum of the contract above, from the weights ``w``
    and neighbour values ``nb`` (dicts keyed wzm/zm, wzp/zp, ...)."""
    r = _fma(w["wzm"], nb["zm"], w["wzp"] * nb["zp"])
    for a in ("xp", "xm", "yp", "ym"):
        r = _fma(w["w" + a], nb[a], r)
    return r


def colour_update(xp, bp, colour: int, omega: float, offset: int = 0,
                  tab=None):
    """(centre, upd, sel) for colour ``colour`` of the packed state ``xp``
    at k in [1, K-2], every i2, j in [1, J-2]: ``centre`` the view of those
    points, ``upd`` their unmasked dp, ``sel`` True where the point's
    physical i is 2*i2 + 1.  The sums of ``_pair_update`` /
    ``_pair_update_maf`` (rbpack.py:132-146, 176-187), in their order;
    ``tab`` (``maf_tables``) selects the MAF update."""
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
    b = None if bp is None else bp[colour, 1:-1, :, 1:-1]
    om = torch.tensor(omega, dtype=xp.dtype, device=xp.device)
    if tab is None:
        ssk = oth[:-2, :, 1:-1] + oth[2:, :, 1:-1]
        ssi = oc + torch.where(sel, up, dn)
        ssj = oth[1:-1, :, :-2] + oth[1:-1, :, 2:]
        ss = ssk + ssi + ssj
        if b is not None:
            ss = ss - b
        r6 = torch.tensor(_R6[xp.dtype], dtype=xp.dtype, device=xp.device)
        upd = _fma(ss, r6, -cen) * om
    else:
        t = table_views(tab, (K, 2 * I2, J))
        i = 2 * torch.arange(I2, device=xp.device)[None, :, None] + sel.long()
        w = {"wzm": t["wzm"][1:-1, None, None], "wzp": t["wzp"][1:-1, None, None],
             "wxp": t["wxp"][i], "wxm": t["wxm"][i],
             "wyp": t["wyp"][1:-1], "wym": t["wym"][1:-1]}
        nb = {"zm": oth[:-2, :, 1:-1], "zp": oth[2:, :, 1:-1],
              "xp": torch.where(sel, up, oc), "xm": torch.where(sel, oc, dn),
              "yp": oth[1:-1, :, 2:], "ym": oth[1:-1, :, :-2]}
        r = maf_r(w, nb)
        if b is not None:
            r = r + b
        dd = 2.0 * ((t["c1"][i] + t["c2"][1:-1]) + t["c3"][1:-1, None, None])
        upd = (r / dd - cen) * om
    return cen, upd, sel


def rb_color_plain(xp, bp, colour: int, omega: float, offset: int = 0,
                   tab=None):
    """Plain PyTorch twin of ``rb_color``: update colour ``colour`` of the
    packed state ``xp`` in place; return its sum of dp^2 (float64, 0-d).
    ``tab`` (``maf_tables``) selects the MAF update."""
    cen, upd, sel = colour_update(xp, bp, colour, omega, offset, tab)
    I2 = xp.shape[2]
    i2 = torch.arange(I2, device=xp.device)[None, :, None]
    inner = ((i2 > 0) | sel) & ((i2 < I2 - 1) | ~sel)  # i in [1, I-2]
    dp = torch.where(inner, upd, 0.0)
    cen += dp
    return (dp * dp).sum(dtype=torch.float64)


def packed_sweeps_plain(xp, bp, n: int, omega: float, offset: int = 0,
                        tab=None):
    """Plain twin of ``rb_sweeps_n``: n red-black iterations in place;
    returns (xp, r2) with r2 the (n,) float64 per-iteration sums."""
    r2 = torch.empty(n, dtype=torch.float64, device=xp.device)
    for it in range(n):
        r2[it] = rb_color_plain(xp, bp, 0, omega, offset, tab) + rb_color_plain(
            xp, bp, 1, omega, offset, tab
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


def check_tab(x, tab, shape):
    """Raise unless ``tab`` fits the field ``x`` of (K, I, J) ``shape``."""
    if tab is None:
        return
    n = 3 * sum(shape)
    if (tab.dim() != 1 or tab.numel() != n or tab.dtype != x.dtype
            or tab.device != x.device or not tab.is_contiguous()):
        raise ValueError(f"MAF tables must be a contiguous ({n},) tensor of "
                         "x's dtype on x's device (maf_tables)")


def _check(xp, bp, tab=None):
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
    _, K, I2, J = xp.shape
    check_tab(xp, tab, (K, 2 * I2, J))


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def count(fn, tab):
    """One more launch of ``fn``'s kernel (and of its MAF form)."""
    fn.launches += 1
    fn.maf_launches += tab is not None


def rb_color(xp, bp, colour: int, omega: float, offset: int = 0, tab=None):
    """Launch ``rb_color_kernel``: colour ``colour`` of one iteration, in
    place; ``tab`` (``maf_tables``) selects the MAF form.  Returns the
    float64 sum of dp^2 (0-d, on the device).  A CPU tensor runs the plain
    twin."""
    if not xp.is_cuda:
        return rb_color_plain(xp, bp, colour, omega, offset, tab)
    _check(xp, bp, tab)
    lib = _build.load()
    cells = _cells(xp)
    if not cells:
        return torch.zeros((), dtype=torch.float64, device=xp.device)
    nblocks = -(-cells // lib.cz_threads_per_block())
    # per-block sums of dp^2, in the field's dtype
    partials = torch.empty(nblocks, dtype=xp.dtype, device=xp.device)
    _, K, I2, J = xp.shape
    rc = getattr(lib, f"cz_rb_color_{_SUFFIX[xp.dtype]}")(
        xp.data_ptr(), ptr(bp), ptr(tab), partials.data_ptr(), K, I2, J,
        colour, offset, omega, cells, xp.device.index, stream(xp),
    )
    _build.check(rc, "rb_color")
    count(rb_color, tab)
    return partials.sum(dtype=torch.float64)


rb_color.launches = rb_color.maf_launches = 0

_MAX_BLOCKS: dict = {}


def rb_sweeps_n(xp, bp, n: int, omega: float, offset: int = 0, tab=None):
    """Launch ``rb_sweeps_kernel``: n full iterations in one cooperative
    launch, in place; ``tab`` selects the MAF form.  Returns the (n,)
    float64 per-iteration sums of dp^2 (on the device).  A CPU tensor runs
    the plain twin."""
    if not xp.is_cuda:
        return packed_sweeps_plain(xp, bp, n, omega, offset, tab)[1]
    _check(xp, bp, tab)
    lib = _build.load()
    sfx = _SUFFIX[xp.dtype]
    dev = xp.device.index
    cells = _cells(xp)
    if not cells:
        return torch.zeros(n, dtype=torch.float64, device=xp.device)
    maf = int(tab is not None)
    key = (sfx, maf, dev)
    if key not in _MAX_BLOCKS:
        out = ctypes.c_int(0)
        _build.check(
            getattr(lib, f"cz_rb_sweeps_max_blocks_{sfx}")(maf, dev, out),
            "rb_sweeps_n occupancy",
        )
        _MAX_BLOCKS[key] = out.value
    nblocks = min(_MAX_BLOCKS[key], -(-cells // lib.cz_threads_per_block()))
    partials = torch.empty(n * 2 * nblocks, dtype=xp.dtype, device=xp.device)
    r2 = torch.empty(n, dtype=torch.float64, device=xp.device)
    _, K, I2, J = xp.shape
    rc = getattr(lib, f"cz_rb_sweeps_n_{sfx}")(
        xp.data_ptr(), ptr(bp), ptr(tab), partials.data_ptr(), r2.data_ptr(),
        K, I2, J, n, offset, omega, cells, nblocks, dev, stream(xp),
    )
    _build.check(rc, "rb_sweeps_n")
    count(rb_sweeps_n, tab)
    return r2


rb_sweeps_n.launches = rb_sweeps_n.maf_launches = 0


# --------------------------------------------------------------------------
# builders (the JAX package's names and step contract)
# --------------------------------------------------------------------------


def _refuses(shape, dtype) -> bool:
    """True where the JAX package's packed layout refuses: odd I.  Raises
    for a dtype the kernels do not take."""
    if dtype not in _SUFFIX:
        raise TypeError(f"packed sweeps take float32 or float64, not {dtype}")
    return shape[1] % 2 == 1


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
    ``rb_color`` launches), r2 a 0-d float64 tensor.  ``mc`` (MafCoeffs)
    selects the MAF update.  None for odd I.  ``plain`` runs the twin on
    any device."""
    if _refuses(shape, dtype):
        return None
    tab = maf_tables(mc, shape, dtype)
    red_black = rb_color_plain if plain else rb_color

    def step(xp, bp):
        b = None if b_is_zero else bp
        r2 = red_black(xp, b, 0, omega, offset, tab)
        return xp, r2 + red_black(xp, b, 1, omega, offset, tab)

    return _attach(step, shape, offset, 1)


def _make_n(shape, dtype, omega, n, offset, b_is_zero, plain, mc):
    tab = maf_tables(mc, shape, dtype)
    sweeps = (
        (lambda xp, b: packed_sweeps_plain(xp, b, n, omega, offset, tab)[1])
        if plain else
        (lambda xp, b: rb_sweeps_n(xp, b, n, omega, offset, tab))
    )

    def step(xp, bp):
        return xp, sweeps(xp, None if b_is_zero else bp)

    single = make_packed_sweep(shape, dtype, omega=omega, offset=offset,
                               b_is_zero=b_is_zero, mc=mc, plain=plain)
    return _attach(step, shape, offset, n, single)


def make_packed_sweep2x(shape, dtype=torch.float32, *, omega: float,
                        offset: int = 0, b_is_zero: bool = True, mc=None,
                        plain: bool = False):
    """Two iterations per call (``rb_sweeps_n`` with n = 2, optional b);
    r2 is a (2,) vector.  ``mc`` selects the MAF update.  None for odd I."""
    if _refuses(shape, dtype):
        return None
    return _make_n(shape, dtype, omega, 2, offset, b_is_zero, plain, mc)


def make_packed_sweepnx(shape, dtype=torch.float32, *, omega: float,
                        n: int = 3, offset: int = 0, mc=None,
                        plain: bool = False):
    """``n`` iterations per call, zero right-hand side (``bp`` is ignored);
    r2 is an (n,) vector.  None for odd I, or n outside 2..9 (2..7 with
    ``mc``): the JAX package's bounds."""
    if _refuses(shape, dtype) or not 2 <= n <= (9 if mc is None else 7):
        return None
    return _make_n(shape, dtype, omega, n, offset, True, plain, mc)
