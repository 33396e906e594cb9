"""Distributed packed red-black SOR: the window chain on one mesh block with
a deep ghost ring, K7 (PyTorch/CUDA port of
``cubez_tpu/pallas_kernels/dist_rbpack.py``, whose kernel is the window
chain ``sweeps2x.build_nx``).

A block's owned (lk, li, lj) cells are extended by a ring of depth
``hs = (hz, hx, hy)``: 2n on each split mesh axis, 0 on the others.  The
extended block is folded by colour as ``rbpack.pack_rb`` folds a field
(offset 0): (2, Ke, Ie/2, Je), no tile padding.  Block extents and depths
are even, so every block origin is even and the extended-local colour
parity equals the global one: all blocks share one fold, and ghost slabs
move between blocks as verbatim slices (parallel/dist_pack.py).

One call runs ``n`` full red-black iterations (``dist_rb_sweeps``, one
cooperative launch of csrc/dist_rbpack.cu).  A point updates where its
7-point neighbourhood lies in the extended array and it is a global inner
point, from the block's global origin and the global shape; the residual
sums dp^2 over the owned box only.  With depth h >= 2n the owned cells are
bitwise the serial n-iteration result (the JAX module's argument: each
iteration consumes two ring layers).  ``n = 1`` on a depth-2n ring is the
step's one-iteration form, with which the driver replays the stopping
chunk, so a distributed solve ends on the serial port's field bit for bit
at any ``check_every``.  (The JAX package's driver returns the field at
the end of the stopping chunk instead; its kernel refuses n < 2.)

The MAF form takes the serial weight vectors (``rbpack.maf_tables``)
sliced at the block's extended origin; entries outside the grid are 1.0,
as in the JAX package's ``_maf_global_tables``, and only ever meet masked
points.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
twin ``dist_sweeps_plain`` (bitwise equal in float32).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .rbpack import (_SUFFIX, TABLES, colour_update, count, maf_tables,
                     pack_rb, ptr, stream, table_views, unpack_rb)

# DistGeom's fields (csrc/dist_rbpack.cu), in order
GEOM = ("hz", "hx", "hy", "lk", "li", "lj", "k0", "i0", "j0", "Kg", "Ig", "Jg")


def ext_dims(block_shape, hs):
    """Extended per-block dims for depths ``hs``: (Ke, Ie, Je, I2e).  The
    JAX function also returns its (8, 128) tile paddings, which the port
    does not have."""
    Ke, Ie, Je = (s + 2 * h for s, h in zip(block_shape, hs))
    return Ke, Ie, Je, Ie // 2


def pack_ext_block(xb: torch.Tensor, hs) -> torch.Tensor:
    """Owned (lk, li, lj) block -> extended packed (2, Ke, Ie/2, Je) with
    zero ghosts (the exchange fills them before every window)."""
    hz, hx, hy = hs
    return pack_rb(F.pad(xb, (hy, hy, hx, hx, hz, hz)))


def unpack_ext_block(xp: torch.Tensor, block_shape, hs):
    """Inverse of :func:`pack_ext_block` (owned cells only)."""
    lk, li, lj = block_shape
    hz, hx, hy = hs
    Ke, Ie, Je, _ = ext_dims(block_shape, hs)
    ext = unpack_rb(xp, (Ke, Ie, Je))
    return ext[hz:hz + lk, hx:hx + li, hy:hy + lj]


def geometry(block_shape, gshape, hs, origin) -> tuple:
    """The ``GEOM`` tuple of a block with owned origin ``origin``."""
    return (*hs, *block_shape, *origin, *gshape)


def _dist_parity_masks(sel, geom, shape):
    """Update mask for one colour at k in [1, Ke-2], every i2, j in
    [1, Je-2] of the extended packed block (``sel`` as from
    ``rbpack.colour_update``): the extended-array interior AND the global
    inner points."""
    hz, hx, hy, _, _, _, k0, i0, j0, Kg, Ig, Jg = geom
    _, Ke, I2e, Je = shape
    dev = sel.device
    k = torch.arange(1, Ke - 1, device=dev)[:, None, None]
    j = torch.arange(1, Je - 1, device=dev)[None, None, :]
    i = 2 * torch.arange(I2e, device=dev)[None, :, None] + sel.long()
    gk, gi, gj = k + (k0 - hz), i + (i0 - hx), j + (j0 - hy)
    return ((i >= 1) & (i <= 2 * I2e - 2) & (gk >= 1) & (gk <= Kg - 2)
            & (gi >= 1) & (gi <= Ig - 2) & (gj >= 1) & (gj <= Jg - 2))


def _owned_mask(geom, shape, device):
    """The owned box at k in [1, Ke-2], every i2, j in [1, Je-2]: whole
    packed pair-rows (even depths and extents), the same for both
    colours."""
    hz, hx, hy, lk, li, lj = geom[:6]
    _, Ke, I2e, Je = shape
    k = torch.arange(1, Ke - 1, device=device)[:, None, None]
    i2 = torch.arange(I2e, device=device)[None, :, None]
    j = torch.arange(1, Je - 1, device=device)[None, None, :]
    return ((k >= hz) & (k < hz + lk) & (2 * i2 >= hx) & (2 * i2 < hx + li)
            & (j >= hy) & (j < hy + lj))


def dist_sweeps_plain(xp, n: int, omega: float, geom, tab=None):
    """Plain twin of ``dist_rb_sweeps``: n red-black iterations in place on
    the extended packed block; returns the (n,) float64 sums of the owned
    dp^2."""
    own = _owned_mask(geom, xp.shape, xp.device)
    r2 = torch.empty(n, dtype=torch.float64, device=xp.device)
    for it in range(n):
        tot = torch.zeros((), dtype=torch.float64, device=xp.device)
        for colour in (0, 1):
            cen, upd, sel = colour_update(xp, None, colour, omega, 0, tab)
            dp = torch.where(_dist_parity_masks(sel, geom, xp.shape), upd, 0.0)
            cen += dp
            dpo = torch.where(own, dp, 0.0)
            tot = tot + (dpo * dpo).sum(dtype=torch.float64)
        r2[it] = tot
    return r2


def _maf_global_tables(mc, gshape, hs, dtype):
    """The serial weight vectors (``rbpack.maf_tables``), each padded with
    its axis's ring depth of 1.0 on both sides: entry e + o of a padded
    vector is the weight of extended-local index e in a block of owned
    origin o."""
    tab = maf_tables(mc, gshape, dtype)
    depth = dict(zip("kij", hs))
    out = {}
    for name, v in table_views(tab, gshape).items():
        h = depth[dict(TABLES)[name]]
        ones = torch.ones(h, dtype=v.dtype, device=v.device)
        out[name] = torch.cat([ones, v, ones])
    return out


def _block_tables(gtab, ext, origin, device):
    """One block's MAF tables (the ``maf_tables`` layout of its extended
    (Ke, Ie, Je) field) on ``device``."""
    n = dict(zip("kij", ext))
    o = dict(zip("kij", origin))
    return torch.cat([
        gtab[name][o[axis]:o[axis] + n[axis]] for name, axis in TABLES
    ]).to(device)


_MAX_BLOCKS: dict = {}


def _check(xp, geom, tab):
    if xp.dtype not in _SUFFIX:
        raise TypeError(f"K7 takes float32 or float64, not {xp.dtype}")
    if xp.dim() != 4 or xp.shape[0] != 2 or not xp.is_contiguous():
        raise ValueError(f"need a contiguous (2, Ke, Ie/2, Je) block, got "
                         f"{tuple(xp.shape)} contiguous={xp.is_contiguous()}")
    if xp.numel() >= 2**31:
        raise ValueError("extended block too large for 32-bit indexing")
    _, Ke, I2e, Je = xp.shape
    if ext_dims(geom[3:6], geom[:3]) != (Ke, 2 * I2e, Je, I2e):
        raise ValueError(f"block {tuple(xp.shape)} does not match {geom}")
    if tab is not None and (tab.dim() != 1 or tab.numel() != 3 * (Ke + 2 * I2e + Je)
                            or tab.dtype != xp.dtype or tab.device != xp.device
                            or not tab.is_contiguous()):
        raise ValueError("MAF tables must be a contiguous 1-D tensor of the "
                         "extended block's tables, its dtype and device")


def dist_rb_sweeps(xp, n: int, omega: float, geom, tab=None):
    """Launch ``dist_rb_sweeps_kernel``: n red-black iterations on the
    extended packed block ``xp`` in place, in one cooperative launch;
    ``geom`` as ``geometry`` gives it; ``tab`` (``make_dist_packed_sweepnx``'s
    ``block_tables``) selects MAF.  Returns the (n,) float64 owned sums of
    dp^2 on the device.  A CPU tensor runs the plain twin."""
    if not xp.is_cuda:
        return dist_sweeps_plain(xp, n, omega, geom, tab)
    _check(xp, geom, tab)
    lib = _build.load()
    sfx = _SUFFIX[xp.dtype]
    dev = xp.device.index
    _, Ke, I2e, Je = xp.shape
    cells = max(Ke - 2, 0) * I2e * max(Je - 2, 0)
    if not cells:
        return torch.zeros(n, dtype=torch.float64, device=xp.device)
    maf = int(tab is not None)
    key = (sfx, maf, dev)
    if key not in _MAX_BLOCKS:
        out = ctypes.c_int(0)
        _build.check(getattr(lib, f"cz_dist_rb_max_blocks_{sfx}")(maf, dev, out),
                     "dist_rb_sweeps occupancy")
        _MAX_BLOCKS[key] = out.value
    nblocks = min(_MAX_BLOCKS[key], -(-cells // lib.cz_threads_per_block()))
    partials = torch.empty(n * 2 * nblocks, dtype=xp.dtype, device=xp.device)
    r2 = torch.empty(n, dtype=torch.float64, device=xp.device)
    g = (ctypes.c_int * len(GEOM))(*geom)
    rc = getattr(lib, f"cz_dist_rb_sweeps_{sfx}")(
        xp.data_ptr(), ptr(tab), partials.data_ptr(), r2.data_ptr(), Ke, I2e, Je,
        n, 0, omega, cells, g, nblocks, dev, stream(xp),
    )
    _build.check(rc, "dist_rb_sweeps")
    count(dist_rb_sweeps, tab)
    return r2


dist_rb_sweeps.launches = dist_rb_sweeps.maf_launches = 0


def make_dist_packed_sweepnx(block_shape, gshape, dtype=torch.float32, *,
                             omega: float, n: int, split=(True, True, True),
                             h: int | None = None, mc=None,
                             plain: bool = False):
    """Build ``kernel(xp, origin, tab=None) -> r2``: ``n`` red-black
    iterations in place on one extended packed block of owned origin
    ``origin`` = (k0, i0, j0), ring depth ``h`` (default 2n, at least 2n) on
    each axis whose ``split`` flag is set; r2 the (n,) float64 owned sums.
    ``mc`` (MafCoeffs) selects the MAF update, whose per-block tables
    ``kernel.block_tables(origin, device)`` makes.  ``plain`` runs the twin
    on any device.  None where the JAX package refuses (odd block extents,
    n outside 2..9, or 2..7 with ``mc``; a ring deeper than the block,
    whose exchange slabs would not be owned cells) or the port does (a ring
    shallower than 2n); the port also takes n = 1."""
    h = 2 * n if h is None else h
    hs = tuple(h if s else 0 for s in split)
    if (
        not 1 <= n <= (7 if mc is not None else 9) or h < 2 * n
        or any(d % 2 for d in block_shape)
        or any(g > d for g, d in zip(hs, block_shape))
    ):
        return None
    ext = ext_dims(block_shape, hs)[:3]
    sweeps = dist_sweeps_plain if plain else dist_rb_sweeps
    gtab = None if mc is None else _maf_global_tables(mc, gshape, hs, dtype)

    def kernel(xp, origin, tab=None):
        geom = geometry(block_shape, gshape, hs, origin)
        return sweeps(xp, n, omega, geom, tab)

    def block_tables(origin, device):
        return _block_tables(gtab, ext, origin, device)

    kernel.block_tables = block_tables
    kernel.hs = hs
    kernel.maf = mc is not None
    kernel.iters_per_call = n
    return kernel
