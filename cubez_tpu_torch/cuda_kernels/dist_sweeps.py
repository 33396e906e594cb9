"""Block-local point sweeps of the distributed path, K8 (PyTorch/CUDA port
of ``cubez_tpu/pallas_kernels/dist_sweeps.py``).

Layout: one mesh block's owned (lk, li, lj) cells with width-1 ghost
planes, (lk+2, li+2, lj+2), contiguous; the TPU kernel's K pad and (8,
128) tile padding are dropped.  The caller refreshes the ghosts
(parallel/dist_fused.py).  A point updates where it is an owned cell and a
global inner point, from the block's global origin and the global shape;
red-black colour c holds (i + j + k + offset + 1) % 2 == c in global
indices.

``block_sweep`` launches csrc/dist_sweeps.cu:

* ``kind='jacobi'``: one Jacobi pass, out of place (never writes ``x``);
* ``kind='sor2sma'``, ``colour`` 0 or 1: one colour, in place;
* ``kind='sor2sma'``, ``colour`` None: colour 0 then colour 1 in one
  cooperative launch, the ghosts keeping their pre-iteration values (the
  reference's one exchange per iteration, dist_sweeps.py:10-15);
* ``region``: 'all', 'interior' (off the one-cell local shell: the TPU
  kernel's ``shrink_shell``) or 'shell' (the shell alone; the overlap
  step's second pass).

Arithmetic: the TPU kernel's ``_delta`` (dist_sweeps.py:88-100) as XLA
contracts it, ``ss = ((((zm + zp) + xm) + xp) + ym) + yp``, ``ss -= b``,
``dp = fma(ss, 1/6, -centre) * omega``: the neighbour sum is a chain, not
K4's pairwise sum.  A CPU tensor runs the plain twin ``block_sweep_plain``
(bitwise equal in float32).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .rbpack import _R6, _SUFFIX, _fma, ptr, stream

KINDS = ("jacobi", "sor2sma")
REGIONS = ("all", "interior", "shell")


def block_layout(block_shape):
    """(lk, li, lj) -> the ghosted block state shape (lk+2, li+2, lj+2)."""
    return tuple(s + 2 for s in block_shape)


def pad_block(xb: torch.Tensor) -> torch.Tensor:
    """Owned (lk, li, lj) block -> ghosted (lk+2, li+2, lj+2), zero ghosts."""
    return torch.nn.functional.pad(xb, (1, 1, 1, 1, 1, 1))


def unpad_block(xp: torch.Tensor) -> torch.Tensor:
    """The owned cells of a ghosted block."""
    return xp[1:-1, 1:-1, 1:-1]


def _dist_masks(block_shape, geom, region: str, device):
    """(update, parity) on the owned cells: update where the cell is a
    global inner point (and in ``region``); parity (gk + gi + gj + offset +
    1) % 2.  ``geom`` = (k0, i0, j0, Kg, Ig, Jg, offset)."""
    k0, i0, j0, Kg, Ig, Jg, offset = geom
    ax = []
    for l, o, G in zip(block_shape, (k0, i0, j0), (Kg, Ig, Jg)):
        loc = torch.arange(l, device=device)
        ax.append((loc, loc + o, G))
    shp = ((-1, 1, 1), (1, -1, 1), (1, 1, -1))
    upd = None
    inner = None
    for (loc, g, G), s in zip(ax, shp):
        ok = ((g >= 1) & (g <= G - 2)).view(s)
        upd = ok if upd is None else upd & ok
        inn = ((loc >= 1) & (loc <= loc.numel() - 2)).view(s)
        inner = inn if inner is None else inner & inn
    if region == "interior":
        upd = upd & inner
    elif region == "shell":
        upd = upd & ~inner
    par = (ax[0][1].view(shp[0]) + ax[1][1].view(shp[1]) + ax[2][1].view(shp[2])
           + offset + 1) % 2
    return upd, par


def _delta(x, b, omega):
    """(centre view, unmasked dp) on the owned cells of a ghosted block."""
    cen = x[1:-1, 1:-1, 1:-1]
    ss = (((((x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1]) + x[1:-1, :-2, 1:-1])
            + x[1:-1, 2:, 1:-1]) + x[1:-1, 1:-1, :-2]) + x[1:-1, 1:-1, 2:])
    if b is not None:
        ss = ss - b[1:-1, 1:-1, 1:-1]
    r6 = torch.tensor(_R6[x.dtype], dtype=x.dtype, device=x.device)
    om = torch.tensor(omega, dtype=x.dtype, device=x.device)
    return cen, _fma(ss, r6, -cen) * om


def block_sweep_plain(x, b, kind: str, colour, omega: float, geom,
                      region: str = "all"):
    """Plain twin of ``block_sweep``: (new block, float64 sum of dp^2).
    Jacobi returns a new tensor; the red-black forms update ``x`` in place
    and return it."""
    bs = tuple(s - 2 for s in x.shape)
    upd, par = _dist_masks(bs, geom, region, x.device)
    if kind == "jacobi":
        cen, dp = _delta(x, b, omega)
        dp = torch.where(upd, dp, 0.0)
        out = x.clone()
        out[1:-1, 1:-1, 1:-1] += dp
        return out, (dp * dp).sum(dtype=torch.float64)
    r2 = torch.zeros((), dtype=torch.float64, device=x.device)
    for c in ((0, 1) if colour is None else (colour,)):
        cen, dp = _delta(x, b, omega)
        dp = torch.where(upd & (par == c), dp, 0.0)
        cen += dp
        r2 = r2 + (dp * dp).sum(dtype=torch.float64)
    return x, r2


def _check(x, b, out, kind, colour, region):
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    if region not in REGIONS:
        raise ValueError(f"region must be one of {REGIONS}, not {region!r}")
    if colour not in (None, 0, 1) or (kind == "jacobi" and colour is not None):
        raise ValueError(f"colour {colour!r} does not fit kind {kind!r}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"K8 takes float32 or float64, not {x.dtype}")
    if x.dim() != 3 or min(x.shape) < 3 or not x.is_contiguous():
        raise ValueError(f"need a contiguous (lk+2, li+2, lj+2) block, got "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    if x.numel() >= 2**31:
        raise ValueError("block too large for 32-bit indexing")
    for name, t in (("b", b), ("out", out)):
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype
                              or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must match x in shape, dtype, device "
                             "and layout")
    if out is not None and out.data_ptr() == x.data_ptr():
        raise ValueError("out must not be x (the Jacobi pass is out of place)")


_MAX_BLOCKS: dict = {}


def block_sweep(x, b, kind: str, colour, omega: float, geom,
                region: str = "all", out=None):
    """Launch K8 on the ghosted block ``x``: ``kind``/``colour``/``region``
    as the module says; ``geom`` = (k0, i0, j0, Kg, Ig, Jg, offset); ``b``
    None for a zero right-hand side; ``out`` the Jacobi pass's output (a
    new tensor when None).  Returns (new block, float64 sum of dp^2 on the
    device).  A CPU tensor runs the plain twin."""
    if not x.is_cuda:
        return block_sweep_plain(x, b, kind, colour, omega, geom, region)
    _check(x, b, out, kind, colour, region)
    lib = _build.load()
    sfx = _SUFFIX[x.dtype]
    dev = x.device.index
    cells = x.numel()
    nblocks = -(-cells // lib.cz_threads_per_block())
    if kind == "jacobi":
        out = torch.empty_like(x) if out is None else out
    else:
        out = x
    if colour is None and kind == "sor2sma":
        key = (sfx, dev)
        if key not in _MAX_BLOCKS:
            cnt = ctypes.c_int(0)
            _build.check(getattr(lib, f"cz_block_sweep_max_blocks_{sfx}")(dev, cnt),
                         "block_sweep occupancy")
            _MAX_BLOCKS[key] = cnt.value
        nblocks = min(nblocks, _MAX_BLOCKS[key])
    passes = 2 if (kind == "sor2sma" and colour is None) else 1
    partials = torch.empty(passes * nblocks, dtype=x.dtype, device=x.device)
    g = (ctypes.c_int * 7)(*geom)
    lk, li, lj = (s - 2 for s in x.shape)
    rc = getattr(lib, f"cz_block_sweep_{sfx}")(
        x.data_ptr(), ptr(b), out.data_ptr(), partials.data_ptr(),
        KINDS.index(kind), -1 if colour is None else colour, REGIONS.index(region),
        lk, li, lj, omega, g, nblocks, dev, stream(x),
    )
    _build.check(rc, "block_sweep")
    block_sweep.launches += 1
    v = variant(kind, colour, region)
    block_sweep.variant_launches[v] = block_sweep.variant_launches.get(v, 0) + 1
    return out, partials.sum(dtype=torch.float64)


def variant(kind: str, colour, region: str) -> str:
    """The launch's variant: 'jacobi', 'colour', 'both', or the region
    ('interior', 'shell') of a masked colour pass."""
    if kind == "jacobi":
        return "jacobi"
    if region != "all":
        return region
    return "both" if colour is None else "colour"


# launches, in all and by ``variant``
block_sweep.launches = 0
block_sweep.variant_launches = {}


def make_block_sweep(kind: str, block_shape, gshape, dtype=torch.float32, *,
                     omega: float, offset: int = 0, b_is_zero: bool = False,
                     color=None, region: str = "all", plain: bool = False):
    """Build ``sweep(x, b, origin, out=None) -> (x_new, r2)`` on the
    ghosted block state, ``origin`` the block's global (k0, i0, j0).
    ``color`` (sor2sma): 0/1 one colour (the caller refreshes the ghosts
    between colours), None both in one pass.  ``region``: see the module.
    ``plain`` runs the twin on any device.  The JAX function's
    ``shrink_shell=True`` is ``region='interior'``."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    if dtype not in _SUFFIX:
        raise TypeError(f"K8 takes float32 or float64, not {dtype}")
    fn = block_sweep_plain if plain else block_sweep

    def sweep(x, b, origin, out=None):
        geom = (*origin, *gshape, offset)
        b = None if b_is_zero else b
        if plain:
            return fn(x, b, kind, color, omega, geom, region)
        return fn(x, b, kind, color, omega, geom, region, out=out)

    return sweep
