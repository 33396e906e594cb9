"""Block-local point sweeps of the distributed path, K8 (PyTorch/CUDA port
of ``cubez_tpu/pallas_kernels/dist_sweeps.py``).

Layout: one mesh block's owned (lk, li, lj) cells with width-1 ghost
planes, (lk+2, li+2, lj+2), contiguous; the TPU kernel's K pad and (8,
128) tile padding are dropped.  The caller refreshes the ghosts
(parallel/dist_fused.py).  A point updates where it is an owned cell and a
global inner point, from the block's global origin and the global shape;
red-black colour c holds (i + j + k + offset + 1) % 2 == c in global
indices.

``BlockSweeps`` launches csrc/dist_sweeps.cu once over all the blocks of a
card (their pointers and origins by value; ``sweep_blocks`` is it for one
call, ``block_sweep`` that launch with one block, for the JAX package's
per-block ``make_block_sweep``):

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
K4's pairwise sum.  CPU blocks run the plain twins ``sweep_blocks_plain``
and ``block_sweep_plain`` (bitwise equal in float32).  The kernel writes
one partial sum of dp^2 per CTA into a dist_halo.Residual, whose fold is
the step's residual.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dist_halo import (Launches, Prepared, Residual, check_blocks, chunks,
                         current_stream, int_array, pointer_array)
from .rbpack import _R6, _SUFFIX, _fma, ptr

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


def sweep_blocks_plain(xs, bs, kind: str, colour, omega: float, origins,
                       gshape, offset: int = 0, region: str = "all"):
    """Twin of ``sweep_blocks``: ``block_sweep_plain`` on each block in
    turn.  Returns (blocks, per-block float64 sums of dp^2)."""
    res = [block_sweep_plain(x, b, kind, colour, omega, (*o, *gshape, offset),
                             region)
           for x, b, o in zip(xs, bs or [None] * len(xs), origins)]
    return [r[0] for r in res], [r[1] for r in res]


# CTAs a pass aims at for each SM of the card: a thread's k walk is a
# chain of loads, so several CTAs an SM hide their latency.  On an H100
# the eight 64^3 blocks of 128^3 took 22.8 us a colour launch at 1, 12.9-14.3
# at 2-16 (tools/prof_dist.py --tiles measures it)
CTAS_PER_SM = 4
_SMS: dict = {}
_MAX_COOP: dict = {}


def _sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _max_coop(device, dtype) -> int:
    key = (device, dtype)
    if key not in _MAX_COOP:
        cnt = ctypes.c_int(0)
        lib = _build.load()
        _build.check(getattr(lib, f"cz_block_sweep_max_blocks_{_SUFFIX[dtype]}")(
            device.index, cnt), "block_sweep occupancy")
        _MAX_COOP[key] = cnt.value
    return _MAX_COOP[key]


def launch_geometry(n: int, block_shape, device, dtype=torch.float32,
                    both: bool = False):
    """(kchunk, grid) of one launch over ``n`` blocks: the rows a work item
    walks, chosen so that the launch has about CTAS_PER_SM CTAs for each SM
    of ``device``, and the CTAs launched (the cooperative form: at most
    the co-resident ones, each then takes several work items)."""
    lk, li, lj = block_shape
    threads = _build.load().cz_threads_per_block()
    col_ctas = -(-(li + 2) * (lj + 2) // threads)
    rows = lk + 2
    nkc = min(rows, max(1, -(-CTAS_PER_SM * _sms(device) // (col_ctas * n))))
    kchunk = -(-rows // nkc)
    nwork = col_ctas * -(-rows // kchunk) * n
    return kchunk, min(nwork, _max_coop(device, dtype)) if both else nwork


class BlockSweeps:
    """K8 over the ghosted blocks of one card (one shape; split above
    MAX_BLOCKS), one pass: ``kind``/``colour``/``region`` as the module
    says, ``origins`` the blocks' global (k0, i0, j0), ``gshape`` the
    global shape.  ``__call__(xs, bs=None, outs=None, res=None,
    plain=False)``: ``bs`` their right-hand sides (None, or None entries,
    for zero); the Jacobi pass writes ``outs`` (new blocks when None); the
    per-CTA partial sums of dp^2 go to ``res`` (a dist_halo.Residual),
    which folds them.  Returns the updated blocks.  CPU blocks (any blocks
    with ``plain``) run the twin and hand ``res`` their per-block sums.
    The launch arguments are built once for each set of block pointers
    (dist_halo.Launches)."""

    def __init__(self, kind: str, colour, omega: float, origins, gshape,
                 offset: int = 0, region: str = "all"):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
        if region not in REGIONS:
            raise ValueError(f"region must be one of {REGIONS}, not {region!r}")
        if colour not in (None, 0, 1) or (kind == "jacobi" and colour is not None):
            raise ValueError(f"colour {colour!r} does not fit kind {kind!r}")
        self.kind, self.colour, self.omega = kind, colour, omega
        self.origins, self.gshape = [tuple(o) for o in origins], tuple(gshape)
        self.offset, self.region = offset, region
        self.variant = variant(kind, colour, region)
        self._launches = Launches(self._prepare)

    def _prepare(self, xs, bs, outs):
        check_blocks("block_sweep", xs, bs, outs)
        x0 = xs[0]
        if x0.dim() != 3 or min(x0.shape) < 3:
            raise ValueError(f"need (lk+2, li+2, lj+2) blocks, got {tuple(x0.shape)}")
        if x0.numel() >= 2**31:
            raise ValueError("block too large for 32-bit indexing")
        if len(xs) != len(self.origins):
            raise ValueError(f"{len(xs)} blocks for {len(self.origins)} origins")
        if outs is not None and any(o.data_ptr() == x.data_ptr()
                                    for o, x in zip(outs, xs)):
            raise ValueError("out must not be x (the Jacobi pass is out of place)")
        both = self.kind == "sor2sma" and self.colour is None
        bs = bs or [None] * len(xs)
        bshape = tuple(v - 2 for v in x0.shape)
        calls = []
        for lo, hi in chunks(len(xs)):
            kchunk, grid = launch_geometry(hi - lo, bshape, x0.device, x0.dtype, both)
            vals, ints = [], [hi - lo, KINDS.index(self.kind),
                              -1 if self.colour is None else self.colour,
                              REGIONS.index(self.region), *bshape, *self.gshape,
                              self.offset, kchunk, grid, x0.get_device()]
            for i in range(lo, hi):
                vals += [xs[i].data_ptr(), ptr(bs[i]),
                         (outs or xs)[i].data_ptr()]
                ints += self.origins[i]
            calls.append((pointer_array(vals), int_array(ints),
                          grid * (2 if both else 1)))
        fn = getattr(_build.load(), f"cz_block_sweep_{_SUFFIX[x0.dtype]}")
        return Prepared(x0, fn, calls)

    def __call__(self, xs, bs=None, outs=None, res=None, plain: bool = False):
        if plain or not xs[0].is_cuda:
            out, r2s = sweep_blocks_plain(xs, bs, self.kind, self.colour,
                                          self.omega, self.origins, self.gshape,
                                          self.offset, self.region)
            res.add(r2s)
            return out
        if self.kind == "jacobi":
            outs = [torch.empty_like(x) for x in xs] if outs is None else outs
        else:
            outs = None
        prep = self._launches.get(xs, bs, outs)
        x0, s = xs[0], current_stream(prep.device)
        for parr, iarr, n in prep.calls:
            _build.check(prep.fn(parr, iarr, self.omega, res.slots(x0, n), s),
                         "block_sweep")
            block_sweep.launches += 1
            v = block_sweep.variant_launches
            v[self.variant] = v.get(self.variant, 0) + 1
        return xs if outs is None else outs


def sweep_blocks(xs, bs, kind: str, colour, omega: float, origins, gshape,
                 offset: int = 0, region: str = "all", outs=None, res=None,
                 plain: bool = False):
    """Launch K8 once over the ghosted blocks ``xs`` of one card: a
    ``BlockSweeps`` built for this call (see it for the arguments)."""
    return BlockSweeps(kind, colour, omega, origins, gshape, offset, region)(
        xs, bs, outs, res, plain)


def block_sweep(x, b, kind: str, colour, omega: float, geom,
                region: str = "all", out=None):
    """K8 on the one ghosted block ``x``: ``sweep_blocks`` with one block.
    ``geom`` = (k0, i0, j0, Kg, Ig, Jg, offset); ``b`` None for a zero
    right-hand side; ``out`` the Jacobi pass's output (a new tensor when
    None).  Returns (new block, float64 sum of dp^2 on the device).  A CPU
    tensor runs the plain twin.  ``block_sweep.launches`` counts the
    launches of ``sweep_blocks``, in all and by ``variant``."""
    if not x.is_cuda:
        return block_sweep_plain(x, b, kind, colour, omega, geom, region)
    res = Residual(x.device)
    outs = sweep_blocks([x], [b], kind, colour, omega, [geom[:3]], geom[3:6],
                        geom[6], region, None if out is None else [out], res)
    return outs[0], res.total()


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
