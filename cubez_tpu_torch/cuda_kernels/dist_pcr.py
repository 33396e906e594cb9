"""Block-local K-line relaxation of the distributed path, K9 (PyTorch/CUDA
port of ``cubez_tpu/pallas_kernels/dist_pcr.py``).

State: K8's ghosted block, (lk+2, li+2, lj+2) per mesh block
(``dist_sweeps.pad_block``), whose ghost planes the caller refreshes
(parallel/dist_fused.py).  The TPU kernel's line layout (li+2, lkp, ljp),
its (8, 128) padding and its J ghost-lane option exist for the TPU's tiles
and are dropped; the K ghost rows of the block are the lines' identity
rows.  A line is a column at an owned (i, j) whose global (gi, gj) is
inner; colour c holds the lines with (gi + gj + offset) % 2 == c, in global
indices.

``BlockPcr`` launches csrc/dist_pcr.cu once over all the blocks of a card
(their pointers and origins by value; ``pcr_blocks`` is it for one call,
``block_pcr`` that launch with one block, for the JAX package's per-block
``make_block_pcr``), in one of two forms (the TPU kernel's ``solver``):

* ``'pcr'`` (any mesh; the only form on K-split meshes): the line is the
  block's lk owned rows plus its two ghost rows, n = lk + 2.  Ghost rows,
  rows on a physical K wall and every row of a column that is not a line
  are identity equations (a = c = 0, d = x): the reference's multi-rank end
  fold (cz_solver.f90:578-579), so one program serves boundary and
  interior blocks.  The other rows carry the stencil equation, constant
  (a = c = -1/6) or MAF (normalised by dw = 0.5 / ((c1 + c2) + c3)).  The
  system is data-dependent, so it runs the variable-coefficient PCR stages
  (``pcr.pcr_solve_var``, num_stage(lk + 2) of them);
* ``'fastdiag'`` (K-unsplit meshes, lk == K): every line spans the full K
  extent, so the serial line relaxation applies per block unchanged.  The
  TPU kernel solves it with dense eigen/inverse tables on the MXU; the
  port solves the same system by Thomas, ``lines.relax_dp`` and
  csrc/lines.cuh's ``relax_line``, as K5 and K6 do.  The name stays so
  that a reader finds the counterpart.

``color`` 0/1 relaxes that colour's lines in place; None relaxes every line
from the pre-pass block, out of place (the line-Jacobi pass: the result is
a new block or ``out``, and x is never written).  The residual is the
float64 sum of dp^2 over the updated rows.

The kernel writes one partial sum of dp^2 per CTA into a
dist_halo.Residual, whose fold is the step's residual.  CPU blocks run the
plain twins ``pcr_blocks_plain`` and ``block_pcr_plain``, bitwise equal
to the kernels in float32 and float64: the 'pcr' form by
``pcr.pcr_solve_var`` after building the system with the kernel's
operations in its order (``(((x[i+1] + x[i-1]) + x[j+1]) + x[j-1] - b) *
R6``; MAF ``((((wxp x[i+1] + wxm x[i-1]) + wyp x[j+1]) + wym x[j-1]) - b)
dw``, ``a = -(wzm dw)``, ``c = -(wzp dw)``), the 'fastdiag' form by
``lines.relax_dp``.  JAX's interpreted kernel contracts some of the PCR
stage products into fused multiply-adds, so the 'pcr' twin is within 2e-6
of it, not bitwise (ROADMAP.md "Faults"); the 'fastdiag' twin, another
algorithm than the TPU's dense solve, within 5e-6.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from ..ops.maf import FIELDS
from ..ops.pcr import num_stage
from . import _build
from .lines import relax_dp, thomas_tables
from .pcr import pcr_solve_var, tile_lines
from .dist_halo import (Launches, Prepared, Residual, check_blocks, chunks,
                         current_stream, int_array, pointer_array)
from .rbpack import _NP, _R6, _SUFFIX, check_tab, maf_tables, ptr, table_views

FORMS = ("pcr", "fastdiag")
# the pad value of each metric coefficient past the grid (identity rows and
# ghost columns only): 1 for c1, c2, c3, 0 for c7, c8, c9
_FILL = {"c1": 1.0, "c7": 0.0, "c2": 1.0, "c8": 0.0, "c3": 1.0, "c9": 0.0}
_AXIS = {"c1": 1, "c7": 1, "c2": 2, "c8": 2, "c3": 0, "c9": 0}


def block_shape_of(x) -> tuple:
    """(lk, li, lj) of a ghosted block."""
    return tuple(s - 2 for s in x.shape)


def block_maf_tables(mc, origin, block_shape, gshape, dtype, form: str = "pcr"):
    """``rbpack.maf_tables`` for one block, indexed by the block's own
    coordinates: i over the li + 2 columns of the ghosted block (global
    i0 - 1 .. i0 + li), j likewise, k over the lk + 2 rows of a 'pcr'
    line (global k0 - 1 .. k0 + lk) or the lk = K rows of a 'fastdiag'
    line (global k).  Entries past the grid take ``_FILL``.  On the CPU."""
    lk, li, lj = block_shape
    dt = _NP[dtype]
    ext = dict(zip((0, 1, 2), ((lk, 1) if form == "fastdiag" else (lk + 2, 0),
                               (li + 2, 0), (lj + 2, 0))))
    cut = {}
    for f in FIELDS:
        ax = _AXIS[f]
        v = getattr(mc, f).reshape(-1).cpu().numpy().astype(dt)
        G = gshape[ax]
        pad = np.full(G + 2, _FILL[f], dt)  # entry p holds global p - 1
        pad[1:G + 1] = v
        n, skip = ext[ax]
        start = origin[ax] + skip  # global origin - 1 + skip, as entry
        cut[f] = torch.from_numpy(pad[start:start + n].copy())
    shape = (ext[0][0], li + 2, lj + 2)
    return maf_tables(types.SimpleNamespace(**cut), shape, dtype)


# --------------------------------------------------------------------------
# plain twin
# --------------------------------------------------------------------------


def _line_ok(block_shape, geom, device):
    """(li, lj) True at the owned columns that are lines (global inner)."""
    _, li, lj = block_shape
    k0, i0, j0, Kg, Ig, Jg, _ = geom
    gi = torch.arange(li, device=device) + i0
    gj = torch.arange(lj, device=device) + j0
    return (((gi >= 1) & (gi <= Ig - 2))[:, None]
            & ((gj >= 1) & (gj <= Jg - 2))[None, :])


def _colour_mask(block_shape, geom, color, device):
    ok = _line_ok(block_shape, geom, device)
    if color is None:
        return ok
    _, li, lj = block_shape
    _, i0, j0, _, _, _, offset = geom
    gi = torch.arange(li, device=device)[:, None] + i0
    gj = torch.arange(lj, device=device)[None, :] + j0
    return ok & ((gi + gj + offset + 4) % 2 == color)


def _pcr_dp(x, b, omega, geom, tab):
    """(m, dp) of the 'pcr' form on every owned column: m the (lk+2, li,
    lj) stencil rows of the lines, dp unmasked."""
    lk, li, lj = block_shape_of(x)
    k0, i0, j0, Kg, Ig, Jg, _ = geom
    dev, dt = x.device, x.dtype
    n = lk + 2
    k = torch.arange(n, device=dev)
    gk = k - 1 + k0
    rows = (k >= 1) & (k <= lk) & (gk >= 1) & (gk <= Kg - 2)
    m = rows[:, None, None] & _line_ok((lk, li, lj), geom, dev)[None]
    xl = x[:, 1:-1, 1:-1]
    xip, xim = x[:, 2:, 1:-1], x[:, :-2, 1:-1]
    xjp, xjm = x[:, 1:-1, 2:], x[:, 1:-1, :-2]
    bb = None if b is None else b[:, 1:-1, 1:-1]
    zero = torch.zeros((), dtype=dt, device=dev)
    if tab is None:
        r6 = torch.tensor(_R6[dt], dtype=dt, device=dev)
        t = xip + xim + xjp + xjm
        if bb is not None:
            t = t - bb
        rhs = t * r6
        a = torch.where(m, -r6, zero)
        c = a
    else:
        w = table_views(tab, (n, li + 2, lj + 2))
        half = torch.tensor(0.5, dtype=dt, device=dev)
        dw = half / (w["c1"][1:-1, None] + w["c2"][1:-1] + w["c3"][:, None, None])
        a = torch.where(m, -(w["wzm"][:, None, None] * dw), zero)
        c = torch.where(m, -(w["wzp"][:, None, None] * dw), zero)
        t = w["wxp"][1:-1, None] * xip + w["wxm"][1:-1, None] * xim
        t = t + w["wyp"][1:-1] * xjp
        t = t + w["wym"][1:-1] * xjm
        if bb is not None:
            t = t - bb
        rhs = t * dw
    d = torch.where(m, rhs, xl)
    sol = pcr_solve_var(a, c, d, num_stage(n))
    return m, (sol - xl) * torch.tensor(omega, dtype=dt, device=dev)


def block_pcr_plain(x, b, form: str, color, omega: float, geom, tab=None,
                    out=None):
    """Plain twin of ``block_pcr``: (block, float64 sum of dp^2).  A colour
    updates ``x`` in place and returns it; ``color`` None writes a new
    block (or ``out``) and leaves x as it was."""
    lk, li, lj = bs = block_shape_of(x)
    sel = _colour_mask(bs, geom, color, x.device)
    if form == "pcr":
        m, dp = _pcr_dp(x, b, omega, geom, tab)
        dp = torch.where(m & sel[None], dp, 0.0)
        rows = slice(None)
    else:
        dp = relax_dp(x[1:-1], None if b is None else b[1:-1], omega, tab)
        dp = torch.where(sel[None], dp, 0.0)
        rows = slice(2, lk)
    r2 = (dp * dp).sum(dtype=torch.float64)
    if color is not None:
        x[rows, 1:-1, 1:-1] += dp
        return x, r2
    res = x.clone() if out is None else out.copy_(x)
    res[rows, 1:-1, 1:-1] += dp
    return res, r2


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------


def variant(form: str, maf: bool) -> str:
    """The launch's variant: 'block_pcr' or 'block_pcr_fastdiag', with
    '_maf' for the MAF form."""
    return ("block_pcr" if form == "pcr" else "block_pcr_fastdiag") + (
        "_maf" if maf else "")


def pcr_blocks_plain(xs, bs, form: str, color, omega: float, origins, gshape,
                     offset: int = 0, tabs=None, outs=None):
    """Twin of ``pcr_blocks``: ``block_pcr_plain`` on each block in turn.
    Returns (blocks, per-block float64 sums of dp^2)."""
    n = len(xs)
    res = [block_pcr_plain(x, b, form, color, omega, (*o, *gshape, offset), t, ob)
           for x, b, o, t, ob in zip(xs, bs or [None] * n, origins,
                                     tabs or [None] * n, outs or [None] * n)]
    return [r[0] for r in res], [r[1] for r in res]


def make_scratch(shape, dtype, device, form: str, color, maf: bool):
    """The Thomas scratch of one 'fastdiag' block of ghosted ``shape``:
    the forward values g (colour passes; the line-Jacobi pass keeps them in
    its output) and, under MAF, the factors e.  None for the 'pcr'
    form."""
    if form != "fastdiag":
        return None
    return [torch.empty(shape, dtype=dtype, device=device)
            for _ in range((color is not None) + maf)]


_THOMAS: dict = {}


def _thomas(lk, dtype, device):
    key = (lk, dtype, device)
    if key not in _THOMAS:
        _THOMAS[key] = thomas_tables(lk, dtype, device)
    return _THOMAS[key]


class BlockPcr:
    """K9 over the ghosted blocks of one card (one shape; split above
    MAX_BLOCKS), one pass: ``form`` 'pcr' or 'fastdiag', ``color`` 0/1 (in
    place) or None (out of place into ``outs``, new blocks when None);
    ``origins`` their global (k0, i0, j0), ``gshape`` the global shape;
    ``tabs`` (each block's ``block_maf_tables`` of the form) selects MAF;
    ``scratch`` the 'fastdiag' form's Thomas scratch, one ``make_scratch``
    per block (made at the first call when None).  ``__call__(xs,
    bs=None, outs=None, res=None, plain=False)``: ``bs`` the right-hand
    sides (None, or None entries, for zero); the per-CTA partial sums of
    dp^2 go to ``res`` (a dist_halo.Residual).  Returns the updated
    blocks.  CPU blocks (any blocks with ``plain``) run the twin and hand
    ``res`` their per-block sums.  The launch arguments are built once
    for each set of block pointers (dist_halo.Launches)."""

    def __init__(self, form: str, color, omega: float, origins, gshape,
                 offset: int = 0, tabs=None, scratch=None):
        if form not in FORMS:
            raise ValueError(f"form must be one of {FORMS}, not {form!r}")
        if color not in (None, 0, 1):
            raise ValueError(f"color must be None, 0 or 1, not {color!r}")
        self.form, self.color, self.omega = form, color, omega
        self.origins, self.gshape = [tuple(o) for o in origins], tuple(gshape)
        self.offset, self.tabs, self.scratch = offset, tabs, scratch
        self.variant = variant(form, tabs is not None)
        self._launches = Launches(self._prepare)

    def _prepare(self, xs, bs, outs):
        check_blocks("block_pcr", xs, bs, outs)
        x0 = xs[0]
        n = len(xs)
        if x0.dim() != 3 or min(x0.shape) < 3:
            raise ValueError(f"need (lk+2, li+2, lj+2) blocks, got {tuple(x0.shape)}")
        if x0.numel() >= 2**31:
            raise ValueError("block too large for 32-bit indexing")
        if n != len(self.origins):
            raise ValueError(f"{n} blocks for {len(self.origins)} origins")
        if outs is not None and any(o.data_ptr() == x.data_ptr()
                                    for o, x in zip(outs, xs)):
            raise ValueError("out must not be x (the line-Jacobi pass is out "
                             "of place)")
        lk, li, lj = block_shape_of(x0)
        form, color, maf = self.form, self.color, self.tabs is not None
        if form == "fastdiag" and (lk != self.gshape[0] or lk - 2 < 2):
            raise ValueError(f"'fastdiag' needs the block to span K (lk {lk}, K "
                             f"{self.gshape[0]}) with two inner rows")
        tabs = self.tabs or [None] * n
        for t in self.tabs or ():
            check_tab(x0, t, ((lk + 2) if form == "pcr" else lk, li + 2, lj + 2))
        lib = _build.load()
        lt = None
        if form == "pcr":
            L = tile_lines(lk + 2, x0.dtype, True)
            gx = -(-((lj + 2) if color is None else (lj + 1) // 2) // L)
            gy = li + 2 if color is None else li
            scratch = [None] * n
        else:
            L, gy = 0, 1
            cols = (li + 2) * (lj + 2) if color is None else li * ((lj + 1) // 2)
            gx = -(-cols // lib.cz_line_threads_per_block())
            lt = None if maf else _thomas(lk, x0.dtype, x0.device)
            if self.scratch is None:
                self.scratch = [make_scratch(x0.shape, x0.dtype, x0.device, form,
                                             color, maf) for _ in xs]
            scratch = self.scratch
            for scr in scratch:
                if len(scr) != (color is not None) + maf:
                    raise ValueError("scratch must be make_scratch's blocks")
                check_blocks("block_pcr scratch", xs[:1], scr)
        bs = bs or [None] * n
        outs = outs or xs
        calls = []
        for lo, hi in chunks(n):
            vals = []
            ints = [hi - lo, FORMS.index(form), -1 if color is None else color, L,
                    num_stage(lk + 2), int(maf), gx, gy, x0.get_device(), lk, li,
                    lj, *self.gshape, self.offset]
            for i in range(lo, hi):
                scr = scratch[i] or ()
                gs = scr[0] if color is not None and scr else None
                es = scr[-1] if maf and scr else None
                vals += [xs[i].data_ptr(), ptr(bs[i]), ptr(tabs[i]),
                         outs[i].data_ptr(), ptr(gs), ptr(es)]
                ints += self.origins[i]
            vals.append(ptr(lt))
            calls.append((pointer_array(vals), int_array(ints), gx * gy * (hi - lo)))
        fn = getattr(lib, f"cz_block_pcr_{_SUFFIX[x0.dtype]}")
        return Prepared(x0, fn, calls)

    def __call__(self, xs, bs=None, outs=None, res=None, plain: bool = False):
        if plain or not xs[0].is_cuda:
            out, r2s = pcr_blocks_plain(xs, bs, self.form, self.color, self.omega,
                                        self.origins, self.gshape, self.offset,
                                        self.tabs, outs)
            res.add(r2s)
            return out
        if self.color is None:
            outs = [torch.empty_like(x) for x in xs] if outs is None else outs
        else:
            outs = None
        prep = self._launches.get(xs, bs, outs)
        x0, s = xs[0], current_stream(prep.device)
        for parr, iarr, n in prep.calls:
            _build.check(prep.fn(parr, iarr, self.omega, res.slots(x0, n), s),
                         "block_pcr")
            block_pcr.launches += 1
            v = block_pcr.variant_launches
            v[self.variant] = v.get(self.variant, 0) + 1
        return xs if outs is None else outs


def pcr_blocks(xs, bs, form: str, color, omega: float, origins, gshape,
               offset: int = 0, tabs=None, outs=None, scratch=None, res=None,
               plain: bool = False):
    """Launch K9 once over the ghosted blocks ``xs`` of one card: a
    ``BlockPcr`` built for this call (see it for the arguments)."""
    return BlockPcr(form, color, omega, origins, gshape, offset, tabs, scratch)(
        xs, bs, outs, res, plain)


def block_pcr(x, b, form: str, color, omega: float, geom, tab=None, out=None,
              scratch=None):
    """K9 on the one ghosted block ``x``: ``pcr_blocks`` with one block.
    ``geom`` = (k0, i0, j0, Kg, Ig, Jg, offset); ``tab`` its
    ``block_maf_tables`` (MAF); ``scratch`` its ``make_scratch`` (made when
    None).  Returns (block, float64 sum of dp^2 on the device).  A CPU
    tensor runs the plain twin.  ``block_pcr.launches`` counts the launches
    of ``pcr_blocks``, in all and by ``variant``."""
    if not x.is_cuda:
        return block_pcr_plain(x, b, form, color, omega, geom, tab, out)
    res = Residual(x.device)
    outs = pcr_blocks([x], [b], form, color, omega, [geom[:3]], geom[3:6],
                      geom[6], None if tab is None else [tab],
                      None if out is None else [out],
                      None if scratch is None else [scratch], res)
    return outs[0], res.total()


# launches, in all and by ``variant``
block_pcr.launches = 0
block_pcr.variant_launches = {}


# --------------------------------------------------------------------------
# builder (the JAX package's name)
# --------------------------------------------------------------------------


def make_block_pcr(block_shape, gshape, dtype=torch.float32, *, omega: float,
                   color=None, offset: int = 0, b_is_zero: bool = False,
                   maf: bool = False, mc=None, solver: str = "pcr",
                   plain: bool = False):
    """Build ``sweep(x, b, origin, tab=None, out=None) -> (x_new, r2)`` on
    the ghosted block state, ``origin`` the block's global (k0, i0, j0) and
    ``tab`` its ``sweep.block_tables(origin, device)`` under MAF.
    ``color`` as in ``block_pcr``.  ``maf=True`` selects the MAF line
    solve and needs ``mc`` (the global MafCoeffs), from which the port
    builds each block's tables itself (the JAX caller slices them in its
    shard_map body).  ``solver``: 'pcr' or 'fastdiag' (see the module);
    None where 'fastdiag' does not apply (lk != K, or fewer than two inner
    rows), as in the JAX package; an empty block raises.  ``plain`` runs
    the twin on any device.  A 'fastdiag' sweep owns its Thomas scratch,
    one set per device."""
    if solver not in FORMS:
        raise ValueError(f"solver must be one of {FORMS}, not {solver!r}")
    if dtype not in _SUFFIX:
        raise TypeError(f"K9 takes float32 or float64, not {dtype}")
    lk, li, lj = block_shape
    if min(block_shape) < 1:
        raise ValueError(f"need a non-empty block, got {tuple(block_shape)}")
    if maf and mc is None:
        raise ValueError("maf=True needs the MafCoeffs (mc)")
    if solver == "fastdiag" and (lk != gshape[0] or lk - 2 < 2):
        return None
    scratch = {}

    def sweep(x, b, origin, tab=None, out=None):
        geom = (*origin, *gshape, offset)
        b = None if b_is_zero else b
        if plain or not x.is_cuda:
            return block_pcr_plain(x, b, solver, color, omega, geom, tab, out)
        scr = None
        if solver == "fastdiag":
            if x.device not in scratch:
                scratch[x.device] = make_scratch(x.shape, x.dtype, x.device,
                                                 solver, color, maf)
            scr = scratch[x.device]
        return block_pcr(x, b, solver, color, omega, geom, tab, out, scr)

    def block_tables(origin, device):
        return block_maf_tables(mc, origin, block_shape, gshape, dtype,
                                solver).to(device)

    sweep.solver = solver
    sweep.block_tables = block_tables
    return sweep
