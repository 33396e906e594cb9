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

``block_pcr`` launches csrc/dist_pcr.cu in one of two forms (the TPU
kernel's ``solver``):

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

For a CPU tensor ``block_pcr`` runs the plain twin ``block_pcr_plain``,
bitwise equal to the kernels in float32 and float64: the 'pcr' form by
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

import ctypes
import types

import numpy as np
import torch

from ..ops.maf import FIELDS
from ..ops.pcr import num_stage
from . import _build
from .lines import relax_dp, thomas_tables
from .pcr import pcr_solve_var, tile_lines
from .rbpack import _NP, _R6, _SUFFIX, check_tab, maf_tables, ptr, stream, table_views

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


def _check(x, b, out, tab, form, color, geom):
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, not {form!r}")
    if color not in (None, 0, 1):
        raise ValueError(f"color must be None, 0 or 1, not {color!r}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"K9 takes float32 or float64, not {x.dtype}")
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
        raise ValueError("out must not be x (the line-Jacobi pass is out of "
                         "place)")
    lk, li, lj = block_shape_of(x)
    if form == "fastdiag" and (lk != geom[3] or lk - 2 < 2):
        raise ValueError(f"'fastdiag' needs the block to span K (lk {lk}, K "
                         f"{geom[3]}) with two inner rows")
    check_tab(x, tab, ((lk + 2) if form == "pcr" else lk, li + 2, lj + 2))


def block_pcr(x, b, form: str, color, omega: float, geom, tab=None, out=None,
              scratch=None):
    """Launch K9 on the ghosted block ``x``: ``form`` 'pcr' or 'fastdiag',
    ``color`` 0/1 (in place) or None (out of place into ``out``, a new
    block when None); ``geom`` = (k0, i0, j0, Kg, Ig, Jg, offset); ``tab``
    (``block_maf_tables`` of the form) selects MAF; ``b`` None for a zero
    right-hand side; ``scratch`` the 'fastdiag' form's Thomas scratch, a
    list of blocks like x (made when None; two under MAF).  Returns (block,
    float64 sum of dp^2 on the device).  A CPU tensor runs the plain
    twin."""
    if not x.is_cuda:
        return block_pcr_plain(x, b, form, color, omega, geom, tab, out)
    _check(x, b, out, tab, form, color, geom)
    lib = _build.load()
    lk, li, lj = block_shape_of(x)
    maf = tab is not None
    out = x if color is not None else (torch.empty_like(x) if out is None
                                       else out)
    gs = es = None
    if form == "pcr":
        L = tile_lines(lk + 2, x.dtype, True)
        gx = -(-((lj + 2) if color is None else (lj + 1) // 2) // L)
        gy = li + 2 if color is None else li
        lt = tab
    else:
        L = 0
        cols = (li + 2) * (lj + 2) if color is None else li * ((lj + 1) // 2)
        gx = -(-cols // lib.cz_line_threads_per_block())
        gy = 1
        lt = tab if maf else thomas_tables(lk, x.dtype, x.device)
        if scratch is None:
            scratch = [torch.empty_like(x) for _ in range((color is not None) + maf)]
        for t in scratch:
            if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                    or not t.is_contiguous():
                raise ValueError("scratch must be contiguous blocks like x")
        if color is not None:
            gs = scratch[0]
        if maf:
            es = scratch[-1]
    partials = torch.empty(gx * gy, dtype=x.dtype, device=x.device)
    g = (ctypes.c_int * 7)(*geom)
    rc = getattr(lib, f"cz_block_pcr_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), ptr(b), ptr(lt), out.data_ptr(), ptr(gs), ptr(es),
        partials.data_ptr(), FORMS.index(form), lk, li, lj, L,
        -1 if color is None else color, num_stage(lk + 2), omega, int(maf),
        g, gx, gy, x.device.index, stream(x))
    _build.check(rc, "block_pcr")
    block_pcr.launches += 1
    v = variant(form, maf)
    block_pcr.variant_launches[v] = block_pcr.variant_launches.get(v, 0) + 1
    return out, partials.sum(dtype=torch.float64)


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
                scratch[x.device] = [torch.empty_like(x)
                                     for _ in range((color is not None) + maf)]
            scr = scratch[x.device]
        return block_pcr(x, b, solver, color, omega, geom, tab, out, scr)

    def block_tables(origin, device):
        return block_maf_tables(mc, origin, block_shape, gshape, dtype,
                                solver).to(device)

    sweep.solver = solver
    sweep.block_tables = block_tables
    return sweep
