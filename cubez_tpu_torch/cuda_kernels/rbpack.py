"""Packed red-black SOR sweeps (PyTorch/CUDA port of
``cubez_tpu/pallas_kernels/rbpack.py`` and of the packed callers of
``sweeps2x.build_2x``/``build_nx``).

Layout: the (K, I, J) field folded along I into two dense colour halves,
``xp[c, k, i2, j] = x[k, 2*i2 + s_c(k, j), j]`` with
``s_red = (k + j + offset + 1) % 2`` and ``s_black = 1 - s_red`` (the JAX
package's map, rbpack.py:64-85).  Shape (2, K, I/2, J), J contiguous.  The
TPU tile padding and the K pad of 2 are dropped: the kernels mask on the
true bounds and never read outside the array.

One launch carries every builder (csrc/rbpack.cu): n full iterations in
one cooperative launch, with an optional right-hand side, OUT OF PLACE: it
reads x and writes every point of ``out``, and folds each iteration's
residual on the card.  K1, the single packed sweep, is n = 1
(``rb_single``: both colours in one launch); K2, the pair, n = 2 with b;
K3, the window chain, n >= 3 without (``rb_sweeps_n``).  ``tile_plan``
picks the form from the field's size: 'tile', one pass over the field on
shared-memory tiles (n = ``TILE_N`` with a zero b, or n = 1 with or
without one), where x and out pass ``TILE_BYTES`` (``SINGLE_TILE_BYTES``
for n = 1), else 'rows', the 2n colour passes with grid-wide syncs
between them.

Both take the MAF (variable-coefficient) update too: ``maf_tables`` gives
the per-axis weight vectors, which the kernels index by the physical i of
each packed point (the fold only mixes the I tables).

Each wrapper launches its kernel for a CUDA tensor and raises on anything it
cannot take; for a CPU tensor it runs the plain twin,
``packed_sweeps_plain`` (n iterations of two ``rb_color_plain`` colours),
which computes the same per-point arithmetic (bitwise equal in float32;
see ``_fma`` and the contracts below).  Every step, the single sweep
included, owns two states and alternates between them, so the state it is
handed (the start, or the driver's snapshot) is only read.

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
import dataclasses
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
    """One colour of one red-black iteration, the plain PyTorch half of
    the kernels' twin: update colour ``colour`` of the packed state ``xp``
    in place; return its sum of dp^2 (float64, 0-d).  ``tab``
    (``maf_tables``) selects the MAF update."""
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


# --------------------------------------------------------------------------
# the n-iteration launch: its plan and launcher
# --------------------------------------------------------------------------

FORMS = ("rows", "tile")
# csrc/rbpack.cu: cells of a region row in shared memory, region rows at
# most, planes of x in flight, iterations a launch at most, threads of a
# CTA of each form, the n the tile kernel is built for with a zero b
# (kTileN; it is also built for n = 1, K1, with or without b)
ROW = 64
REGION_ROWS = 32
AHEAD = 2
MAX_N = 9
THREADS = 256
TILE_THREADS = 512
TILE_N = 2
# the bytes of x and out together past which the zero-b chain's tile form
# beats the rows at their depths, by (MAF, itemsize); None: never
# (tools/prof_rbpack.py --depths, H100 80GB HBM3 at 700 W; PERF.md).
# Constant coefficients switch at the H100's 50 MB L2: float32 rows ahead
# at 160^3, tiles from 192^3; float64 rows at 128^3, tiles from 160^3.
# MAF float32: rows up to 384^3 (453 MB, even there), tiles from 448^3
# (719 MB).  MAF float64: the tiles lost at every size (3.4x at 320^3).
L2_BYTES = 50 * 2**20
TILE_BYTES = {(False, 4): L2_BYTES, (False, 8): L2_BYTES,
              (True, 4): 512 * 2**20, (True, 8): None}
# the same switch for K1's single iteration (n = 1), by (MAF, itemsize, a
# right-hand side): x and out together past these bytes take the one-pass
# tile form, else the two colour passes of the row form; None: never
# (tools/prof_rbpack.py --single, H100 80GB HBM3 at 700 W, device us an
# iteration, rows / tiles).  Constant coefficients with a zero b switch at
# the L2: f32 128^3 15.6 / 24.7, 256^3 94.3 / 85.3, 512^3 669.1 /
# 623.4-630.6; f64 128^3 20.3-20.4 / 27.4-27.5, 256^3 170.7-171.0 /
# 125.7-127.2.  With a streamed b the rows won everywhere (512^3 f32 1215 /
# 1871-1922), and with MAF (512^3 f32 1084-1085 / 1170-1178; f64
# 1434-1440 / 1526-1531).
SINGLE_TILE_BYTES = {(maf, size, has_b): None if maf or has_b else L2_BYTES
                     for maf in (False, True) for size in (4, 8)
                     for has_b in (False, True)}
# iterations a call of the zero-b chain (tools/prof_rbpack.py --depths, H100
# 80GB HBM3 at 700 W): the row form gains a little with n (128^3: 15.4 us an
# iteration at n = 2, 13.1 at n = 6), and the tile form runs n = TILE_N
ROWS_CHAIN_N = 6
# a test and profiling hook, never set by the solvers: overrides of
# tile_plan's choices for every plan made while it holds them ("form";
# "rows", fewer region rows; "kchunk", planes a chunk)
_force_plan: dict = {}


@dataclasses.dataclass(frozen=True)
class RbPlan:
    """An ``rb_sweeps_n`` launch on the packed state of physical ``shape``
    (K, I, J).  'rows': the 2n colour passes over the whole field.
    'tile': ``tiles_i`` x ``tiles_j`` tiles of ``ti`` packed rows x ``tj``
    columns (the last of each ragged), times ``nkc`` chunks of ``kchunk``
    planes (the last ragged); x is loaded with ``halo_rows`` packed rows,
    ``halo_cols`` columns and ``halo_planes`` planes around a work item
    (the cone of the 2n half-steps: a half-step reaches one physical cell,
    half a packed row); ``smem`` bytes of shared memory a CTA, ``per_sm``
    CTAs an SM at most by shared memory and threads."""

    form: str
    shape: tuple
    n: int
    ti: int = 0
    tj: int = 0
    tiles_i: int = 0
    tiles_j: int = 0
    kchunk: int = 0
    nkc: int = 0
    smem: int = 0
    per_sm: int = 0

    @property
    def halo_rows(self) -> int:
        return self.n + 1

    @property
    def halo_cols(self) -> int:
        return 2 * self.n

    halo_planes = halo_cols

    @property
    def nwork(self) -> int:
        return self.tiles_i * self.tiles_j * self.nkc

    def items(self):
        """Each work item's owned box of a colour plane, ((k_lo, k_hi),
        (r_lo, r_hi), (j_lo, j_hi)) in packed rows, in the kernel's
        order."""
        K, I, J = self.shape
        for w in range(self.nwork):
            kc, t = divmod(w, self.tiles_i * self.tiles_j)
            ty, tx = divmod(t, self.tiles_j)
            yield ((kc * self.kchunk, min((kc + 1) * self.kchunk, K)),
                   (ty * self.ti, min((ty + 1) * self.ti, I // 2)),
                   (tx * self.tj, min((tx + 1) * self.tj, J)))

    def region(self, item):
        """The box of x a work item loads: its owned box with the halos,
        cut to the array."""
        K, I, J = self.shape
        (k0, k1), (r0, r1), (j0, j1) = item
        hp, hr, hc = self.halo_planes, self.halo_rows, self.halo_cols
        return ((max(k0 - hp, 0), min(k1 + hp, K)),
                (max(r0 - hr, 0), min(r1 + hr, I // 2)),
                (max(j0 - hc, 0), min(j1 + hc, J)))


def tile_built(n: int, has_b: bool) -> bool:
    """True where the tile kernel is built for n iterations (with b):
    n = ``TILE_N`` with a zero right-hand side, and n = 1 (K1)."""
    return n == 1 or (n == TILE_N and not has_b)


def tile_plan(shape, n: int, itemsize: int = 4, has_b: bool = False,
              maf: bool = False, *, slots: int | None = None,
              sms: int = 132) -> RbPlan:
    """The plan of an ``rb_sweeps_n`` launch of n iterations on the packed
    state of physical ``shape``: 'tile' where the tile kernel runs the
    launch (``tile_built``) and x and out together pass ``TILE_BYTES``
    (n = 1: ``SINGLE_TILE_BYTES``) for ``maf``, ``itemsize`` and b, else
    'rows'.
    Measured on an H100 80GB HBM3 at 700 W (tools/prof_rbpack.py
    --depths): at 512^3 the tiles take 412 us an iteration against the
    rows' 669 (MAF 882 against 1082), at 128^3 18.5 against 12.9; with a
    streamed b the tiles lost (MAF 1422 against 1056 at 512^3) and are not
    built.  A tile's region is at most ``REGION_ROWS`` rows of ``ROW``
    cells, as many rows as the planes leave in a CTA's shared memory; its
    k chunks are chosen by the launch's makespan for ``slots`` co-resident
    CTAs (by default an estimate for ``sms`` SMs).  ``_force_plan``
    overrides the form, the region rows and the chunk.  Raises ValueError
    where a forced tile is not built or does not fit."""
    from . import sweeps

    if not 1 <= n <= MAX_N:
        raise ValueError(f"rb_sweeps_n runs n in 1..{MAX_N}, not {n}")
    K, I, J = shape
    form, rows, kchunk = (_force_plan.get(k)
                          for k in ("form", "rows", "kchunk"))
    if form is None:
        most = (SINGLE_TILE_BYTES[bool(maf), itemsize, bool(has_b)] if n == 1
                else TILE_BYTES[bool(maf), itemsize])
        tiles = tile_built(n, has_b) and most is not None
        form = "tile" if tiles and 2 * K * I * J * itemsize > most else "rows"
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, not {form!r}")
    if form == "rows":
        return RbPlan("rows", tuple(shape), n)
    if not tile_built(n, has_b):
        raise ValueError(f"the tile kernel runs n = {TILE_N} with a zero "
                         f"right-hand side or n = 1, not n = {n}"
                         + (" with b" if has_b else ""))
    hr, hc = n + 1, 2 * n
    # x's two colours (three planes in use, AHEAD in flight), two planes
    # of each level but the last; a plane is the region's rows and a row
    # of padding on each side, and two rows more close the last plane (a
    # cell off the region reads up to a row and a few cells past its own)
    planes = 2 * (3 + AHEAD) + 2 * (2 * n - 1)
    # a region row also holds up to 16 / itemsize - 1 cells before its
    # first, so that it copies in aligned 16-byte pieces
    tj_most = ROW - 2 * hc - (16 // itemsize - 1)
    rows_most = min(REGION_ROWS, rows or REGION_ROWS,
                    (sweeps.SMEM_CTA // (ROW * itemsize) - 2) // planes - 2)
    if rows_most - 2 * hr < 1:
        raise ValueError(f"rb_sweeps_n n={n}: no tile fits ({rows_most} "
                         f"region rows, a halo of {hr})")
    ti = sweeps._even(I // 2, rows_most - 2 * hr)
    tj = sweeps._even(J, tj_most)
    smem = (planes * (ti + 2 * hr + 2) + 2) * ROW * itemsize
    per_sm = max(1, min(sweeps.THREADS_SM // TILE_THREADS,
                        sweeps.SMEM_SM // (smem + 1024)))
    tiles_i, tiles_j = -(-(I // 2) // ti), -(-J // tj)
    if kchunk is None:
        slots = sms * per_sm if slots is None else slots
        # a chunk's levels run 2n planes past each end of it
        kchunk = sweeps._k_chunks(K, tiles_i * tiles_j, slots, 4 * n)
    kchunk = min(kchunk, K)
    return RbPlan("tile", tuple(shape), n, ti, tj, tiles_i, tiles_j, kchunk,
                  -(-K // kchunk), smem, per_sm)


def chain_depth(shape, dtype=torch.float32, maf: bool = False) -> int:
    """Iterations a call of the zero-b chain that the dispatch builds (MAF
    with ``maf``): ``TILE_N`` where ``tile_plan`` takes the tile form at
    that n, ``ROWS_CHAIN_N`` where the row form runs (constant
    coefficients and MAF alike: at 128^3 the MAF chain at n = 6 took 17.6
    us an iteration, the MAF pair 19.5)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = tile_plan(shape, TILE_N, itemsize, maf=maf)
    return TILE_N if plan.form == "tile" else ROWS_CHAIN_N


_MAX_BLOCKS: dict = {}


def _max_blocks(fi, n, maf, has_b, smem, x) -> int:
    key = (fi, n, maf, has_b, smem, x.dtype, x.get_device())
    if key not in _MAX_BLOCKS:
        cnt = ctypes.c_int(0)
        rc = getattr(_build.load(), f"cz_rbn_max_blocks_{_SUFFIX[x.dtype]}")(
            fi, n, int(maf), int(has_b), smem, x.get_device(), cnt)
        _build.check(rc, "rb_sweeps_n occupancy")
        if cnt.value < 1:
            raise RuntimeError(f"rb_sweeps_n form {fi}: no CTA fits an SM")
        _MAX_BLOCKS[key] = cnt.value
    return _MAX_BLOCKS[key]


def out_for(x, out):
    """``out`` checked as the second field of an out-of-place update of x
    (a new one for None)."""
    if out is None:
        return torch.empty_like(x)
    if (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
            or not out.is_contiguous() or out.data_ptr() == x.data_ptr()):
        raise ValueError("out must match x in shape, dtype, device and layout, "
                         "and must not be x (the update is out of place)")
    return out


class RbSweeps:
    """``rb_sweeps_n``'s launcher for one step: n iterations at colour
    ``offset``, ``tab`` (``maf_tables``) selecting MAF; the plan is
    ``tile_plan``'s, made at the first call.  ``__call__(x, b, out)``
    reads x and writes every point of ``out`` (never x); returns the (n,)
    float64 r2 in a buffer of the launcher's that holds until its next
    call.  The plan, the partials and the ctypes arguments (for each set of
    field pointers) are built once; ``plan`` and ``grid`` tell what it
    launches.  It counts its launches on ``counter`` (``rb_sweeps_n``, or
    ``rb_single`` for K1's steps), and by form, MAF and b in
    ``counter.variant_launches``."""

    def __init__(self, n: int, omega: float, offset: int = 0, tab=None,
                 counter=None):
        if not 1 <= n <= MAX_N:
            raise ValueError(f"rb_sweeps_n runs n in 1..{MAX_N}, not {n}")
        self.n, self.omega, self.offset, self.tab = n, omega, offset, tab
        self.counter = rb_sweeps_n if counter is None else counter
        self._key = None  # (shape, dtype, device, b given) of the buffers
        self._args = {}
        self.plan = self.grid = None

    def _setup(self, x, b):
        from .dist_halo import int_array

        _, K, I2, J = x.shape
        shape = (K, 2 * I2, J)
        dev = x.get_device()
        maf = self.tab is not None
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        kw = dict(itemsize=x.element_size(), has_b=b is not None, maf=maf)
        plan = tile_plan(shape, self.n, sms=sms, **kw)
        fi = FORMS.index(plan.form)
        slots = _max_blocks(fi, self.n, maf, b is not None, plan.smem, x)
        if plan.form == "tile":
            # as many k chunks as the co-resident CTAs take in one round
            plan = tile_plan(shape, self.n, slots=slots, **kw)
            grid = min(plan.nwork, slots)
        else:
            grid = min(slots, -(-K * I2 // (THREADS // 32)))
        per = 2 if plan.form == "rows" else 1
        self._partials = torch.empty(per * self.n * grid, dtype=x.dtype,
                                     device=x.device)
        self._r2 = torch.empty(self.n, dtype=torch.float64, device=x.device)
        self._ints = int_array((fi, self.n, K, I2, J,
                                self.offset, plan.ti, plan.tj, plan.tiles_i,
                                plan.tiles_j, plan.kchunk, plan.nwork, grid,
                                plan.smem, dev))
        self._fn = getattr(_build.load(), f"cz_rbn_sweeps_{_SUFFIX[x.dtype]}")
        self._key = (x.shape, x.dtype, x.device, b is not None)
        self._args = {}
        self.plan, self.grid = plan, grid

    def __call__(self, x, b, out):
        from .dist_halo import current_stream, pointer_array

        key = (x.data_ptr(), ptr(b), out.data_ptr())
        args = self._args.get(key)
        if args is None or (x.shape, x.dtype, x.device, b is not None) != self._key:
            _check(x, b, self.tab)
            out_for(x, out)
            if (x.shape, x.dtype, x.device, b is not None) != self._key:
                self._setup(x, b)
            if len(self._args) >= 8:
                self._args.clear()
            args = self._args[key] = pointer_array(
                (x.data_ptr(), ptr(b), ptr(self.tab), out.data_ptr(),
                 self._partials.data_ptr(), self._r2.data_ptr()))
        elif not x.is_contiguous():
            raise ValueError("need a contiguous (2, K, I/2, J) state")
        _build.check(self._fn(args, self._ints, self.omega,
                              current_stream(x.get_device())),
                     f"rb_sweeps_n {self.plan.form}")
        c = self.counter
        count(c, self.tab)
        key = (self.plan.form, self.tab is not None, b is not None)
        c.variant_launches[key] = c.variant_launches.get(key, 0) + 1
        return self._r2


def rb_sweeps_n(xp, bp, n: int, omega: float, offset: int = 0, tab=None,
                out=None):
    """Launch ``rb_sweeps_n``'s kernel (the form ``tile_plan`` picks): n
    full iterations in one cooperative launch from ``xp`` into ``out``
    (never ``xp``, which is only read); with ``out`` None the result is
    copied back into ``xp``.  ``tab`` selects the MAF form.  Returns the
    (n,) float64 per-iteration sums of dp^2 (on the device).  A CPU tensor
    runs the plain twin (in ``out``, or in place)."""
    if not xp.is_cuda:
        dst = xp if out is None else out_for(xp, out).copy_(xp)
        return packed_sweeps_plain(dst, bp, n, omega, offset, tab)[1]
    _check(xp, bp, tab)
    dst = out_for(xp, out)
    if not _cells(xp):
        dst.copy_(xp)
        r2 = torch.zeros(n, dtype=torch.float64, device=xp.device)
    else:
        r2 = RbSweeps(n, omega, offset, tab)(xp, bp, dst)
    if out is None:
        xp.copy_(dst)
    return r2


rb_sweeps_n.launches = rb_sweeps_n.maf_launches = 0
# launches by (form, MAF, a right-hand side)
rb_sweeps_n.variant_launches = {}


def rb_single(xp, bp, omega: float, offset: int = 0, tab=None, out=None):
    """K1: one red-black iteration, both colours in one launch of the
    form ``tile_plan`` picks at n = 1, from ``xp`` into ``out`` (never
    ``xp``); with ``out`` None the result is copied back into ``xp``.
    ``tab`` selects the MAF form.  Returns the 0-d float64 sum of dp^2 (on
    the device).  A CPU tensor runs the plain twin, two ``rb_color_plain``
    colours."""
    if not xp.is_cuda:
        dst = xp if out is None else out_for(xp, out).copy_(xp)
        return packed_sweeps_plain(dst, bp, 1, omega, offset, tab)[1][0]
    _check(xp, bp, tab)
    dst = out_for(xp, out)
    if not _cells(xp):
        dst.copy_(xp)
        r2 = torch.zeros(1, dtype=torch.float64, device=xp.device)
    else:
        r2 = RbSweeps(1, omega, offset, tab, rb_single)(xp, bp, dst)
    if out is None:
        xp.copy_(dst)
    return r2[0]


rb_single.launches = rb_single.maf_launches = 0
rb_single.variant_launches = {}


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
    """``step(xp, bp) -> (xp_new, r2)``: one red-black iteration in one
    launch (``rb_single``: both colours, the residual folded on the card),
    r2 a 0-d float64 tensor.  As the n-iteration steps, it returns one of
    two states it owns (the one that is not ``xp``) and only reads ``xp``,
    so the driver's replay from its snapshot never writes the snapshot.
    ``mc`` (MafCoeffs) selects the MAF update.  None for odd I.  ``plain``
    runs the twin on any device."""
    if _refuses(shape, dtype):
        return None
    return _make_n(shape, dtype, omega, 1, offset, b_is_zero, plain, mc)


def _make_n(shape, dtype, omega, n, offset, b_is_zero, plain, mc):
    tab = maf_tables(mc, shape, dtype)
    launch = RbSweeps(n, omega, offset, tab, rb_single if n == 1 else None)
    bufs = []  # the two states the step alternates between

    def step(xp, bp):
        b = None if b_is_zero else bp
        if not bufs or bufs[0].device != xp.device:
            bufs[:] = (torch.empty_like(xp), torch.empty_like(xp))
        # ping-pong: write the state that is not xp; a foreign xp (the
        # start, or the driver's snapshot in its replay) is only read
        out = bufs[1] if xp.data_ptr() == bufs[0].data_ptr() else bufs[0]
        if plain or not xp.is_cuda:
            out.copy_(xp)
            r2 = packed_sweeps_plain(out, b, n, omega, offset, tab)[1]
        elif not _cells(xp):
            out.copy_(xp)
            r2 = torch.zeros(n, dtype=torch.float64, device=xp.device)
        else:
            r2 = launch(xp, b, out)
        return out, r2[0] if n == 1 else r2

    single = None
    if n > 1:
        single = make_packed_sweep(shape, dtype, omega=omega, offset=offset,
                                   b_is_zero=b_is_zero, mc=mc, plain=plain)
    step = _attach(step, shape, offset, n, single)
    step.launcher = launch
    return step


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
    ``mc``): the JAX package's bounds.  As the pair's, the step returns
    one of two states it owns (the one that is not ``xp``), which holds
    until the call after next, and its r2 until the next call on CUDA."""
    if _refuses(shape, dtype) or not 2 <= n <= (9 if mc is None else 7):
        return None
    return _make_n(shape, dtype, omega, n, offset, True, plain, mc)
