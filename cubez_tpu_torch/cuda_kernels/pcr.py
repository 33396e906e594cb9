"""Serial line-PCR pass, K10 (PyTorch/CUDA port of
``cubez_tpu/pallas_kernels/pcr.py``).

One pass relaxes the inner K-lines of the (K, I, J) field: each line's
tridiagonal system over its n = K - 2 inner rows (the Dirichlet values
x[0] and x[K-1] folded into its ends) is solved by parallel cyclic
reduction (PCR) and the line moves by omega towards the solution, the
reference's pcr family (cz_solver.f90:497-1676, cz_maf.f90:442-1560).
Constant coefficients run the table-driven solve (``build_tables``, the
stage tables evolved in float64 on the host), MAF the variable-coefficient
one on the system normalised to a unit diagonal by dw = 0.5 / ((c1 + c2) +
c3).  ``color`` 0/1 relaxes the lines with (i + j + offset) % 2 == color
in place; None every inner line from the pre-pass field, out of place (the
line-Jacobi pass).

Layout: the (K, I, J) field itself (``sweeps.pad_k2``), as K6; the TPU
kernel's (I+2, Kp, Jp) line layout and its (8, 128) padding are dropped.
No solver dispatch takes this kernel (the JAX package's dispatch sends the
line solvers to K5/K6 too): its entry point is ``make_fused_pcr_step``.

``fused_pcr`` (one pass) and the steps of ``make_fused_pcr_step`` launch
csrc/pcr.cu through a ``PcrLines`` launcher for a CUDA tensor and raise on
what they cannot take; for a CPU tensor they run the plain twin
``fused_pcr_plain``, bitwise equal to the kernel in float32 and float64.
``line_plan`` picks the kernel's form: 'lines' for lines of up to 512
rows (a warp a line, the PCR stages in registers by shuffles, both colours
of a pcr_rb step and the residual's fold in one cooperative launch), else
'tile' (whole lines of a CTA in shared memory, a barrier a stage, one
launch a colour and the fold on the host).  Arithmetic contract
(csrc/pcr.cu and csrc/pcr.cuh state it for the kernel): one rounding per
operation, no fused multiply-add.

* constant: ``d = ((((x[i+1] + x[i-1]) + x[j+1]) + x[j-1]) - b) * R6``,
  ``d += x[k=0] * R6`` at the first inner row and ``d += x[k=K-1] * R6`` at
  the last; then ``pcr_solve``;
* MAF (the weight vectors of ``rbpack.maf_tables``): ``dw = 0.5 / ((c1 +
  c2) + c3)``, ``a = -(wzm dw)`` (0 on the first row), ``c = -(wzp dw)``
  (0 on the last), ``d = ((((wxp x[i+1] + wxm x[i-1]) + wyp x[j+1]) + wym
  x[j-1]) - b) dw``, ``d += (wzm dw) x[k=0]`` and ``d += (wzp dw)
  x[k=K-1]`` at the ends; then ``pcr_solve_var``;

and ``dp = (s - x) * omega``, ``x += dp``; the residual is the float64 sum
of dp^2.  The JAX package's interpreted kernel on the CPU contracts some of
these products into fused multiply-adds where XLA fuses the stages (a
``jax.jit`` of the stage recurrence differs from the same ops run one by
one); the twin is bitwise the op-by-op form, and within 2e-6 (constant)
and 3e-6 (MAF) of the interpreted kernel at 16^3 (tests/test_torch_pcr.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..ops.pcr import num_stage, pcr_reduce_var
from ..ops.shifts import shift
from . import _build
from .rbpack import _NP, _R6, _SUFFIX, maf_tables, ptr, stream, table_views
from .sweeps import _check, pad_k2, unpad_k2

R6 = 1.0 / 6.0
# shared memory a CTA may take for its tile of lines (two CTAs an SM)
SMEM_BYTES = 100 * 1024


def build_tables(n: int, dtype=torch.float32) -> np.ndarray:
    """Stage and final tables as one ((pn-1)*3 + 3, n) array in ``dtype``.

    Rows 3p..3p+2 hold (a, c, e) of stage p (stride 2^p); the last 3 rows
    hold (c_lo, a_hi, jj) of the final 2x2 inversion, zero-padded from
    length s = 2^(pn-1) to n.  Evolved in float64, as the JAX package's
    ``build_tables`` and ``build_pcr_plan`` do."""
    pn = num_stage(n)

    def shift_np(v, d):
        out = np.zeros_like(v)
        if d > 0:
            out[:-d] = v[d:]
        elif d < 0:
            out[-d:] = v[:d]
        else:
            out[:] = v
        return out

    a = np.full(n, -R6, np.float64)
    c = np.full(n, -R6, np.float64)
    a[0] = 0.0
    c[-1] = 0.0
    rows = []
    for p in range(1, pn):
        s = 2 ** (p - 1)
        al, ar = shift_np(a, -s), shift_np(a, s)
        cl, cr = shift_np(c, -s), shift_np(c, s)
        e = 1.0 / (1.0 - a * cl - c * ar)
        rows += [a.copy(), c.copy(), e]
        a, c = -e * a * al, -e * c * cr

    s = 2 ** (pn - 1)
    a_hi = np.zeros(s)
    a_hi[: max(n - s, 0)] = a[s:]
    c_lo = c[:s].copy()
    jj = 1.0 / (1.0 - a_hi * c_lo)

    def padn(v):
        out = np.zeros(n)
        out[: v.shape[0]] = v
        return out

    rows += [padn(c_lo), padn(a_hi), padn(jj)]
    return np.asarray(rows, dtype=_NP.get(dtype, dtype))


@functools.lru_cache(maxsize=None)
def stage_tables(n: int, dtype, device, width: int | None = None) -> torch.Tensor:
    """``build_tables(n, dtype)`` as a contiguous tensor on ``device``; with
    ``width``, each row padded with zeros to ``width`` values (the line
    form's tables: rows past n stay zero through every stage)."""
    tab = build_tables(n, dtype)
    if width is not None:
        tab = np.concatenate([tab, np.zeros((tab.shape[0], width - n), tab.dtype)], 1)
    return torch.from_numpy(np.ascontiguousarray(tab)).to(device)


# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------


def pcr_solve(d, tab, pn: int):
    """Table-driven PCR on the right-hand sides ``d`` (n, ...), the line
    along axis 0; ``tab`` the (rows, n) tensor of ``build_tables``."""
    n = d.shape[0]

    def col(r):
        return tab[r].reshape((n,) + (1,) * (d.dim() - 1))

    for p in range(pn - 1):
        s = 2 ** p
        ap, cp, e = col(3 * p), col(3 * p + 1), col(3 * p + 2)
        dl = shift(d, 0, +s)  # d[k+s]
        dr = shift(d, 0, -s)  # d[k-s]
        d = e * (d - ap * dr - cp * dl)
    s = 2 ** (pn - 1)
    fin = 3 * (pn - 1)
    c_lo, a_hi, jj = col(fin), col(fin + 1), col(fin + 2)
    d_hi = shift(d, 0, +s)
    x_lo = (d - c_lo * d_hi) * jj
    x_hi = (d_hi - a_hi * d) * jj
    return torch.cat([x_lo[:s], shift(x_hi, 0, -s)[s:]], dim=0)


# the variable-coefficient solve: the stage recurrence of ops/pcr.py
pcr_solve_var = pcr_reduce_var


def line_system(x, b, tab=None):
    """(a, c, d) of every inner line of the (K, I, J) field, each (K-2,
    I-2, J-2), by the contract above (a and c None for constant
    coefficients; ``tab`` from ``maf_tables`` selects MAF)."""
    K, I, J = x.shape
    xip, xim = x[1:-1, 2:, 1:-1], x[1:-1, :-2, 1:-1]
    xjp, xjm = x[1:-1, 1:-1, 2:], x[1:-1, 1:-1, :-2]
    x0, xK = x[0, 1:-1, 1:-1], x[-1, 1:-1, 1:-1]
    bb = None if b is None else b[1:-1, 1:-1, 1:-1]
    if tab is None:
        r6 = torch.tensor(_R6[x.dtype], dtype=x.dtype, device=x.device)
        t = xip + xim + xjp + xjm
        if bb is not None:
            t = t - bb
        d = t * r6
        d[0] = d[0] + x0 * r6
        d[-1] = d[-1] + xK * r6
        return None, None, d
    w = table_views(tab, (K, I, J))
    ci = {f: w[f][1:-1, None] for f in ("wxp", "wxm", "c1")}
    cj = {f: w[f][1:-1] for f in ("wyp", "wym", "c2")}
    ck = {f: w[f][1:-1, None, None] for f in ("wzm", "wzp", "c3")}
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    dw = half / (ci["c1"] + cj["c2"] + ck["c3"])
    wzm = ck["wzm"] * dw
    wzp = ck["wzp"] * dw
    a = -wzm
    c = -wzp
    a[0] = 0.0
    c[-1] = 0.0
    t = ci["wxp"] * xip + ci["wxm"] * xim
    t = t + cj["wyp"] * xjp
    t = t + cj["wym"] * xjm
    if bb is not None:
        t = t - bb
    d = t * dw
    d[0] = d[0] + wzm[0] * x0
    d[-1] = d[-1] + wzp[-1] * xK
    return a, c, d


def fused_pcr_plain(x, b, omega: float, color=None, offset: int = 0,
                    tab=None, out=None):
    """Plain twin of ``fused_pcr``: (field, float64 sum of dp^2).  A colour
    updates ``x`` in place and returns it; ``color`` None writes a new
    field (or ``out``) and leaves x as it was."""
    K, I, J = x.shape
    a, c, d = line_system(x, b, tab)
    pn = num_stage(K - 2)
    if tab is None:
        sol = pcr_solve(d, stage_tables(K - 2, x.dtype, x.device), pn)
    else:
        sol = pcr_solve_var(a, c, d, pn)
    own = x[1:-1, 1:-1, 1:-1]
    dp = (sol - own) * torch.tensor(omega, dtype=x.dtype, device=x.device)
    if color is not None:
        i = torch.arange(1, I - 1, device=x.device)[:, None]
        j = torch.arange(1, J - 1, device=x.device)[None, :]
        dp = torch.where((i + j + offset) % 2 == color, dp, 0.0)
        own += dp
        return x, (dp * dp).sum(dtype=torch.float64)
    res = x.clone() if out is None else out.copy_(x)
    res[1:-1, 1:-1, 1:-1] += dp
    return res, (dp * dp).sum(dtype=torch.float64)


# --------------------------------------------------------------------------
# kernel wrapper: the plan and the launcher
# --------------------------------------------------------------------------

FORMS = ("lines", "tile")
# csrc/pcr.cu: threads of a line-form CTA, columns of its work item, the
# slab counts it is built for (a line of n rows takes the least M with
# n <= 32 M, so at most 512 rows), the shared memory a CTA may take
LINE_THREADS = 256
WINDOW = 32
SLABS = (1, 2, 4, 8, 16)
SMEM_CTA = 227 * 1024 - 1024


@dataclasses.dataclass(frozen=True)
class PcrPlan:
    """A K10 launch on lines of ``n`` rows: 'lines', a warp a line in
    registers, ``slabs`` registers a lane (row k = lane + 32 m), a line's
    rows ``stride`` values apart in shared memory; 'tile', ``tile_lines``
    whole lines a CTA in shared memory (pcr.cuh), for lines past the
    registers."""

    form: str
    n: int
    slabs: int = 0
    tile_lines: int = 0

    @property
    def stride(self) -> int:
        return 32 * self.slabs + 1

    def smem(self, itemsize: int, jacobi: bool, maf: bool = False) -> int:
        """Shared memory a line-form CTA takes: the constant coefficients'
        padded stage tables, then the right-hand sides of its work item's
        lines (32 for the line-Jacobi pass, 16 for a colour)."""
        tables = 0 if maf else (3 * (num_stage(self.n) - 1) + 3) * 32 * self.slabs
        return (tables + (WINDOW if jacobi else WINDOW // 2) * self.stride) * itemsize


# MAF lines of more slabs than this (by itemsize) take the tile form: a
# lane holds a, c and d of M rows and their six shifted copies, 202
# registers at 16 slabs in float32 (one CTA an SM) and 2.3 KB spilled a
# thread in float64 (tools/prof_pcr.py --forms, H100 80GB HBM3 at 700 W,
# device us a pcr_rb step, lines / tiles: f32 256^3 496 / 576, 512^3 7128
# / 4877; f64 128^3 86.5-87.4 / 91.6-94.4, 256^3 1107 / 889, 512^3 19093 /
# 8158).  Constant coefficients keep the line form to 512 rows (512^3 f32
# 2583-2588 / 4517-4659) where its shared memory fits.
MAF_SLABS = {4: 8, 8: 4}
# a test and profiling hook, never set by the steps: {"form": "tile"} makes
# line_plan take the tile form at any length, {"form": "lines"} the line
# form wherever its shared memory fits
_force_plan: dict = {}


def line_plan(n: int, dtype=torch.float32, maf: bool = False,
              jacobi: bool = True) -> PcrPlan:
    """The form of a K10 launch on lines of ``n`` inner rows (``jacobi``:
    the line-Jacobi pass, else colour passes): 'lines' up to 32 *
    max(SLABS) = 512 rows (MAF: 32 * MAF_SLABS[itemsize]) where its shared memory
    fits a CTA, else 'tile' (``tile_lines``); ``_force_plan`` overrides."""
    if n < 1:
        raise ValueError(f"a line needs an inner row, not {n}")
    force = _force_plan.get("form")
    if force != "tile":
        item = torch.empty((), dtype=dtype).element_size()
        for m in SLABS:
            if n <= 32 * m:
                plan = PcrPlan("lines", n, slabs=m)
                regs = not maf or m <= MAF_SLABS[item] or force == "lines"
                if regs and plan.smem(item, jacobi, maf) <= SMEM_CTA:
                    return plan
                break
    return PcrPlan("tile", n, tile_lines=tile_lines(n, dtype, maf))


def tile_lines(n: int, dtype, maf: bool) -> int:
    """Lines a tile-form CTA holds: the largest of 32, 16, ..., 1 whose
    stage buffers (two of d, or two of a, c, d under MAF) fit
    SMEM_BYTES."""
    per_line = (6 if maf else 2) * n * torch.empty((), dtype=dtype).element_size()
    for L in (32, 16, 8, 4, 2, 1):
        if L * per_line <= SMEM_BYTES:
            return L
    raise ValueError(f"a line of {n} rows does not fit the kernel's shared "
                     "memory")


_MAX_BLOCKS: dict = {}


def _max_blocks(slabs, maf, smem, x) -> int:
    key = (slabs, maf, smem, x.dtype, x.get_device())
    if key not in _MAX_BLOCKS:
        cnt = ctypes.c_int(0)
        rc = getattr(_build.load(), f"cz_pcr_lines_max_blocks_{_SUFFIX[x.dtype]}")(
            slabs, int(maf), smem, x.get_device(), cnt)
        _build.check(rc, "K10 line form occupancy")
        if cnt.value < 1:
            raise RuntimeError(f"K10 line form, {slabs} slabs: no CTA fits an SM")
        _MAX_BLOCKS[key] = cnt.value
    return _MAX_BLOCKS[key]


def _check_out(x, out):
    if (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
            or not out.is_contiguous() or out.data_ptr() == x.data_ptr()):
        raise ValueError("out must be a contiguous field like x, not x")


class PcrLines:
    """K10's launcher for one step: the passes ``colours`` (0 and/or 1 in
    place, in that order, or (None,), the line-Jacobi pass into ``out``) at
    ``offset``, ``tab`` (``maf_tables``) selecting MAF.  ``__call__(x, b,
    out)`` returns the 0-d float64 sum of dp^2 over the passes, in a
    buffer of the launcher's that holds until its next call.  The line
    form makes one launch a call, whatever the passes: a grid-wide sync
    between them, the fold on the card.  The tile form (lines past the
    registers) makes one launch a pass and folds on the host.  The plan,
    the buffers and the ctypes arguments (for each set of field pointers)
    are built once.  It counts its launches on ``fused_pcr`` (by form and
    MAF in ``fused_pcr.variant_launches``)."""

    def __init__(self, colours, omega: float, offset: int = 0, tab=None):
        colours = tuple(colours)
        if colours not in ((0,), (1,), (0, 1), (None,)):
            raise ValueError(f"passes must be colours 0, 1, both, or None, "
                             f"not {colours!r}")
        self.colours, self.omega, self.offset, self.tab = colours, omega, offset, tab
        self._key = None  # (shape, dtype, device) of the buffers
        self._args = {}
        self.plan = self.grid = None

    def _setup(self, x):
        from .dist_halo import int_array

        K, I, J = x.shape
        maf = self.tab is not None
        dev = x.get_device()
        jac = self.colours == (None,)
        self.plan = plan = line_plan(K - 2, x.dtype, maf, jac)
        self._lt = self.tab
        if not maf:
            width = 32 * plan.slabs if plan.form == "lines" else None
            self._lt = stage_tables(K - 2, x.dtype, x.device, width)
        self._r2 = torch.zeros((), dtype=torch.float64, device=x.device)
        lib = _build.load()
        if plan.form == "tile":
            self._fn = getattr(lib, f"cz_fused_pcr_{_SUFFIX[x.dtype]}")
            L = plan.tile_lines
            self._tile_grids = {c: ((-(-J // L), I) if c is None
                                    else (-(-((J - 1) // 2) // L), I - 2))
                                for c in self.colours}
            self._partials = {c: torch.empty(gx * gy, dtype=x.dtype,
                                             device=x.device)
                              for c, (gx, gy) in self._tile_grids.items()}
        else:
            smem = plan.smem(x.element_size(), jac, maf)
            wins = -(-(J - (0 if jac else 1)) // WINDOW)
            items = (I if jac else I - 2) * wins
            self.grid = min(_max_blocks(plan.slabs, maf, smem, x), items)
            self._partials = torch.empty(len(self.colours) * self.grid,
                                         dtype=x.dtype, device=x.device)
            cols = [-1 if c is None else c for c in self.colours] + [0]
            self._ints = int_array((plan.slabs, int(maf), K, I, J, self.offset,
                                    num_stage(K - 2), len(self.colours),
                                    cols[0], cols[1], self.grid, smem, dev))
            self._fn = getattr(lib, f"cz_pcr_lines_{_SUFFIX[x.dtype]}")
        self._key = (x.shape, x.dtype, x.device)
        self._args = {}

    def __call__(self, x, b, out):
        from .dist_halo import current_stream, pointer_array

        key = (x.data_ptr(), ptr(b), out.data_ptr())
        args = self._args.get(key)
        if args is None or (x.shape, x.dtype, x.device) != self._key:
            _check(x, b, self.tab)
            K, I, J = x.shape
            if K - 2 < 1 or I < 3 or J < 3:
                raise ValueError(f"no inner line in a field of shape {tuple(x.shape)}")
            if self.colours == (None,):
                _check_out(x, out)
            elif out.data_ptr() != x.data_ptr():
                raise ValueError("a colour pass updates x in place: out must be x")
            if (x.shape, x.dtype, x.device) != self._key:
                self._setup(x)
            if len(self._args) >= 8:
                self._args.clear()
            args = self._args[key] = (() if self.plan.form == "tile" else pointer_array(
                (x.data_ptr(), ptr(b), self._lt.data_ptr(), out.data_ptr(),
                 self._partials.data_ptr(), self._r2.data_ptr())))
        elif not x.is_contiguous():
            raise ValueError("need a contiguous (K, I, J) field")
        if self.plan.form == "tile":
            return self._tile(x, b, out)
        _build.check(self._fn(args, self._ints, self.omega,
                              current_stream(x.get_device())), "fused_pcr lines")
        self._count("lines")
        return self._r2

    def _count(self, form):
        fused_pcr.launches += 1
        fused_pcr.maf_launches += self.tab is not None
        key = (form, self.tab is not None)
        fused_pcr.variant_launches[key] = fused_pcr.variant_launches.get(key, 0) + 1

    def _tile(self, x, b, out):
        """The tile form: one launch of fused_pcr_kernel a pass."""
        K, I, J = x.shape
        r2 = None
        for c in self.colours:
            gx, gy = self._tile_grids[c]
            part = self._partials[c]
            rc = self._fn(
                x.data_ptr(), ptr(b), self._lt.data_ptr(), out.data_ptr(),
                part.data_ptr(), K, I, J, self.plan.tile_lines,
                -1 if c is None else c, self.offset, num_stage(K - 2),
                self.omega, int(self.tab is not None), gx, gy,
                x.device.index, stream(x))
            _build.check(rc, "fused_pcr tile")
            self._count("tile")
            s = part.sum(dtype=torch.float64)
            r2 = s if r2 is None else r2 + s
        self._r2.copy_(r2)
        return self._r2


def fused_pcr(x, b, omega: float, color=None, offset: int = 0, tab=None,
              out=None):
    """One line-PCR pass over the (K, I, J) field ``x`` in one launch of
    the form ``line_plan`` picks: ``color`` 0/1 in place, None out of
    place into ``out`` (a new field when None; never x); ``tab``
    (``maf_tables``) selects MAF.  Returns (field, float64 sum of dp^2 on
    the device).  A CPU tensor runs the plain twin."""
    if not x.is_cuda:
        return fused_pcr_plain(x, b, omega, color, offset, tab, out)
    if color not in (None, 0, 1):
        raise ValueError(f"color must be None, 0 or 1, not {color!r}")
    return _one_pass(PcrLines((color,), omega, offset, tab), x, b, out)


def _one_pass(launch, x, b, out):
    """(field, r2) of a one-pass launcher: a colour in place, or the
    line-Jacobi pass into ``out`` (a new field when None)."""
    if launch.colours != (None,):
        out = x
    elif out is None:
        out = torch.empty_like(x)
    return out, launch(x, b, out)


fused_pcr.launches = fused_pcr.maf_launches = 0
# launches by (form, MAF)
fused_pcr.variant_launches = {}


# --------------------------------------------------------------------------
# builders (the JAX package's names and step contract)
# --------------------------------------------------------------------------


def _builder_checks(shape, dtype) -> bool:
    if dtype not in _SUFFIX:
        raise TypeError(f"K10 takes float32 or float64, not {dtype}")
    return shape[0] - 2 >= 1


def make_fused_pcr(shape, dtype=torch.float32, *, omega: float, color=None,
                   offset: int = 0, b_is_zero: bool = False, mc=None):
    """Build ``pass_(x, b, out=None) -> (x_new, r2)`` over the (K, I, J)
    field: ``color`` None the full-plane line-Jacobi pass (the reference's
    pcr_j_esa; out of place), 0/1 one colour of pcr_rb (in place).  ``mc``
    (MafCoeffs) selects the MAF line solve.  None where a line has no
    inner row (K < 3).  The pass keeps its launcher (one launch a call)."""
    if not _builder_checks(shape, dtype):
        return None
    tab = maf_tables(mc, shape, dtype)
    launch = PcrLines((color,), omega, offset, tab)

    def pass_(x, b, out=None):
        bb = None if b_is_zero else b
        if not x.is_cuda:
            return fused_pcr_plain(x, bb, omega, color, offset, tab, out)
        return _one_pass(launch, x, bb, out)

    pass_.launcher = launch
    return pass_


def make_fused_pcr_step(kind: str, shape, dtype=torch.float32, *,
                        omega: float, offset: int = 0, b_is_zero: bool = False,
                        mc=None):
    """``step(x, b) -> (x, r2)`` for 'pcr' (the full-plane line-Jacobi
    pass: x is only read; the returned field is one of two the step owns,
    the one that is not x) or 'pcr_rb' (both colours in place, colour 1
    after colour 0, serial-equivalent); ``mc`` selects MAF.  On the card
    either is one launch a call (the line form; the tile form, for lines
    past 512 rows, one a colour).  None where K < 3."""
    if kind not in ("pcr", "pcr_rb"):
        raise ValueError(f"kind must be 'pcr' or 'pcr_rb', not {kind!r}")
    if not _builder_checks(shape, dtype):
        return None
    tab = maf_tables(mc, shape, dtype)
    colours = (None,) if kind == "pcr" else (0, 1)
    launch = PcrLines(colours, omega, offset, tab)
    bufs = []

    def step(x, b):
        bb = None if b_is_zero else b
        if kind == "pcr":
            if not bufs or bufs[0].device != x.device:
                bufs[:] = (torch.empty_like(x), torch.empty_like(x))
            out = bufs[1] if x.data_ptr() == bufs[0].data_ptr() else bufs[0]
        else:
            out = x
        if not x.is_cuda:
            if kind == "pcr":
                return fused_pcr_plain(x, bb, omega, None, offset, tab, out)
            x, r0 = fused_pcr_plain(x, bb, omega, 0, offset, tab)
            x, r1 = fused_pcr_plain(x, bb, omega, 1, offset, tab)
            return x, r0 + r1
        return out, launch(x, bb, out)

    step.iters_per_call = 1
    step.single = step
    step.launcher = launch
    step.pad = pad_k2
    step.unpad = functools.partial(unpad_k2, shape=tuple(shape))
    return step
