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

``fused_pcr`` launches csrc/pcr.cu for a CUDA tensor and raises on what it
cannot take; for a CPU tensor it runs the plain twin ``fused_pcr_plain``,
bitwise equal to the kernel in float32 and float64.  Arithmetic contract
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
def stage_tables(n: int, dtype, device) -> torch.Tensor:
    """``build_tables(n, dtype)`` as a contiguous tensor on ``device``."""
    return torch.from_numpy(build_tables(n, dtype)).to(device)


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
# kernel wrapper
# --------------------------------------------------------------------------


def tile_lines(n: int, dtype, maf: bool) -> int:
    """Lines a CTA holds: the largest of 32, 16, ..., 1 whose stage
    buffers (two of d, or two of a, c, d under MAF) fit SMEM_BYTES."""
    per_line = (6 if maf else 2) * n * torch.empty((), dtype=dtype).element_size()
    for L in (32, 16, 8, 4, 2, 1):
        if L * per_line <= SMEM_BYTES:
            return L
    raise ValueError(f"a line of {n} rows does not fit the kernel's shared "
                     "memory")


def fused_pcr(x, b, omega: float, color=None, offset: int = 0, tab=None,
              out=None):
    """Launch ``fused_pcr_kernel``: one line-PCR pass over the (K, I, J)
    field ``x``; ``color`` 0/1 in place, None out of place into ``out`` (a
    new field when None; never x); ``tab`` (``maf_tables``) selects MAF.
    Returns (field, float64 sum of dp^2 on the device).  A CPU tensor runs
    the plain twin."""
    if not x.is_cuda:
        return fused_pcr_plain(x, b, omega, color, offset, tab, out)
    _check(x, b, tab)
    if color not in (None, 0, 1):
        raise ValueError(f"color must be None, 0 or 1, not {color!r}")
    K, I, J = x.shape
    if K - 2 < 1 or I < 3 or J < 3:
        raise ValueError(f"no inner line in a field of shape {tuple(x.shape)}")
    lib = _build.load()
    maf = tab is not None
    L = tile_lines(K - 2, x.dtype, maf)
    if color is None:
        out = torch.empty_like(x) if out is None else out
        if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device \
                or not out.is_contiguous() or out.data_ptr() == x.data_ptr():
            raise ValueError("out must be a contiguous field like x, not x")
        gx, gy = -(-J // L), I
    else:
        out = x
        gx, gy = -(-((J - 1) // 2) // L), I - 2
    lt = tab if maf else stage_tables(K - 2, x.dtype, x.device)
    partials = torch.empty(gx * gy, dtype=x.dtype, device=x.device)
    rc = getattr(lib, f"cz_fused_pcr_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), ptr(b), lt.data_ptr(), out.data_ptr(), partials.data_ptr(),
        K, I, J, L, -1 if color is None else color, offset, num_stage(K - 2),
        omega, int(maf), gx, gy, x.device.index, stream(x))
    _build.check(rc, "fused_pcr")
    fused_pcr.launches += 1
    fused_pcr.maf_launches += maf
    return out, partials.sum(dtype=torch.float64)


fused_pcr.launches = fused_pcr.maf_launches = 0


# --------------------------------------------------------------------------
# builders (the JAX package's names and step contract)
# --------------------------------------------------------------------------


def make_fused_pcr(shape, dtype=torch.float32, *, omega: float, color=None,
                   offset: int = 0, b_is_zero: bool = False, mc=None):
    """Build ``pass_(x, b, out=None) -> (x_new, r2)`` over the (K, I, J)
    field: ``color`` None the full-plane line-Jacobi pass (the reference's
    pcr_j_esa; out of place), 0/1 one colour of pcr_rb (in place).  ``mc``
    (MafCoeffs) selects the MAF line solve.  None where a line has no
    inner row (K < 3)."""
    if dtype not in _SUFFIX:
        raise TypeError(f"K10 takes float32 or float64, not {dtype}")
    if shape[0] - 2 < 1:
        return None
    tab = maf_tables(mc, shape, dtype)

    def pass_(x, b, out=None):
        return fused_pcr(x, None if b_is_zero else b, omega, color, offset,
                         tab, out)

    return pass_


def make_fused_pcr_step(kind: str, shape, dtype=torch.float32, *,
                        omega: float, offset: int = 0, b_is_zero: bool = False,
                        mc=None):
    """``step(x, b) -> (x, r2)`` for 'pcr' (the full-plane line-Jacobi
    pass: x is only read; the returned field is one of two the step owns,
    the one that is not x) or 'pcr_rb' (both colours in place, colour 1
    after colour 0, serial-equivalent); ``mc`` selects MAF.  None where K
    < 3."""
    kw = dict(omega=omega, offset=offset, b_is_zero=b_is_zero, mc=mc)
    if kind == "pcr":
        p = make_fused_pcr(shape, dtype, color=None, **kw)
        if p is None:
            return None
        bufs = []

        def step(x, b):
            if not bufs:
                bufs.extend(torch.empty_like(x) for _ in range(2))
            out = bufs[1] if x.data_ptr() == bufs[0].data_ptr() else bufs[0]
            return p(x, b, out)
    elif kind == "pcr_rb":
        p0 = make_fused_pcr(shape, dtype, color=0, **kw)
        p1 = make_fused_pcr(shape, dtype, color=1, **kw)
        if p0 is None:
            return None

        def step(x, b):
            x, r0 = p0(x, b)
            x, r1 = p1(x, b)
            return x, r0 + r1
    else:
        raise ValueError(f"kind must be 'pcr' or 'pcr_rb', not {kind!r}")
    step.iters_per_call = 1
    step.single = step
    step.pad = pad_k2
    step.unpad = functools.partial(unpad_k2, shape=tuple(shape))
    return step
