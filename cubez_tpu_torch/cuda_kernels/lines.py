"""Line relaxation on the unpacked field (PyTorch/CUDA port of
``cubez_tpu/pallas_kernels/lines.py``, the fused line kernel K6), and the
line solve shared with the packed kernel K5 (``rblines.py``).

A line is the column of K values at one (i, j).  A line sweep solves each
inner line's K-tridiagonal system (the Dirichlet values x[0] and x[K-1]
folded into its ends) and moves the line by omega towards the solution:
the reference's pcr family (cz_solver.f90:497-1676, cz_maf.f90:442-1560).
The kernels solve each line by the Thomas algorithm in place of the TPU
kernel's dense T^-1 d and fast-diagonalization products, on a
shared-memory tile (``csrc/line_tile.cuh``): a CTA takes ``L`` lines of
one row, whole in K (``line_tile`` chooses L), builds their right-hand
sides with all its threads, runs the recurrences a thread a line out of
shared memory and writes the lines back once; no global scratch.

Layout: the (K, I, J) field itself, as K4 (``sweeps.pad_k2``, a
contiguous copy, and ``unpad_k2``); the TPU kernel's (I+4, Kp, Jp) line
layout and its padding are dropped.

Two kernels (csrc/lines.cu), each with constant coefficients or MAF and a
zero or a streamed right-hand side:

* ``line_j``: kind pcr_j, line-Jacobi over the whole plane from the
  pre-sweep field (the reference's pcr_j_esa), OUT OF PLACE: it writes a
  second field and never the one it was handed (the driver's
  stopping-chunk replay starts from its snapshot); the step owns two such
  fields and alternates between them;
* ``line_rb``: kind pcr_rb, one red-black line iteration in place, two
  colour launches; colour c holds the lines with (i + j + offset) % 2 == c
  and colour 1 sees colour 0's update.  The dispatch takes it where K5's
  packed layout refuses (odd I).

For a CPU tensor each runs its plain twin, ``line_j_plain`` /
``line_rb_plain``, which does the kernels' arithmetic vectorised over the
lines: bitwise equal to them in float32 and float64.

Arithmetic contract (``csrc/line_tile.cuh`` states it for the kernels): no
fused multiply-add; every operation rounds once, in this order.

* constant coefficients, R6 = 1/6 in the field dtype, Thomas factors
  Q_k = 1/m_k and E_k = (1/6)/m_k computed in float64 and rounded
  (``thomas_tables``):
  ``d = ((((x[i+1] + x[i-1]) + x[j+1]) + x[j-1]) - b) * R6``, then
  ``d += x[k=0] * R6`` at k = 1 and ``d += x[k=K-1] * R6`` at k = K-2;
  ``g_k = (d + R6 * g_{k-1}) * Q_k``, ``s_k = g_k + E_k * s_{k+1}``;
* MAF, on the weight vectors of ``rbpack.maf_tables``:
  ``d = ((wxp x[i+1] + wxm x[i-1]) + wyp x[j+1]) + wym x[j-1] - b``, then
  ``d += wzm_1 x[k=0]`` at k = 1 and ``d += wzp_{K-2} x[k=K-1]`` at
  k = K-2; ``m_k = 2 ((c1 + c2) + c3_k) - wzm_k e_{k-1}``,
  ``q_k = 1 / m_k``, ``g_k = (d + wzm_k g_{k-1}) q_k``,
  ``e_k = wzp_k q_k``, ``s_k = g_k + e_k s_{k+1}``;

then ``dp = (s_k - x) * omega`` and ``x += dp`` on the inner values of
the inner lines; the residual is the float64 sum of dp^2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .rbpack import _NP, _R6, _SUFFIX, count, maf_tables, ptr, stream, table_views
from .sweeps import _check, pad_k2, unpad_k2

KINDS = ("pcr_j", "pcr_rb")


def refuses(shape, dtype) -> bool:
    """True where no line step exists: fewer than two inner points along
    K (the JAX package's n = K - 2 < 2).  Raises for a dtype the kernels do
    not take."""
    if dtype not in _SUFFIX:
        raise TypeError(f"line steps take float32 or float64, not {dtype}")
    return shape[0] - 2 < 2


@functools.lru_cache(maxsize=None)
def _thomas_np(K: int) -> np.ndarray:
    r6 = 1.0 / 6.0
    q = np.zeros(K)
    e = np.zeros(K)
    m = 1.0
    for k in range(1, K - 1):
        if k > 1:
            m = 1.0 - r6 * e[k - 1]
        q[k] = 1.0 / m
        e[k] = r6 / m if k < K - 2 else 0.0
    return np.concatenate([q, e])


@functools.lru_cache(maxsize=None)
def thomas_tables(K: int, dtype, device) -> torch.Tensor:
    """The constant-coefficient Thomas factors of a line of K values:
    (2K,) tensor, Q_k = 1/m_k then E_k = (1/6)/m_k for k = 1..K-2 (zeros
    elsewhere, E_{K-2} = 0), computed in float64 and rounded to ``dtype``."""
    return torch.from_numpy(_thomas_np(K).astype(_NP[dtype])).to(device)


# --------------------------------------------------------------------------
# the shared-memory tile of the kernels (csrc/line_tile.cuh)
# --------------------------------------------------------------------------

TILE_LINES = 32  # the most lines a tile takes
# threads of a tile's CTA: a multiple of 32 and of L
# (tools/prof_lines.py --fixed --tiles measures the choices)
TILE_THREADS = 256
# an H100 (sm_90): a CTA may take 227 KB of shared memory, an SM holds
# 228 KB and keeps 1 KB of it for each resident CTA; the kernels' static
# array (the fold's warp sums, kTileMaxThreads / 32 values) is counted at
# its largest, float64
SMEM_CTA = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1024
TILE_MAX_THREADS = 256  # line_tile.cuh's kTileMaxThreads
SMEM_STATIC = 8 * TILE_MAX_THREADS // 32
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


def _tile_bytes(K: int, dtype, maf: bool, L: int) -> int:
    """line_tile.cuh's ``tile_smem_bytes``: the k tables (2K values, 3K for
    MAF), then (K - 2) L values of d, and as many of e_k for MAF."""
    n = (3 if maf else 2) * K + (K - 2) * L * (2 if maf else 1)
    return n * _ITEMSIZE[dtype]


def max_tile_k(dtype, maf: bool) -> int:
    """The largest K whose tile of one line fits one CTA's shared memory."""
    # a one-line tile: (tables + per_line) K - 2 per_line values
    item, per_line, tables = _ITEMSIZE[dtype], 2 if maf else 1, 3 if maf else 2
    return (SMEM_CTA - SMEM_STATIC + 2 * per_line * item) // ((tables + per_line) * item)


def line_tile(K: int, dtype, maf: bool, max_lines: int | None = None):
    """(L, smem bytes): the lines one CTA of the line kernels takes for
    lines of K values, and the shared memory of its tile (``_tile_bytes``).
    L is the largest power of two up to ``max_lines`` (``TILE_LINES``)
    whose tile leaves room for two CTAs an SM, while that allows L >= 16;
    else the largest whose tile fits one CTA.  Raises ValueError past
    ``max_tile_k``."""
    top = TILE_LINES if max_lines is None else max_lines
    cands = [1 << p for p in range(top.bit_length() - 1, -1, -1)]

    def fits(L, ctas):
        need = _tile_bytes(K, dtype, maf, L) + SMEM_STATIC
        return need <= SMEM_CTA and ctas * (need + SMEM_RESERVED) <= SMEM_SM

    for L in cands:
        if L >= 16 and fits(L, 2):
            return L, _tile_bytes(K, dtype, maf, L)
    for L in cands:
        if fits(L, 1):
            return L, _tile_bytes(K, dtype, maf, L)
    raise ValueError(
        f"a line of K = {K} {dtype} values{' (MAF)' if maf else ''} does not "
        f"fit the line kernels' shared memory: K <= {max_tile_k(dtype, maf)}")


def tile_count(rows: int, lanes: int, L: int) -> int:
    """Tiles of a launch over ``rows`` rows of ``lanes`` lines, L a tile:
    line_tile.cuh's ``tile_count``."""
    return rows * -(-lanes // L)


def tile_plan(kind: str, shape, dtype, maf: bool):
    """(L, threads, tiles) of one launch of ``kind`` on a state of
    ``shape``: 'rbl' (K5, the packed (2, K, I/2, J) state; a colour's rows
    are i2 and its lanes j), 'line_j' (every line of (K, I, J), rows i,
    lanes j) or 'line_rb' (one colour of (K, I, J), lanes the colour's
    ceil(J/2) j).  A launch writes one partial sum of dp^2 a tile."""
    K, I, J = shape[-3:]
    return _plan(kind, K, I, J, dtype, bool(maf), TILE_LINES, TILE_THREADS)


@functools.lru_cache(maxsize=None)
def _plan(kind, K, I, J, dtype, maf, max_lines, threads):
    rows, lanes = {"rbl": (I, J), "line_j": (I, J),
                   "line_rb": (I, (J + 1) // 2)}[kind]
    L, _ = line_tile(K, dtype, maf, max_lines)
    return L, max(threads, L), tile_count(rows, lanes, L)


# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------


def relax_dp(x, b, omega: float, tab=None, msk=None):
    """dp on the inner values of the inner lines of the (K, I, J) field x,
    shaped (K-2, I-2, J-2), by the contract above; ``tab``
    (``maf_tables``) selects MAF.  ``msk`` (a (K, I, J) 0/1 mask, None for
    the standard one) zeroes the line right-hand side and dp where it is 0,
    as the JAX package's jnp line step does; the face lines never move.
    x is only read."""
    K, I, J = x.shape
    dt, dev = x.dtype, x.device
    nb = {"ip": x[1:-1, 2:, 1:-1], "im": x[1:-1, :-2, 1:-1],
          "jp": x[1:-1, 1:-1, 2:], "jm": x[1:-1, 1:-1, :-2]}
    own = x[1:-1, 1:-1, 1:-1]
    x0, xK = x[0, 1:-1, 1:-1], x[-1, 1:-1, 1:-1]
    b = None if b is None else b[1:-1, 1:-1, 1:-1]
    msk = None if msk is None else msk[1:-1, 1:-1, 1:-1]
    n = K - 2
    g = torch.empty_like(own)
    gp = torch.zeros_like(own[0])
    if tab is None:
        r6 = torch.tensor(_R6[dt], dtype=dt, device=dev)
        qe = thomas_tables(K, dt, dev)
        d = nb["ip"] + nb["im"] + nb["jp"] + nb["jm"]
        if b is not None:
            d = d - b
        d = d * r6
        d[0] = d[0] + x0 * r6
        d[-1] = d[-1] + xK * r6
        if msk is not None:
            d = d * msk
        for k in range(1, K - 1):
            gp = (d[k - 1] + r6 * gp) * qe[k]
            g[k - 1] = gp
        f = qe[K + 1:2 * K - 1, None, None].expand_as(g)
    else:
        t = table_views(tab, (K, I, J))
        wi = {w: t[w][1:-1, None] for w in ("wxp", "wxm")}
        wj = {w: t[w][1:-1] for w in ("wyp", "wym")}
        d = wi["wxp"] * nb["ip"] + wi["wxm"] * nb["im"]
        d = d + wj["wyp"] * nb["jp"]
        d = d + wj["wym"] * nb["jm"]
        if b is not None:
            d = d - b
        d[0] = d[0] + t["wzm"][1] * x0
        d[-1] = d[-1] + t["wzp"][K - 2] * xK
        if msk is not None:
            d = d * msk
        s12 = t["c1"][1:-1, None] + t["c2"][1:-1]
        two = torch.tensor(2.0, dtype=dt, device=dev)
        one = torch.ones_like(s12)
        f = torch.empty_like(own)
        ep = torch.zeros_like(gp)
        for k in range(1, K - 1):
            m = two * (s12 + t["c3"][k]) - t["wzm"][k] * ep
            q = one / m
            gp = (d[k - 1] + t["wzm"][k] * gp) * q
            ep = t["wzp"][k] * q
            g[k - 1], f[k - 1] = gp, ep
    sol = torch.empty_like(own)
    s = torch.zeros_like(gp)
    for k in range(n - 1, -1, -1):
        s = g[k] + f[k] * s
        sol[k] = s
    dp = (sol - own) * torch.tensor(omega, dtype=dt, device=dev)
    return dp if msk is None else dp * msk


def line_j_plain(x, b, omega: float, tab=None, msk=None):
    """Plain twin of ``line_j``: (new field, float64 sum of dp^2); ``msk``
    as in ``relax_dp``."""
    dp = relax_dp(x, b, omega, tab, msk)
    out = x.clone()
    out[1:-1, 1:-1, 1:-1] += dp
    return out, (dp * dp).sum(dtype=torch.float64)


def line_colours(I, J, offset, device):
    """(I-2, J-2) colour of each inner line: (i + j + offset) % 2."""
    i = torch.arange(1, I - 1, device=device)[:, None]
    j = torch.arange(1, J - 1, device=device)[None, :]
    return (i + j + offset) % 2


def line_rb_plain(x, b, omega: float, offset: int = 0, tab=None, msk=None):
    """Plain twin of ``line_rb``: one red-black line iteration in place;
    returns the float64 sum of dp^2 over both colours.  ``msk`` as in
    ``relax_dp``."""
    K, I, J = x.shape
    par = line_colours(I, J, offset, x.device)
    r2 = torch.zeros((), dtype=torch.float64, device=x.device)
    for c in (0, 1):
        dp = torch.where(par == c, relax_dp(x, b, omega, tab, msk), 0.0)
        x[1:-1, 1:-1, 1:-1] += dp
        r2 = r2 + (dp * dp).sum(dtype=torch.float64)
    return r2


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def launch_args(x, tab):
    """(library, the line tables, the MAF flag) for a launch on x; the
    line tables are ``tab`` for MAF, else ``thomas_tables``."""
    if x.shape[-3] - 2 < 2:
        raise ValueError("the line kernels need K - 2 >= 2 inner points "
                         f"along K, got K = {x.shape[-3]}")
    lt = tab if tab is not None else thomas_tables(x.shape[-3], x.dtype, x.device)
    return _build.load(), lt, int(tab is not None)


def line_j(x, b, omega: float, tab=None, out=None):
    """Launch ``line_jacobi_kernel``: one line-Jacobi iteration into
    ``out`` (a new field when None; never ``x``, which is only read);
    ``tab`` (``maf_tables``) selects MAF.  Returns (out, float64 sum of
    dp^2 on the device).  A CPU tensor runs the plain twin."""
    if not x.is_cuda:
        return line_j_plain(x, b, omega, tab)
    _check(x, b, tab)
    lib, lt, maf = launch_args(x, tab)
    K, I, J = x.shape
    if out is None:
        out = torch.empty_like(x)
    if (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {tuple(x.shape)} "
                         f"{x.dtype} tensor on {x.device}")
    if out.data_ptr() == x.data_ptr():
        raise ValueError("out must not be x (the update is out of place)")
    L, threads, tiles = tile_plan("line_j", x.shape, x.dtype, maf)
    partials = torch.empty(tiles, dtype=x.dtype, device=x.device)
    rc = getattr(lib, f"cz_line_j_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), ptr(b), lt.data_ptr(), out.data_ptr(),
        partials.data_ptr(), K, I, J, omega, maf, L, threads, tiles,
        x.device.index, stream(x),
    )
    _build.check(rc, "line_j")
    count(line_j, tab)
    return out, partials.sum(dtype=torch.float64)


line_j.launches = line_j.maf_launches = 0


def line_rb(x, b, omega: float, offset: int = 0, tab=None):
    """Launch ``line_rb_color_kernel`` twice (colour 0, then 1): one
    red-black line iteration in place; ``tab`` selects MAF.  Returns the
    float64 sum of dp^2 over both colours (on the device).  A CPU tensor
    runs the plain twin."""
    if not x.is_cuda:
        return line_rb_plain(x, b, omega, offset, tab)
    _check(x, b, tab)
    lib, lt, maf = launch_args(x, tab)
    K, I, J = x.shape
    L, threads, tiles = tile_plan("line_rb", x.shape, x.dtype, maf)
    fn = getattr(lib, f"cz_line_rb_color_{_SUFFIX[x.dtype]}")
    partials = torch.empty(2, tiles, dtype=x.dtype, device=x.device)
    st = stream(x)
    for c in (0, 1):
        rc = fn(x.data_ptr(), ptr(b), lt.data_ptr(), partials[c].data_ptr(),
                K, I, J, c, offset, omega, maf, L, threads, tiles,
                x.device.index, st)
        _build.check(rc, "line_rb")
        count(line_rb, tab)
    return partials.sum(dtype=torch.float64)


line_rb.launches = line_rb.maf_launches = 0


# --------------------------------------------------------------------------
# builder (the JAX package's name and step contract)
# --------------------------------------------------------------------------


def make_line_step(kind: str, shape, dtype=torch.float32, *, omega: float,
                   offset: int = 0, b_is_zero: bool = False, mc=None,
                   plain: bool = False):
    """``step(x, b) -> (x, r2)`` on the unpacked state (``pad_k2``), r2 a
    0-d float64 tensor.  ``kind``: 'pcr_j' (x is only read; on CUDA the
    returned field is one of two buffers the step owns, the one that is
    not x, so it holds until the call after next) or 'pcr_rb' (x is
    updated in place and returned).  ``mc`` (MafCoeffs) selects MAF;
    ``b_is_zero`` ignores ``b``; ``plain`` runs the twin on any device.
    None where K - 2 < 2."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    if refuses(shape, dtype):
        return None
    tab = maf_tables(mc, shape, dtype)
    bufs = []  # line-Jacobi's two fields, made at the first CUDA call

    if kind == "pcr_j" and plain:
        def step(x, b):
            return line_j_plain(x, None if b_is_zero else b, omega, tab)
    elif kind == "pcr_j":
        def step(x, b):
            if not x.is_cuda:
                return line_j(x, None if b_is_zero else b, omega, tab)
            if not bufs:
                bufs.extend(torch.empty_like(x) for _ in range(2))
            # ping-pong: write the buffer that is not x; a foreign x (the
            # start, or the driver's snapshot in its replay) is only read
            out = bufs[1] if x.data_ptr() == bufs[0].data_ptr() else bufs[0]
            return line_j(x, None if b_is_zero else b, omega, tab, out=out)
    elif plain:
        def step(x, b):
            return x, line_rb_plain(x, None if b_is_zero else b, omega, offset, tab)
    else:
        def step(x, b):
            return x, line_rb(x, None if b_is_zero else b, omega, offset, tab)

    step.iters_per_call = 1
    step.single = step
    step.pad = pad_k2
    step.unpad = functools.partial(unpad_k2, shape=tuple(shape))
    return step
