"""Unpacked point sweeps (PyTorch/CUDA port of
``cubez_tpu/pallas_kernels/sweeps.py``, the fused sweep K4).

Layout: the (K, I, J) field itself, contiguous.  ``pad_k2`` is a
contiguous copy (the solve's state must be a tensor of its own) and
``unpad_k2`` its inverse; the TPU kernel's K pad of 2 and (8, 128) tile
padding are dropped, and the kernels mask on the true bounds.

Two kernels on shared-memory plane tiles (csrc/sweeps.cu), each in a
constant-coefficient and a MAF form, with a zero or a streamed right-hand
side, both OUT OF PLACE (they write a second field and never the one they
were handed) and each one cooperative launch that folds its own residuals:

* ``jacobi_k4``: ``n`` Jacobi iterations (1 or ``JACOBI_N``) in one launch;
* ``sor2sma_k4``: one red-black iteration, both colours in one pass.

``tile_plan`` sizes the tiles on the host.  The steps of
``make_fused_sweep`` own two fields and alternate between them (the
driver's stopping-chunk replay starts from its snapshot, which must stay
as it is), with their launch arguments, partials and residual built once.

For a CPU tensor each runs its plain twin, ``jacobi_plain`` (applied n
times: ``jacobi_n_plain``) / ``sor2sma_plain`` (on a copy), with the
arithmetic of ``cuda_kernels/rbpack.py``'s contracts (bitwise equal to the
kernels and to the JAX package's interpreted kernel in float32).  Colour c
holds the points with (i + j + k + offset + 1) % 2 == c (the JAX kernel's
``_iota_masks``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .dist_halo import current_stream, int_array, pointer_array
from .rbpack import (_R6, _SUFFIX, _fma, check_tab, count, maf_r, maf_tables,
                     out_for, ptr, table_views)

KINDS = ("jacobi", "sor2sma")
# Jacobi iterations a launch of the jacobi step: a divisor of 8, since
# slice 4's preconditioner runs 8 fixed sweeps on this step and
# driver.fixed_sweeps rounds up to whole calls
JACOBI_N = 2


def pad_k2(a: torch.Tensor) -> torch.Tensor:
    """(K, I, J) field -> the sweeps' state: a contiguous copy.  Apply to x
    and b alike."""
    return a.clone(memory_format=torch.contiguous_format)


def unpad_k2(a: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`pad_k2` (the state is the field of ``shape``)."""
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"state shape {tuple(a.shape)} != {tuple(shape)}")
    return a


# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------


def _dp(x, b, omega, tab):
    """dp on the interior (K-2, I-2, J-2) of the field x (rbpack.py's
    contracts; ``tab`` from ``maf_tables`` selects MAF)."""
    K, I, J = x.shape
    inner = (slice(1, -1),) * 3
    cen = x[inner]
    nb = {"zm": x[:-2, 1:-1, 1:-1], "zp": x[2:, 1:-1, 1:-1],
          "xm": x[1:-1, :-2, 1:-1], "xp": x[1:-1, 2:, 1:-1],
          "ym": x[1:-1, 1:-1, :-2], "yp": x[1:-1, 1:-1, 2:]}
    b = None if b is None else b[inner]
    om = torch.tensor(omega, dtype=x.dtype, device=x.device)
    if tab is None:
        ss = (nb["zm"] + nb["zp"]) + (nb["xm"] + nb["xp"]) + (nb["ym"] + nb["yp"])
        if b is not None:
            ss = ss - b
        r6 = torch.tensor(_R6[x.dtype], dtype=x.dtype, device=x.device)
        return _fma(ss, r6, -cen) * om
    t = table_views(tab, (K, I, J))
    zi, xi, yi = (slice(1, -1), None, None), (None, slice(1, -1), None), slice(1, -1)
    w = {"wzm": t["wzm"][zi], "wzp": t["wzp"][zi], "wxp": t["wxp"][xi],
         "wxm": t["wxm"][xi], "wyp": t["wyp"][yi], "wym": t["wym"][yi]}
    r = maf_r(w, nb)
    if b is not None:
        r = r + b
    dd = 2.0 * ((t["c1"][xi] + t["c2"][yi]) + t["c3"][zi])
    return (r / dd - cen) * om


def jacobi_plain(x, b, omega: float, tab=None):
    """Plain twin of one Jacobi iteration: (new field, float64 sum of
    dp^2)."""
    dp = _dp(x, b, omega, tab)
    out = x.clone()
    out[1:-1, 1:-1, 1:-1] += dp
    return out, (dp * dp).sum(dtype=torch.float64)


def jacobi_n_plain(x, b, omega: float, tab=None, n: int = 1):
    """Plain twin of ``jacobi_k4``: ``jacobi_plain`` applied n times;
    (new field, the (n,) float64 sums of dp^2)."""
    r2 = []
    for _ in range(n):
        x, r = jacobi_plain(x, b, omega, tab)
        r2.append(r)
    return x, torch.stack(r2)


def _colour(shape, colour, offset, device):
    """Interior points of ``colour``: (i + j + k + offset + 1) % 2 == c."""
    K, I, J = shape
    k = torch.arange(1, K - 1, device=device)[:, None, None]
    i = torch.arange(1, I - 1, device=device)[None, :, None]
    j = torch.arange(1, J - 1, device=device)[None, None, :]
    return (k + i + j + offset + 1) % 2 == colour


def sor2sma_plain(x, b, omega: float, offset: int = 0, tab=None):
    """Plain twin of one red-black iteration, in place (colour 0, then
    colour 1); returns the float64 sum of dp^2 over both colours."""
    r2 = torch.zeros((), dtype=torch.float64, device=x.device)
    for c in (0, 1):
        dp = torch.where(_colour(x.shape, c, offset, x.device),
                         _dp(x, b, omega, tab), 0.0)
        x[1:-1, 1:-1, 1:-1] += dp
        r2 = r2 + (dp * dp).sum(dtype=torch.float64)
    return r2


# --------------------------------------------------------------------------
# the tile plan
# --------------------------------------------------------------------------

# A tile's region (the tile and its halo) is at most REGION_ROWS rows of
# ROW cells, two a lane of a warp (csrc/sweeps.cu kRegionRows, the most
# the kernels take, and kRow).  Tiles are evened out over each axis within
# those bounds.
REGION_ROWS = 32
ROW = 64
# the least owned planes of a work item: a chunk recomputes a few planes
# past each end, so short chunks pay more
MIN_KCHUNK = 4
THREADS = 256  # csrc/sweeps.cu kThreads
AHEAD = 2  # planes of x in flight (csrc/sweeps.cu kAhead)
# H100: dynamic shared memory a CTA may take (the opt-in maximum less the
# kernels' static block_sum scratch), shared memory and threads of an SM
SMEM_CTA = 232448 - 1024
SMEM_SM = 233472
THREADS_SM = 2048


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A K4 launch's work: ``tiles_i`` x ``tiles_j`` tiles of ``ti`` x
    ``tj`` owned columns (the last of each row and column ragged), times
    ``nkc`` chunks of ``kchunk`` owned planes (the last ragged); ``halo``
    cells of halo in i and j around a tile; ``smem`` bytes of shared memory a CTA; ``per_sm`` CTAs an SM at most
    by shared memory and threads."""

    kind: str
    shape: tuple
    n: int
    halo: int
    ti: int
    tj: int
    tiles_i: int
    tiles_j: int
    kchunk: int
    nkc: int
    smem: int
    per_sm: int

    @property
    def nwork(self) -> int:
        return self.tiles_i * self.tiles_j * self.nkc

    def items(self):
        """Each work item's owned box ((k_lo, k_hi), (i_lo, i_hi), (j_lo,
        j_hi)), in the kernel's order."""
        K, I, J = self.shape
        for w in range(self.nwork):
            kc, t = divmod(w, self.tiles_i * self.tiles_j)
            ty, tx = divmod(t, self.tiles_j)
            yield ((kc * self.kchunk, min((kc + 1) * self.kchunk, K)),
                   (ty * self.ti, min((ty + 1) * self.ti, I)),
                   (tx * self.tj, min((tx + 1) * self.tj, J)))


def _even(size: int, most: int) -> int:
    """The least tile extent that covers ``size`` in as few tiles of at
    most ``most`` as it can."""
    return -(-size // -(-size // most))


def _k_chunks(K: int, tiles: int, slots: int, extra: int) -> int:
    """Owned planes a k chunk: the chunking whose launch ends soonest, of
    at least ``MIN_KCHUNK`` planes.  Each of ``slots`` co-resident CTAs
    runs its work items one after another, so a launch takes ceil(items /
    slots) items of kchunk + ``extra`` steps (the planes a chunk
    recomputes past its ends); the longest chunks on a tie."""
    best = None
    for nkc in range(1, -(-K // MIN_KCHUNK) + 1):
        kchunk = -(-K // nkc)
        cost = -(-tiles * -(-K // kchunk) // slots) * (kchunk + extra)
        if best is None or cost < best[0]:
            best = (cost, kchunk)
    return best[1]


def tile_plan(kind: str, shape, n: int = 1, itemsize: int = 4,
              slots: int | None = None, sms: int = 132) -> TilePlan:
    """The tiles of a K4 launch: a halo of n (Jacobi, n iterations) or 2
    (red-black), regions of ``REGION_ROWS`` rows and ``ROW`` columns at
    most, and k chunks (``_k_chunks``) for ``slots`` co-resident CTAs (by
    default an estimate for ``sms`` SMs).  Raises ValueError where the
    ring of planes does not fit a CTA's shared memory or the halo leaves
    no tile."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    if kind == "jacobi" and n not in (1, JACOBI_N):
        raise ValueError(f"the Jacobi kernel runs n in (1, {JACOBI_N}), not {n}")
    K, I, J = shape
    # the rings of planes, and AHEAD more for the planes in flight
    halo, planes = (n, 3 * n + AHEAD) if kind == "jacobi" else (2, 4 + AHEAD)
    # a region row also holds up to 16 / itemsize - 1 cells before its
    # first, so that it copies in aligned 16-byte pieces
    ti_most, tj_most = REGION_ROWS - 2 * halo, ROW - 2 * halo - (16 // itemsize - 1)
    if ti_most < 1 or tj_most < 1:
        raise ValueError(f"K4 {kind} n={n}: a halo of {halo} leaves no tile")
    ti, tj = _even(I, ti_most), _even(J, tj_most)
    smem = planes * (ti + 2 * halo) * ROW * itemsize
    if smem > SMEM_CTA:
        raise ValueError(f"K4 {kind} n={n}: {smem} bytes of shared memory a "
                         f"CTA, more than {SMEM_CTA}")
    per_sm = max(1, min(THREADS_SM // THREADS, SMEM_SM // (smem + 1024)))
    tiles_i, tiles_j = -(-I // ti), -(-J // tj)
    slots = sms * per_sm if slots is None else slots
    # steps past a chunk's planes: the kernels walk [k_lo - n, k_hi + n)
    # (Jacobi) or [k_lo - 2, k_hi + 2) (red-black)
    kchunk = _k_chunks(K, tiles_i * tiles_j, slots,
                       2 * n if kind == "jacobi" else 4)
    return TilePlan(kind, tuple(shape), n, halo, ti, tj, tiles_i, tiles_j,
                    kchunk, -(-K // kchunk), smem, per_sm)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check(x, b, tab):
    if not x.is_cuda:
        raise ValueError("kernel launch needs a CUDA tensor")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"unpacked sweeps take float32 or float64, not {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"need a contiguous (K, I, J) field, got "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    if x.numel() >= 2**31:
        raise ValueError("field too large for 32-bit indexing")
    if b is not None and (
        b.shape != x.shape or b.dtype != x.dtype
        or b.device != x.device or not b.is_contiguous()
    ):
        raise ValueError("b must match x in shape, dtype, device and layout")
    check_tab(x, tab, tuple(x.shape))


_MAX_BLOCKS: dict = {}


def _max_blocks(kind, n, maf, smem, x) -> int:
    # the kernels' rows copy in 16-byte pieces where J allows (csrc kVec)
    aligned = x.shape[2] % (16 // x.element_size()) == 0
    key = (kind, n, maf, aligned, smem, x.dtype, x.get_device())
    if key not in _MAX_BLOCKS:
        cnt = ctypes.c_int(0)
        rc = getattr(_build.load(), f"cz_k4_max_blocks_{_SUFFIX[x.dtype]}")(
            KINDS.index(kind), n, int(maf), int(aligned), smem, x.get_device(), cnt)
        _build.check(rc, "K4 occupancy")
        if cnt.value < 1:
            raise RuntimeError(f"K4 {kind} n={n}: no CTA fits an SM")
        _MAX_BLOCKS[key] = cnt.value
    return _MAX_BLOCKS[key]


class TileSweep:
    """K4's launcher for one step: ``kind`` 'jacobi' (``n`` iterations a
    launch) or 'sor2sma' (one red-black iteration at colour ``offset``),
    ``tab`` (``maf_tables``) selecting MAF.  ``__call__(x, b, out)`` reads
    x and writes every point of ``out`` (never x); returns the float64 r2,
    (n,) for n > 1, else 0-d, in a buffer of the launcher's that holds
    until its next call.  The plan, the partials and the ctypes arguments
    (for each set of field pointers) are built once.  It counts its
    launches on ``jacobi_k4`` / ``sor2sma_k4``."""

    def __init__(self, kind: str, omega: float, n: int = 1, offset: int = 0,
                 tab=None):
        self.kind, self.omega, self.n, self.offset = kind, omega, n, offset
        self.tab = tab
        self.counter = jacobi_k4 if kind == "jacobi" else sor2sma_k4
        self.levels = n if kind == "jacobi" else 1
        self._key = None  # (shape, dtype, device) the buffers were made for
        self._args = {}

    def _setup(self, x):
        shape = tuple(x.shape)
        dev = x.get_device()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = tile_plan(self.kind, shape, self.n, x.element_size(), sms=sms)
        slots = _max_blocks(self.kind, self.n, self.tab is not None, plan.smem, x)
        # as many k chunks as the co-resident CTAs take in one round
        plan = tile_plan(self.kind, shape, self.n, x.element_size(), slots=slots)
        grid = min(plan.nwork, slots)
        self._partials = torch.empty(self.levels * grid, dtype=x.dtype,
                                     device=x.device)
        self._r2 = torch.empty(self.levels, dtype=torch.float64, device=x.device)
        self._ret = self._r2 if self.levels > 1 else self._r2[0]
        K, I, J = shape
        self._ints = int_array((KINDS.index(self.kind), self.n, K, I, J, plan.ti,
                                plan.tj, plan.tiles_i, plan.tiles_j, plan.kchunk,
                                plan.nwork, self.offset, grid, plan.smem, dev))
        self._fn = getattr(_build.load(), f"cz_k4_sweep_{_SUFFIX[x.dtype]}")
        self._key = (x.shape, x.dtype, x.device)
        self._args = {}

    def __call__(self, x, b, out):
        key = (x.data_ptr(), ptr(b), out.data_ptr())
        args = self._args.get(key)
        if args is None or (x.shape, x.dtype, x.device) != self._key:
            _check(x, b, self.tab)
            out_for(x, out)
            if (x.shape, x.dtype, x.device) != self._key:
                self._setup(x)
            if len(self._args) >= 8:
                self._args.clear()
            args = self._args[key] = pointer_array(
                (x.data_ptr(), ptr(b), ptr(self.tab), out.data_ptr(),
                 self._partials.data_ptr(), self._r2.data_ptr()))
        elif not x.is_contiguous():
            raise ValueError("need a contiguous (K, I, J) field")
        _build.check(self._fn(args, self._ints, self.omega,
                              current_stream(x.get_device())),
                     f"K4 {self.kind}")
        count(self.counter, self.tab)
        return self._ret


def _degenerate(x):
    """No inner point: nothing to launch."""
    return min(x.shape) < 3


def jacobi_k4(x, b, omega: float, tab=None, out=None, n: int = 1):
    """Launch ``jacobi_tile_kernel``: ``n`` (1 or ``JACOBI_N``) Jacobi
    iterations into ``out`` (a new field when None; never ``x``, which is
    only read); ``tab`` (``maf_tables``) selects the MAF form.  Returns
    (out, float64 r2 on the device: 0-d for n = 1, else the (n,) sums an
    iteration).  A CPU tensor runs the plain twin."""
    if not x.is_cuda:
        if n == 1:
            return jacobi_plain(x, b, omega, tab)
        return jacobi_n_plain(x, b, omega, tab, n)
    _check(x, b, tab)
    out = out_for(x, out)
    if _degenerate(x):
        out.copy_(x)
        return out, torch.zeros(() if n == 1 else n, dtype=torch.float64,
                                device=x.device)
    return out, TileSweep("jacobi", omega, n, tab=tab)(x, b, out)


jacobi_k4.launches = jacobi_k4.maf_launches = 0


def sor2sma_k4(x, b, omega: float, offset: int = 0, tab=None, out=None):
    """Launch ``rb_tile_kernel``: one red-black iteration, both colours in
    one pass, from ``x`` into ``out`` (a new field when None; never ``x``);
    ``tab`` selects the MAF form.  Returns (out, the float64 sum of dp^2
    over both colours, on the device).  A CPU tensor runs the plain twin on
    a copy."""
    if not x.is_cuda:
        out = x.clone() if out is None else out.copy_(x)
        return out, sor2sma_plain(out, b, omega, offset, tab)
    _check(x, b, tab)
    out = out_for(x, out)
    if _degenerate(x):
        out.copy_(x)
        return out, torch.zeros((), dtype=torch.float64, device=x.device)
    return out, TileSweep("sor2sma", omega, offset=offset, tab=tab)(x, b, out)


sor2sma_k4.launches = sor2sma_k4.maf_launches = 0


# --------------------------------------------------------------------------
# builder (the JAX package's name and step contract)
# --------------------------------------------------------------------------


def make_fused_sweep(kind: str, shape, dtype=torch.float32, *, omega: float,
                     offset: int = 0, b_is_zero: bool = False, mc=None,
                     plain: bool = False):
    """``step(x, b) -> (x, r2)`` on the unpacked state (``pad_k2``), r2
    float64: 'jacobi' runs ``JACOBI_N`` iterations a call (r2 their (n,)
    sums) and 'sor2sma' one red-black iteration (r2 0-d).  x is only
    read: on CUDA the returned field is one of two buffers the step owns,
    the one that is not x, so it holds until the call after next (and r2
    until the next call).  ``step.single`` is the one-iteration form on
    the same buffers.  ``mc`` (MafCoeffs) selects
    the MAF update; ``b_is_zero`` ignores ``b``; ``plain`` runs the twins
    on any device."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    if dtype not in _SUFFIX:
        raise TypeError(f"unpacked sweeps take float32 or float64, not {dtype}")
    n = JACOBI_N if kind == "jacobi" else 1
    tab = maf_tables(mc, shape, dtype)
    bufs = []  # the two fields, made at the first CUDA call

    def make(iters):
        if kind == "jacobi":
            def twin(x, b):
                if iters == 1:
                    return jacobi_plain(x, b, omega, tab)
                return jacobi_n_plain(x, b, omega, tab, iters)
        else:
            def twin(x, b):
                x = x.clone()
                return x, sor2sma_plain(x, b, omega, offset, tab)
        launch = TileSweep(kind, omega, iters, offset, tab)

        def step(x, b):
            b = None if b_is_zero else b
            if plain or not x.is_cuda:
                return twin(x, b)
            if _degenerate(x):
                return jacobi_k4(x, b, omega, tab, n=iters) if kind == "jacobi" \
                    else sor2sma_k4(x, b, omega, offset, tab)
            if not bufs:
                bufs.extend((torch.empty_like(x), torch.empty_like(x)))
            # ping-pong: write the buffer that is not x; a foreign x (the
            # start, or the driver's snapshot in its replay) is only read
            out = bufs[1] if x.data_ptr() == bufs[0].data_ptr() else bufs[0]
            return out, launch(x, b, out)

        step.iters_per_call = iters
        step.pad = pad_k2
        step.unpad = functools.partial(unpad_k2, shape=tuple(shape))
        return step

    step = make(n)
    step.single = step if n == 1 else make(1)
    return step
