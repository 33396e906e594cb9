"""Lexicographic point-SOR sweeps on the diagonal layout, kernel P1
(csrc/psor.cu).  It takes the place of the JAX package's
``cubez_tpu/ops/psor_scan.py::make_psor_diag_step``, which XLA runs as a
loop over diagonals (no ``pallas_call``).

``psor_diag(S, B, omega, mc)`` runs sweeps of psor (``mc`` None) or
psor_maf on the (D, K, I) layout of ``ops/psor_scan.make_skew``, in place,
and returns (S, float64 sums of dp^2): for a CUDA tensor one cooperative
launch of the kernel through a ``PsorSweep`` launcher of n sweeps (r2 of
shape (n,), or 0-d for n = 1), which raises on what it cannot take; for a
CPU tensor the plain twin ``ops/psor_scan.psor_diag_plain``, one sweep,
bitwise equal to the kernel in float32 and float64 (both apply the
reference's point update in its serial order; csrc/psor.cu states the
arithmetic).  A launch of n sweeps lags sweep s + 1 two wavefront steps
behind sweep s; ``inputs`` and ``flag_waits`` state its order, which
the CPU tests replay on the plain point update.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.psor_scan import field_shape, psor_diag_plain
from . import _build
from .rbpack import _SUFFIX, maf_tables, ptr

# csrc/psor.cu: the most threads of a CTA, each a line of a chunk; the card
# holds 1024 threads an SM (__launch_bounds__(1024, 1))
THREADS = 1024
# the plan's constants, by tools/prof_diag.py on an H100 80GB HBM3 at 700 W
# (PERF.md section 6), ms a sweep: 128^3 float32 constant
# / MAF 0.0290 / 0.0478 at 4 rows a chunk and 32 sweeps a launch, 0.0474 /
# 0.0634 at 2 rows and 16 (the most that fit at 2 rows); 256^3 float32
# 0.197 at 4 rows and 8, 0.363 at 2 rows and 4; 64^3 float64 0.0188 at 4
# rows and 32, 0.0163 at 2 rows and 32.  At every height and count the
# progress counters beat a grid-wide barrier a step (128^3, 2 rows, 16
# sweeps: 0.0473 against 0.0597).
# rows of a chunk: fewer rows make more steps and more CTAs
ROWS = 4
# sweeps of a launch, where the card holds their CTAs together
SWEEPS = 32


@dataclasses.dataclass(frozen=True)
class PsorPlan:
    """P1's launch of ``sweeps`` lagged sweeps on a (K, I, J) field: each
    line's K - 2 inner rows in ``chunks`` chunks of ``rows``, ``lanes``
    threads a chunk (the longest diagonal's lines rounded up to a warp), on
    ``grid`` CTAs of ``threads``, ``grid // sweeps`` a sweep: a CTA
    (``units`` of them where ``lanes`` passes THREADS) a chunk of a sweep,
    waiting on its inputs' progress counters."""

    lanes: int
    chunks: int
    rows: int
    grid: int
    sweeps: int
    threads: int

    @property
    def per_sweep(self) -> int:
        return self.grid // self.sweeps

    @property
    def units(self) -> int:
        """CTAs of a chunk."""
        return self.lanes // self.threads

    def steps(self, shape) -> int:
        """The tasks of the launch's longest chain of waits: I + J - 5
        + chunks - 1 + 2 (sweeps - 1)."""
        _, I, J = shape
        return I + J - 5 + self.chunks - 1 + 2 * (self.sweeps - 1)


def plan(shape, max_ctas: int | None = None,
         sweeps: int | None = None) -> PsorPlan:
    """The launch of ``sweeps`` (default SWEEPS) sweeps of a (K, I, J)
    field, chunks of ROWS rows (the last may be shorter).  ``max_ctas`` is
    the card's SMs, each holding THREADS threads of the kernel (THREADS //
    threads CTAs): every sweep's CTAs must fit together, so past that the
    sweeps shrink, and past one sweep the chunks grow longer."""
    K, I, J = shape
    n = K - 2
    lanes0 = 32 * -(-max(min(I - 2, J - 2), 1) // 32)
    threads = min(lanes0, THREADS)
    lanes = -(-lanes0 // threads) * threads
    rows = min(ROWS, n)
    sweeps = SWEEPS if sweeps is None else sweeps
    while True:
        chunks = -(-n // rows)
        per = chunks * (lanes // threads)
        if max_ctas is None:
            break
        cap = max_ctas * (THREADS // threads)  # co-resident CTAs
        if per <= cap or rows == n:
            sweeps = max(1, min(sweeps, cap // per))
            break
        sweeps, rows = 1, rows + 1
    return PsorPlan(lanes, chunks, rows, per * sweeps, sweeps, threads)


def sweeps_for(shape, device, divides: int | None = None) -> int:
    """Sweeps a launch on ``device``'s card: the plan's, or with
    ``divides`` the most that divide it and fit the card together (a
    preconditioner's fixed sweeps)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if divides is None:
        return plan(shape, max_ctas=sms).sweeps
    cap = plan(shape, max_ctas=sms, sweeps=divides).sweeps
    return max(m for m in range(1, cap + 1) if divides % m == 0)


def inputs(task, p: PsorPlan, shape):
    """The tasks whose writes task (s, d, c) reads (csrc/psor.cu)."""
    s, d, c = task
    d_last = shape[1] + shape[2] - 4
    out = []
    if d > 2:
        out.append((s, d - 1, c))
    if c > 0:
        out.append((s, d, c - 1))
    if s > 0:
        out.append((s - 1, min(d + 1, d_last), c))
        if c + 1 < p.chunks:
            out.append((s - 1, d, c + 1))
    return out


def flag_waits(p: PsorPlan, shape, s: int, d: int, c: int):
    """The waits before task (s, d, c), as csrc/psor.cu's
    ``wait_inputs`` makes them: ((sweep, chunk) of a counter, the count it
    waits for), a chunk's counter counting its CTAs' diagonals done."""
    U = p.units
    d_last = shape[1] + shape[2] - 4
    out = []
    if U > 1 and d > 2:
        out.append(((s, c), U * (d - 2)))
    if c > 0:
        out.append(((s, c - 1), U * (d - 1)))
    if s > 0:
        out.append(((s - 1, c), U * (min(d + 1, d_last) - 1)))
        if c + 1 < p.chunks:
            out.append(((s - 1, c + 1), U * (d - 1)))
    return out


def _check(S, B):
    if not S.is_cuda:
        raise ValueError("kernel launch needs a CUDA tensor")
    if S.dtype not in _SUFFIX:
        raise TypeError(f"P1 takes float32 or float64, not {S.dtype}")
    if S.dim() != 3 or not S.is_contiguous():
        raise ValueError(f"need a contiguous (D, K, I) field, got {tuple(S.shape)} "
                         f"contiguous={S.is_contiguous()}")
    K, I, J = field_shape(S)
    if K < 3 or I < 3 or J < 3:
        raise ValueError(f"no inner point in a field of shape {(K, I, J)}")
    if (B is None or B.shape != S.shape or B.dtype != S.dtype
            or B.device != S.device or not B.is_contiguous()):
        raise ValueError("B must match S in shape, dtype, device and layout")


class PsorSweep:
    """P1's launcher for one step: ``__call__(S, B)`` runs ``sweeps``
    sweeps of ``S`` in place in one cooperative launch and returns their
    float64 sums of dp^2 ((sweeps,), 0-d for one sweep), in a buffer of the
    launcher's that holds until its next call.  ``mc`` (MafCoeffs) selects
    psor_maf.  The MAF tables, the ``plan`` (chunks and CTAs), the buffers and the ctypes
    arguments (for each pair of field pointers) are built once; ValueError
    where the card cannot hold the sweeps' CTAs together."""

    def __init__(self, omega: float, mc=None, sweeps: int = 1):
        if sweeps < 1:
            raise ValueError(f"a launch runs at least one sweep, not {sweeps}")
        self.omega, self.mc, self.sweeps = omega, mc, sweeps
        self._key = None  # (shape, dtype, device) of the buffers
        self._args = {}

    def _setup(self, S):
        from .dist_halo import int_array

        K, I, J = field_shape(S)
        self.tab = maf_tables(self.mc, (K, I, J), S.dtype)
        if self.tab is not None:
            self.tab = self.tab.to(S.device)
        sms = torch.cuda.get_device_properties(S.device).multi_processor_count
        self.plan = p = plan((K, I, J), max_ctas=sms, sweeps=self.sweeps)
        if p.sweeps != self.sweeps:
            raise ValueError(f"{self.sweeps} sweeps of a {(K, I, J)} field do "
                             f"not fit the card's CTAs together (at most "
                             f"{p.sweeps})")
        self.grid = p.grid
        dev = S.device
        self._partials = torch.empty(self.grid, dtype=torch.float64, device=dev)
        self._r2 = torch.zeros(self.sweeps, dtype=torch.float64, device=dev)
        self._prog = torch.zeros(p.sweeps * p.chunks, dtype=torch.int32, device=dev)
        self._ints = int_array((K, I, J, int(self.tab is not None), self.grid,
                                S.get_device(), p.lanes, p.chunks, p.rows,
                                p.sweeps, p.per_sweep, p.units, p.threads))
        self._fn = getattr(_build.load(), f"cz_psor_sweep_{_SUFFIX[S.dtype]}")
        self._key = (S.shape, S.dtype, S.device)
        self._args = {}

    def __call__(self, S, B):
        from .dist_halo import current_stream, pointer_array

        key = (S.data_ptr(), ptr(B))
        args = self._args.get(key)
        if args is None or (S.shape, S.dtype, S.device) != self._key:
            _check(S, B)
            if (S.shape, S.dtype, S.device) != self._key:
                self._setup(S)
            if len(self._args) >= 8:
                self._args.clear()
            args = self._args[key] = pointer_array(
                (S.data_ptr(), B.data_ptr(), ptr(self.tab),
                 self._partials.data_ptr(), self._r2.data_ptr(),
                 self._prog.data_ptr()))
        elif not (S.is_contiguous() and B.is_contiguous()):
            raise ValueError("need contiguous (D, K, I) fields")
        _build.check(self._fn(args, self._ints, self.omega,
                              current_stream(S.get_device())), "psor sweep")
        psor_diag.launches += 1
        psor_diag.maf_launches += self.tab is not None
        return self._r2 if self.sweeps > 1 else self._r2[0]


def psor_diag(S, B, omega: float, mc=None, launcher=None):
    """Lexicographic point-SOR sweeps of the diagonal-layout field ``S``
    with right-hand side ``B``; ``mc`` selects psor_maf.  A CUDA tensor is
    updated in place by one launch of P1 through ``launcher`` (a
    ``PsorSweep`` of the same omega and coefficients; its sweeps) or a new
    one-sweep launcher; a CPU tensor runs one sweep of the plain twin,
    which returns a new field (ValueError for a launcher of more sweeps).
    Returns (S, r2), r2 the float64 sums of dp^2 on S's device (0-d for
    one sweep)."""
    launch = PsorSweep(omega, mc) if launcher is None else launcher
    if not S.is_cuda:
        if launch.sweeps > 1:
            raise ValueError(f"a launcher of {launch.sweeps} sweeps needs a "
                             "CUDA tensor; the plain twin runs one a call")
        return psor_diag_plain(S, B, omega, mc)
    return S, launch(S, B)


psor_diag.launches = psor_diag.maf_launches = 0
