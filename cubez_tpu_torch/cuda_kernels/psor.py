"""Lexicographic point-SOR sweep on the diagonal layout, kernel P1
(csrc/psor.cu).  It takes the place of the JAX package's
``cubez_tpu/ops/psor_scan.py::make_psor_diag_step``, which XLA runs as a
loop over diagonals (no ``pallas_call``).

``psor_diag(S, B, omega, mc)`` runs one sweep of psor (``mc`` None) or
psor_maf on the (D, K, I) layout of ``ops/psor_scan.make_skew``, in place,
and returns (S, float64 sum of dp^2): for a CUDA tensor one cooperative
launch of the kernel through a ``PsorSweep`` launcher, which raises on what
it cannot take; for a CPU tensor the plain twin
``ops/psor_scan.psor_diag_plain``, bitwise equal to the kernel in float32
and float64 (both apply the reference's point update in its serial order;
csrc/psor.cu states the arithmetic).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.psor_scan import field_shape, psor_diag_plain
from . import _build
from .rbpack import _SUFFIX, maf_tables, ptr

# csrc/psor.cu: threads of a CTA, each a (chunk, line) task a phase
THREADS = 1024
# rows of a chunk: fewer rows make more phases and more CTAs, with a
# grid-wide sync a phase between them; 2 was the fastest at 128^3 and
# 256^3 float32 and within 6% at 64^3 float64 (tools/prof_diag.py, PERF.md
# section 6, PR 13)
ROWS = 2


@dataclasses.dataclass(frozen=True)
class PsorPlan:
    """P1's chunked wavefront on a (K, I, J) field: each line's K - 2
    inner rows in ``chunks`` chunks of ``rows``; a phase runs chunk c of
    diagonal t - c for every c, ``lanes`` threads a chunk (the longest
    diagonal's lines rounded up to a warp), on ``grid`` CTAs of THREADS; a
    sweep is I + J - 5 + chunks - 1 phases."""

    lanes: int
    chunks: int
    rows: int
    grid: int


def plan(shape, max_ctas: int | None = None) -> PsorPlan:
    """The chunking of a (K, I, J) field: chunks of ROWS rows (the last
    may be shorter), or longer where the CTAs would pass ``max_ctas`` (the
    card's co-resident CTAs: one of THREADS an SM)."""
    K, I, J = shape
    n = K - 2
    lanes = 32 * -(-max(min(I - 2, J - 2), 1) // 32)
    rows = min(ROWS, n)
    if max_ctas is not None:
        rows = max(rows, -(-n // max(max_ctas * THREADS // lanes, 1)))
    chunks = -(-n // rows)
    return PsorPlan(lanes, chunks, rows, -(-chunks * lanes // THREADS))


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
    """P1's launcher for one step: ``__call__(S, B)`` runs one sweep of
    ``S`` in place in one cooperative launch and returns the 0-d float64
    sum of dp^2, in a buffer of the launcher's that holds until its next
    call.  ``mc`` (MafCoeffs) selects psor_maf.  The MAF tables, the
    ``plan`` (chunks and CTAs), the buffers and the ctypes arguments (for
    each pair of field pointers) are built once."""

    def __init__(self, omega: float, mc=None):
        self.omega, self.mc = omega, mc
        self._key = None  # (shape, dtype, device) of the buffers
        self._args = {}

    def _setup(self, S):
        from .dist_halo import int_array

        K, I, J = field_shape(S)
        self.tab = maf_tables(self.mc, (K, I, J), S.dtype)
        if self.tab is not None:
            self.tab = self.tab.to(S.device)
        sms = torch.cuda.get_device_properties(S.device).multi_processor_count
        self.plan = p = plan((K, I, J), max_ctas=sms)
        self.grid = p.grid
        self._partials = torch.empty(self.grid, dtype=torch.float64, device=S.device)
        self._r2 = torch.zeros((), dtype=torch.float64, device=S.device)
        self._ints = int_array((K, I, J, int(self.tab is not None), self.grid,
                                S.get_device(), p.lanes, p.chunks, p.rows))
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
                 self._partials.data_ptr(), self._r2.data_ptr()))
        elif not (S.is_contiguous() and B.is_contiguous()):
            raise ValueError("need contiguous (D, K, I) fields")
        _build.check(self._fn(args, self._ints, self.omega,
                              current_stream(S.get_device())), "psor sweep")
        psor_diag.launches += 1
        psor_diag.maf_launches += self.tab is not None
        return self._r2


def psor_diag(S, B, omega: float, mc=None, launcher=None):
    """One lexicographic point-SOR sweep of the diagonal-layout field ``S``
    with right-hand side ``B``; ``mc`` selects psor_maf.  A CUDA tensor is
    updated in place by one launch of P1 (through ``launcher``, a
    ``PsorSweep`` of the same omega and coefficients, or a new one); a CPU
    tensor runs the plain twin, which returns a new field.  Returns (S, r2),
    r2 the float64 sum of dp^2 on S's device."""
    if not S.is_cuda:
        return psor_diag_plain(S, B, omega, mc)
    launch = PsorSweep(omega, mc) if launcher is None else launcher
    return S, launch(S, B)


psor_diag.launches = psor_diag.maf_launches = 0
