"""Lexicographic line Gauss-Seidel sweep on the diagonal layout, kernel P2
(csrc/pcr_gs.cu).  It takes the place of the JAX package's
``cubez_tpu/ops/pcr_gs.py::make_pcr_gs_diag_step``, which XLA runs as a
loop over diagonals (no ``pallas_call``).

``pcr_gs_diag(S, B, omega, mc)`` runs one sweep of pcr (``mc`` None) or
pcr_maf on the (D, K, I) layout of ``ops/psor_scan.make_skew``, in place,
and returns (S, float64 sum of dp^2): for a CUDA tensor one cooperative
launch through a ``PcrGsSweep`` launcher, which raises on what it cannot
take; for a CPU tensor the plain twin ``ops/pcr_gs.pcr_gs_diag_plain``,
bitwise equal to the kernel in float32 and float64.  The line solve is
K10's (cuda_kernels/pcr.py): ``plan`` picks 'lines' (a warp a line in
registers, ``pcr.SLABS``; MAF lines to ``pcr.MAF_SLABS``) or, for longer
lines, 'tile' (L lines of a CTA in shared memory).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..ops.pcr import num_stage
from ..ops.pcr_gs import pcr_gs_diag_plain
from ..ops.psor_scan import field_shape
from . import _build
from . import pcr as k10
from .rbpack import _SUFFIX, maf_tables, ptr

# csrc/pcr_gs.cu: threads of a CTA; lines of a line-form work item (a warp
# each)
THREADS = 256
LINES = 8
FORMS = ("lines", "tile")


@dataclasses.dataclass(frozen=True)
class GsPlan:
    """A P2 launch on lines of ``n`` rows: 'lines' with ``slabs``
    registers a lane (row k = lane + 32 m), LINES lines an item; 'tile'
    with ``lines`` lines an item whole in shared memory."""

    form: str
    n: int
    slabs: int = 0
    lines: int = LINES

    def smem(self, itemsize: int, maf: bool) -> int:
        """Dynamic shared memory of a CTA: under the line form the constant
        coefficients' padded stage tables and the item's right-hand sides
        (a line LS = 32 M + 1 values apart); under the tile form two
        buffers of d (MAF: of a, c and d) for the item's lines."""
        if self.form == "tile":
            return (6 if maf else 2) * self.n * self.lines * itemsize
        tables = 0 if maf else (3 * (num_stage(self.n) - 1) + 3) * 32 * self.slabs
        return (tables + LINES * (32 * self.slabs + 1)) * itemsize


def plan(n: int, dtype=torch.float32, maf: bool = False,
         form: str | None = None) -> GsPlan:
    """The form of a P2 launch on lines of ``n`` inner rows: K10's choice
    (``pcr.line_plan``'s limits: MAF lines past ``pcr.MAF_SLABS`` take the
    tile form, and no line-form kernel is built for them) unless ``form``
    forces one; the tile form takes up to LINES lines an item, as many as
    ``pcr.tile_lines`` fits."""
    if n < 1:
        raise ValueError(f"a line needs an inner row, not {n}")
    if form not in (None,) + FORMS:
        raise ValueError(f"form must be one of {FORMS}, not {form!r}")
    item = torch.empty((), dtype=dtype).element_size()
    if form != "tile":
        for m in k10.SLABS:
            if n <= 32 * m:
                p = GsPlan("lines", n, slabs=m)
                regs = not maf or m <= k10.MAF_SLABS[item]
                if regs and p.smem(item, maf) <= k10.SMEM_CTA:
                    return p
                break
        if form == "lines":
            raise ValueError(f"lines of {n} rows do not fit the line form")
    return GsPlan("tile", n, lines=min(LINES, k10.tile_lines(n, dtype, maf)))


_MAX_BLOCKS: dict = {}


def _max_blocks(p: GsPlan, maf: bool, smem: int, S) -> int:
    slabs = p.slabs if p.form == "lines" else 0
    key = (slabs, maf, smem, S.dtype, S.get_device())
    if key not in _MAX_BLOCKS:
        cnt = ctypes.c_int(0)
        rc = getattr(_build.load(), f"cz_pcr_gs_max_blocks_{_SUFFIX[S.dtype]}")(
            slabs, int(maf), smem, S.get_device(), cnt)
        _build.check(rc, "P2 occupancy")
        if cnt.value < 1:
            raise RuntimeError(f"P2 {p.form} form: no CTA fits an SM")
        _MAX_BLOCKS[key] = cnt.value
    return _MAX_BLOCKS[key]


def _check(S, B):
    if not S.is_cuda:
        raise ValueError("kernel launch needs a CUDA tensor")
    if S.dtype not in _SUFFIX:
        raise TypeError(f"P2 takes float32 or float64, not {S.dtype}")
    if S.dim() != 3 or not S.is_contiguous():
        raise ValueError(f"need a contiguous (D, K, I) field, got {tuple(S.shape)} "
                         f"contiguous={S.is_contiguous()}")
    K, I, J = field_shape(S)
    if K < 3 or I < 3 or J < 3:
        raise ValueError(f"no inner line in a field of shape {(K, I, J)}")
    if (B is None or B.shape != S.shape or B.dtype != S.dtype
            or B.device != S.device or not B.is_contiguous()):
        raise ValueError("B must match S in shape, dtype, device and layout")


class PcrGsSweep:
    """P2's launcher for one step: ``__call__(S, B)`` runs one sweep of
    ``S`` in place in one cooperative launch and returns the 0-d float64
    sum of dp^2, in a buffer of the launcher's that holds until its next
    call.  ``mc`` (MafCoeffs) selects the MAF forms; ``form`` forces a
    form of ``plan`` (tests).  The plan, the tables, the grid (the
    co-resident CTAs, at most the items of the longest diagonal), the
    buffers and the ctypes arguments (for each pair of field pointers) are
    built once."""

    def __init__(self, omega: float, mc=None, form: str | None = None):
        self.omega, self.mc, self.form = omega, mc, form
        self._key = None  # (shape, dtype, device) of the buffers
        self._args = {}
        self._tables = {}

    def tables(self, S):
        """The MAF tables of S's field (None for constant coefficients),
        on S's device and in its dtype."""
        key = (S.shape, S.dtype, S.device)
        if key not in self._tables:
            tab = maf_tables(self.mc, field_shape(S), S.dtype)
            self._tables[key] = None if tab is None else tab.to(S.device)
        return self._tables[key]

    def _setup(self, S):
        from .dist_halo import int_array

        K, I, J = field_shape(S)
        maf = self.mc is not None
        self.plan = p = plan(K - 2, S.dtype, maf, self.form)
        self._tab = self.tables(S)
        if not maf:
            width = 32 * p.slabs if p.form == "lines" else None
            self._tab = k10.stage_tables(K - 2, S.dtype, S.device, width)
        smem = p.smem(S.element_size(), maf)
        per_item = LINES if p.form == "lines" else p.lines
        items = -(-max(min(I - 2, J - 2), 1) // per_item)
        self.grid = min(_max_blocks(p, maf, smem, S), items)
        self._partials = torch.empty(self.grid, dtype=torch.float64, device=S.device)
        self._r2 = torch.zeros((), dtype=torch.float64, device=S.device)
        self._ints = int_array((p.slabs if p.form == "lines" else 0, int(maf), K, I, J,
                                num_stage(K - 2), p.lines, self.grid, smem,
                                S.get_device()))
        self._fn = getattr(_build.load(), f"cz_pcr_gs_sweep_{_SUFFIX[S.dtype]}")
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
                (S.data_ptr(), B.data_ptr(), self._tab.data_ptr(),
                 self._partials.data_ptr(), self._r2.data_ptr()))
        elif not (S.is_contiguous() and B.is_contiguous()):
            raise ValueError("need contiguous (D, K, I) fields")
        _build.check(self._fn(args, self._ints, self.omega,
                              current_stream(S.get_device())), "pcr_gs sweep")
        pcr_gs_diag.launches += 1
        pcr_gs_diag.maf_launches += self.mc is not None
        key = (self.plan.form, self.mc is not None)
        pcr_gs_diag.variant_launches[key] = pcr_gs_diag.variant_launches.get(key, 0) + 1
        return self._r2


def pcr_gs_diag(S, B, omega: float, mc=None, launcher=None):
    """One lexicographic line Gauss-Seidel sweep of the diagonal-layout
    field ``S`` with right-hand side ``B``; ``mc`` selects the MAF form.
    A CUDA tensor is updated in place by one launch of P2 (through
    ``launcher``, a ``PcrGsSweep`` of the same omega and coefficients, or a
    new one); a CPU tensor runs the plain twin, which returns a new field.
    Returns (S, r2), r2 the float64 sum of dp^2 on S's device."""
    launch = PcrGsSweep(omega, mc) if launcher is None else launcher
    if not S.is_cuda:
        return pcr_gs_diag_plain(S, B, omega, launch.tables(S))
    return S, launch(S, B)


pcr_gs_diag.launches = pcr_gs_diag.maf_launches = 0
# launches by (form, MAF)
pcr_gs_diag.variant_launches = {}
