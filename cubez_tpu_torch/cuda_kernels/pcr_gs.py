"""Lexicographic line Gauss-Seidel sweeps on the diagonal layout, kernel P2
(csrc/pcr_gs.cu).  It takes the place of the JAX package's
``cubez_tpu/ops/pcr_gs.py::make_pcr_gs_diag_step``, which XLA runs as a
loop over diagonals (no ``pallas_call``).

``pcr_gs_diag(S, B, omega, mc)`` runs sweeps of pcr (``mc`` None) or
pcr_maf on the (D, K, I) layout of ``ops/psor_scan.make_skew``, in place,
and returns (S, float64 sums of dp^2): for a CUDA tensor one cooperative
launch of n sweeps through a ``PcrGsSweep`` launcher (r2 of shape (n,), 0-d
for n = 1), which raises on what it cannot take; for a CPU tensor the plain
twin ``ops/pcr_gs.pcr_gs_diag_plain``, bitwise equal to the kernel in
float32 and float64, once a sweep.  The line solve is K10's
(cuda_kernels/pcr.py): ``plan`` picks 'lines' (a warp a line in registers,
``pcr.SLABS``; MAF lines to ``pcr.MAF_SLABS``) or, for longer lines,
'tile' (L lines of a CTA in shared memory).  A launch of n sweeps lags
sweep s + 1 two diagonals behind sweep s; ``inputs`` and ``flag_waits``
state its order, which the CPU tests replay on the plain line
relaxation.
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
# the launch's constants, by tools/prof_diag.py on an H100 80GB HBM3 at
# 700 W (PERF.md section 6), ms a sweep in the line form: 128^3 float32
# constant / MAF 0.0650 / 0.1436 at 16 sweeps a launch (the most the card
# holds), 0.1054 / 0.2304 at 8; a grid-wide barrier a step in place of the
# progress counters 0.0762 / 0.1505 at 16; 64^3 float64 0.0181 at 32,
# 0.0265 at 16
# sweeps of a launch, where the card holds their CTAs together
SWEEPS = 32


@dataclasses.dataclass(frozen=True)
class GsPlan:
    """A P2 launch on lines of ``n`` rows: 'lines' with ``slabs``
    registers a lane (row k = lane + 32 m), LINES lines an item; 'tile'
    with ``lines`` lines an item whole in shared memory.  ``sweeps`` lagged
    sweeps a launch, each sweep's CTAs waiting on its own and the last
    sweep's progress counters."""

    form: str
    n: int
    slabs: int = 0
    lines: int = LINES
    sweeps: int = 1

    @property
    def per_item(self) -> int:
        """Lines of a work item."""
        return LINES if self.form == "lines" else self.lines

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
         form: str | None = None, sweeps: int | None = None) -> GsPlan:
    """The form of a P2 launch on lines of ``n`` inner rows: K10's choice
    (``pcr.line_plan``'s limits: MAF lines past ``pcr.MAF_SLABS`` take the
    tile form, and no line-form kernel is built for them) unless ``form``
    forces one; the tile form takes up to LINES lines an item, as many as
    ``pcr.tile_lines`` fits.  ``sweeps`` (default SWEEPS) as asked:
    ``launch_grid`` fits them to the card."""
    if n < 1:
        raise ValueError(f"a line needs an inner row, not {n}")
    if form not in (None,) + FORMS:
        raise ValueError(f"form must be one of {FORMS}, not {form!r}")
    sweeps = SWEEPS if sweeps is None else sweeps
    item = torch.empty((), dtype=dtype).element_size()
    if form != "tile":
        for m in k10.SLABS:
            if n <= 32 * m:
                p = GsPlan("lines", n, slabs=m, sweeps=sweeps)
                regs = not maf or m <= k10.MAF_SLABS[item]
                if regs and p.smem(item, maf) <= k10.SMEM_CTA:
                    return p
                break
        if form == "lines":
            raise ValueError(f"lines of {n} rows do not fit the line form")
    return GsPlan("tile", n, lines=min(LINES, k10.tile_lines(n, dtype, maf)),
                  sweeps=sweeps)


def launch_grid(p: GsPlan, shape, max_blocks: int) -> tuple[int, int]:
    """(sweeps, CTAs a sweep) of a launch on a (K, I, J) field where the
    card holds ``max_blocks`` CTAs of the plan's form together: a CTA an
    item of the longest diagonal, to ``max_blocks``; the plan's sweeps,
    fewer where their CTAs would pass it (and past that, each CTA takes
    several items of a diagonal)."""
    _, I, J = shape
    items = -(-max(min(I - 2, J - 2), 1) // p.per_item)
    per = min(items, max_blocks)
    return max(1, min(p.sweeps, max_blocks // per)), per


def inputs(task, shape):
    """The tasks whose writes task (s, d) reads (csrc/pcr_gs.cu)."""
    s, d = task
    d_last = shape[1] + shape[2] - 4
    out = [(s, d - 1)] if d > 2 else []
    if s > 0:
        out.append((s - 1, min(d + 1, d_last)))
    return out


def flag_waits(shape, per_sweep: int, s: int, d: int):
    """The waits before task (s, d), as csrc/pcr_gs.cu's
    ``run_sweeps`` makes them: (sweep of a counter, the count it waits
    for), a sweep's counter counting its CTAs' diagonals done."""
    d_last = shape[1] + shape[2] - 4
    out = [(s, per_sweep * (d - 2))] if d > 2 else []
    if s > 0:
        out.append((s - 1, per_sweep * (min(d + 1, d_last) - 1)))
    return out


_MAX_BLOCKS: dict = {}


def max_blocks(p: GsPlan, maf: bool, dtype, device) -> int:
    """CTAs of the plan's form (at its shared memory) that the card holds
    together."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    smem = p.smem(torch.empty((), dtype=dtype).element_size(), maf)
    slabs = p.slabs if p.form == "lines" else 0
    key = (slabs, maf, smem, dtype, index)
    if key not in _MAX_BLOCKS:
        cnt = ctypes.c_int(0)
        rc = getattr(_build.load(), f"cz_pcr_gs_max_blocks_{_SUFFIX[dtype]}")(
            slabs, int(maf), smem, index, cnt)
        _build.check(rc, "P2 occupancy")
        if cnt.value < 1:
            raise RuntimeError(f"P2 {p.form} form: no CTA fits an SM")
        _MAX_BLOCKS[key] = cnt.value
    return _MAX_BLOCKS[key]


def sweeps_for(shape, dtype, maf: bool, device, divides: int | None = None) -> int:
    """Sweeps a launch on ``device``'s card: the plan's, or with
    ``divides`` the most that divide it and fit the card together (a
    preconditioner's fixed sweeps)."""
    p = plan(shape[0] - 2, dtype, maf, sweeps=divides)
    cap, _ = launch_grid(p, shape, max_blocks(p, maf, dtype, device))
    if divides is None:
        return cap
    return max(m for m in range(1, cap + 1) if divides % m == 0)


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
    """P2's launcher for one step: ``__call__(S, B)`` runs ``sweeps``
    sweeps of ``S`` in place in one cooperative launch and returns their
    float64 sums of dp^2 ((sweeps,), 0-d for one sweep), in a buffer of the
    launcher's that holds until its next call.  ``mc`` (MafCoeffs) selects
    the MAF forms; ``form`` forces a form of ``plan`` (tests,
    profiling).  The plan, the tables, the grid (``launch_grid``), the
    buffers and the ctypes arguments (for each pair of field pointers) are
    built once; ValueError where the card cannot hold the sweeps' CTAs
    together."""

    def __init__(self, omega: float, mc=None, form: str | None = None,
                 sweeps: int = 1):
        if sweeps < 1:
            raise ValueError(f"a launch runs at least one sweep, not {sweeps}")
        self.omega, self.mc, self.form, self.sweeps = omega, mc, form, sweeps
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

        K, I, J = shape = field_shape(S)
        maf = self.mc is not None
        self.plan = p = plan(K - 2, S.dtype, maf, self.form, self.sweeps)
        self._tab = self.tables(S)
        if not maf:
            width = 32 * p.slabs if p.form == "lines" else None
            self._tab = k10.stage_tables(K - 2, S.dtype, S.device, width)
        smem = p.smem(S.element_size(), maf)
        sweeps, self.per_sweep = launch_grid(p, shape, max_blocks(p, maf, S.dtype,
                                                                  S.device))
        if sweeps != self.sweeps:
            raise ValueError(f"{self.sweeps} sweeps of a {shape} field do not fit "
                             f"the card's CTAs together (at most {sweeps})")
        self.grid = sweeps * self.per_sweep
        dev = S.device
        self._partials = torch.empty(self.grid, dtype=torch.float64, device=dev)
        self._r2 = torch.zeros(sweeps, dtype=torch.float64, device=dev)
        self._prog = torch.zeros(sweeps, dtype=torch.int32, device=dev)
        self._ints = int_array((p.slabs if p.form == "lines" else 0, int(maf), K, I, J,
                                num_stage(K - 2), p.lines, self.grid, smem,
                                S.get_device(), sweeps, self.per_sweep))
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
                 self._partials.data_ptr(), self._r2.data_ptr(),
                 self._prog.data_ptr()))
        elif not (S.is_contiguous() and B.is_contiguous()):
            raise ValueError("need contiguous (D, K, I) fields")
        _build.check(self._fn(args, self._ints, self.omega,
                              current_stream(S.get_device())), "pcr_gs sweep")
        pcr_gs_diag.launches += 1
        pcr_gs_diag.maf_launches += self.mc is not None
        key = (self.plan.form, self.mc is not None)
        pcr_gs_diag.variant_launches[key] = pcr_gs_diag.variant_launches.get(key, 0) + 1
        return self._r2 if self.sweeps > 1 else self._r2[0]


def pcr_gs_diag(S, B, omega: float, mc=None, launcher=None):
    """Lexicographic line Gauss-Seidel sweeps of the diagonal-layout field
    ``S`` with right-hand side ``B``; ``mc`` selects the MAF form.  A CUDA
    tensor is updated in place by one launch of P2 through ``launcher`` (a
    ``PcrGsSweep`` of the same omega and coefficients; its sweeps) or a
    new one-sweep launcher; a CPU tensor runs one sweep of the plain twin,
    which returns a new field (ValueError for a launcher of more sweeps).
    Returns (S, r2), r2 the float64 sums of dp^2 on S's device (0-d for
    one sweep)."""
    launch = PcrGsSweep(omega, mc) if launcher is None else launcher
    if not S.is_cuda:
        if launch.sweeps > 1:
            raise ValueError(f"a launcher of {launch.sweeps} sweeps needs a "
                             "CUDA tensor; the plain twin runs one a call")
        return pcr_gs_diag_plain(S, B, omega, launch.tables(S))
    return S, launch(S, B)


pcr_gs_diag.launches = pcr_gs_diag.maf_launches = 0
# launches by (form, MAF)
pcr_gs_diag.variant_launches = {}
