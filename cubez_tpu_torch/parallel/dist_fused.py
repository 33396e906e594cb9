"""Distributed steps on ghosted blocks with K8 (point sweeps) and K9 (line
relaxation) (PyTorch port of ``cubez_tpu/parallel/dist_fused.py``).

State: one (lk+2, li+2, lj+2) block per mesh block (cuda_kernels/
dist_sweeps.py's layout).  An iteration is the reference's multi-rank
skeleton, kernel, Comm_S(X, 1), Comm_SUM_1 (cz_Poisson.cpp:39-79):

    refresh the face ghosts (halo.FaceExchange: one launch a card)
    -> one K8 or K9 launch over all the blocks of a card
    -> the residual: the launches' per-CTA partials folded in float64 on
       the card, one launch a step (dist_halo.Residual).

So a 'color' or pcr_rb iteration on one card is five launches (exchange
and sweep for each colour, then the fold), jacobi and pcr_j_esa three,
'overlap' nine.  CPU blocks, and every block with ``plain``, run the twins
of the same launches block by block, and their residuals are folded by
``halo.psum_all``.

Red-black cadence (``sync``): 'color' refreshes before each colour and is
serial-equivalent; 'iter' refreshes once and runs both colours in one
cooperative pass, the reference's semantics, unstable at omega 1.5 on
small blocks.  ``make_dist_fused_overlap_step`` gathers the ghosts while
the interior runs.  The line kinds ('pcr', 'pcr_rb') refresh before each
colour and run K9 on the same blocks, its 'fastdiag' form on K-unsplit
meshes and its 'pcr' form otherwise; MAF point sweeps have no step here,
as in the JAX package (parallel/dist.py runs them).  The mesh's
``block_shape`` takes the place of the JAX module's ``_block_shape``.
"""

from __future__ import annotations

import torch

from ..core.problem import Problem
from ..cuda_kernels import dist_pcr, dist_sweeps
from ..cuda_kernels.dist_halo import Residual
from .halo import FaceExchange
from .mesh import CubeMesh


def to_block_state(cmesh: CubeMesh, arr):
    """Global (K, I, J) field -> ghosted blocks with zero ghosts."""
    return [dist_sweeps.pad_block(xb) for xb in cmesh.shard(arr)]


def from_block_state(cmesh: CubeMesh, state, gshape, device=None):
    """Ghosted blocks -> the global field (owned cells) on ``device``
    (default: block 0's)."""
    cmesh.block_shape(gshape)  # the state must be this grid's
    return cmesh.gather([dist_sweeps.unpad_block(x) for x in state], device)


class _Mesh:
    """The mesh's blocks grouped by device, for one step: a launcher per
    device for each pass (a single one when the blocks share a card), and
    the step's ``Residual``."""

    def __init__(self, cmesh: CubeMesh, plain: bool):
        groups = {}
        for b, d in enumerate(cmesh.devices):
            groups.setdefault(d, []).append(b)
        self.groups = list(groups.values())
        self.n = cmesh.size
        self.plain = plain
        self.res = Residual(cmesh.devices[0])

    def launchers(self, make):
        """[(block indices, make(block indices))] for each device."""
        return [(idx, make(idx)) for idx in self.groups]

    def run(self, launchers, xs, bs=None, outs=None):
        """Run one pass: each device's launcher on its blocks; returns the
        blocks they return, in mesh order."""
        if len(launchers) == 1:
            return launchers[0][1](xs, bs, outs, self.res, self.plain)
        out = [None] * self.n
        for idx, fn in launchers:
            sel = [None if v is None else [v[i] for i in idx] for v in (xs, bs, outs)]
            for i, t in zip(idx, fn(*sel, self.res, self.plain)):
                out[i] = t
        return out


def _pick(values, idx):
    return None if values is None else [values[i] for i in idx]


def make_dist_fused_step(problem: Problem, cmesh: CubeMesh, kind: str,
                         omega: float, *, b_is_zero: bool = False,
                         sync: str = "color", plain: bool = False):
    """``step(xstate, bstate) -> (xstate_new, r2)`` on ghosted block states
    (``to_block_state``), r2 a 0-d float64 tensor on block 0's device.
    ``kind``: 'jacobi' (out of place: the step writes blocks it owns, two
    per mesh block in turn, and never the state it is handed, apart from
    its ghost faces), 'sor2sma' (in place; ``sync`` 'color' or 'iter'),
    'pcr' (the line-Jacobi pass on K9, out of place as jacobi) or 'pcr_rb'
    (K9 per colour, in place; ``sync`` does not apply).  ``problem.mc``
    selects MAF for the line kinds.  ``plain`` runs the twins on any
    device.  None for the MAF point sweeps, as in the JAX package (its
    explicit jnp step covers them)."""
    if kind in LINE_KINDS:
        return _make_line_step(problem, cmesh, kind, omega, b_is_zero, plain)
    if problem.mc is not None:
        return None
    if kind not in dist_sweeps.KINDS:
        raise ValueError(f"kind must be one of {dist_sweeps.KINDS}, not {kind!r}")
    if sync not in ("color", "iter"):
        raise ValueError(f"sync must be 'color' or 'iter', not {sync!r}")
    gshape = problem.grid.shape_kij
    cmesh.block_shape(gshape)
    origins = cmesh.offsets(gshape)
    exchange = FaceExchange(cmesh, plain)
    mesh = _Mesh(cmesh, plain)
    colours = (None,) if kind == "jacobi" or sync == "iter" else (0, 1)
    passes = [mesh.launchers(lambda idx, c=c: dist_sweeps.BlockSweeps(
        kind, c, omega, _pick(origins, idx), gshape)) for c in colours]

    if kind == "jacobi":

        def sweep(xs, bl, outs):
            return mesh.run(passes[0], xs, None if b_is_zero else bl, outs)

        step = _out_of_place(exchange, mesh, plain, sweep)
    else:

        def step(xs, bstate):
            bl = None if b_is_zero else bstate
            mesh.res.start()
            for launchers in passes:
                exchange(xs)
                mesh.run(launchers, xs, bl)
            return xs, mesh.res.total()

    return _attach(step, exchange, len(colours))


def _attach(step, exchange, exchanges: int):
    """Set a step's driver attributes (one iteration a call, its own
    ``single``) and its ghost refresh alone (``exchange``, called
    ``exchanges_per_call`` times a call), which perf/profile.py times."""
    step.iters_per_call = 1
    step.single = step
    step.exchange = exchange
    step.exchanges_per_call = exchanges
    return step


def _out_of_place(exchange, mesh: _Mesh, plain: bool, sweep):
    """A step around ``sweep(xs, bl, outs) -> blocks`` that writes blocks
    it owns, two per mesh block in turn, and never the state it is handed,
    apart from its ghost faces."""
    bufs = []  # two blocks per mesh block, made at the first call

    def step(xs, bstate):
        exchange(xs)
        outs = None  # the twins return new blocks
        if xs[0].is_cuda and not plain:
            if not bufs:
                bufs.extend([torch.empty_like(x) for x in xs] for _ in range(2))
            # write the set that is not xs; a foreign state (the start, or
            # the driver's snapshot in its replay) is only read
            outs = bufs[1] if xs[0].data_ptr() == bufs[0][0].data_ptr() else bufs[0]
        mesh.res.start()
        out = sweep(xs, bstate, outs)
        return out, mesh.res.total()

    return step


LINE_KINDS = ("pcr", "pcr_rb")


def line_form(cmesh: CubeMesh, block_shape) -> str:
    """K9's form for the mesh: 'fastdiag' where K is unsplit and a line has
    two inner rows, else 'pcr' (dist_fused.py:399-409 of the JAX
    package)."""
    return "fastdiag" if cmesh.div[0] == 1 and block_shape[0] - 2 >= 2 else "pcr"


def _make_line_step(problem: Problem, cmesh: CubeMesh, kind: str, omega: float,
                    b_is_zero: bool, plain: bool):
    """The line kinds on K9.  Only face ghosts are refreshed; K9 reads no
    edge ghost into an update: ghost rows are identity rows and ghost
    columns are never lines.  The MAF tables are made here, once."""
    g = problem.grid
    gshape = g.shape_kij
    bs = cmesh.block_shape(gshape)
    if min(bs) < 1:
        raise ValueError(f"need non-empty blocks, got {bs}")
    origins = cmesh.offsets(gshape)
    form = line_form(cmesh, bs)
    mc = problem.mc
    tabs = None
    if mc is not None:
        tabs = [dist_pcr.block_maf_tables(mc, o, bs, gshape, g.dtype, form).to(d)
                for o, d in zip(origins, cmesh.devices)]
    exchange = FaceExchange(cmesh, plain)
    mesh = _Mesh(cmesh, plain)
    colours = (0, 1) if kind == "pcr_rb" else (None,)
    passes = [mesh.launchers(lambda idx, c=c: dist_pcr.BlockPcr(
        form, c, omega, _pick(origins, idx), gshape, 0, _pick(tabs, idx)))
        for c in colours]

    if kind == "pcr":

        def sweep(xs, bl, outs):
            return mesh.run(passes[0], xs, None if b_is_zero else bl, outs)

        step = _out_of_place(exchange, mesh, plain, sweep)
    else:

        def step(xs, bstate):
            bl = None if b_is_zero else bstate
            mesh.res.start()
            for launchers in passes:
                exchange(xs)
                mesh.run(launchers, xs, bl)
            return xs, mesh.res.total()

    step.solver = form
    return _attach(step, exchange, len(colours))


def make_dist_fused_overlap_step(problem: Problem, cmesh: CubeMesh,
                                 omega: float, *, b_is_zero: bool = False,
                                 plain: bool = False):
    """sor2sma step with the ghost exchange overlapped with the interior
    sweep (the capability the reference lacks: its loop is kernel, Comm_S,
    allreduce, cz_Poisson.cpp:39-79).

    Per colour: (1) gather the neighbours' current faces into a staging
    buffer, one launch a card on a side stream; (2) K8 on the interior, the
    one-cell local shell masked off, one launch on the current stream
    meanwhile; (3) scatter the staging buffer into the face ghosts; (4) K8
    on the shell alone.  A colour-c cell reads only colour 1-c cells and
    ghosts, which neither pass of this colour changes, and the interior
    pass writes no face, so the interior and the shell see the
    synchronized values and the field is bitwise the per-colour step's
    (the JAX version, whose shell patch is XLA-fused, is within 0-2 ulp of
    it).  The residual groups its partial sums differently (interior plus
    shell).  On one card the gather and the interior share its SMs: this
    shows the structure, not a gain.  CPU blocks refresh in step (3).
    Constant coefficients only; None under MAF."""
    if problem.mc is not None:
        return None
    gshape = problem.grid.shape_kij
    cmesh.block_shape(gshape)
    origins = cmesh.offsets(gshape)
    exchange = FaceExchange(cmesh, plain)
    mesh = _Mesh(cmesh, plain)
    passes = [[mesh.launchers(lambda idx, c=c, r=r: dist_sweeps.BlockSweeps(
        "sor2sma", c, omega, _pick(origins, idx), gshape, 0, r))
        for r in ("interior", "shell")] for c in (0, 1)]

    def step(xs, bstate):
        bl = None if b_is_zero else bstate
        mesh.res.start()
        for interior, shell in passes:
            exchange.collect(xs)
            mesh.run(interior, xs, bl)
            exchange.write(xs)
            mesh.run(shell, xs, bl)
        return xs, mesh.res.total()

    return _attach(step, exchange, 2)
