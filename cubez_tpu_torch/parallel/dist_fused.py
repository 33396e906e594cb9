"""Distributed steps on ghosted blocks with K8 (point sweeps) and K9 (line
relaxation) (PyTorch port of ``cubez_tpu/parallel/dist_fused.py``).

State: one (lk+2, li+2, lj+2) block per mesh block (cuda_kernels/
dist_sweeps.py's layout).  An iteration is the reference's multi-rank
skeleton, kernel, Comm_S(X, 1), Comm_SUM_1 (cz_Poisson.cpp:39-79):

    refresh the six width-1 ghost planes (halo.refresh_ghosts)
    -> one K8 or K9 launch per block
    -> the residual, folded over the blocks in float64.

Red-black cadence (``sync``): 'color' refreshes before each colour and is
serial-equivalent; 'iter' refreshes once and runs both colours in one
pass, the reference's semantics, unstable at omega 1.5 on small blocks.
``make_dist_fused_overlap_step`` collects the ghosts while the interior
runs.  The line kinds ('pcr', 'pcr_rb') refresh before each colour and
run K9 on the same blocks, its 'fastdiag' form on K-unsplit meshes and its
'pcr' form otherwise; MAF point sweeps have no step here, as in the JAX
package (parallel/dist.py runs them).  The mesh's ``block_shape`` takes
the place of the JAX module's ``_block_shape``.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.problem import Problem
from ..cuda_kernels import dist_pcr, dist_sweeps
from .halo import psum_all
from .halo import refresh_ghosts as _refresh_ghosts
from .mesh import CubeMesh


def to_block_state(cmesh: CubeMesh, arr):
    """Global (K, I, J) field -> ghosted blocks with zero ghosts."""
    return [dist_sweeps.pad_block(xb) for xb in cmesh.shard(arr)]


def from_block_state(cmesh: CubeMesh, state, gshape, device=None):
    """Ghosted blocks -> the global field (owned cells) on ``device``
    (default: block 0's)."""
    cmesh.block_shape(gshape)  # the state must be this grid's
    return cmesh.gather([dist_sweeps.unpad_block(x) for x in state], device)


def make_dist_fused_step(problem: Problem, cmesh: CubeMesh, kind: str,
                         omega: float, *, b_is_zero: bool = False,
                         sync: str = "color", plain: bool = False):
    """``step(xstate, bstate) -> (xstate_new, r2)`` on ghosted block states
    (``to_block_state``), r2 a 0-d float64 tensor on block 0's device.
    ``kind``: 'jacobi' (out of place: the step writes blocks it owns, two
    per mesh block in turn, and never the state it is handed, apart from
    its ghost planes), 'sor2sma' (in place; ``sync`` 'color' or 'iter'),
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
    g = problem.grid
    bs = cmesh.block_shape(g.shape_kij)
    origins = cmesh.offsets(g.shape_kij)
    kw = dict(omega=omega, b_is_zero=b_is_zero, plain=plain)
    if kind == "sor2sma" and sync == "color":
        sweeps = [dist_sweeps.make_block_sweep(kind, bs, g.shape_kij, g.dtype,
                                               color=c, **kw) for c in (0, 1)]
    else:
        sweeps = [dist_sweeps.make_block_sweep(kind, bs, g.shape_kij, g.dtype,
                                               **kw)]

    if kind == "jacobi":
        step = _out_of_place(cmesh, plain, origins, [None] * cmesh.size,
                             lambda x, bb, o, t, ob: sweeps[0](x, bb, o, out=ob))
    else:

        def step(xs, bstate):
            r2 = []
            for sweep in sweeps:
                _refresh_ghosts(xs, cmesh)
                r2 += [sweep(x, bb, o)[1]
                       for x, bb, o in zip(xs, _bl(bstate, xs), origins)]
            return xs, psum_all(r2)

    step.iters_per_call = 1
    step.single = step
    return step


def _bl(bstate, xs):
    return [None] * len(xs) if bstate is None else bstate


def _out_of_place(cmesh: CubeMesh, plain: bool, origins, tabs, sweep):
    """A step around ``sweep(x, b, origin, tab, out) -> (block, r2)`` that
    writes blocks it owns, two per mesh block in turn, and never the state
    it is handed, apart from its ghost planes."""
    bufs = []  # two blocks per mesh block, made at the first call

    def step(xs, bstate):
        _refresh_ghosts(xs, cmesh)
        out = [None] * len(xs)  # the twins return new blocks
        if xs[0].is_cuda and not plain:
            if not bufs:
                bufs.extend([torch.empty_like(x) for x in xs] for _ in range(2))
            # write the set that is not xs; a foreign state (the start, or
            # the driver's snapshot in its replay) is only read
            out = bufs[1] if xs[0].data_ptr() == bufs[0][0].data_ptr() else bufs[0]
        res = [sweep(x, bb, o, t, ob) for x, bb, o, t, ob
               in zip(xs, _bl(bstate, xs), origins, tabs, out)]
        return [r[0] for r in res], psum_all([r[1] for r in res])

    return step


LINE_KINDS = ("pcr", "pcr_rb")


def _make_line_step(problem: Problem, cmesh: CubeMesh, kind: str, omega: float,
                    b_is_zero: bool, plain: bool):
    """The line kinds on K9: its 'fastdiag' form where the mesh leaves K
    unsplit and the builder accepts, else its 'pcr' form
    (dist_fused.py:399-409 of the JAX package).  The ghosts are refreshed
    before each colour in the order Z, X, Y (the JAX line layout refreshes
    X, Z, Y); only edge ghosts differ, and K9 reads none of them into an
    update: ghost rows are identity rows and ghost columns are never
    lines."""
    g = problem.grid
    gshape = g.shape_kij
    bs = cmesh.block_shape(gshape)
    origins = cmesh.offsets(gshape)
    mc = problem.mc
    kw = dict(omega=omega, b_is_zero=b_is_zero, maf=mc is not None, mc=mc,
              plain=plain)

    def make(c):
        s = None
        if cmesh.div[0] == 1:
            s = dist_pcr.make_block_pcr(bs, gshape, g.dtype, color=c,
                                        solver="fastdiag", **kw)
        if s is None:
            s = dist_pcr.make_block_pcr(bs, gshape, g.dtype, color=c, **kw)
        return s

    sweeps = [make(c) for c in ((0, 1) if kind == "pcr_rb" else (None,))]
    tabs = [None] * cmesh.size
    if mc is not None:
        tabs = [sweeps[0].block_tables(o, d)
                for o, d in zip(origins, cmesh.devices)]

    if kind == "pcr":
        step = _out_of_place(cmesh, plain, origins, tabs, sweeps[0])
    else:

        def step(xs, bstate):
            r2 = []
            for sweep in sweeps:
                _refresh_ghosts(xs, cmesh)
                r2 += [sweep(x, bb, o, t)[1] for x, bb, o, t
                       in zip(xs, _bl(bstate, xs), origins, tabs)]
            return xs, psum_all(r2)

    step.solver = sweeps[0].solver
    step.iters_per_call = 1
    step.single = step
    return step


def _collect_ghosts(xs, cmesh: CubeMesh):
    """The six width-1 ghost planes of every block, copied from the
    neighbours' CURRENT faces with no write in between: a list per block of
    (axis, ghost index, plane).  Edge parts of the planes are stale, which
    no 7-point update reads (NOFACE=6, CB_Define_stub.h:31-35)."""
    out = []
    for b in range(len(xs)):
        planes = []
        for axis in range(3):
            n = xs[b].shape[axis] - 2
            for step, dst, src in ((1, n + 1, 1), (-1, 0, n)):
                nb = cmesh.neighbor(b, axis, step)
                if nb is not None:
                    planes.append((axis, dst, xs[nb].select(axis, src).clone()))
        out.append(planes)
    return out


def _write_ghosts(xs, ghosts):
    for x, planes in zip(xs, ghosts):
        for axis, dst, plane in planes:
            x.select(axis, dst).copy_(plane)


def make_dist_fused_overlap_step(problem: Problem, cmesh: CubeMesh,
                                 omega: float, *, b_is_zero: bool = False,
                                 plain: bool = False):
    """sor2sma step with the ghost exchange overlapped with the interior
    sweep (the capability the reference lacks: its loop is kernel, Comm_S,
    allreduce, cz_Poisson.cpp:39-79).

    Per colour: (1) copy the six ghost planes from the current faces, on a
    side stream for CUDA blocks; (2) K8 on the interior, the one-cell local
    shell masked off, on the current stream meanwhile; (3) write the
    ghosts; (4) K8 on the shell alone.  A colour-c cell reads only colour
    1-c cells and ghosts, which neither pass of this colour changes, so the
    interior and the shell see the synchronized values, and the field is
    bitwise the per-colour step's (the JAX version, whose shell patch is
    XLA-fused, is within 0-2 ulp of it).  The residual groups its partial
    sums differently (interior plus shell).  On one card the copies and the
    interior kernels share its SMs: this shows the structure, not a gain.
    Constant coefficients only; None under MAF."""
    if problem.mc is not None:
        return None
    g = problem.grid
    bs = cmesh.block_shape(g.shape_kij)
    origins = cmesh.offsets(g.shape_kij)
    kw = dict(omega=omega, b_is_zero=b_is_zero, plain=plain)
    passes = [
        [dist_sweeps.make_block_sweep("sor2sma", bs, g.shape_kij, g.dtype,
                                      color=c, region=r, **kw)
         for r in ("interior", "shell")]
        for c in (0, 1)
    ]
    side = {}  # device -> side stream, for CUDA blocks

    def collect(xs):
        devs = sorted({x.device for x in xs if x.is_cuda}, key=str)
        if not devs:
            return _collect_ghosts(xs, cmesh), []
        for d in devs:
            if d not in side:
                side[d] = torch.cuda.Stream(d)
            side[d].wait_stream(torch.cuda.current_stream(d))
        # one side stream per device; the blocks' faces are read there
        with contextlib.ExitStack() as on_side:
            for d in devs:
                on_side.enter_context(torch.cuda.stream(side[d]))
            ghosts = _collect_ghosts(xs, cmesh)
        for planes in ghosts:
            for _, _, plane in planes:
                plane.record_stream(torch.cuda.current_stream(plane.device))
        return ghosts, devs

    def step(xs, bstate):
        bl = _bl(bstate, xs)
        r2 = []
        for interior, shell in passes:
            ghosts, devs = collect(xs)
            r2 += [interior(x, bb, o)[1] for x, bb, o in zip(xs, bl, origins)]
            for d in devs:
                torch.cuda.current_stream(d).wait_stream(side[d])
            _write_ghosts(xs, ghosts)
            r2 += [shell(x, bb, o)[1] for x, bb, o in zip(xs, bl, origins)]
        return xs, psum_all(r2)

    step.iters_per_call = 1
    step.single = step
    return step
