"""Distributed solver steps on owned blocks with an explicit halo exchange
(PyTorch port of ``cubez_tpu/parallel/dist.py``).

The JAX package runs these as shard_map bodies of jnp operations, which XLA
compiles for the TPU; here a step is plain torch operations over the list
of owned (lk, li, lj) blocks (``CubeMesh.shard``), which run on the blocks'
devices.  ``solve_dist`` takes them where the JAX package takes its jnp
steps: float64, the MAF point sweeps off the packed path, ``jacobi`` with
``sync='overlap'`` and a non-standard mask (every step carries the
problem's own mask).

Semantics follow the reference's multi-rank behaviour:

* a width-1 halo exchange before each sweep (per colour for red-black,
  which is serial-equivalent);
* the residual is the sum of per-block partials, folded in float64 in
  block order (``halo.psum_all``; Comm_SUM_1, cz_comm.cpp:102-120);
* red-black parity is global (from the block origin, cz_Poisson.cpp:179-
  186);
* K-lines of the line solvers stay block-local, each extended with its two
  ghost rows as identity equations (x_ghost = known), which is the
  reference's ``d(kst) += x(kst-1)/6`` fold (cz_solver.f90:578-579).

Steps are functional: ``step(xs, bs) -> (new blocks, r2)``, r2 a 0-d
float64 tensor on block 0's device.
"""

from __future__ import annotations

import torch

from ..core.problem import Problem
from ..ops import maf as maf_ops
from ..ops import stencil
from ..ops.pcr import num_stage, pcr_reduce_var
from ..solvers.fused_cache import get_fused_step
from ..solvers.steps import (EXTENSIONS, make_step, parse_name,
                              require_standard_mask)
from .halo import exchange_halo, pad_zeros, psum_all
from .mesh import CubeMesh


def _global_parity(cmesh: CubeMesh, gshape, axes, extra: int, dtype):
    """Per block, the two 0/1 masks of (sum of the global indices on
    ``axes`` + extra) % 2 == 0 and == 1, on the block's device."""
    bs = cmesh.block_shape(gshape)
    out = []
    for o, dev in zip(cmesh.offsets(gshape), cmesh.devices):
        par = torch.full(bs, extra, dtype=torch.int64, device=dev)
        for ax in axes:
            shp = [1, 1, 1]
            shp[ax] = -1
            par = par + (torch.arange(bs[ax], device=dev) + o[ax]).view(shp)
        par = par % 2
        out.append(((par == 0).to(dtype), (par == 1).to(dtype)))
    return out


def _interior(a):
    return a[1:-1, 1:-1, 1:-1]


def _overlap_delta(xs, bhs, mhs, delta_fn, cmesh: CubeMesh):
    """dp of every block for one sweep with the halo exchange OVERLAPPED
    with interior compute (the capability the reference lacks: its loop is
    strictly kernel, Comm_S, allreduce, cz_Poisson.cpp:39-79).

    The full-block delta is computed with zero ghosts, right everywhere
    but on the six one-cell faces and independent of the exchange; the
    faces are then recomputed from the true ghosts and patched in.  A
    stencil delta is elementwise, so the result is bitwise the sequential
    exchange-then-sweep's."""
    dps = [_interior(delta_fn(pad_zeros(x), bh, mh))
           for x, bh, mh in zip(xs, bhs, mhs)]
    xhs = exchange_halo(xs, cmesh)
    for dp, xh, bh, mh in zip(dps, xhs, bhs, mhs):
        for axis in range(3):
            L = dp.shape[axis]
            for lo in (True, False):
                sub = [slice(None)] * 3
                sub[axis] = slice(0, 3) if lo else slice(L - 1, L + 2)
                sub = tuple(sub)
                face = _interior(delta_fn(xh[sub], bh[sub], mh[sub]))
                tgt = [slice(None)] * 3
                tgt[axis] = slice(0, 1) if lo else slice(L - 1, L)
                dp[tuple(tgt)] = face
    return dps


def _sum2(dps):
    return psum_all([(d * d).sum(dtype=torch.float64) for d in dps])


def _attach(step, cmesh: CubeMesh, exchanges: int):
    """Set a step's driver attributes (one iteration a call, its own
    ``single``) and its halo exchange alone (``exchange``, called
    ``exchanges_per_call`` times a call), which perf/profile.py times."""
    step.iters_per_call = 1
    step.single = step
    step.exchange = lambda xs: exchange_halo(xs, cmesh)
    step.exchanges_per_call = exchanges
    return step


def make_dist_step(problem: Problem, cmesh: CubeMesh, name: str, omega: float,
                   overlap: bool = False):
    """Build ``step(xs, bs) -> (xs_new, r2)`` on owned blocks, one
    iteration with an explicit halo exchange.  Supported: jacobi, sor2sma,
    pcr_j_esa (kind 'pcr'), pcr_rb and pcr_rb_esa, and their MAF forms.
    ``overlap=True`` (jacobi, sor2sma; constant coefficients) computes the
    interior apart from the exchange, see ``_overlap_delta``."""
    kind, is_maf = parse_name(name)
    g = problem.grid
    dtype = g.dtype
    mbs = cmesh.shard(problem.msk)
    if is_maf:
        if problem.mc is None:
            raise ValueError("MAF solver requested but Problem has no MafCoeffs")
        return _make_dist_maf_step(problem, cmesh, kind, omega, mbs)

    if kind in ("jacobi", "sor2sma"):
        def delta(xh, bh, mh):
            return stencil.jacobi_delta(xh, bh, mh, omega)

        def sweep(xs, bs, mhs):
            bhs = [pad_zeros(b) for b in bs]
            if overlap:
                return _overlap_delta(xs, bhs, mhs, delta, cmesh)
            return [_interior(delta(xh, bh, mh)) for xh, bh, mh
                    in zip(exchange_halo(xs, cmesh), bhs, mhs)]

        if kind == "jacobi":
            mhs = [pad_zeros(m) for m in mbs]

            def step(xs, bs):
                dps = sweep(xs, bs, mhs)
                return [x + d for x, d in zip(xs, dps)], _sum2(dps)

            return _attach(step, cmesh, 1)

        colours = _global_parity(cmesh, g.shape_kij, (0, 1, 2), 1, dtype)
        mhs_c = [[pad_zeros(m * cm[c]) for m, cm in zip(mbs, colours)]
                 for c in (0, 1)]

        def step(xs, bs):
            r2 = None
            for mhs in mhs_c:
                dps = sweep(xs, bs, mhs)
                xs = [x + d for x, d in zip(xs, dps)]
                r2 = _sum2(dps) if r2 is None else r2 + _sum2(dps)
            return xs, r2

        return _attach(step, cmesh, 2)

    if kind in ("pcr", "pcr_rb"):
        lk = g.nk // cmesh.div[0]
        pn = num_stage(lk + 2)
        r = torch.tensor(1.0 / 6.0, dtype=dtype)

        def line_solve(xh, bh, mh):
            # columns: owned (li, lj); rows: lk + 2 with the ghost identity rows
            xcol = xh[:, 1:-1, 1:-1]
            mcol = mh[:, 1:-1, 1:-1]
            bcol = bh[:, 1:-1, 1:-1]
            rr = r.to(xh.device)
            trans = (xh[:, 2:, 1:-1] + xh[:, :-2, 1:-1] + xh[:, 1:-1, 2:]
                     + xh[:, 1:-1, :-2])
            a = -rr * mcol
            c = -rr * mcol
            d = ((trans - bcol) * rr) * mcol + xcol * (1.0 - mcol)
            return pcr_reduce_var(a, c, d, pn)

        return _line_step(kind, cmesh, g, mbs, omega, line_solve)

    raise ValueError(f"no explicit distributed step for '{name}'")


def _line_step(kind, cmesh, g, mbs, omega, line_solve, mcls=None):
    """The pcr / pcr_rb step around a block ``line_solve(xh, bh, mh[,
    mcl])``; ``mcls`` the per-block MAF coefficients."""
    mhs = [pad_zeros(m) for m in mbs]
    extra = [()] * len(mbs) if mcls is None else [(m,) for m in mcls]
    if kind == "pcr":
        lms = [(None,)] * len(mbs)
    else:
        lms = _global_parity(cmesh, g.shape_kij, (1, 2), 0, g.dtype)

    def step(xs, bs):
        r2 = None
        for c in range(1 if kind == "pcr" else 2):
            xhs = exchange_halo(xs, cmesh)
            dps = []
            for x, xh, b, mb, mh, lm, ex in zip(xs, xhs, bs, mbs, mhs, lms, extra):
                om = torch.tensor(omega, dtype=x.dtype, device=x.device)
                sol = line_solve(xh, pad_zeros(b), mh, *ex)
                dp = (sol[1:-1] - x) * om * mb
                dps.append(dp if lm[c] is None else dp * lm[c])
            xs = [x + d for x, d in zip(xs, dps)]
            r2 = _sum2(dps) if r2 is None else r2 + _sum2(dps)
        return xs, r2

    return _attach(step, cmesh, 2 if kind == "pcr_rb" else 1)


def _local_mc(mc, cmesh: CubeMesh, gshape):
    """Per block, its MafCoeffs over the block extent plus one halo entry on
    each side, sliced from the global tables padded with ones (the padded
    entries reach only discarded halo values or identity rows)."""
    bs = cmesh.block_shape(gshape)
    vec = {}
    for f in maf_ops.FIELDS:
        v = getattr(mc, f).reshape(-1)
        vec[f] = torch.cat([v.new_ones(1), v, v.new_ones(1)])
    axis = {"c1": 1, "c7": 1, "c2": 2, "c8": 2, "c3": 0, "c9": 0}
    out = []
    for o, dev in zip(cmesh.offsets(gshape), cmesh.devices):
        cut = [vec[f][o[axis[f]]:o[axis[f]] + bs[axis[f]] + 2].to(dev)
               for f in maf_ops.FIELDS]
        out.append(maf_ops.MafCoeffs._from_axes(*cut))
    return out


def _make_dist_maf_step(problem: Problem, cmesh: CubeMesh, kind: str,
                        omega: float, mbs):
    """MAF (variable-coefficient) sweeps; each block's coefficients are
    sliced from the separable global tables (``_local_mc``)."""
    if kind not in ("jacobi", "sor2sma", "pcr", "pcr_rb"):
        raise NotImplementedError(f"explicit distributed MAF step for '{kind}'")
    g = problem.grid
    dtype = g.dtype
    mcls = _local_mc(problem.mc, cmesh, g.shape_kij)

    if kind in ("pcr", "pcr_rb"):
        lk = g.nk // cmesh.div[0]
        pn = num_stage(lk + 2)

        def line_solve_maf(xh, bh, mh, mcl):
            xcol = xh[:, 1:-1, 1:-1]
            mcol = mh[:, 1:-1, 1:-1]
            bcol = bh[:, 1:-1, 1:-1]
            c3, c9 = mcl.c3, mcl.c9  # (lk+2, 1, 1) with the ghost rows
            c1, c7 = mcl.c1[:, 1:-1, :], mcl.c7[:, 1:-1, :]  # (1, li, 1)
            c2, c8 = mcl.c2[:, :, 1:-1], mcl.c8[:, :, 1:-1]
            half = torch.tensor(0.5, dtype=dtype, device=xh.device)
            dw = half / (c1 + c2 + c3)
            a = (-(c3 - half * c9) * dw) * mcol
            c = (-(c3 + half * c9) * dw) * mcol
            trans = ((c1 + half * c7) * xh[:, 2:, 1:-1]
                     + (c1 - half * c7) * xh[:, :-2, 1:-1]
                     + (c2 + half * c8) * xh[:, 1:-1, 2:]
                     + (c2 - half * c8) * xh[:, 1:-1, :-2])
            d = ((trans - bcol) * dw) * mcol + xcol * (1.0 - mcol)
            return pcr_reduce_var(a, c, d, pn)

        return _line_step(kind, cmesh, g, mbs, omega, line_solve_maf, mcls)

    def deltas(xs, bs, mhs):
        return [_interior(maf_ops.maf_delta(xh, pad_zeros(b), mh, omega, mcl))
                for xh, b, mh, mcl in zip(exchange_halo(xs, cmesh), bs, mhs, mcls)]

    if kind == "jacobi":
        mhs = [pad_zeros(m) for m in mbs]

        def step(xs, bs):
            dps = deltas(xs, bs, mhs)
            return [x + d for x, d in zip(xs, dps)], _sum2(dps)

        return _attach(step, cmesh, 1)

    colours = _global_parity(cmesh, g.shape_kij, (0, 1, 2), 1, dtype)
    mhs_c = [[pad_zeros(m * cm[c]) for m, cm in zip(mbs, colours)]
             for c in (0, 1)]

    def step(xs, bs):
        r2 = None
        for mhs in mhs_c:
            dps = deltas(xs, bs, mhs)
            xs = [x + d for x, d in zip(xs, dps)]
            r2 = _sum2(dps) if r2 is None else r2 + _sum2(dps)
        return xs, r2

    return _attach(step, cmesh, 2)


def make_gathered_step(problem: Problem, cmesh: CubeMesh, name: str,
                       omega: float, plain: bool = False,
                       b_arg_is_problem_rhs: bool = True,
                       divides: int | None = None):
    """(step, pre, post) of a solver the JAX package reaches on a mesh only
    through auto-SPMD with serial semantics (its parallel/api.py:187-225):
    the exact serial orders (psor, pcr_gs) and the extensions (mg, fmg,
    fd), with their ``_maf`` forms, by ``name``.  ``pre`` gathers the
    blocks into one field, the serial step runs on it, and ``post`` shards
    the result back; counts and fields are the serial solve's bit for bit.

    psor and pcr_gs gather on the first block's device, into the diagonal
    layout of their step of ``get_fused_step`` built for that device
    (kernel P1 or P2, n sweeps a call on a card, ``divides`` as there; or
    with ``plain`` its twin), which is returned as it is,
    ``iters_per_call`` and ``single`` too.
    The extensions gather on the device of the problem's fields, where
    ``steps.make_step`` builds their step (K4 on mg's finest level;
    ``plain`` and ``b_arg_is_problem_rhs`` as there).
    ValueError for a non-standard mask, as the serial step raises."""
    kind, _ = parse_name(name)
    if kind in EXTENSIONS:
        step = make_step(problem, name, omega, plain=plain,
                         b_arg_is_problem_rhs=b_arg_is_problem_rhs)
        dev, pad, unpad = problem.x0.device, None, None
    else:
        require_standard_mask(problem, name)
        dev = cmesh.devices[0]
        step = get_fused_step(kind, problem.grid, omega, mc=problem.mc,
                              plain=plain, divides=divides, device=dev)
        pad, unpad = step.pad, step.unpad

    def pre(blocks):
        x = cmesh.gather(blocks, device=dev)
        return x if pad is None else pad(x)

    def post(S):
        return cmesh.shard(S if unpad is None else unpad(S))

    return step, pre, post
