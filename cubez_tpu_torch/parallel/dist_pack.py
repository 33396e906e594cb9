"""Distributed sor2sma on packed red-black blocks with a deep ghost ring
(PyTorch port of ``cubez_tpu/parallel/dist_pack.py``).

One step runs ``n`` full red-black iterations:

    refresh the ghost ring, depth h = 2n on each split mesh axis
    -> K7 on the blocks (cuda_kernels/dist_rbpack.py)
    -> the (n,) owned residual sums, folded over the blocks in float64.

With every block of the mesh on one card that is two launches a call: the
one-launch ring refresh (``dist_rbpack.PackExchange``) and one cooperative
K7 launch over all the blocks, which folds the residuals on the card
(``dist_rbpack.BlockRbSweeps``).  Otherwise (CPU blocks, ``plain``, blocks
on several cards, or more than ``dist_rbpack.MAX_BLOCKS`` blocks) the ring
takes one slab-copy phase per split axis, in the order Z, X, Y
(``exchange_ghosts_packed``), K7 runs block by block (its twin on CPU
blocks) and ``psum_all`` folds the sums; the faces between cards are
untested (the test rig has one card).

Owned cells are bitwise the serial n-iteration result, so iteration
counts equal the serial port's on any mesh and histories agree to the
rounding of the residual's partial sums.  The stopping chunk is replayed
with ``step.single``, K7 at n = 1 on the same ring, so the field at the
stop is the serial port's bit for bit.

Unsplit axes carry no ghosts.  Each exchange phase copies slabs that span
the full extent of the axes already refreshed, so edge and corner ghosts
(which deep-halo windows read) fill transitively with two- and three-hop
values.  Every slab is a verbatim slice of the packed blocks: K rows and J
lanes directly, and on X whole pair-rows (i2) of both colour halves, since
depths and block origins are even.  Ring cells past a mesh edge lie
outside the grid: K7 never updates them and the exchange never writes
them, so they keep the zeros they were packed with.
"""

from __future__ import annotations

import torch

from ..core.problem import Problem
from ..cuda_kernels import dist_rbpack
from .halo import psum_all
from .mesh import CubeMesh


def exchange_ghosts_packed(blocks, cmesh: CubeMesh, block_shape, hs):
    """Refresh the ghost ring of every extended packed block
    (2, Ke, Ie/2, Je) in place, depth ``hs[axis]`` per axis (0: skipped),
    from the neighbours' owned cells."""
    lk, li, lj = block_shape
    hz, hx, hy = hs
    # (axis of the packed block, depth, owned extent) per mesh axis; X
    # moves pair-rows, so its depth and extent are halved
    phases = ((1, hz, lk), (2, hx // 2, li // 2), (3, hy, lj))
    for axis, (dim, h, n) in enumerate(phases):
        if not h or cmesh.div[axis] == 1:
            continue
        for b, blk in enumerate(blocks):
            # my high ghost <- the next block's first h owned; my low
            # ghost <- the previous block's last h owned
            for step, dst, src in ((1, h + n, h), (-1, 0, n)):
                nb = cmesh.neighbor(b, axis, step)
                if nb is not None:
                    blk.narrow(dim, dst, h).copy_(blocks[nb].narrow(dim, src, h))
    return blocks


def to_packed_state(cmesh: CubeMesh, arr, hs):
    """Global (K, I, J) field -> the extended packed blocks."""
    return [dist_rbpack.pack_ext_block(xb, hs) for xb in cmesh.shard(arr)]


def from_packed_state(cmesh: CubeMesh, state, gshape, hs, device=None):
    """Extended packed blocks -> the global field (owned cells) on
    ``device`` (default: block 0's)."""
    bs = cmesh.block_shape(gshape)
    return cmesh.gather(
        [dist_rbpack.unpack_ext_block(xp, bs, hs) for xp in state], device)


def make_dist_packed_step(problem: Problem, cmesh: CubeMesh, omega: float, *,
                          n: int | None = None, plain: bool = False):
    """``step(xstate, bstate) -> (xstate, r2)`` on packed block states
    (``to_packed_state``; ``bstate`` is ignored, zero right-hand side), r2
    the (n,) float64 residual sums on block 0's device.  ``n`` pins the
    window depth; by default the first of the JAX package's candidates
    that fits: 6, 5, 4, 3, 2 for constant coefficients, 2, 3, 4 under MAF
    (``problem.mc``).  The ring covers the split mesh axes.
    ``step.single`` runs one iteration on the same ring.  ``plain`` runs
    K7's twin on any device.  On one card r2 is a buffer of the step's
    that holds until its next call.  None where the path does not apply:
    float64, a nonzero inner right-hand side, odd block extents, or blocks
    thinner than the ring."""
    g = problem.grid
    if g.dtype != torch.float32 or not problem.rhs_is_inner_zero():
        return None
    bs = cmesh.block_shape(g.shape_kij)
    split = tuple(d > 1 for d in cmesh.div)
    cand = [n] if n else ([2, 3, 4] if problem.mc is not None
                          else [6, 5, 4, 3, 2])
    kw = dict(omega=omega, split=split, mc=problem.mc, plain=plain)
    for nx in cand:
        kern = dist_rbpack.make_dist_packed_sweepnx(bs, g.shape_kij, g.dtype,
                                                    n=nx, **kw)
        if kern is not None:
            break
    if kern is None:
        return None
    single = dist_rbpack.make_dist_packed_sweepnx(
        bs, g.shape_kij, g.dtype, n=1, h=2 * kern.iters_per_call, **kw)
    hs = kern.hs
    origins = cmesh.offsets(g.shape_kij)
    tabs = [None] * cmesh.size
    if kern.maf:
        tabs = [kern.block_tables(o, d) for o, d in zip(origins, cmesh.devices)]

    devs = set(cmesh.devices)
    on_card = (not plain and len(devs) == 1 and next(iter(devs)).type == "cuda"
               and cmesh.size <= dist_rbpack.MAX_BLOCKS)

    def make(k):
        if on_card:
            exchange = dist_rbpack.PackExchange(cmesh.div, bs, hs)
            sweeps = dist_rbpack.BlockRbSweeps(k.iters_per_call, omega, bs,
                                               g.shape_kij, hs, origins)
            launch_tabs = tabs if kern.maf else None

            def step(xs, bstate):
                exchange(xs)
                return xs, sweeps(xs, launch_tabs)
        else:
            def exchange(xs):
                return exchange_ghosts_packed(xs, cmesh, bs, hs)

            def step(xs, bstate):
                exchange(xs)
                r2 = [k(xp, o, t) for xp, o, t in zip(xs, origins, tabs)]
                return xs, psum_all(r2)

        step.iters_per_call = k.iters_per_call
        step.hs = hs
        # the ring refresh alone, once a call (perf/profile.py times it)
        step.exchange = exchange
        step.exchanges_per_call = 1
        return step

    step = make(kern)
    step.single = make(single)
    return step
