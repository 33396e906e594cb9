"""The Krylov solvers on a block mesh: bicgstab.py's and cg.py's loops over
the blocks of a mesh (the JAX package runs them on sharded fields under
GSPMD, parallel/api.py:64-88 there).

Vectors are block lists (``CubeMesh.shard``) and every BLAS op runs a block
at a time.  A dot sums each block's partial in the field's dtype and folds
the partials in float64 in block order (``halo.psum_all``, the psum of the
JAX package), cast back to the field's dtype.  ``ax`` and ``rk`` read the
neighbours through ``halo.exchange_halo``; their MAF forms take the
block-local coefficients (dist.py's ``_local_mc``) and the block's slice of
``problem.pvt``.

The preconditioner takes ``solve_dist``'s route for its name with a
streamed b: in float32 with the standard mask, the K8 step (jacobi,
sor2sma; 'color' cadence) or the K9 step (the line kinds, constant and
MAF) of ``dist_fused.make_dist_fused_step`` on ghosted blocks; otherwise
(float64, the MAF point sweeps, another mask) dist.py's plain step on the
blocks.  The exact serial orders (psor, pcr_gs) run their serial step on
the gathered vector (``dist.make_gathered_step``).  The packed path does
not apply: it refuses a nonzero b.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.problem import Problem
from ..cuda_kernels import dist_sweeps
from ..ops import blas
from ..ops import maf as maf_ops
from ..solvers import steps as steps_mod
from ..solvers.bicgstab import (VectorOps, is_identity, precon_plan,
                                run_bicgstab, sweeps_precon)
from ..solvers.cg import check_cg, run_cg
from ..solvers.driver import SolveResult
from . import dist_fused
from .dist import _interior, _local_mc, make_dist_step, make_gathered_step
from .halo import exchange_halo, pad_zeros, psum_all
from .mesh import CubeMesh


class BlockOps(VectorOps):
    """VectorOps on the block lists of ``cmesh``; scalars live on block 0's
    device."""

    def __init__(self, problem: Problem, cmesh: CubeMesh, mc, precon):
        super().__init__(problem, mc, precon)
        self.cmesh = cmesh
        self.device = cmesh.devices[0]
        self.mbs = cmesh.shard(problem.msk)
        self.mhs = [pad_zeros(m) for m in self.mbs]
        self.mcls = self.pvhs = None
        if self.mc is not None:
            gshape = problem.grid.shape_kij
            self.mcls = _local_mc(self.mc, cmesh, gshape)
            self.pvhs = [pad_zeros(v) for v in cmesh.shard(problem.pvt)]

    def _map(self, fn, *vs):
        """``fn(*blocks, msk block)`` on each block of the vectors ``vs``."""
        return [fn(*bs, m) for *bs, m in zip(*vs, self.mbs)]

    def _dot(self, fn, *vs):
        """The 0-d sum of ``fn``'s per-block partials, folded in block
        order."""
        return psum_all(self._map(fn, *vs)).to(self.dtype)

    def dot1(self, v):
        return self._dot(blas.dot1, v)

    def dot2(self, v, w):
        return self._dot(blas.dot2, v, w)

    def dots_t(self, t, s):
        return self.dot2(t, s), self.dot1(t)

    def triad(self, x, y, a):
        return self._map(lambda x, y, m: blas.triad(x, y, a, m), x, y)

    def bicg_1(self, p, r, q, beta, omega):
        return self._map(lambda p, r, q, m: blas.bicg_1(p, r, q, beta, omega, m),
                         p, r, q)

    def bicg_2(self, z, x, y, a, b):
        return self._map(lambda z, x, y, m: blas.bicg_2(z, x, y, a, b, m),
                         z, x, y)

    def update_xr(self, x, p_, s_, t_, s, r0, alpha, omega):
        x = self.bicg_2(x, p_, s_, alpha, omega)
        r = self.triad(t_, s, -omega)
        return x, r, self.dot1(r), self.dot2(r, r0)

    def axpy(self, x, a, p):
        return self._map(lambda x, p, m: blas.axpy(x, a, p, m), x, p)

    def neg(self, v):
        return self._map(lambda v, m: -v, v)

    def _padded(self, fn, p, *extra):
        """fn on each block with its ghosts (zeros past the mesh edge), the
        owned cells of the result."""
        xhs = exchange_halo(p, self.cmesh)
        if self.mcls is None:
            return [_interior(fn(xh, *e, mh)) for xh, *e, mh
                    in zip(xhs, *extra, self.mhs)]
        return [_interior(fn(xh, *e, mh, mcl, pvh)) for xh, *e, mh, mcl, pvh
                in zip(xhs, *extra, self.mhs, self.mcls, self.pvhs)]

    def ax(self, p):
        return self._padded(blas.calc_ax if self.mcls is None
                            else maf_ops.calc_ax_maf, p)

    def rk(self, p, b):
        bhs = [pad_zeros(t) for t in b]
        return self._padded(blas.calc_rk if self.mcls is None
                            else maf_ops.calc_rk_maf, p, bhs)


def make_dist_precon(problem: Problem, cmesh: CubeMesh, precond, omega: float,
                     impl: str = "auto"):
    """The preconditioner on block lists (see the module docstring)."""
    if is_identity(precond):
        return lambda v: v
    precond, omega, sweeps = precon_plan(precond, omega)
    kind, _ = steps_mod.parse_name(precond)
    pprob = dataclasses.replace(problem,
                                mc=steps_mod.maf_coeffs(problem, precond))
    if kind in steps_mod.DIAGONAL + steps_mod.EXTENSIONS:
        step, pre, post = make_gathered_step(pprob, cmesh, precond, omega,
                                             plain=impl == "plain",
                                             b_arg_is_problem_rhs=False,
                                             divides=sweeps)
        return sweeps_precon(steps_mod.labeled(precond, step), pre, post,
                             sweeps=sweeps)
    step = None
    if (problem.grid.dtype == torch.float32 and problem.msk_is_standard()
            and (kind in dist_fused.LINE_KINDS or pprob.mc is None)):
        step = dist_fused.make_dist_fused_step(
            pprob, cmesh, kind, omega, b_is_zero=False, plain=impl == "plain")
    if step is None:
        return sweeps_precon(steps_mod.labeled(
            precond, make_dist_step(pprob, cmesh, precond, omega)))
    return sweeps_precon(
        steps_mod.labeled(precond, step),
        lambda vs: [dist_sweeps.pad_block(v) for v in vs],
        # copies of the owned cells: the step's blocks are its own
        lambda xs: [dist_sweeps.unpad_block(x).contiguous() for x in xs])


def solve_krylov_dist(problem: Problem, cmesh: CubeMesh, solver: str,
                      omega: float, itr_max: int, eps: float, precond,
                      impl: str) -> SolveResult:
    """``pbicgstab``, ``pbicgstab_maf`` or ``cg`` over the mesh's blocks;
    x of the result is the assembled field on the device of ``problem.x0``."""
    kind, _ = steps_mod.parse_name(solver)
    if kind == "cg":
        check_cg(problem, precond)
    ops = BlockOps(problem, cmesh, steps_mod.maf_coeffs(problem, solver),
                   make_dist_precon(problem, cmesh, precond, omega, impl))
    run = run_cg if kind == "cg" else run_bicgstab
    result = run(ops, cmesh.shard(problem.x0), cmesh.shard(problem.rhs),
                 itr_max, eps, problem.grid.res_normal)
    return dataclasses.replace(
        result, x=cmesh.gather(result.x, device=problem.x0.device))
