"""Distributed solve API (PyTorch port of ``cubez_tpu/parallel/api.py``):
the counterpart of solvers.api.solve on a block mesh.

    from cubez_tpu_torch.parallel import make_mesh, solve_dist
    cm = make_mesh(prob.grid.shape_kij, devices=["cuda:0"] * 8, div=(2, 2, 2))
    result = solve_dist(prob, cm, "sor2sma", omega=1.5, itr_max=10000)

This slice runs the point solvers on their kernels: sor2sma and
sor2sma_maf on K7 (the packed path, dist_pack.py), jacobi and sor2sma on
K8 (dist_fused.py), and runs the same driver and convergence logic as the
serial path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.problem import Problem
from ..solvers.driver import EPS_DEFAULT, SolveResult, run_iterative
from ..solvers.steps import require_ported
from . import dist_fused, dist_pack
from .mesh import CubeMesh

IMPLS = ("auto", "plain")
SYNCS = ("auto", "pack", "color", "iter", "overlap")
_LATER = ("slice 9b of ROADMAP.md (the dist line path, K9/K10 with "
          "parallel/dist.py)")


def solve_dist(
    problem: Problem,
    cmesh: CubeMesh,
    solver: str,
    omega: float,
    itr_max: int,
    eps: float = EPS_DEFAULT,
    history_path: Optional[str] = None,
    impl: str = "auto",
    sync: str = "auto",
    check_every: Optional[int] = None,
    precond: Optional[str] = None,
) -> SolveResult:
    """Run a point solver distributed over the mesh's blocks.

    The returned SolveResult.x is the assembled global (K, I, J) field on
    the device of ``problem.x0``.  ``sync`` selects the red-black halo
    cadence: 'pack' is the packed path (K7 on blocks with a depth-2n ghost
    ring, n iterations per exchange, owned cells bitwise the serial
    result, so counts and the field at the stop equal the serial port's);
    'color' exchanges before each colour (serial-equivalent) and 'iter'
    once per iteration (the reference's semantics), both on K8; 'overlap'
    is 'color' with the exchange overlapped with the interior sweep.
    'auto' resolves to 'pack' where it applies, else 'color'.  An explicit
    'pack' raises ValueError where the packed path cannot run (not
    sor2sma, float64, a nonzero inner right-hand side, odd blocks or
    blocks thinner than the ring) instead of changing trajectories.

    ``impl``: 'auto' launches the kernels for CUDA blocks and runs the
    plain twins for CPU blocks; 'plain' runs the twins on any device.

    What the JAX package runs through its jnp shard_map steps or
    auto-SPMD, the line solvers, float64, the MAF point sweeps off the
    packed path and a non-standard mask, raises NotImplementedError naming
    slice 9b; the Krylov solvers name their slice, 4.  ``precond`` is
    accepted for signature parity and unused by these solvers."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    if sync not in SYNCS:
        raise ValueError(f"sync must be one of {SYNCS}, not {sync!r}")
    kind, is_maf = require_ported(solver)
    g = problem.grid
    cmesh.block_shape(g.shape_kij)  # a grid the mesh does not divide
    if kind not in ("jacobi", "sor2sma"):
        raise NotImplementedError(f"solve_dist('{solver}') is {_LATER}")
    if is_maf and problem.mc is None:
        raise ValueError("MAF solver requested but Problem has no MafCoeffs")
    plain = impl == "plain"
    mc_problem = problem if is_maf else dataclasses.replace(problem, mc=None)

    pack_ok = (kind == "sor2sma" and sync in ("auto", "pack")
               and g.dtype == torch.float32)
    if sync == "pack" and not pack_ok:
        raise ValueError(
            "sync='pack' applies only to sor2sma in float32; use sync='auto' "
            "to fall back to 'color'")
    if not problem.msk_is_standard():
        raise NotImplementedError(
            f"a non-standard mask needs a masked distributed sweep, {_LATER}")
    if pack_ok:
        pstep = dist_pack.make_dist_packed_step(mc_problem, cmesh, omega,
                                                plain=plain)
        if pstep is None and sync == "pack":
            raise ValueError(
                "sync='pack' unavailable for this configuration (needs float32, "
                "zero inner RHS, even block extents >= the 2n ghost depth); "
                "use sync='auto' to fall back to 'color'")
        if pstep is not None:
            xs = dist_pack.to_packed_state(cmesh, problem.x0, pstep.hs)
            result = run_iterative(pstep, xs, None, g.res_normal, itr_max, eps,
                                   check_every=check_every)
            x = dist_pack.from_packed_state(cmesh, result.x, g.shape_kij,
                                            pstep.hs, device=problem.x0.device)
            return _finish(dataclasses.replace(result, x=x), history_path)

    if g.dtype != torch.float32:
        raise NotImplementedError(f"float64 solve_dist is {_LATER}")
    if is_maf:
        raise NotImplementedError(
            f"'{solver}' off the packed path (sync={sync!r}, or a problem the "
            f"packed path refuses) is {_LATER}")
    b_is_zero = problem.rhs_is_inner_zero()
    if sync == "overlap":
        if kind != "sor2sma":
            raise NotImplementedError(f"sync='overlap' for '{solver}' is {_LATER}")
        step = dist_fused.make_dist_fused_overlap_step(
            problem, cmesh, omega, b_is_zero=b_is_zero, plain=plain)
    else:
        step = dist_fused.make_dist_fused_step(
            problem, cmesh, kind, omega, b_is_zero=b_is_zero, plain=plain,
            sync="iter" if sync == "iter" else "color")
    xs = dist_fused.to_block_state(cmesh, problem.x0)
    bs = None if b_is_zero else dist_fused.to_block_state(cmesh, problem.rhs)
    result = run_iterative(step, xs, bs, g.res_normal, itr_max, eps,
                           check_every=check_every)
    x = dist_fused.from_block_state(cmesh, result.x, g.shape_kij,
                                    device=problem.x0.device)
    return _finish(dataclasses.replace(result, x=x), history_path)


def _finish(result: SolveResult, history_path) -> SolveResult:
    if history_path:
        result.write_history(history_path)
    return result
