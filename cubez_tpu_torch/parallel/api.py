"""Distributed solve API (PyTorch port of ``cubez_tpu/parallel/api.py``):
the counterpart of solvers.api.solve on a block mesh.

    from cubez_tpu_torch.parallel import make_mesh, solve_dist
    cm = make_mesh(prob.grid.shape_kij, devices=["cuda:0"] * 8, div=(2, 2, 2))
    result = solve_dist(prob, cm, "sor2sma", omega=1.5, itr_max=10000)

Routes as the JAX package does, with the port's kernels in the place of
its fused Pallas steps: float32 with the standard mask runs sor2sma and
sor2sma_maf on K7 (the packed path, dist_pack.py), jacobi and sor2sma on
K8 and the line solvers (pcr_rb, pcr_rb_esa, pcr_j_esa and their MAF
forms) on K9 (dist_fused.py); everything else the JAX package runs on its
jnp steps, float64, the MAF point sweeps off the packed path, jacobi with
sync='overlap' and a non-standard mask, runs on parallel/dist.py.  The
exact serial orders (psor, pcr, pcr_eda, pcr_esa and their MAF forms),
which the JAX package reaches only through auto-SPMD with serial
semantics, run their serial step on the gathered field
(dist.make_gathered_step), and so do the extensions mg, fmg, fd and their
MAF forms, which the JAX package also runs through auto-SPMD.  Every route
drives the same convergence logic as the serial path.  The Krylov
solvers run their loops on the blocks (krylov.py), with these routes for
their preconditioner.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.problem import Problem
from ..perf import spans
from ..solvers.api import _initial_x
from ..solvers.driver import EPS_DEFAULT, SolveResult, run_iterative
from ..solvers.steps import DIAGONAL, EXTENSIONS, KRYLOV, labeled, parse_name
from . import dist_fused, dist_pack
from .dist import make_dist_step, make_gathered_step
from .krylov import solve_krylov_dist
from .mesh import CubeMesh

IMPLS = ("auto", "plain")
SYNCS = ("auto", "pack", "color", "iter", "overlap")


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
    """Run a relaxation or line solver distributed over the mesh's blocks.

    The returned SolveResult.x is the assembled global (K, I, J) field on
    the device of ``problem.x0``.  ``sync`` selects the red-black halo
    cadence of the point solvers: 'pack' is the packed path (K7 on blocks
    with a depth-2n ghost ring, n iterations per exchange, owned cells
    bitwise the serial result, so counts and the field at the stop equal
    the serial port's); 'color' exchanges before each colour
    (serial-equivalent) and 'iter' once per iteration (the reference's
    semantics), both on K8; 'overlap' is 'color' with the exchange
    overlapped with the interior sweep (parallel/dist.py's for jacobi).
    'auto' resolves to 'pack' where it applies, else 'color'.  An explicit
    'pack' raises ValueError where the packed path cannot run (not
    sor2sma, float64, a non-standard mask, a nonzero inner right-hand side,
    odd blocks or blocks thinner than the ring) instead of changing
    trajectories.  The line solvers exchange before each colour and run
    K9, its 'fastdiag' form (Thomas on whole K-lines) where the mesh leaves
    K unsplit, else its 'pcr' form (block-local lines with identity ghost
    rows).

    float64, the MAF point sweeps off the packed path, jacobi with
    sync='overlap' and a non-standard mask run parallel/dist.py's steps,
    plain torch operations on the blocks' devices, as the JAX package runs
    them on its jnp steps.  psor and pcr_gs (pcr, pcr_eda, pcr_esa) and
    their MAF forms, which the JAX package reaches only through auto-SPMD
    with serial semantics, gather the blocks on the first block's device
    and run the serial step there (kernels P1 and P2 on the diagonal
    layout), so their counts and fields are the serial solve's bit for
    bit; ``sync`` is unused by them ('pack' raises), and a non-standard
    mask raises ValueError, as serially.  mg, fmg and fd and their MAF
    forms take the same route, gathered on the device of the problem's
    fields: the serial step of solvers/multigrid.py (K4 on the finest
    level) or solvers/direct.py, fmg from its F-cycle.

    The Krylov solvers ``pbicgstab``, ``pbicgstab_maf`` and ``cg`` run
    bicgstab.py's and cg.py's loops on the blocks (parallel/krylov.py):
    dots fold the blocks' partials in block order, ``ax`` and ``rk`` read
    the neighbours through a halo exchange, and the ``precond`` sweeps take
    this function's route for their name with the Krylov vector as b: K8
    for jacobi and sor2sma ('color'), K9 for the line solvers, in float32
    with the standard mask, else parallel/dist.py's steps.  ``sync`` may
    only be 'auto' or 'color' for them.

    ``impl``: 'auto' launches the kernels for CUDA blocks and runs the
    plain twins for CPU blocks; 'plain' runs the twins on any device.
    ``precond`` is unused by the relaxation solvers.

    The solve is recorded as ``solve``'s is (perf/spans.py), its root span
    on the first block's device, ``cz.route`` over ``dist_route``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    if sync not in SYNCS:
        raise ValueError(f"sync must be one of {SYNCS}, not {sync!r}")
    kind, is_maf = parse_name(solver)
    g = problem.grid
    cmesh.block_shape(g.shape_kij)  # a grid the mesh does not divide
    if kind in KRYLOV and sync not in ("auto", "color"):
        raise ValueError(
            f"sync={sync!r}: the Krylov preconditioner exchanges before "
            "each colour ('color'); the packed path refuses its nonzero b")
    rec = spans.begin(cmesh.devices[0])
    iters = None
    try:
        if kind in KRYLOV:
            result = solve_krylov_dist(problem, cmesh, solver, omega, itr_max,
                                       eps, precond, impl)
        else:
            if rec is not None:
                rec.enter("cz.route")
            route = dist_route(problem, cmesh, solver, omega, impl, sync)
            if rec is not None:
                rec.exit()
            result = run_iterative(route.step, route.x, route.b, g.res_normal,
                                   itr_max, eps, check_every=check_every,
                                   pre=route.pre, post=route.post)
            result = dataclasses.replace(result, x=route.out(result.x))
        iters = result.iters
    finally:
        if rec is not None:
            spans.end(rec, iters)
    return _finish(result, history_path)


@dataclasses.dataclass
class DistRoute:
    """The step a distributed relaxation or line solve runs and the state it
    runs on.  ``kind``: 'pack' (K7, dist_pack.py), 'fused' (K8/K9,
    dist_fused.py), 'plain' (parallel/dist.py) or 'gathered' (the serial
    step on the gathered field).  ``x``/``b``: the starting state and the
    right-hand side in the step's layout (``b`` None where the step skips
    a zero b); ``pre``/``post`` the driver's converters (the gathered
    route's); ``out`` maps the final state to the global (K, I, J) field
    on the device of the problem's x0.  The steps of the block routes carry
    ``exchange`` (their ghost refresh alone, on their state) and
    ``exchanges_per_call``."""
    kind: str
    step: Callable
    x: list
    b: Optional[list]
    out: Callable
    pre: Optional[Callable] = None
    post: Optional[Callable] = None


def dist_route(problem: Problem, cmesh: CubeMesh, solver: str, omega: float,
               impl: str = "auto", sync: str = "auto") -> DistRoute:
    """The route ``solve_dist`` takes for a relaxation or line solver (see
    its docstring), which ``perf.profile.profile_solve`` and
    ``perf.scaling.weak_scaling`` time too.  The step carries the solver's
    name as its profiler label (``steps.labeled``)."""
    kind, is_maf = parse_name(solver)
    g = problem.grid
    if is_maf and problem.mc is None:
        raise ValueError("MAF solver requested but Problem has no MafCoeffs")
    plain = impl == "plain"
    mc_problem = problem if is_maf else dataclasses.replace(problem, mc=None)
    line = kind in dist_fused.LINE_KINDS
    dev = problem.x0.device
    # the kernels' routes take what the JAX package fuses: float32 and the
    # standard mask (its fused steps synthesize the inner mask)
    kernels = g.dtype == torch.float32 and problem.msk_is_standard()

    pack_ok = kernels and kind == "sor2sma" and sync in ("auto", "pack")
    if sync == "pack" and not pack_ok:
        raise ValueError(
            "sync='pack' applies only to sor2sma in float32 with the standard "
            "mask; use sync='auto' to fall back to 'color'")
    if kind in DIAGONAL + EXTENSIONS:
        step, pre, post = make_gathered_step(mc_problem, cmesh, solver, omega,
                                             plain=plain)
        step = labeled(solver, step)
        return DistRoute("gathered", step,
                         cmesh.shard(_initial_x(step, mc_problem)),
                         cmesh.shard(problem.rhs),
                         lambda xs: cmesh.gather(xs, device=dev), pre, post)
    if pack_ok:
        pstep = dist_pack.make_dist_packed_step(mc_problem, cmesh, omega,
                                                plain=plain)
        if pstep is None and sync == "pack":
            raise ValueError(
                "sync='pack' unavailable for this configuration (needs float32, "
                "zero inner RHS, even block extents >= the 2n ghost depth); "
                "use sync='auto' to fall back to 'color'")
        if pstep is not None:
            return DistRoute(
                "pack", labeled(solver, pstep),
                dist_pack.to_packed_state(cmesh, problem.x0, pstep.hs), None,
                lambda xs: dist_pack.from_packed_state(
                    cmesh, xs, g.shape_kij, pstep.hs, device=dev))

    b_is_zero = problem.rhs_is_inner_zero()
    step = None
    if kernels and (line or not is_maf):
        if sync != "overlap":
            step = dist_fused.make_dist_fused_step(
                mc_problem, cmesh, kind, omega, b_is_zero=b_is_zero, plain=plain,
                sync="iter" if sync == "iter" else "color")
        elif kind == "sor2sma":
            step = dist_fused.make_dist_fused_overlap_step(
                problem, cmesh, omega, b_is_zero=b_is_zero, plain=plain)
    if step is not None:
        return DistRoute(
            "fused", labeled(solver, step),
            dist_fused.to_block_state(cmesh, problem.x0),
            None if b_is_zero else dist_fused.to_block_state(cmesh, problem.rhs),
            lambda xs: dist_fused.from_block_state(cmesh, xs, g.shape_kij,
                                                   device=dev))
    return plain_route(mc_problem, cmesh, solver, omega,
                       overlap=sync == "overlap")


def plain_route(problem: Problem, cmesh: CubeMesh, solver: str, omega: float,
                overlap: bool = False) -> DistRoute:
    """The 'plain' route: parallel/dist.py's step on owned blocks (plain
    torch on the blocks' devices), where ``dist_route`` sends float64, the
    MAF point sweeps off the packed path, jacobi with sync='overlap' and a
    non-standard mask."""
    step = make_dist_step(problem, cmesh, solver, omega, overlap=overlap)
    dev = problem.x0.device
    return DistRoute("plain", labeled(solver, step), cmesh.shard(problem.x0),
                     cmesh.shard(problem.rhs),
                     lambda xs: cmesh.gather(xs, device=dev))


def _finish(result: SolveResult, history_path) -> SolveResult:
    if history_path:
        result.write_history(history_path)
    return result
