"""Measured per-phase profiling of solver runs — the PMlib report with real
section timings (PM.start/stop around every kernel and comm call,
cz.h:506-539, report cz_Evaluate.cpp:506-544; PyTorch port of
``cubez_tpu/perf/profile.py``).

Phases are measured by timing the pieces of the step ``solve`` or
``solve_dist`` runs (sweeps alone, the ghost exchange alone, the residual
fold alone) over a fixed iteration count, with CUDA events on the card
(``pmlib.Timer``), the median of 3 after a warm-up, and attributing
analytic flop/byte costs (roofline.py; the reference accumulates flops
analytically inside each kernel too, cz_solver.f90:238-241).  COMM bytes
use the reference's accounting: 2 (send+recv) x 2 (both directions) x face
area x itemsize per axis per exchange (cz_Evaluate.cpp:181-184).
"""

from __future__ import annotations

import torch

from ..cuda_kernels.dist_halo import fold_partials, psum_all
from ..parallel.api import dist_route
from ..parallel.dist_fused import LINE_KINDS
from ..solvers.driver import fixed_sweeps, run_iterative
from ..solvers.fused_cache import relaxation_route
from ..solvers.steps import EXTENSIONS, KRYLOV, parse_name
from .pmlib import CALC, COMM, PerfMonitor, Timer, device_hbm_gbps, device_peak_gflops
from .roofline import sweep_cost

# bytes a residual fold moves: one float64 sum sent and received
FOLD_BYTES = 2 * 8


def _timed(fn, *args, reps: int = 3, device=None):
    """Median seconds of fn(*args) after a warm-up call: CUDA events around
    each call on a CUDA ``device``, the host clock elsewhere
    (``pmlib.Timer``)."""
    fn(*args)  # warm: kernel build, launch arguments, buffers
    ts = []
    for _ in range(reps):
        with Timer(device) as t:
            fn(*args)
        ts.append(t.seconds)
    ts.sort()
    return ts[len(ts) // 2]


def comm_bytes_per_exchange(block_shape, itemsize: int) -> int:
    """CBrick width-1 6-face halo volume per exchange per device
    (comm_size = 2*2*(xy+yz+xz)*sizeof, cz_Evaluate.cpp:181-184)."""
    lk, li, lj = block_shape
    return 2 * 2 * (lk * li + li * lj + lj * lk) * itemsize


def calls_for(step, iters: int):
    """(calls of ``step``, calls of ``step.single``) that run exactly
    ``iters`` iterations: whole calls of a multi-iteration step, then the
    rest one at a time, as run_iterative replays a stopping chunk."""
    ipc = getattr(step, "iters_per_call", 1)
    return iters // ipc, iters % ipc


def exact_sweeps(step, iters: int):
    """``fn(x, b)``: exactly ``iters`` iterations of ``step``
    (``calls_for``)."""
    ipc = getattr(step, "iters_per_call", 1)
    single = getattr(step, "single", step)
    n, rest = calls_for(step, iters)

    def run(x, b):
        x = fixed_sweeps(step, x, b, n * ipc)
        return fixed_sweeps(single, x, b, rest)

    return run


def _fold(cmesh, plain: bool):
    """The route's residual fold of one float64 partial a block: one
    ``fold_partials`` launch where every block shares a card (the fused
    steps' ``Residual``; K7 folds inside its own launch), else
    ``psum_all`` in block order."""
    dev0 = cmesh.devices[0]
    if not plain and dev0.type == "cuda" and set(cmesh.devices) == {dev0}:
        parts = torch.zeros(cmesh.size, dtype=torch.float64, device=dev0)
        return lambda: fold_partials(parts, cmesh.size)
    blocks = [torch.zeros((), dtype=torch.float64, device=d)
              for d in cmesh.devices]
    return lambda: psum_all(blocks)


def profile_solve(problem, solver: str, omega: float, iters: int = 50,
                  cmesh=None, impl: str = "auto") -> PerfMonitor:
    """Measure per-phase sections for ``iters`` iterations of ``solver``,
    a relaxation or line solver, on the step its solve runs.

    Serial (``solvers.fused_cache.relaxation_route``, the step ``solve``
    runs): ``<solver>_sweep``, exactly ``iters`` iterations (whole calls
    of a multi-iteration step, the rest on ``step.single``), with their
    flops and bytes; ``driver_overhead``, ``run_iterative`` at eps 0 over
    ``iters`` iterations less those sweeps (its chunking, snapshot,
    history and replay).  Distributed (``cmesh``;
    ``parallel.api.dist_route``, the route ``solve_dist`` takes):
    ``halo_exchange`` (COMM; the route's exchange alone, as many times as
    the step exchanges in those iterations: before each colour on K8/K9
    and parallel/dist.py, once a call of n iterations on the pack ring),
    ``residual_allreduce`` (COMM; the fold once a call), and
    ``<solver>_block_sweep`` (CALC; the step less the two).  The gathered
    route (psor, pcr_gs) exchanges nothing an iteration: its profile is
    the sweep alone.  Times are the device's own on the card (CUDA events
    on the first block's device), the host's on the CPU."""
    kind, _ = parse_name(solver)
    if kind in KRYLOV + EXTENSIONS:
        raise ValueError(f"profile_solve times relaxation and line solvers, "
                         f"not {solver!r} (the CLI profiles sor2sma for it)")
    g = problem.grid
    name = solver.lower()
    itemsize = torch.empty((), dtype=g.dtype).element_size()
    dev = problem.x0.device if cmesh is None else cmesh.devices[0]
    pm = PerfMonitor(hbm_gbps=device_hbm_gbps(dev),
                     peak_gflops=device_peak_gflops(dev, g.dtype), device=dev)
    b_is_zero = problem.rhs_is_inner_zero()

    if cmesh is None:
        flops1, bytes1 = sweep_cost(name, g.shape_kij, itemsize, b_is_zero)
        step, pre, post = relaxation_route(problem, solver, omega, impl)
        x = problem.x0 if pre is None else pre(problem.x0)
        b = problem.rhs if pre is None else pre(problem.rhs)
        t_sweeps = _timed(exact_sweeps(step, iters), x, b, device=dev)
        pm.add(f"{solver}_sweep", t_sweeps, kind=CALC, flops=flops1 * iters,
               bytes=bytes1 * iters, calls=iters)
        t_loop = _timed(lambda: run_iterative(step, x, b, g.res_normal, iters,
                                              eps=0.0), device=dev)
        pm.add("driver_overhead", max(t_loop - t_sweeps, 0.0), kind=CALC,
               calls=iters)
        return pm

    # ---- distributed ------------------------------------------------------
    route = dist_route(problem, cmesh, solver, omega, impl)
    step = route.step
    bs = cmesh.block_shape(g.shape_kij)
    form = line_n = None
    if kind in LINE_KINDS and route.kind in ("fused", "plain"):
        if getattr(step, "solver", None) == "fastdiag":
            form = "thomas"  # K9 'fastdiag': whole K-lines
        else:
            form, line_n = "pcr", bs[0]  # block-local lines
    flops1, bytes1 = sweep_cost(name, g.shape_kij, itemsize, b_is_zero,
                                form=form, line_n=line_n)
    x = route.x if route.pre is None else route.pre(route.x)
    b = route.b if route.pre is None or route.b is None else route.pre(route.b)
    t_step = _timed(exact_sweeps(step, iters), x, b, device=dev)

    t_comm = 0.0
    exchange = getattr(step, "exchange", None)
    if exchange is not None:
        n, rest = calls_for(step, iters)
        single = getattr(step, "single", step)
        n_exch = n * step.exchanges_per_call + rest * single.exchanges_per_call
        n_fold = n + rest

        def halo(xs):
            for _ in range(n_exch):
                exchange(xs)

        fold = _fold(cmesh, impl == "plain")

        def folds():
            for _ in range(n_fold):
                fold()

        t_halo = _timed(halo, x, device=dev)
        t_fold = _timed(folds, device=dev)
        pm.add("halo_exchange", t_halo, kind=COMM,
               bytes=comm_bytes_per_exchange(bs, itemsize) * n_exch,
               calls=n_exch)
        pm.add("residual_allreduce", t_fold, kind=COMM,
               bytes=FOLD_BYTES * n_fold, calls=n_fold)
        t_comm = t_halo + t_fold
    pm.add(f"{name}_block_sweep", max(t_step - t_comm, 0.0), kind=CALC,
           flops=flops1 * iters, bytes=bytes1 * iters, calls=iters)
    return pm
