"""Weak-scaling harness over the block mesh (PyTorch port of
``cubez_tpu/perf/scaling.py``).

The reference documents multi-node runs only as mpirun invocations
(example/scripts.txt); this module makes scaling a first-class measurement:
run the same block size per mesh block over growing meshes and report
parallel efficiency.  Each point runs the route ``solve_dist`` takes
(``parallel.api.dist_route``) and records which one ran, and on how many
distinct devices its blocks sit.  Blocks that share one card (``devices=
["cuda:0"] * 8``) measure the mesh's cost on that card, not scaling, and
the report says so.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.problem import Problem
from ..parallel.api import dist_route, plain_route
from ..parallel.decomp import auto_division
from ..parallel.mesh import make_mesh
from ..solvers.steps import parse_name
from .profile import _timed, exact_sweeps

IMPLS = ("auto", "fused", "plain")


@dataclasses.dataclass
class ScalePoint:
    n_devices: int  # mesh blocks
    div: tuple
    global_shape: tuple
    iters: int
    seconds: float
    # the route that ran: "fused" (the kernels' block routes, dist_pack.py
    # and dist_fused.py, their twins on CPU blocks), "plain"
    # (parallel/dist.py) or "gathered" (the serial step on the gathered
    # field); a harness that fell back silently would measure another path
    step_impl: str = "plain"
    cards: int = 1  # distinct devices the blocks sit on

    @property
    def cells_per_s(self) -> float:
        nk, ni, nj = self.global_shape
        inner = (nk - 2) * (ni - 2) * (nj - 2)
        return inner * self.iters / self.seconds


def weak_scaling(
    block: int = 64,
    solver: str = "sor2sma",
    omega: float = 1.5,
    iters: int = 50,
    device_counts=None,
    impl: str = "auto",
    devices=None,
) -> list[ScalePoint]:
    """Fixed block per mesh block, growing mesh; returns one point per
    count.  ``devices``: one device per block, the first n for a count of
    n (repeats allowed: ``["cuda:0"] * 8`` puts every block on one card);
    default the visible CUDA devices.  ``device_counts`` defaults to those
    of 1, 2, 4, 8 that ``devices`` covers.

    ``impl='auto'`` measures the route ``solve_dist`` takes; 'fused'
    requires the kernels' block routes (ValueError where the solver has
    none); 'plain' pins parallel/dist.py (the JAX package's 'jnp').  Each
    point times exactly ``iters`` iterations after a warm-up, the median
    of 3 (CUDA events on a card)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("weak_scaling: no CUDA device; pass devices "
                               "(e.g. ['cpu'] * 8) to run blocks elsewhere")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    _, is_maf = parse_name(solver)
    points = []
    for n in device_counts:
        # grow the cube so each block holds a block^3 region
        div = auto_division(n, (10**9, 10**9, 10**9))
        gsize = tuple(block * d for d in div)
        cm = make_mesh(gsize, devices=devices[:n], div=div)
        prob = Problem.poisson_cube((gsize[1], gsize[2], gsize[0]),
                                    device=devices[0], maf=is_maf)
        if impl == "plain":
            route = plain_route(prob, cm, solver, omega)
        else:
            route = dist_route(prob, cm, solver, omega)
        step_impl = "fused" if route.kind in ("pack", "fused") else route.kind
        if impl == "fused" and step_impl != "fused":
            raise ValueError(f"{solver!r} has no kernel block route here "
                             f"(it runs the {route.kind!r} route)")
        x = route.x if route.pre is None else route.pre(route.x)
        b = route.b if route.pre is None or route.b is None else route.pre(route.b)
        dt = _timed(exact_sweeps(route.step, iters), x, b, device=devices[0])
        points.append(
            ScalePoint(
                n_devices=n, div=div, global_shape=gsize, iters=iters,
                seconds=dt, step_impl=step_impl, cards=len(set(devices[:n])),
            )
        )
    return points


def efficiency(points: list[ScalePoint]) -> list[float]:
    """Weak-scaling efficiency vs the 1-device point (1.0 = perfect)."""
    if not points:
        return []
    base = points[0].cells_per_s / points[0].n_devices
    return [p.cells_per_s / p.n_devices / base for p in points]


def report(points: list[ScalePoint]) -> str:
    eff = efficiency(points)
    lines = [f"{'devs':>5} {'mesh':>10} {'grid':>16} {'Mcells/s':>10} {'eff':>6}"]
    for p, e in zip(points, eff):
        lines.append(
            f"{p.n_devices:>5} {str(p.div):>10} {str(p.global_shape):>16} "
            f"{p.cells_per_s / 1e6:>10.1f} {e:>6.2f}"
        )
    shared = [p for p in points if p.cards < p.n_devices]
    if shared:
        lines.append(
            f"blocks share devices ({', '.join(f'{p.n_devices} on {p.cards}' for p in shared)}): "
            "the efficiency measures the mesh's cost there, not scaling")
    return "\n".join(lines)
