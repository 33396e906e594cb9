"""Geometric multigrid, solver names ``mg``, ``mg_maf``, ``fmg`` and
``fmg_maf`` (PyTorch port of ``cubez_tpu/solvers/multigrid.py``; an
extension beyond the reference).

One "iteration" is one V(nu1, nu2) cycle on the 7-point operator of
ops/blas.py (``A x = sum(neighbours) - 6 x``, the h^2-scaled Laplacian, so
the coarse equation for the error carries the factor 4 on the restricted
residual), exposed as ``step(x, b) -> (x_new, r2)`` for the driver.  It
stops on the omega = 1 Jacobi-equivalent update ``RMS((b - A x) / 6)``
(``r / dd`` for MAF), computed after each cycle; the sum of its squares
is taken in float64, where the JAX package sums in the field's dtype (the
driver keeps float64 histories).

Vertex-centred coarsening on the inner nodes: coarse inner index c sits at
fine inner index 2c, mc = m // 2 for any m.  Restriction is the 27-point
full weighting (the tensor product of 1D (1/4, 1/2, 1/4)), prolongation
its transpose (trilinear), both on full arrays with a zero shell.  The MAF
cycle (``maf=True``) takes each level's operator from the coarsened node
coordinates and transfers the residual with no factor 4.  ``fmg`` adds one
F-cycle from the RHS as the initial iterate (``step.fmg_init``), with the
Dirichlet shell injected down the hierarchy.

The finest level smooths with the fused red-black sweep: kernel K4 (the
one-pass red-black step of ``cuda_kernels.sweeps.make_fused_sweep``) on
CUDA tensors, its plain twin ``sor2sma_plain`` on the CPU or with
``plain``.  The JAX package picks its fused smoother only for float32 on
a TPU; the port runs K4 in float32 and float64 alike, so no plain twin
runs on the card's path.  The coarse levels and the transfers are plain
torch operations, as they are XLA operations in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.grid import Grid
from ..cuda_kernels import sweeps
from ..ops import blas
from ..ops import stencil
from ..ops.maf import MafCoeffs


def _axis_slice(nd: int, axis: int, sl: slice):
    return tuple(sl if a == axis else slice(None) for a in range(nd))


def _pad1(a, axis: int):
    """``a`` with one zero on each side along ``axis``."""
    pad = [0] * (2 * a.dim())
    pad[2 * (a.dim() - 1 - axis)] = pad[2 * (a.dim() - 1 - axis) + 1] = 1
    return F.pad(a, pad)


def _restrict1(r, axis: int, mc: int):
    """Full-weighting restriction along one axis of a full (shell-padded)
    array: coarse inner c = 1..mc reads fine inner 2c-1, 2c, 2c+1.  The
    result has extent mc + 2 with a zero shell along ``axis``.  The weights
    are powers of two, exact as Python numbers."""
    nd = r.dim()
    mid = r[_axis_slice(nd, axis, slice(2, 2 * mc + 1, 2))]
    lo = r[_axis_slice(nd, axis, slice(1, 2 * mc, 2))]
    hi = r[_axis_slice(nd, axis, slice(3, 2 * mc + 2, 2))]
    return _pad1(lo * 0.25 + mid * 0.5 + hi * 0.25, axis)


def _prolong1(e, axis: int, m: int):
    """Trilinear prolongation along one axis: fine inner 2c takes the
    coarse value, odd fine inner points the mean of their two coarse
    neighbours (the zero shell stands in for the walls).  The result has
    extent m + 2 with a zero shell along ``axis``."""
    nd = e.dim()

    def sl(s, t):
        return _axis_slice(nd, axis, slice(s, t))

    mc = e.shape[axis] - 2
    ec = e[sl(1, mc + 1)]
    odd = (e[sl(0, mc + 1)] + e[sl(1, mc + 2)]) * 0.5
    inter = torch.stack([odd[sl(0, mc)], ec], dim=axis + 1)
    shp = list(ec.shape)
    shp[axis] = 2 * mc
    body = torch.cat([inter.reshape(shp), odd[sl(mc, mc + 1)]], dim=axis)
    # for even m the last of the 2mc + 1 positions is the wall: keep m
    return _pad1(body[sl(0, m)], axis)


def restrict_fw(r, coarse_shape):
    """27-point full-weighting (K, I, J) restriction onto ``coarse_shape``
    (full extents, zero shell)."""
    for ax in range(3):
        r = _restrict1(r, ax, coarse_shape[ax] - 2)
    return r


def prolong(e, fine_shape):
    """Trilinear (K, I, J) prolongation onto ``fine_shape`` (full extents,
    zero shell)."""
    for ax in range(3):
        e = _prolong1(e, ax, fine_shape[ax] - 2)
    return e


@dataclasses.dataclass(frozen=True)
class _Level:
    shape: tuple[int, int, int]  # full extents (K, I, J)
    msk: torch.Tensor
    # the inner mask times each colour's mask (the red-black sweep's two
    # halves, stencil.sor_color_sweep)
    cmasks: tuple[torch.Tensor, torch.Tensor]
    mc: MafCoeffs | None = None  # the variable-coefficient cycle's operator


def _inner_mask(shape, dtype, device):
    m = torch.zeros(shape, dtype=dtype, device=device)
    m[1:-1, 1:-1, 1:-1] = 1.0
    return m


def _coarsen_coords(c, m: int):
    """Coordinates of the coarse nodes along one axis: the walls and the
    fine nodes 2c (c = 1..m // 2).  For even m the last coarse node sits
    one fine spacing from the wall; MafCoeffs.from_coords takes the metric
    from the actual spacings, so the MAF coarse operator is exact there."""
    mcc = m // 2
    return torch.cat([c[0:1], c[2:2 * mcc + 1:2], c[-1:]])


def build_levels(shape_kij, dtype, device, min_inner: int = 2,
                 coords=None) -> list[_Level]:
    """The level hierarchy from the fine grid down to min(inner) // 2 <=
    ``min_inner``.  ``coords``: (zc, xc, yc), the 1D node coordinates along
    (K, I, J), builds a MafCoeffs a level from the coarsened
    coordinates."""
    levels = []
    shape = tuple(int(s) for s in shape_kij)
    while True:
        mc = None
        if coords is not None:
            zc, xc, yc = coords
            mc = MafCoeffs.from_coords(xc, yc, zc)
        msk = _inner_mask(shape, dtype, device)
        colours = stencil.color_masks(shape, 0, dtype, device)
        levels.append(_Level(shape=shape, msk=msk,
                             cmasks=tuple(msk * c for c in colours), mc=mc))
        inner = [s - 2 for s in shape]
        if min(inner) // 2 <= min_inner:
            break
        if coords is not None:
            coords = tuple(_coarsen_coords(c, m) for c, m in zip(coords, inner))
        shape = tuple(m // 2 + 2 for m in inner)
    return levels


def _inject_coarse(f, coarse_shape):
    """Coarsen a full (shell-carrying) array by injection at the coarse
    node positions, full-array index 0, 2c (c = 1..mc), n - 1 an axis (the
    index pattern of :func:`_coarsen_coords`).  Carries the Dirichlet
    shells down the FMG hierarchy: the coarse shell nodes are fine shell
    nodes."""
    for ax in range(3):
        n = f.shape[ax]
        mc = coarse_shape[ax] - 2
        idx = torch.cat([torch.tensor([0]), torch.arange(2, 2 * mc + 1, 2),
                         torch.tensor([n - 1])]).to(f.device)
        f = f.index_select(ax, idx)
    return f


def make_mg_step(grid: Grid, omega: float = 1.0, nu1: int = 1, nu2: int = 1,
                 coarse_sweeps: int = 16, plain: bool = False,
                 b_is_zero: bool = False, maf: bool = False,
                 fmg: bool = False, bc_shell=None):
    """``step(x, b) -> (x_new, r2)``: one V(nu1, nu2) cycle and the float64
    sum of the squared Jacobi-equivalent update (module docstring); x is
    only read, and x_new is a tensor of the step's own, never one of K4's
    buffers (a consumer may hold it across the next call).

    ``omega`` relaxes the red-black smoother (1.0, the smoothing choice).
    The finest level runs K4 for CUDA tensors and its plain twin for CPU
    tensors or with ``plain``; ``b_is_zero`` lets K4 skip the right-hand
    side (the caller drives the step with a zero inner RHS).  ``maf``: the
    variable-coefficient cycle, each level's MafCoeffs from the coarsened
    coordinates of ``grid``, no factor 4 on the residual transfer, and the
    stopping update r / dd.  ``fmg`` adds ``step.fmg_init(b)``, the
    F-cycle from the RHS, with the Dirichlet shell ``bc_shell`` (default
    ``grid.bc_field``) injected down the hierarchy.  ``step.
    check_every_default`` is 2."""
    dt, dev = grid.dtype, grid.device
    coords = (grid.zc, grid.xc, grid.yc) if maf else None
    levels = build_levels(grid.shape_kij, dt, dev, coords=coords)
    # 0-d tensors on the fields' device, made once: a Python divisor turns
    # into a reciprocal multiply on CUDA, and a tensor made in the cycle
    # would be a host-to-device copy
    dd6 = torch.tensor(stencil.DD, dtype=dt, device=dev)
    om = torch.tensor(omega, dtype=dt, device=dev)
    r6 = torch.tensor(1.0 / 6.0, dtype=dt, device=dev)
    dds = [lv.mc.dd if maf else None for lv in levels]
    fine = sweeps.make_fused_sweep(
        "sor2sma", grid.shape_kij, dt, omega=omega, b_is_zero=b_is_zero,
        mc=levels[0].mc, plain=plain)

    def residual(x, b, li):
        lv = levels[li]
        if maf:
            return (b - (dds[li] * x - lv.mc.nbr_weighted(x))) * lv.msk
        return blas.calc_rk(x, b, lv.msk)

    def smooth(x, b, li: int, count: int):
        if li == 0:
            for _ in range(count):
                x, _ = fine(x, b)
            return x
        lv = levels[li]
        # the red-black sweep of ops/stencil.py (ops/maf.py under MAF)
        # without its residual sums, which the cycle never reads
        for _ in range(count):
            for cm in lv.cmasks:
                if maf:
                    rp = lv.mc.nbr_weighted(x) + b
                    x = x + (rp / dds[li] - x) * om * cm
                else:
                    x = x + ((stencil.nbr_sum(x) - b) / dd6 - x) * om * cm
        return x

    def vcycle(x, b, li: int):
        lv = levels[li]
        if li == len(levels) - 1:
            return smooth(x, b, li, coarse_sweeps)
        x = smooth(x, b, li, nu1)
        coarse = levels[li + 1]
        bc = restrict_fw(residual(x, b, li), coarse.shape) * coarse.msk
        if not maf:
            bc = bc * 4.0
        ec = vcycle(torch.zeros(coarse.shape, dtype=dt, device=x.device), bc,
                    li + 1)
        x = x + prolong(ec, lv.shape) * lv.msk
        return smooth(x, b, li, nu2)

    def own(x):
        """x, or a copy where it is one of K4's two buffers, which the
        next fine-level sweep rewrites."""
        return x.clone() if x.is_cuda and not plain else x

    def step(x, b):
        x = own(vcycle(x, b, 0))
        r = residual(x, b, 0)
        r = r / dds[0] if maf else r * r6
        return x, (r * r).sum(dtype=torch.float64)

    if fmg:
        shell0 = grid.bc_field if bc_shell is None else bc_shell
        bcs = [shell0 * (1.0 - levels[0].msk)]
        for lv in levels[1:]:
            bcs.append(_inject_coarse(bcs[-1], lv.shape))

        def fmg_init(b):
            """One F-cycle from the RHS alone: the initial iterate, with
            discretization-level error."""
            bl = b * levels[0].msk  # the RHS's shell is never read
            bs_ = [bl]
            for lv in levels[1:]:
                bl = restrict_fw(bl, lv.shape) * lv.msk
                if not maf:
                    bl = bl * 4.0
                bs_.append(bl)
            li = len(levels) - 1
            x = bcs[li] + torch.zeros(levels[li].shape, dtype=b.dtype,
                                      device=b.device)
            x = smooth(x, bs_[li], li, coarse_sweeps)
            for li in range(len(levels) - 2, -1, -1):
                lv = levels[li]
                # the prolongation's end averages read the coarse shell, so
                # the boundary data shapes the first fine layer
                x = prolong(x, lv.shape) * lv.msk + bcs[li]
                x = vcycle(x, bs_[li], li)
            return own(x)

        step.fmg_init = fmg_init

    # a V-cycle dwarfs the convergence check, and a chunk of 16 would run
    # up to 15 surplus cycles of a solve that stops after about 6
    step.check_every_default = 2
    return step
