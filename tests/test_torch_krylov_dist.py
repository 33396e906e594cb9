"""The Krylov solvers on a block mesh (parallel/krylov.py) on CPU blocks:
the block vector operations against the serial ones, and solve_dist of
pbicgstab, pbicgstab_maf and cg over (2, 2, 2) and (1, 2, 2) against the
serial port (count +-1, Error max to rtol 1e-2).

The preconditioner takes solve_dist's route for its name: float32 with the
standard mask runs the K8 (jacobi, sor2sma) and K9 (line kinds) twins on
ghosted blocks, everything else parallel/dist.py's steps.  Over a K-split
mesh the line preconditioners solve block-local K-lines, another operator
than the serial one, so the solve converges to the same eps along another
path: its count is held to the serial one and its Error max only to
eps's reach."""

import dataclasses

import numpy as np
import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu_torch.parallel import krylov
from cubez_tpu_torch.solvers import bicgstab

torch.set_num_threads(1)

N = 32


def _mesh(div, n=N):
    return czt.make_mesh((n, n, n) if isinstance(n, int) else n,
                         devices=["cpu"] * (div[0] * div[1] * div[2]), div=div)


def _serial_and_dist(p, div, solver, precond, omega):
    rs = czt.solve(p, solver, omega=omega, itr_max=4000, precond=precond)
    rd = czt.solve_dist(p, _mesh(div, p.grid.shape_kij), solver, omega=omega,
                        itr_max=4000, precond=precond)
    return rs, rd


@pytest.mark.parametrize("div", [(2, 2, 2), (1, 2, 2)])
@pytest.mark.parametrize("solver,precond,omega,dtype", [
    ("pbicgstab", "sor2sma", 1.1, torch.float32),
    ("pbicgstab", "sor2sma", 1.1, torch.float64),
    ("pbicgstab", "jacobi", 0.8, torch.float32),
    ("pbicgstab", "pcr_rb", 1.1, torch.float32),
    ("pbicgstab", "pcr_j_esa", 1.0, torch.float32),
    ("pbicgstab", "none", 1.1, torch.float64),
    ("pbicgstab_maf", "sor2sma_maf", 1.1, torch.float32),
    ("pbicgstab_maf", "pcr_rb_maf", 1.1, torch.float32),
    ("cg", "jacobi", 0.8, torch.float32),
    ("cg", None, 0.8, torch.float64),
])
def test_solve_dist_krylov_matches_serial(solver, precond, omega, dtype, div):
    p = czt.Problem.poisson_cube(N, dtype=dtype, device="cpu",
                                 maf=solver.endswith("_maf"))
    rs, rd = _serial_and_dist(p, div, solver, precond, omega)
    assert abs(rd.iters - rs.iters) <= 1 and rd.res < 1e-5
    assert rd.x.shape == (N,) * 3 and rd.x.dtype == dtype
    es, ed = czt.max_error(p.grid, rs.x), czt.max_error(p.grid, rd.x)
    line = precond is not None and precond.startswith("pcr")
    if line and div[0] > 1:
        assert ed < 2 * es
    else:
        assert ed == pytest.approx(es, rel=1e-2)


def test_solve_dist_stretched_krylov_family():
    """pbicgstab_maf with sor2sma_maf on the stretched grid ("krylov" sign,
    float64: dist.py's MAF sweeps and the block MAF operator) stops where
    the serial solve stops, on its field."""
    p, _ = czt.Problem.manufactured_stretched(16, dtype=torch.float64,
                                              family="krylov", device="cpu")
    rs, rd = _serial_and_dist(p, (2, 2, 2), "pbicgstab_maf", "sor2sma_maf", 1.1)
    assert abs(rd.iters - rs.iters) <= 1
    torch.testing.assert_close(rd.x, rs.x, rtol=0, atol=1e-6)


def _seeded(shape, dtype, n, seed=11):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape)).to(dtype)
            for _ in range(n)]


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_ops_match_serial(dtype, maf):
    """Each block op gathers to the serial op's field bit for bit; the dots
    (blocks' partials folded in float64, cast back) to rtol 1e-6 in
    float32 and 1e-13 in float64."""
    shape = (12, 8, 16)  # (K, I, J)
    if maf:
        p, _ = czt.Problem.manufactured_stretched((8, 16, 12), dtype=dtype,
                                                  family="krylov", device="cpu")
    else:
        p = czt.Problem.poisson_cube((8, 16, 12), dtype=dtype, device="cpu")
    cm = _mesh((2, 2, 2), shape)
    mc = p.mc if maf else None
    ser = bicgstab.VectorOps(p, mc, None)
    blk = krylov.BlockOps(p, cm, mc, None)
    x, y, z = (v * p.msk for v in _seeded(shape, dtype, 3))
    sx, sy, sz = (cm.shard(v) for v in (x, y, z))
    a, b = ser.scalar(0.37), ser.scalar(-1.6)
    pairs = [
        (ser.ax(x), blk.ax(sx)), (ser.rk(x, y), blk.rk(sx, sy)),
        (ser.triad(x, y, a), blk.triad(sx, sy, a)),
        (ser.bicg_1(x, y, z, a, b), blk.bicg_1(sx, sy, sz, a, b)),
        (ser.bicg_2(x, y, z, a, b), blk.bicg_2(sx, sy, sz, a, b)),
        (ser.axpy(x, a, y), blk.axpy(sx, a, sy)), (ser.neg(x), blk.neg(sx)),
    ]
    for want, got in pairs:
        assert torch.equal(cm.gather(got), want)
    rtol = 1e-6 if dtype == torch.float32 else 1e-13
    for want, got in ((ser.dot1(x), blk.dot1(sx)), (ser.dot2(x, y), blk.dot2(sx, sy))):
        assert got.dtype == dtype and got.dim() == 0
        torch.testing.assert_close(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("precond", ["jacobi", "sor2sma", "pcr_rb", "pcr_j_esa",
                                     "jacobi_maf"])
def test_dist_precon_result_is_its_own(precond):
    """The block preconditioner's result holds after the next application,
    on every route (K8, K9, dist.py)."""
    p = czt.Problem.poisson_cube(16, device="cpu", maf=True)
    cm = _mesh((2, 2, 2), 16)
    pre = krylov.make_dist_precon(p, cm, precond, 0.8)
    v, w = (cm.shard(t * p.msk) for t in _seeded((16,) * 3, torch.float32, 2))
    first = pre(v)
    kept = [t.clone() for t in first]
    pre(w)
    assert all(torch.equal(a, b) for a, b in zip(first, kept))


@pytest.mark.parametrize("solver,kw,exc,match", [
    ("pbicgstab", {"precond": "psor"}, NotImplementedError, "slice 6"),
    ("pbicgstab", {"precond": "mg"}, NotImplementedError, "slice 7"),
    ("cg", {"precond": "sor2sma"}, ValueError, "symmetric"),
    ("pbicgstab", {"precond": "sor2sma", "sync": "pack"}, ValueError, "sync"),
    ("pbicgstab", {"precond": "sor2sma", "sync": "overlap"}, ValueError, "sync"),
])
def test_solve_dist_krylov_refusals(solver, kw, exc, match):
    """Bad options and unported preconditioners raise.  psor, which raised
    naming slice 6 until it was ported, now preconditions the blocks'
    solve (its serial step on the gathered vector)."""
    p = czt.Problem.poisson_cube(8, device="cpu")
    if match == "slice 6":
        r = czt.solve_dist(p, _mesh((2, 2, 2), 8), solver, omega=1.0,
                           itr_max=10, **kw)
        assert r.res < 1e-5 and 0 < r.iters < 10
        return
    with pytest.raises(exc, match=match):
        czt.solve_dist(p, _mesh((2, 2, 2), 8), solver, omega=1.0, itr_max=4,
                       **kw)


def test_solve_dist_krylov_breakdown_and_history(tmp_path):
    """A zero problem breaks down at once (x0 back, 0 iterations); a
    history file is written as the serial solve writes it."""
    p = czt.Problem.poisson_cube(8, device="cpu")
    z = torch.zeros_like(p.x0)
    q = dataclasses.replace(p, x0=z, rhs=z.clone())
    r = czt.solve_dist(q, _mesh((2, 2, 2), 8), "pbicgstab", omega=1.1,
                       itr_max=10, precond="sor2sma")
    assert r.iters == 0 and torch.equal(r.x, z)
    r = czt.solve_dist(p, _mesh((1, 2, 2), 8), "pbicgstab", omega=1.1,
                       itr_max=3, precond="sor2sma",
                       history_path=tmp_path / "h.txt")
    assert r.iters == 2
    assert len((tmp_path / "h.txt").read_text().splitlines()) == 3
