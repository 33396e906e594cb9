"""The port's explicit distributed steps (parallel/dist.py) and the
distributed line solves against the JAX package on the conftest's eight
CPU devices: three steps of each ``make_dist_step`` form (jacobi, sor2sma,
their overlapped exchange, the line solvers, MAF, float64, a non-standard
mask) from a seeded field against JAX's jnp shard_map step, and the
``solve_dist`` counts of pcr_rb and pcr_rb_maf at 32^3 over (2, 2, 2) and
(1, 2, 4) against the JAX package's ``solve_dist`` on the same mesh.

Bands (XLA fuses the jitted steps and rounds differently from the port,
which rounds each torch operation): the point sweeps within 1e-6 in
float32, as tests/test_torch_dist_fused.py holds the fused steps; the line
steps within 2e-6 (the stage recurrence's products contract into fused
multiply-adds); MAF within 2e-5 (its weighted sums contract too); float64
within 1e-12; r2 to rtol 1e-4 (1e-3 MAF): JAX sums dp^2 per block in the
field's dtype, the port in float64.  The port's own overlapped exchange
is bitwise its sequential one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.parallel.api import solve_dist as j_solve_dist
from cubez_tpu.parallel.dist import make_dist_step as j_make_dist_step
from cubez_tpu.parallel.mesh import make_mesh as j_make_mesh

import cubez_tpu_torch as czt
from cubez_tpu_torch.parallel import dist as tdist

torch.set_num_threads(1)

N = 16


def _problems(n, dtype, maf, masked):
    """(JAX problem, port problem) of the reference cube, with a hole in
    the mask when ``masked``."""
    jdt = jnp.float64 if dtype == "f64" else jnp.float32
    tdt = torch.float64 if dtype == "f64" else torch.float32
    jp = JProblem.poisson_cube(n, dtype=jdt, maf=maf)
    tp = czt.Problem.poisson_cube(n, dtype=tdt, device="cpu", maf=maf)
    if masked:
        msk = np.asarray(jp.msk).copy()
        msk[5, 6, 7] = 0.0
        msk[9, 3:6, 10] = 0.0
        jp = dataclasses.replace(jp, msk=jnp.asarray(msk))
        tp = dataclasses.replace(tp, msk=torch.tensor(msk))
    return jp, tp


@pytest.mark.parametrize("name,omega,dtype,masked,overlap", [
    ("jacobi", 0.8, "f32", False, False),
    ("jacobi", 0.8, "f32", False, True),
    ("sor2sma", 1.5, "f32", False, False),
    ("sor2sma", 1.5, "f32", False, True),
    ("pcr_j_esa", 1.0, "f32", False, False),
    ("pcr_rb", 1.5, "f32", False, False),
    ("jacobi_maf", 0.8, "f32", False, False),
    ("sor2sma_maf", 1.5, "f32", False, False),
    ("pcr_rb_maf", 1.2, "f32", False, False),
    ("sor2sma", 1.5, "f64", False, False),
    ("pcr_rb", 1.5, "f64", False, False),
    ("jacobi", 0.8, "f32", True, False),
    ("pcr_rb", 1.5, "f32", True, False),
])
def test_dist_step_matches_jax_dist_step(name, omega, dtype, masked, overlap):
    maf = name.endswith("_maf")
    jp, tp = _problems(N, dtype, maf, masked)
    rng = np.random.default_rng(8)
    x0 = rng.standard_normal((N, N, N)).astype(np.float64 if dtype == "f64"
                                                else np.float32)
    b0 = rng.standard_normal(x0.shape).astype(x0.dtype)
    jm = j_make_mesh((N, N, N), devices=jax.devices("cpu")[:8], div=(2, 2, 2))
    tm = czt.make_mesh((N, N, N), devices=["cpu"] * 8, div=(2, 2, 2))
    jstep = jax.jit(j_make_dist_step(jp, jm, name, omega, overlap=overlap))
    tstep = tdist.make_dist_step(tp, tm, name, omega, overlap=overlap)
    xj, bj = jm.shard(jnp.asarray(x0)), jm.shard(jnp.asarray(b0))
    xt, bt = tm.shard(torch.tensor(x0)), tm.shard(torch.tensor(b0))
    for _ in range(3):
        xj, rj = jstep(xj, bj)
        xt, rt = tstep(xt, bt)
    got = tm.gather(xt).numpy()
    line = name.startswith("pcr")
    if dtype == "f64":
        tol = 1e-12
    elif maf:
        tol = 2e-5
    else:
        tol = 2e-6 if line else 1e-6
    np.testing.assert_allclose(got, np.asarray(xj), rtol=0, atol=tol)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-3 if maf else 1e-4)
    if masked:  # the hole never moves
        assert got[5, 6, 7] == x0[5, 6, 7]


def test_overlap_step_is_bitwise_the_sequential_one():
    """The overlapped exchange gives the sequential step's field bit for
    bit (a stencil delta is elementwise)."""
    _, tp = _problems(N, "f32", False, False)
    tm = czt.make_mesh((N, N, N), devices=["cpu"] * 8, div=(2, 4, 1))
    x0 = torch.tensor(np.random.default_rng(9).standard_normal((N, N, N)),
                      dtype=torch.float32)
    for name in ("jacobi", "sor2sma"):
        xs = ys = tm.shard(x0)
        seq = tdist.make_dist_step(tp, tm, name, 1.0)
        ovl = tdist.make_dist_step(tp, tm, name, 1.0, overlap=True)
        bs = tm.shard(tp.rhs)
        for _ in range(2):
            xs, rx = seq(xs, bs)
            ys, ry = ovl(ys, bs)
        assert all(torch.equal(a, b) for a, b in zip(xs, ys))
        assert float(rx) == float(ry)


@pytest.mark.parametrize("div", [(2, 2, 2), (1, 2, 4)])
@pytest.mark.parametrize("name", ["pcr_rb", "pcr_rb_maf"])
def test_solve_dist_line_counts_match_jax(name, div):
    """solve_dist at 32^3, omega 1.5, eight CPU blocks: the port (K9's
    twins, 'pcr' on (2, 2, 2), 'fastdiag' on the K-unsplit (1, 2, 4))
    stops at the JAX package's count (its jnp dist steps), its history
    within rtol 1e-3 and its field within 3e-4 of JAX's."""
    n = 32
    maf = name.endswith("_maf")
    jp = JProblem.poisson_cube(n, dtype=jnp.float32, maf=maf)
    jm = j_make_mesh((n, n, n), devices=jax.devices("cpu")[:8], div=div)
    rj = j_solve_dist(jp, jm, name, omega=1.5, itr_max=2000)
    tp = czt.Problem.poisson_cube(n, device="cpu", maf=maf)
    tm = czt.make_mesh((n, n, n), devices=["cpu"] * 8, div=div)
    rt = czt.solve_dist(tp, tm, name, omega=1.5, itr_max=2000)
    assert rt.iters == rj.iters
    if div == (1, 2, 4):  # K-unsplit: the serial count
        assert rt.iters == 140
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=1e-3)
    assert float(np.abs(rt.x.numpy() - np.asarray(rj.x)).max()) < 3e-4
