"""The port's block mesh and its packed distributed path (K7) against the
JAX package on the conftest's eight CPU devices: the decomposition search,
the block order, the halo exchange, the extended packed layout, K7's twin
through ``make_dist_packed_step`` against JAX's interpreted step (owned
cells bitwise, residuals to rtol 2e-5: JAX folds its owned partials in
float32, the port in float64), the dryrun's packed convergence proofs and
the refusals."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cubez_tpu import Problem as JProblem
from cubez_tpu.parallel import decomp as jdecomp
from cubez_tpu.parallel import dist_pack as jdp
from cubez_tpu.parallel.halo import exchange_halo as j_exchange_halo
from cubez_tpu.parallel.halo import psum_all as j_psum_all
from cubez_tpu.parallel.mesh import FIELD_SPEC
from cubez_tpu.parallel.mesh import make_mesh as j_make_mesh
from cubez_tpu.pallas_kernels import dist_rbpack as jdr

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import dist_rbpack as tdr
from cubez_tpu_torch.cuda_kernels import rbpack as trb
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.parallel import decomp, dist_pack, halo

torch.set_num_threads(1)

OMEGA = 1.5
N = 16


def _jmesh(n, div):
    nd = div[0] * div[1] * div[2]
    return j_make_mesh((n, n, n), devices=jax.devices("cpu")[:nd], div=div)


def _tmesh(n, div):
    nd = div[0] * div[1] * div[2]
    return czt.make_mesh((n, n, n), devices=["cpu"] * nd, div=div)


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("gsize", [(32, 32, 32), (64, 32, 16), (16, 48, 24),
                                   (12, 20, 128)])
def test_auto_division_matches_jax(gsize):
    for nproc in range(1, 17):
        assert decomp.auto_division(nproc, gsize) == jdecomp.auto_division(
            nproc, gsize), nproc


def test_make_mesh_checks_and_block_order_match_jax():
    """Blocks in (z, x, y) row-major order: block b is the shard JAX puts on
    the b-th device; shard and gather round-trip."""
    x = _field((16, 24, 8), 1)
    for div in [(2, 2, 2), (2, 4, 1), (1, 2, 4)]:
        jm = j_make_mesh(x.shape, devices=jax.devices("cpu")[:8], div=div)
        tm = czt.make_mesh(x.shape, devices=["cpu"] * 8, div=div)
        blocks = tm.shard(torch.tensor(x))
        devs = list(jax.devices("cpu")[:8])
        for s in jm.shard(jnp.asarray(x)).addressable_shards:
            b = devs.index(s.device)
            np.testing.assert_array_equal(blocks[b].numpy(), x[s.index])
        assert torch.equal(tm.gather(blocks), torch.tensor(x))
    with pytest.raises(ValueError, match="does not match"):
        czt.make_mesh((16, 16, 16), devices=["cpu"] * 4, div=(2, 2, 2))
    with pytest.raises(ValueError, match="not divisible"):
        czt.make_mesh((16, 18, 16), devices=["cpu"] * 8, div=(1, 4, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            czt.make_mesh((16, 16, 16))


def test_exchange_halo_and_psum_match_jax():
    """Width-1 halo (zeros at the mesh edges) and the block-order float64
    sum, against JAX's ppermute/psum under shard_map."""
    x = _field((N, N, N), 2)
    jm, tm = _jmesh(N, (2, 2, 2)), _tmesh(N, (2, 2, 2))
    fn = shard_map(lambda xb: (j_exchange_halo(xb), j_psum_all(jnp.sum(xb))),
                   mesh=jm.mesh, in_specs=(FIELD_SPEC,),
                   out_specs=(FIELD_SPEC, P()))
    jh, js = fn(jm.shard(jnp.asarray(x)))
    th = halo.exchange_halo(tm.shard(torch.tensor(x)), tm)
    # JAX stacks the (10, 10, 10) padded blocks along each mesh axis
    jh = np.asarray(jh)
    for b, blk in enumerate(th):
        iz, ix, iy = tm.coords(b)
        np.testing.assert_array_equal(
            jh[iz * 10:(iz + 1) * 10, ix * 10:(ix + 1) * 10, iy * 10:(iy + 1) * 10],
            blk.numpy())
    ts = halo.psum_all([b.sum() for b in tm.shard(torch.tensor(x))])
    assert ts.dtype == torch.float64
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)


@pytest.mark.parametrize("div", [(2, 2, 2), (2, 4, 1), (1, 2, 1)])
def test_packed_state_roundtrip_and_layout_match_jax(div):
    """to_/from_packed_state round-trip bitwise; each extended packed block
    is JAX's pack_ext_block with its K pad and tile padding stripped."""
    x = _field((N, N, N), 3)
    hs = tuple(4 if d > 1 else 0 for d in div)
    tm = _tmesh(N, div)
    st = dist_pack.to_packed_state(tm, torch.tensor(x), hs)
    back = dist_pack.from_packed_state(tm, st, (N, N, N), hs)
    assert torch.equal(back, torch.tensor(x))
    bs = tm.block_shape((N, N, N))
    Ke, Ie, Je, I2e = tdr.ext_dims(bs, hs)
    I2ep = jdr.ext_dims(bs, hs)[4]
    for b, xb in enumerate(tm.shard(torch.tensor(x))):
        pj = np.asarray(jdr.pack_ext_block(jnp.asarray(xb.numpy()), hs))
        assert st[b].shape == (2, Ke, I2e, Je)
        np.testing.assert_array_equal(pj[2:-2, :I2e, :Je], st[b][0].numpy())
        np.testing.assert_array_equal(pj[2:-2, I2ep:I2ep + I2e, :Je],
                                      st[b][1].numpy())
        assert torch.equal(tdr.unpack_ext_block(st[b], bs, hs), xb)


@functools.lru_cache(maxsize=None)
def _jax_step(div, maf):
    """JAX's interpreted packed step at 16^3, n = 2, built and jitted once;
    and its ring depths."""
    step = jdp.make_dist_packed_step(_jproblem(maf), _jmesh(N, div), OMEGA,
                                     n=2, interpret=True)
    return jax.jit(step), step.hs


@functools.lru_cache(maxsize=None)
def _jproblem(maf):
    """A seeded start with zero RHS; MAF on the stretched grid's
    coefficients."""
    jp = JProblem.poisson_cube(N, dtype=jnp.float32)
    if maf:
        jp = dataclasses.replace(
            jp, mc=JProblem.manufactured_stretched(N, dtype=jnp.float32)[0].mc)
    return dataclasses.replace(jp, x0=jnp.asarray(_field((N, N, N), 4)))


def _tproblem(jp):
    mc = None
    if jp.mc is not None:
        mc = tmaf.MafCoeffs.from_numpy(
            *(np.asarray(getattr(jp.mc, f)) for f in tmaf.FIELDS), device="cpu")
    return czt.Problem.from_arrays((N, N, N), torch.float32, np.asarray(jp.x0),
                                   np.asarray(jp.rhs), rhs_inner_zero=True,
                                   device="cpu", mc=mc)


@pytest.mark.parametrize("div,maf", [((2, 2, 2), False), ((2, 4, 1), False),
                                     ((2, 2, 2), True)])
def test_k7_twin_step_matches_jax_and_serial(div, maf):
    """Two n = 2 steps: owned cells bitwise JAX's interpreted step and the
    port's serial packed twin (four iterations); residuals to rtol 2e-5."""
    jp = _jproblem(maf)
    jstep, hs = _jax_step(div, maf)
    jm = _jmesh(N, div)
    xj = jdp.to_packed_state(jm, jp.x0, hs)
    tp = _tproblem(jp)
    tm = _tmesh(N, div)
    tstep = dist_pack.make_dist_packed_step(tp, tm, OMEGA, n=2)
    assert tstep.hs == hs and tstep.iters_per_call == 2
    xt = dist_pack.to_packed_state(tm, tp.x0, tstep.hs)
    rj, rt = [], []
    for _ in range(2):
        xj, r = jstep(xj, xj)
        rj += np.asarray(r).tolist()
        xt, r = tstep(xt, None)
        rt += r.tolist()
    got = dist_pack.from_packed_state(tm, xt, (N, N, N), tstep.hs)
    want = jdp.from_packed_state(jm, xj, (N, N, N), hs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(rt, rj, rtol=2e-5)
    tab = trb.maf_tables(tp.mc, (N, N, N), torch.float32)
    xs = trb.pack_rb(tp.x0.clone())
    _, rs = trb.packed_sweeps_plain(xs, None, 4, OMEGA, tab=tab)
    assert torch.equal(trb.unpack_rb(xs, (N, N, N)), got)
    np.testing.assert_allclose(rt, rs.numpy(), rtol=1e-6)


@pytest.mark.parametrize("solver", ["sor2sma", "sor2sma_maf"])
def test_dryrun_pack_proof_at_32(solver):
    """The dryrun's packed proofs at 32^3 over (2, 2, 2), on the twins: the
    serial port's 199 iterations, its history, and its field at the stop
    bit for bit."""
    maf = solver.endswith("_maf")
    p = czt.Problem.poisson_cube(32, device="cpu", maf=maf)
    cm = _tmesh(32, (2, 2, 2))
    r = czt.solve_dist(p, cm, solver, omega=OMEGA, itr_max=2000, sync="pack")
    s = czt.solve(p, solver, omega=OMEGA, itr_max=2000)
    assert r.iters == s.iters == 199
    assert torch.equal(r.x, s.x)
    torch.testing.assert_close(r.history, s.history, rtol=1e-6, atol=0)


def test_k7_window_depths_and_single_step():
    """The JAX package's candidate depths (6 first; 2 under MAF), the
    one-iteration form on the same ring, and n = 6 only where blocks hold
    the depth-12 ring."""
    p = czt.Problem.poisson_cube(32, device="cpu")
    step = dist_pack.make_dist_packed_step(p, _tmesh(32, (2, 2, 2)), OMEGA)
    assert step.iters_per_call == 6 and step.hs == (12, 12, 12)
    assert step.single.iters_per_call == 1 and step.single.hs == step.hs
    # 8-wide blocks: depth 8 at most, so n = 4; an unsplit axis has no ring
    step = dist_pack.make_dist_packed_step(p, _tmesh(32, (4, 1, 1)), OMEGA)
    assert step.iters_per_call == 4 and step.hs == (8, 0, 0)
    pm = czt.Problem.poisson_cube(32, device="cpu", maf=True)
    step = dist_pack.make_dist_packed_step(pm, _tmesh(32, (2, 2, 2)), OMEGA)
    assert step.iters_per_call == 2


def test_pack_refusals_match_jax():
    """Thin blocks, odd blocks, float64 and a nonzero inner RHS:
    make_dist_packed_step returns None and an explicit sync='pack' raises, as in the JAX package;
    a grid the mesh does not divide raises ValueError."""
    p = czt.Problem.poisson_cube(N, device="cpu")
    jthin = jdp.make_dist_packed_step(JProblem.poisson_cube(N, dtype=jnp.float32),
                                      _jmesh(N, (8, 1, 1)), OMEGA, n=2)
    assert jthin is None
    assert dist_pack.make_dist_packed_step(p, _tmesh(N, (8, 1, 1)), OMEGA,
                                           n=2) is None
    with pytest.raises(ValueError, match="pack"):
        czt.solve_dist(p, _tmesh(N, (8, 1, 1)), "sor2sma", omega=OMEGA,
                       itr_max=4, sync="pack")
    # odd blocks refuse rather than mis-colour: 18 / 2 = 9
    odd = czt.Problem.poisson_cube(18, device="cpu")
    assert dist_pack.make_dist_packed_step(odd, _tmesh(18, (2, 1, 1)),
                                           OMEGA) is None
    assert tdr.make_dist_packed_sweepnx((9, 18, 18), (18, 18, 18),
                                        omega=OMEGA, n=2) is None
    p64 = czt.Problem.poisson_cube(N, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="pack"):
        czt.solve_dist(p64, _tmesh(N, (2, 2, 2)), "sor2sma", omega=OMEGA,
                       itr_max=4, sync="pack")
    pb = dataclasses.replace(p, rhs=torch.ones_like(p.rhs), rhs_inner_zero=False)
    assert dist_pack.make_dist_packed_step(pb, _tmesh(N, (2, 2, 2)), OMEGA) is None
    with pytest.raises(ValueError, match="pack"):
        czt.solve_dist(pb, _tmesh(N, (2, 2, 2)), "sor2sma", omega=OMEGA,
                       itr_max=4, sync="pack")
    with pytest.raises(ValueError, match="pack"):
        czt.solve_dist(p, _tmesh(N, (2, 2, 2)), "jacobi", omega=0.8,
                       itr_max=4, sync="pack")
    with pytest.raises(ValueError, match="not divisible"):
        czt.solve_dist(czt.Problem.poisson_cube(18, device="cpu"),
                       _tmesh(N, (1, 4, 1)), "sor2sma", omega=OMEGA, itr_max=4)
