"""The packed distributed path's one-launch forms (cuda_kernels/
dist_rbpack.py) on the CPU: the ring refresh's plain twin (every ring cell
copied from the block that owns it) against the three-phase transitive
slab copy of parallel/dist_pack.py, edges and corners included; the
batched step's plain form (owner gather, K7's twin on every block, one
float64 fold) against the JAX package's make_dist_packed_step on the
conftest's CPU devices (owned cells bitwise, r2 to rtol 2e-5: JAX folds
its owned partials in float32); the launchers' refusals."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.parallel import dist_pack as jdp
from cubez_tpu.parallel.mesh import make_mesh as j_make_mesh

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import dist_rbpack as tdr
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.parallel import dist_pack

torch.set_num_threads(1)

OMEGA = 1.5
N = 16
MESHES = [(2, 2, 2), (2, 1, 1), (1, 2, 2)]


def _tmesh(gshape, div):
    return czt.make_mesh(gshape, devices=["cpu"] * (div[0] * div[1] * div[2]),
                         div=div)


def _poisoned_state(gshape, div, n, seed):
    """Packed blocks of a seeded field whose ring cells inside the grid
    hold other seeded values (as K7's redundant updates leave them); ring
    cells past the grid keep the packing's zeros, as on the path."""
    cm = _tmesh(gshape, div)
    hs = tuple(2 * n if d > 1 else 0 for d in div)
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(gshape), dtype=torch.float32)
    st = dist_pack.to_packed_state(cm, x, hs)
    bs = cm.block_shape(gshape)
    Ke, Ie, Je, _ = tdr.ext_dims(bs, hs)
    for b, o in enumerate(cm.offsets(gshape)):
        idx = [torch.arange(e) + (oo - h) for e, oo, h in zip((Ke, Ie, Je), o, hs)]
        inside = ((idx[0] >= 0) & (idx[0] < gshape[0]))[:, None, None] & (
            (idx[1] >= 0) & (idx[1] < gshape[1]))[None, :, None] & (
            (idx[2] >= 0) & (idx[2] < gshape[2]))[None, None, :]
        noise = torch.tensor(rng.standard_normal(st[b].shape), dtype=torch.float32)
        st[b] = torch.where(tdr.pack_rb(inside.float()) > 0, noise, st[b])
    return cm, bs, hs, st


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("div", MESHES)
def test_owner_gather_is_bitwise_the_transitive_copy(div, n):
    """exchange_packed_plain (the one-launch exchange's twin) writes every
    ring cell, edges and corners included, with the value the three
    phases of exchange_ghosts_packed leave there; owned cells and cells
    past the grid stay as they were."""
    gshape = tuple(16 if d > 1 else 8 for d in div)
    cm, bs, hs, st = _poisoned_state(gshape, div, n, 11 + n)
    want = dist_pack.exchange_ghosts_packed([t.clone() for t in st], cm, bs, hs)
    got = tdr.exchange_packed_plain([t.clone() for t in st], div, bs, hs)
    before = tdr.exchange_packed.launches
    via = tdr.exchange_packed([t.clone() for t in st], div, bs, hs)
    assert tdr.exchange_packed.launches == before  # CPU blocks: the twin
    for w, g, v, s in zip(want, got, via, st):
        assert torch.equal(g, w) and torch.equal(v, w)
        own = tdr.unpack_ext_block(s, bs, hs)
        assert torch.equal(tdr.unpack_ext_block(g, bs, hs), own)
    changed = sum(int((g != s).sum()) for g, s in zip(got, st))
    assert changed > 0  # the poison was rewritten


def test_owner_gather_leaves_cells_past_the_grid():
    """A corner block's ring past the grid is not written (the transitive
    copy brings only zeros there, from blocks whose ring is also past the
    grid)."""
    div, n = (2, 2, 2), 2
    cm, bs, hs, st = _poisoned_state((16, 16, 16), div, n, 5)
    st = [t + 7.0 for t in st]  # no zero anywhere
    got = tdr.exchange_packed_plain([t.clone() for t in st], div, bs, hs)
    Ke, Ie, Je, _ = tdr.ext_dims(bs, hs)
    ext = tdr.unpack_rb(got[0], (Ke, Ie, Je))
    before = tdr.unpack_rb(st[0], (Ke, Ie, Je))
    h = hs[0]
    # block 0 sits at the low corner: its low rings lie past the grid
    assert torch.equal(ext[:h], before[:h])
    assert torch.equal(ext[:, :h], before[:, :h])
    assert torch.equal(ext[:, :, :h], before[:, :, :h])


@functools.lru_cache(maxsize=None)
def _jproblem(maf):
    jp = JProblem.poisson_cube(N, dtype=jnp.float32)
    if maf:
        jp = dataclasses.replace(
            jp, mc=JProblem.manufactured_stretched(N, dtype=jnp.float32)[0].mc)
    x0 = np.random.default_rng(4).standard_normal((N, N, N)).astype(np.float32)
    return dataclasses.replace(jp, x0=jnp.asarray(x0))


@functools.lru_cache(maxsize=None)
def _jax_step(div, maf):
    """JAX's interpreted packed step at 16^3, n = 2, built and jitted once."""
    nd = div[0] * div[1] * div[2]
    jm = j_make_mesh((N, N, N), devices=jax.devices("cpu")[:nd], div=div)
    step = jdp.make_dist_packed_step(_jproblem(maf), jm, OMEGA, n=2,
                                     interpret=True)
    return jax.jit(step), step.hs, jm


def _tproblem(jp):
    mc = None
    if jp.mc is not None:
        mc = tmaf.MafCoeffs.from_numpy(
            *(np.asarray(getattr(jp.mc, f)) for f in tmaf.FIELDS), device="cpu")
    return czt.Problem.from_arrays((N, N, N), torch.float32, np.asarray(jp.x0),
                                   np.asarray(jp.rhs), rhs_inner_zero=True,
                                   device="cpu", mc=mc)


@pytest.mark.parametrize("div,maf", [((2, 2, 2), False), ((1, 2, 2), False),
                                     ((2, 2, 2), True)])
def test_batched_step_matches_jax(div, maf):
    """Two n = 2 calls of the batched step's plain form (the exchange's
    owner gather, K7's twin on every block, one float64 fold over the
    blocks' owned sums) and of make_dist_packed_step on CPU blocks: owned
    cells bitwise JAX's interpreted step, r2 to rtol 2e-5."""
    jp = _jproblem(maf)
    jstep, hs, jm = _jax_step(div, maf)
    tp = _tproblem(jp)
    tm = _tmesh((N, N, N), div)
    step = dist_pack.make_dist_packed_step(tp, tm, OMEGA, n=2)
    assert step.hs == hs and step.iters_per_call == 2
    bs = tm.block_shape((N, N, N))
    origins = tm.offsets((N, N, N))
    kern = tdr.make_dist_packed_sweepnx(bs, (N, N, N), torch.float32, omega=OMEGA,
                                        n=2, split=tuple(d > 1 for d in div),
                                        mc=tp.mc)
    tabs = [kern.block_tables(o, "cpu") if maf else None for o in origins]

    def batched(xs):
        tdr.exchange_packed(xs, div, bs, hs)
        r2 = [kern(x, o, t) for x, o, t in zip(xs, origins, tabs)]
        return xs, torch.stack(r2).sum(0, dtype=torch.float64)

    xj = jdp.to_packed_state(jm, jp.x0, hs)
    xb = dist_pack.to_packed_state(tm, tp.x0, hs)
    xs = [t.clone() for t in xb]
    rj, rb, rs = [], [], []
    for _ in range(2):
        xj, r = jstep(xj, xj)
        rj += np.asarray(r).tolist()
        xb, r = batched(xb)
        rb += r.tolist()
        xs, r = step(xs, None)
        rs += r.tolist()
    want = np.asarray(jdp.from_packed_state(jm, xj, (N, N, N), hs))
    for state in (xb, xs):
        got = dist_pack.from_packed_state(tm, state, (N, N, N), hs)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(rb, rj, rtol=2e-5)
    np.testing.assert_allclose(rs, rj, rtol=2e-5)
    np.testing.assert_allclose(rb, rs, rtol=1e-12)


def test_launchers_refuse_more_blocks_than_a_launch_holds():
    with pytest.raises(ValueError, match="blocks"):
        tdr.PackExchange((4, 4, 4), (8, 8, 8), (4, 4, 4))
    with pytest.raises(ValueError, match="blocks"):
        tdr.BlockRbSweeps(2, OMEGA, (8, 8, 8), (32, 32, 32), (4, 4, 4),
                          [(0, 0, 0)] * (tdr.MAX_BLOCKS + 1))
    assert tdr.MAX_BLOCKS == 32
