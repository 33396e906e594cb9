"""K9, the port's block-local line relaxation, against the JAX package on
the CPU: the twin against the interpreted ``make_block_pcr`` on one block
at a nonzero origin (the 'pcr' form within 2e-6, the 'fastdiag' form,
Thomas against the TPU's dense solve, within 5e-6; constant and MAF,
colours 0, 1 and the line-Jacobi pass, zero and streamed b; r2 to rtol
1e-4: JAX sums dp^2 in float32), and ``make_dist_fused_step`` for the line
kinds against JAX's interpreted fused step and the port's own
parallel/dist.py step on the (2, 2, 2), (2, 4, 1) and (1, 2, 4) meshes
(the bands of tests/test_dist_fused.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.pallas_kernels import dist_pcr as jk9
from cubez_tpu.parallel import dist_fused as jdf
from cubez_tpu.parallel.mesh import make_mesh as j_make_mesh

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import dist_pcr as tk9
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.parallel import dist as tdist
from cubez_tpu_torch.parallel import dist_fused

torch.set_num_threads(1)

OMEGA = 1.5
# (form, block shape, global shape, origin): a K-split block and a block
# that spans K (the 'fastdiag' form), both with physical faces
BLOCKS = {"pcr": ((8, 10, 12), (16, 20, 24), (8, 0, 12)),
          "fastdiag": ((16, 8, 12), (16, 16, 24), (0, 8, 12))}
TOL = {"pcr": 2e-6, "fastdiag": 5e-6}


@functools.lru_cache(maxsize=None)
def _mc(gshape):
    """(JAX MafCoeffs, port MafCoeffs) of the stretched grid of (K, I, J)
    ``gshape``."""
    K, I, J = gshape
    jp, _ = JProblem.manufactured_stretched((I, J, K), dtype=jnp.float32)
    return jp.mc, tmaf.MafCoeffs.from_numpy(
        *(np.asarray(getattr(jp.mc, f)) for f in tmaf.FIELDS), device="cpu")


def _jax_tables(mc, bs, gs, origin, kp, jp):
    """The per-block (tki, tkj, tkk) that JAX's dist_fused slices (J ghost
    lanes: gj = 1)."""
    lk, li, lj = bs
    Kg, Ig, Jg = gs
    k0, i0, j0 = origin

    def pad1d(v, ng, fill):
        out = np.full(ng, fill, np.float32)
        vv = np.asarray(v, np.float32).reshape(-1)
        out[1:1 + len(vv)] = vv
        return out

    c1, c7 = pad1d(mc.c1, Ig + 2, 1.0), pad1d(mc.c7, Ig + 2, 0.0)
    tki = np.broadcast_to(np.stack([c1, c7], 1)[i0:i0 + li + 2, :, None],
                          (li + 2, 2, jp))
    c2, c8 = pad1d(mc.c2, Jg + 2 + jp, 1.0), pad1d(mc.c8, Jg + 2 + jp, 0.0)
    tkj = np.stack([c2, c8])[:, None, j0:j0 + jp]
    c3, c9 = pad1d(mc.c3, Kg + 2 + kp, 1.0), pad1d(mc.c9, Kg + 2 + kp, 0.0)
    tkk = np.broadcast_to(np.stack([c3, c9])[:, k0:k0 + kp, None], (2, kp, jp))
    return tuple(jnp.asarray(np.ascontiguousarray(t)) for t in (tki, tkj, tkk))


@functools.lru_cache(maxsize=None)
def _jsweep(form, maf, color, bz):
    bs, gs, _ = BLOCKS[form]
    mc = _mc(gs)[0] if maf else None
    return jax.jit(jk9.make_block_pcr(bs, gs, jnp.float32, omega=OMEGA,
                                      color=color, b_is_zero=bz, maf=maf,
                                      mc=mc, solver=form, interpret=True))


@pytest.mark.parametrize("bz", [True, False])
@pytest.mark.parametrize("color", [0, 1, None])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("form", ["pcr", "fastdiag"])
def test_k9_twin_matches_interpreted_kernel(form, maf, color, bz):
    """One pass on a ghosted block with random ghosts, owned cells within
    the form's band."""
    bs, gs, origin = BLOCKS[form]
    lk, li, lj = bs
    rng = np.random.default_rng(11)
    x = rng.standard_normal((lk + 2, li + 2, lj + 2)).astype(np.float32)
    b = rng.standard_normal(x.shape).astype(np.float32)
    _, kp, jp = jk9.line_block_layout(bs, 1)

    def to_jax(a):  # (lk+2, li+2, lj+2) -> JAX's (li+2, kp, jp), gj = 1
        out = np.zeros((li + 2, kp, jp), np.float32)
        out[:, :lk + 2, :lj + 2] = a.transpose(1, 0, 2)
        return jnp.asarray(out)

    tabs = ()
    if maf:
        tabs = _jax_tables(_mc(gs)[0], bs, gs, origin, kp, jp)
    xj, rj = _jsweep(form, maf, color, bz)(
        to_jax(x), to_jax(b), jnp.asarray([origin], jnp.int32), *tabs)
    want = np.asarray(xj)[:, :lk + 2, :lj + 2].transpose(1, 0, 2)
    sweep = tk9.make_block_pcr(bs, gs, omega=OMEGA, color=color, b_is_zero=bz,
                               maf=maf, mc=_mc(gs)[1] if maf else None,
                               solver=form)
    tab = sweep.block_tables(origin, "cpu") if maf else None
    xt = torch.tensor(x)
    got, rt = sweep(xt, torch.tensor(b), origin, tab)
    if color is None:
        assert torch.equal(xt, torch.tensor(x))  # out of place
    else:
        assert got.data_ptr() == xt.data_ptr()
    np.testing.assert_allclose(got.numpy()[1:-1, 1:-1, 1:-1],
                               want[1:-1, 1:-1, 1:-1], rtol=0, atol=TOL[form])
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-4)


def test_fastdiag_refuses_a_k_split_block():
    assert tk9.make_block_pcr((8, 8, 8), (16, 16, 16), omega=OMEGA,
                              solver="fastdiag") is None
    assert tk9.make_block_pcr((3, 8, 8), (3, 16, 16), omega=OMEGA,
                              solver="fastdiag") is None
    assert tk9.make_block_pcr((16, 8, 8), (16, 16, 16), omega=OMEGA,
                              solver="fastdiag").solver == "fastdiag"


N = 16


@pytest.mark.parametrize("div,kind,maf", [
    ((2, 2, 2), "pcr_rb", False), ((2, 2, 2), "pcr_rb", True),
    ((2, 2, 2), "pcr", False), ((2, 4, 1), "pcr_rb", False),
    ((1, 2, 4), "pcr_rb", False), ((1, 2, 4), "pcr_rb", True),
    ((1, 2, 4), "pcr", True),
])
def test_line_step_matches_jax_fused_and_dist_step(div, kind, maf):
    """Three steps of the port's K9 step (its 'fastdiag' form on the
    K-unsplit (1, 2, 4), 'pcr' elsewhere) from a seeded field against
    JAX's interpreted fused step (field within 2e-6 for 'pcr', 5e-6 for
    'fastdiag'; MAF 2e-5 and r2 rtol 1e-3, as tests/test_dist_fused.py
    holds JAX's own MAF pair) and the port's parallel/dist.py step."""
    omega = 1.0 if kind == "pcr" else 1.2
    name = ("pcr_j_esa" if kind == "pcr" else "pcr_rb") + ("_maf" if maf else "")
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((N, N, N)).astype(np.float32)
    jp = JProblem.poisson_cube(N, dtype=jnp.float32, maf=maf)
    nd = div[0] * div[1] * div[2]
    jm = j_make_mesh((N, N, N), devices=jax.devices("cpu")[:nd], div=div)
    jstep = jax.jit(jdf.make_dist_fused_step(jp, jm, kind, omega, interpret=True))
    tp = czt.Problem.poisson_cube(N, device="cpu", maf=maf)
    tm = czt.make_mesh((N, N, N), devices=["cpu"] * nd, div=div)
    tstep = dist_fused.make_dist_fused_step(tp, tm, kind, omega)
    assert tstep.solver == ("fastdiag" if div[0] == 1 else "pcr")
    dstep = tdist.make_dist_step(tp, tm, name, omega)
    xj = jdf.to_line_block_state(jm, jnp.asarray(x0))
    bj = jdf.to_line_block_state(jm, jp.rhs)
    xt = dist_fused.to_block_state(tm, torch.tensor(x0))
    bt = dist_fused.to_block_state(tm, tp.rhs)
    xd, bd = tm.shard(torch.tensor(x0)), tm.shard(tp.rhs)
    for _ in range(3):
        xj, rj = jstep(xj, bj)
        xt, rt = tstep(xt, bt)
        xd, rd = dstep(xd, bd)
    want = np.asarray(jdf.from_line_block_state(jm, xj, (N, N, N)))
    got = dist_fused.from_block_state(tm, xt, (N, N, N)).numpy()
    tol = 2e-5 if maf else (5e-6 if div[0] == 1 else 2e-6)
    rtol = 1e-3 if maf else 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(float(rt), float(rj), rtol=rtol)
    np.testing.assert_allclose(tm.gather(xd).numpy(), got, rtol=0, atol=tol)
    np.testing.assert_allclose(float(rd), float(rt), rtol=rtol)


def test_line_jacobi_step_never_writes_the_state_it_is_handed():
    """The 'pcr' kind (line-Jacobi on K9) is out of place: the blocks it is
    handed keep their owned cells."""
    tp = czt.Problem.poisson_cube(N, device="cpu")
    tm = czt.make_mesh((N, N, N), devices=["cpu"] * 8, div=(2, 2, 2))
    step = dist_fused.make_dist_fused_step(tp, tm, "pcr", 1.0)
    xs = dist_fused.to_block_state(tm, tp.x0)
    before = [x[1:-1, 1:-1, 1:-1].clone() for x in xs]
    ys, _ = step(xs, None)
    assert all(torch.equal(x[1:-1, 1:-1, 1:-1], b) for x, b in zip(xs, before))
    assert not all(torch.equal(y, x) for y, x in zip(ys, xs))
