"""The port's packed line step K5 (cuda_kernels/rblines.py) against the JAX
package's: the colour-packed line layout bit for bit, and the plain twin
against the interpreted Pallas kernel (make_rbl_step) and the jnp step
after two sweeps, constant and MAF, zero and streamed b, in the bands of
tests/test_rblines.py (field rtol 2e-5 / atol 2e-6, r2 rtol 2e-4: the TPU
kernel solves each line by a dense T^-1 product, the port by Thomas)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.pallas_kernels import rblines as jrbl
from cubez_tpu.solvers.steps import make_step as j_make_step

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import lines as tl
from cubez_tpu_torch.cuda_kernels import rblines as trbl
from cubez_tpu_torch.ops import maf as tmaf

torch.set_num_threads(1)

SHAPE = (18, 16, 20)  # (K, I, J)


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return x, b


@functools.lru_cache(maxsize=None)
def _jax_side(maf):
    """(interpreted make_rbl_step streaming b, jitted jnp pcr_rb step, port
    MafCoeffs or None) at SHAPE, built once and shared by the zero-b and
    streamed-b cases: the stretched grid's coefficients carried across for
    MAF, the cube otherwise."""
    K, I, J = SHAPE
    tmc = None
    if maf:
        jp, _ = JProblem.manufactured_stretched((I, J, K), dtype=jnp.float32)
        tmc = tmaf.MafCoeffs.from_numpy(
            *(np.asarray(getattr(jp.mc, f)) for f in tmaf.FIELDS), device="cpu")
    else:
        jp = JProblem.poisson_cube((I, J, K), dtype=jnp.float32)
    jstep = jrbl.make_rbl_step(SHAPE, omega=1.5, mc=jp.mc if maf else None,
                               b_is_zero=False, interpret=True)
    ref = jax.jit(j_make_step(jp, "pcr_rb_maf" if maf else "pcr_rb", 1.5))
    return jstep, ref, tmc


@pytest.mark.parametrize("shape,offset", [((10, 12, 9), 0), ((16, 8, 130), 1)])
def test_pack_rb_lines_bitwise_vs_jax(shape, offset):
    """The port's (2, K, I/2, J) state is JAX's (2, I2+4, Kp, Jp) with the
    padding stripped and the axes in K-outer order; the fold inverts."""
    x, _ = _fields(shape, 3)
    K, I, J = shape
    js = np.asarray(jrbl.pack_rb_lines(jnp.asarray(x), offset=offset))
    js = js[:, 2:-2, :K, :J].transpose(0, 2, 1, 3)
    ts = trbl.pack_rb_lines(torch.tensor(x), offset)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(
        trbl.unpack_rb_lines(ts, shape, offset).numpy(), x)
    with pytest.raises(ValueError, match="even I"):
        trbl.pack_rb_lines(torch.zeros(K, I - 1, J))


@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
def test_rbl_twin_vs_jax_kernel_and_jnp(maf, with_b):
    """Two sweeps of rbl_plain against the interpreted make_rbl_step and the
    JAX package's jnp pcr_rb step on the same seeded fields.  Without b the
    port's step is built with b_is_zero and handed a random b, which it
    must ignore; the JAX side gets zeros."""
    jstep, ref, tmc = _jax_side(maf)
    x, b = _fields(SHAPE, 11 + 2 * maf + with_b)
    tstep = trbl.make_rbl_step(SHAPE, torch.float32, omega=1.5, mc=tmc,
                               b_is_zero=not with_b)
    bj = jnp.asarray(b if with_b else np.zeros_like(b))
    xj, bjp = jstep.pad(jnp.asarray(x)), jstep.pad(bj)
    xt, btp = tstep.pad(torch.tensor(x)), tstep.pad(torch.tensor(b))
    xr = jnp.asarray(x)
    for _ in range(2):
        xj, rj = jstep(xj, bjp)
        xt, rt = tstep(xt, btp)
        xr, rr = ref(xr, bj)
    ft = tstep.unpad(xt).numpy()
    for fj, r in ((np.asarray(jstep.unpad(xj)), rj), (np.asarray(xr), rr)):
        np.testing.assert_allclose(ft, fj, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(float(rt), float(r), rtol=2e-4)


def test_rbl_offset_1_vs_jax_kernel():
    """offset 1 flips which lines are colour 0, as in the JAX kernel."""
    x, b = _fields(SHAPE, 23)
    jstep = jrbl.make_rbl_step(SHAPE, omega=1.5, offset=1, b_is_zero=False,
                               interpret=True)
    tstep = trbl.make_rbl_step(SHAPE, omega=1.5, offset=1)
    xj, rj = jstep(jstep.pad(jnp.asarray(x)), jstep.pad(jnp.asarray(b)))
    xt, rt = tstep(tstep.pad(torch.tensor(x)), tstep.pad(torch.tensor(b)))
    np.testing.assert_allclose(tstep.unpad(xt).numpy(),
                               np.asarray(jstep.unpad(xj)), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(rt), float(rj), rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rbl_twin_equals_unpacked_line_rb_twin(dtype):
    """The packed layout changes where a line lives, not its arithmetic:
    K5's twin is bitwise K6's red-black twin, MAF included."""
    shape = (12, 10, 14)
    x, b = (torch.tensor(a, dtype=dtype) for a in _fields(shape, 31))
    mc = czt.Problem.manufactured_stretched((10, 14, 12), dtype=dtype,
                                            device="cpu")[0].mc
    for m in (None, mc):
        k5 = trbl.make_rbl_step(shape, dtype, omega=1.5, offset=1, mc=m)
        k6 = tl.make_line_step("pcr_rb", shape, dtype, omega=1.5, offset=1,
                               mc=m)
        xp, xu = k5.pad(x), k6.pad(x)
        for _ in range(2):
            xp, rp = k5(xp, k5.pad(b))
            xu, ru = k6(xu, k6.pad(b))
        assert torch.equal(k5.unpad(xp), k6.unpad(xu))
        assert torch.equal(rp, ru)
    assert trbl.make_rbl_step((12, 11, 14), omega=1.5) is None  # odd I
    assert trbl.make_rbl_step((3, 10, 14), omega=1.5) is None   # K - 2 < 2
