"""The port's grid BLAS (ops/blas.py) and MAF Krylov operator (ops/maf.py)
against the JAX package's on the same seeded fields at a ragged shape:
float64 to 1e-14 relative, float32 to rtol 1e-6, the dots to rtol 1e-5
(the two libraries sum in different orders).  Also the MAF pivot
``Problem.pvt`` against the JAX package's."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.ops import blas as jblas
from cubez_tpu.ops import maf as jmaf

import cubez_tpu_torch as czt
from cubez_tpu_torch.ops import blas
from cubez_tpu_torch.ops import maf as tmaf

torch.set_num_threads(1)

SHAPE = (13, 10, 17)  # (K, I, J)
RTOL = {"float64": 1e-14, "float32": 1e-6}
# scalars as the Krylov loop hands them over: Python floats here, rounded
# to the field's dtype by both sides
A, B = 0.7310585786300049, -1.2599210498948732


def _fields(dtype, seed=7, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(dtype) for _ in range(n)]


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(t, j, rtol):
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype
    scale = max(float(np.abs(j).max()), 1e-300)
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * scale)


@functools.lru_cache(maxsize=None)
def _mask(dtype):
    return np.asarray(JProblem.poisson_cube(
        (SHAPE[1], SHAPE[2], SHAPE[0]), dtype=getattr(jnp, dtype)).msk)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("op", ["triad", "bicg_1", "bicg_2", "calc_ax",
                                "calc_rk", "dot1", "dot2"])
def test_blas_op_matches_jax(op, dtype):
    (xj, xt), (yj, yt), (zj, zt), (wj, wt) = (_pair(a) for a in _fields(dtype))
    mj, mt = _pair(_mask(dtype))
    calls = {
        "triad": ((xj, yj, A, mj), (xt, yt, A, mt)),
        "bicg_1": ((xj, yj, zj, A, B, mj), (xt, yt, zt, A, B, mt)),
        "bicg_2": ((xj, yj, zj, A, B, mj), (xt, yt, zt, A, B, mt)),
        "calc_ax": ((xj, mj), (xt, mt)),
        "calc_rk": ((xj, wj, mj), (xt, wt, mt)),
        "dot1": ((xj, mj), (xt, mt)),
        "dot2": ((xj, yj, mj), (xt, yt, mt)),
    }
    jargs, targs = calls[op]
    got, want = getattr(blas, op)(*targs), getattr(jblas, op)(*jargs)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    rtol = 1e-5 if op.startswith("dot") and dtype == "float32" else RTOL[dtype]
    _close(got, want, rtol)


def test_scalars_stay_in_the_field_dtype():
    """A 0-d float64 tensor or a Python float enters a float32 op rounded to
    float32, as jnp.asarray(a, x.dtype) rounds it."""
    x, y = (torch.from_numpy(a) for a in _fields("float32", n=2))
    m = torch.ones(SHAPE)
    a64 = torch.tensor(A, dtype=torch.float64)
    ref = (torch.tensor(np.float32(A)) * x + y) * m
    for a in (A, a64):
        out = blas.triad(x, y, a, m)
        assert out.dtype == torch.float32 and torch.equal(out, ref)


def _carry(jmc):
    return tmaf.MafCoeffs.from_numpy(
        *(np.asarray(getattr(jmc, f)) for f in tmaf.FIELDS), device="cpu")


@functools.lru_cache(maxsize=None)
def _jstretched(dtype):
    return JProblem.manufactured_stretched((SHAPE[1], SHAPE[2], SHAPE[0]),
                                           dtype=getattr(jnp, dtype),
                                           family="krylov")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("op", ["calc_ax_maf", "calc_rk_maf"])
def test_maf_operator_matches_jax(op, dtype):
    jp, _ = _jstretched(dtype)
    mc = _carry(jp.mc)
    pvt = torch.from_numpy(np.array(jp.pvt))
    (xj, xt), (bj, bt) = (_pair(a) for a in _fields(dtype, n=2))
    mj, mt = _pair(_mask(dtype))
    if op == "calc_ax_maf":
        got = tmaf.calc_ax_maf(xt, mt, mc, pvt)
        want = jmaf.calc_ax_maf(xj, mj, jp.mc, jp.pvt)
    else:
        got = tmaf.calc_rk_maf(xt, bt, mt, mc, pvt)
        want = jmaf.calc_rk_maf(xj, bj, mj, jp.mc, jp.pvt)
    _close(got, want, RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("grid", ["uniform", "stretched"])
def test_pvt_matches_jax(grid, dtype):
    """The port's own Problem.pvt (coefficients built by the port) against
    the JAX package's."""
    n = (SHAPE[1], SHAPE[2], SHAPE[0])
    if grid == "uniform":
        jp = JProblem.poisson_cube(n, dtype=getattr(jnp, dtype), maf=True)
        tp = czt.Problem.poisson_cube(n, dtype=getattr(torch, dtype),
                                      device="cpu", maf=True)
    else:
        jp, _ = _jstretched(dtype)
        tp, _ = czt.Problem.manufactured_stretched(
            n, dtype=getattr(torch, dtype), family="krylov", device="cpu")
    assert tuple(tp.pvt.shape) == tuple(jp.pvt.shape)
    _close(tp.pvt, jp.pvt, RTOL[dtype])
