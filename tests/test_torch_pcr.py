"""The port's line PCR against the JAX package's, on the CPU: ``num_stage``,
``build_tables`` and ``pcr_reduce_var`` bitwise (the JAX function run op
by op, float32 and float64, n = 14, 18 and 66: a power of two plus one and
lk + 2 of 64^3 blocks); the table-driven and variable solves against a
dense solve; K10's twin (``make_fused_pcr_step``, 'pcr' and 'pcr_rb',
constant and MAF, zero and streamed b) against the interpreted Pallas
kernel at 16^3 and (20, 12, 16) within the bands of
tests/test_pallas_pcr.py (2e-6 constant, 3e-6 MAF; the interpreted kernel
contracts some stage products into fused multiply-adds, the twin does
not), residuals to rtol 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu import Problem as JProblem
from cubez_tpu.ops import pcr as jops_pcr
from cubez_tpu.ops import tdma as jtdma
from cubez_tpu.pallas_kernels import pcr as jpcr

from cubez_tpu_torch.cuda_kernels import pcr as k10
from cubez_tpu_torch.ops import maf as tmaf
from cubez_tpu_torch.ops import pcr as tops_pcr

torch.set_num_threads(1)

OMEGA = 1.1
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "f64": (np.float64, torch.float64, jnp.float64)}


def test_num_stage_matches_jax():
    assert all(tops_pcr.num_stage(n) == jtdma.num_stage(n) for n in range(1, 600))


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n", [1, 2, 14, 18, 66, 126, 258])
def test_build_tables_matches_jax(n, dt):
    npdt, tdt, jdt = DTYPES[dt]
    want = jpcr.build_tables(n, jdt)
    got = k10.build_tables(n, tdt)
    assert got.dtype == npdt and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _system(n, dt, seed):
    """A seeded diagonally dominant unit-diagonal (n, 5, 7) system with
    a[0] = c[n-1] = 0, in numpy."""
    npdt = DTYPES[dt][0]
    rng = np.random.default_rng(seed)
    a = (-0.45 * rng.random((n, 5, 7))).astype(npdt)
    c = (-0.45 * rng.random((n, 5, 7))).astype(npdt)
    a[0] = 0
    c[-1] = 0
    d = rng.standard_normal((n, 5, 7)).astype(npdt)
    return a, c, d


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n", [14, 18, 66])
def test_pcr_reduce_var_bitwise(n, dt):
    """The port's stage recurrence equals the JAX function run op by op
    (no jit: XLA's fusion would contract products into fma)."""
    a, c, d = _system(n, dt, seed=n)
    pn = jtdma.num_stage(n)
    with jax.disable_jit():
        want = np.asarray(jops_pcr.pcr_reduce_var(
            jnp.asarray(a), jnp.asarray(c), jnp.asarray(d), pn))
    got = tops_pcr.pcr_reduce_var(torch.tensor(a), torch.tensor(c),
                                  torch.tensor(d), pn).numpy()
    np.testing.assert_array_equal(got, want)


def _dense_solve(a, c, d):
    n = d.shape[0]
    T = np.zeros((n, n) + d.shape[1:])
    k = np.arange(n)
    T[k, k] = 1.0
    T[k[1:], k[1:] - 1] = a[1:]
    T[k[:-1], k[:-1] + 1] = c[:-1]
    return np.linalg.solve(np.moveaxis(T, (0, 1), (-2, -1)),
                           np.moveaxis(d, 0, -1)[..., None])[..., 0]


@pytest.mark.parametrize("n", [1, 2, 3, 14, 18, 66])
def test_pcr_solves_solve_the_line(n):
    """Both solves of the kernels, float64: pcr_solve_var on a variable
    system and the table-driven pcr_solve on the constant one (a = c =
    -1/6), against a dense solve."""
    a, c, d = _system(n, "f64", seed=3)
    pn = tops_pcr.num_stage(n)
    got = k10.pcr_solve_var(torch.tensor(a), torch.tensor(c), torch.tensor(d), pn)
    want = np.moveaxis(_dense_solve(a, c, d), -1, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-12)
    ac = np.full_like(a, -1.0 / 6.0)
    cc = ac.copy()
    ac[0] = 0
    cc[-1] = 0
    tab = torch.tensor(k10.build_tables(n, torch.float64))
    got = k10.pcr_solve(torch.tensor(d), tab, pn)
    want = np.moveaxis(_dense_solve(ac, cc, d), -1, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-12)


SHAPES = [(16, 16, 16), (20, 12, 16)]  # (K, I, J)


@functools.lru_cache(maxsize=None)
def _mafs(shape):
    """(JAX MafCoeffs, port MafCoeffs) of the stretched grid at ``shape``."""
    K, I, J = shape
    jp, _ = JProblem.manufactured_stretched((I, J, K), dtype=jnp.float32)
    return jp.mc, tmaf.MafCoeffs.from_numpy(
        *(np.asarray(getattr(jp.mc, f)) for f in tmaf.FIELDS), device="cpu")


@functools.lru_cache(maxsize=None)
def _jstep(kind, shape, maf, bz):
    return jax.jit(jpcr.make_fused_pcr_step(
        kind, shape, jnp.float32, omega=OMEGA, b_is_zero=bz,
        mc=_mafs(shape)[0] if maf else None, interpret=True))


@pytest.mark.parametrize("bz", [True, False])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("kind", ["pcr", "pcr_rb"])
@pytest.mark.parametrize("shape", SHAPES)
def test_k10_twin_matches_interpreted_kernel(shape, kind, maf, bz):
    """One step of each form from a seeded field: field within 2e-6
    (constant) or 3e-6 (MAF), r2 within rtol 1e-5."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    xj, rj = _jstep(kind, shape, maf, bz)(jpcr.to_line_layout(jnp.asarray(x)),
                                         jpcr.to_line_layout(jnp.asarray(b)))
    want = np.asarray(jpcr.from_line_layout(xj, shape))
    step = k10.make_fused_pcr_step(kind, shape, torch.float32, omega=OMEGA,
                                   b_is_zero=bz,
                                   mc=_mafs(shape)[1] if maf else None)
    xt = torch.tensor(x)
    got, rt = step(step.pad(xt), torch.tensor(b))
    assert torch.equal(xt, torch.tensor(x))  # the step took a copy
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=3e-6 if maf else 2e-6)
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-5)


@pytest.mark.parametrize("kind", ["pcr", "pcr_rb"])
def test_k10_line_jacobi_is_out_of_place(kind):
    """'pcr' never writes the field it is handed and alternates two fields
    it owns; 'pcr_rb' updates in place.  Two steps equal the plain twin's
    two passes."""
    shape = (12, 9, 10)
    x = torch.tensor(np.random.default_rng(2).standard_normal(shape),
                     dtype=torch.float32)
    step = k10.make_fused_pcr_step(kind, shape, omega=OMEGA, b_is_zero=True)
    x0 = x.clone()
    y1, _ = step(x, None)
    if kind == "pcr":
        assert torch.equal(x, x0) and y1.data_ptr() != x.data_ptr()
        y2, _ = step(y1, None)
        assert y2.data_ptr() not in (y1.data_ptr(), x.data_ptr())
        want = k10.fused_pcr_plain(k10.fused_pcr_plain(x0, None, OMEGA)[0],
                                   None, OMEGA)[0]
    else:
        assert y1.data_ptr() == x.data_ptr()
        y2, _ = step(y1, None)
        want = x0.clone()
        for _ in range(2):
            for c in (0, 1):
                k10.fused_pcr_plain(want, None, OMEGA, c)
    assert torch.equal(y2, want)
