"""The port's packed red-black layout and plain twins against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX
package's own tests run them: the same seeded fields, bitwise equal after
three sweeps, residuals to rtol 1e-5 (per-tile partial sums group
differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cubez_tpu.pallas_kernels import rbpack as jrb

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import rbpack as trb
from cubez_tpu_torch.ops import stencil

torch.set_num_threads(1)

OMEGA = 1.5


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return x, b


def _both(x, b, offset):
    """(JAX packed x, b), (torch packed x, b) from numpy fields."""
    j = (jrb.pack_rb(jnp.asarray(x), offset), jrb.pack_rb(jnp.asarray(b), offset))
    t = (trb.pack_rb(torch.tensor(x), offset), trb.pack_rb(torch.tensor(b), offset))
    return j, t


def _run_and_compare(jstep, tstep, x, b, offset, calls):
    shape = x.shape
    (xj, bj), (xt, bt) = _both(x, b, offset)
    jstep = jax.jit(jstep)
    for _ in range(calls):
        xj, rj = jstep(xj, bj)
        xt, rt = tstep(xt, bt)
        np.testing.assert_array_equal(
            np.asarray(jrb.unpack_rb(xj, shape, offset)),
            trb.unpack_rb(xt, shape, offset).numpy(),
        )
        np.testing.assert_allclose(
            np.atleast_1d(rt.numpy()), np.atleast_1d(np.asarray(rj)), rtol=1e-5
        )


@pytest.mark.parametrize("offset", [0, 1])
def test_pack_matches_jax_and_roundtrips(offset):
    x, _ = _fields((12, 10, 20), 3)
    shape = x.shape
    K, I, J = shape
    I2, I2p = I // 2, jrb._dims(shape)[4]
    pj = np.asarray(jrb.pack_rb(jnp.asarray(x), offset))
    pt = trb.pack_rb(torch.tensor(x), offset)
    assert pt.shape == (2, K, I2, J) and pt.is_contiguous()
    np.testing.assert_array_equal(pj[2:-2, :I2, :J], pt[0].numpy())
    np.testing.assert_array_equal(pj[2:-2, I2p:I2p + I2, :J], pt[1].numpy())
    np.testing.assert_array_equal(trb.unpack_rb(pt, shape, offset).numpy(), x)


@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_single_sweep_bitwise_vs_jax(offset, with_b):
    """K1: rbpack.make_packed_sweep (interpret, kt=4) at (12, 10, 16)."""
    shape = (12, 10, 16)
    x, b = _fields(shape, 11 + offset)
    jstep = jrb.make_packed_sweep(
        shape, jnp.float32, omega=OMEGA, kt=4, offset=offset,
        b_is_zero=not with_b, interpret=True,
    )
    tstep = trb.make_packed_sweep(
        shape, torch.float32, omega=OMEGA, offset=offset, b_is_zero=not with_b
    )
    _run_and_compare(jstep, tstep, x, b, offset, calls=3)


def test_pair_with_b_bitwise_vs_jax():
    """K2: rbpack.make_packed_sweep2x with a streamed b (interpret, kt=8)."""
    shape = (16, 16, 16)
    x, b = _fields(shape, 21)
    jstep = jrb.make_packed_sweep2x(
        shape, jnp.float32, omega=OMEGA, kt=8, b_is_zero=False, interpret=True
    )
    tstep = trb.make_packed_sweep2x(
        shape, torch.float32, omega=OMEGA, b_is_zero=False
    )
    assert tstep.iters_per_call == 2
    _run_and_compare(jstep, tstep, x, b, 0, calls=2)


def test_window_chain_n3_bitwise_vs_jax():
    """K3: rbpack.make_packed_sweepnx(n=3, kt=8) at 16^3, zero RHS."""
    shape = (16, 16, 16)
    x, b = _fields(shape, 31)
    jstep = jrb.make_packed_sweepnx(
        shape, jnp.float32, omega=OMEGA, n=3, kt=8, interpret=True
    )
    tstep = trb.make_packed_sweepnx(shape, torch.float32, omega=OMEGA, n=3)
    assert tstep.iters_per_call == 3
    _run_and_compare(jstep, tstep, x, b, 0, calls=1)


def test_fma_emulation_rounds_once():
    """fma(ss, R6, c) where the exact value sits a hair off a float32
    midpoint M, so that the float64 sum rounds onto M itself: a plain
    float64-then-float32 rounding then picks a neighbour by ties-to-even,
    wrong half the time; the emulation must pick the side of the exact
    value.  (Such cases need |ss/6| > |c|: with |c| dominant the 48-bit
    product never has the 28-bit run of equal bits a tie needs.)"""
    r6 = np.float64(np.float32(1.0 / 6.0))
    rng = np.random.default_rng(7)
    ss = rng.uniform(1.0, 2.0, 200_000).astype(np.float32)
    p = ss.astype(np.float64) * r6  # exact: 24 x 24 bits
    ulp32 = 2.0 ** (np.floor(np.log2(p)) - 23)
    mid = (np.round(p / ulp32 - 0.5) + 0.5) * ulp32  # nearest midpoint
    eps = mid - p  # exact (Sterbenz)
    keep = (eps != 0) & (np.abs(eps) < ulp32 * 2.0**-8)
    ss, p, ulp32, mid, eps = ss[keep], p[keep], ulp32[keep], mid[keep], eps[keep]
    c = eps.astype(np.float32)
    c = np.where(c.astype(np.float64) == eps, np.nextafter(c, np.float32(np.inf)), c)
    d = c.astype(np.float64) - eps  # exact value = mid + d, d != 0
    assert np.all(np.abs(d) < ulp32 * 2.0**-30)  # float64 rounds onto mid
    assert ss.size >= 100
    expect = (mid + np.sign(d) * ulp32 / 2).astype(np.float32)
    got = trb._fma(torch.tensor(ss), torch.tensor(np.float32(r6)),
                   torch.tensor(c))
    np.testing.assert_array_equal(got.numpy(), expect)
    naive = (p + c.astype(np.float64)).astype(np.float32)
    assert (naive != expect).sum() > ss.size // 4


def test_packed_twin_matches_unpacked_stencil():
    """The packed twin against the layout-independent unpacked sweep
    (ops/stencil.py, a true division by 6): equal to float32 roundoff."""
    shape = (14, 12, 18)
    x, b = _fields(shape, 41)
    p = czt.Problem.from_arrays(shape, torch.float32, x, b, device="cpu")
    step = trb.make_packed_sweep(shape, torch.float32, omega=OMEGA)
    cm = stencil.color_masks(shape, 0, torch.float32)
    xu, xp = p.x0, step.pad(p.x0)
    bp = step.pad(p.rhs)
    for _ in range(3):
        xu, ru = stencil.sor2sma_sweep(xu, p.rhs, p.msk, OMEGA, cm)
        xp, rp = step(xp, bp)
        np.testing.assert_allclose(step.unpad(xp).numpy(), xu.numpy(),
                                   atol=2e-6)
        np.testing.assert_allclose(float(rp), float(ru), rtol=1e-5)


def test_builders_refuse_where_jax_layout_does():
    even, odd = (8, 10, 12), (8, 11, 12)
    mc = czt.Problem.poisson_cube((10, 12, 8), device="cpu", maf=True).mc
    for make in (trb.make_packed_sweep, trb.make_packed_sweep2x):
        assert make(odd, omega=OMEGA) is None
        assert make(odd, omega=OMEGA, mc=mc) is None
        assert make(even, omega=OMEGA, mc=mc) is not None
        assert make(even, omega=OMEGA) is not None
    for n in (1, 10):
        assert trb.make_packed_sweepnx(even, omega=OMEGA, n=n) is None
    for n in range(2, 10):
        s = trb.make_packed_sweepnx(even, omega=OMEGA, n=n)
        assert s.iters_per_call == n and s.single.iters_per_call == 1
        # MAF: n <= 7, the JAX package's tk guard band
        s = trb.make_packed_sweepnx(even, omega=OMEGA, n=n, mc=mc)
        assert (s is None) == (n > 7)
    assert trb.make_packed_sweepnx(odd, omega=OMEGA) is None
    with pytest.raises(ValueError, match="entries"):
        trb.make_packed_sweep((8, 10, 14), omega=OMEGA, mc=mc)
    with pytest.raises(TypeError):
        trb.make_packed_sweep(even, torch.float16, omega=OMEGA)


def test_wrappers_run_the_twin_on_cpu_without_launching():
    x, b = _fields((9, 8, 11), 51)
    xa = trb.pack_rb(torch.tensor(x))
    bb = trb.pack_rb(torch.tensor(b))
    xb = xa.clone()
    before = (trb.rb_single.launches, trb.rb_sweeps_n.launches)
    ra = trb.rb_single(xa, bb, OMEGA)
    rn = trb.rb_sweeps_n(xb, bb, 1, OMEGA)
    assert (trb.rb_single.launches, trb.rb_sweeps_n.launches) == before
    assert torch.equal(xa, xb) and float(ra) == float(rn[0])
    xc = trb.pack_rb(torch.tensor(x))
    rc = trb.rb_color_plain(xc, bb, 0, OMEGA) + trb.rb_color_plain(xc, bb, 1, OMEGA)
    assert torch.equal(xa, xc) and float(ra) == float(rc)
    with pytest.raises(ValueError, match="CUDA"):
        trb._check(xa, None)
