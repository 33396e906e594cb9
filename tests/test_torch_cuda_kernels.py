"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the tests, not at import).  This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import rbpack as rb

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

OMEGA = 1.5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _builders():
    yield "single b=0", lambda sh, dt, off, pl: rb.make_packed_sweep(
        sh, dt, omega=OMEGA, offset=off, b_is_zero=True, plain=pl)
    yield "single b", lambda sh, dt, off, pl: rb.make_packed_sweep(
        sh, dt, omega=OMEGA, offset=off, b_is_zero=False, plain=pl)
    yield "pair b", lambda sh, dt, off, pl: rb.make_packed_sweep2x(
        sh, dt, omega=OMEGA, offset=off, b_is_zero=False, plain=pl)
    for n in (3, 4, 6):
        yield f"n={n}", lambda sh, dt, off, pl, n=n: rb.make_packed_sweepnx(
            sh, dt, omega=OMEGA, n=n, offset=off, plain=pl)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 10, 17)])
def test_kernels_match_plain_twins(dev, shape, dtype, offset):
    """float32 fields bitwise equal; float64 within 1e-14 (the twin has no
    fma); residuals to rtol 1e-5 (block partial sums group differently)."""
    gen = torch.Generator().manual_seed(3 + offset)
    x0 = rb.pack_rb(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1,
                    offset).to(dev)
    b0 = rb.pack_rb(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1,
                    offset).to(dev)
    tol = 0.0 if dtype == torch.float32 else 1e-14
    for label, build in _builders():
        kstep = build(shape, dtype, offset, False)
        pstep = build(shape, dtype, offset, True)
        xk, xp = x0.clone(), x0.clone()
        before = rb.rb_color.launches + rb.rb_sweeps_n.launches
        for _ in range(3):
            xk, rk = kstep(xk, b0)
            xp, rp = pstep(xp, b0)
        torch.cuda.synchronize()
        assert rb.rb_color.launches + rb.rb_sweeps_n.launches > before, label
        assert float((xk - xp).abs().max()) <= tol, label
        torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


def test_solve_on_cuda_matches_cpu_twin(dev):
    """The whole slice at 32^3: the kernels and the CPU twin stop at the
    same iteration with bitwise equal fields."""
    g = czt.Problem.poisson_cube(32, device=dev)
    c = czt.Problem.poisson_cube(32, device="cpu")
    rg = czt.solve(g, "sor2sma", omega=OMEGA, itr_max=10000)
    rc = czt.solve(c, "sor2sma", omega=OMEGA, itr_max=10000)
    assert rg.iters == rc.iters == 199
    assert torch.equal(rg.x.cpu(), rc.x)
    torch.testing.assert_close(rg.history.cpu(), rc.history, rtol=1e-5, atol=0)


def test_wrappers_refuse_what_they_cannot_take(dev):
    x = rb.pack_rb(torch.zeros(8, 8, 8, device=dev))
    with pytest.raises(TypeError):
        rb.rb_color(x.half(), None, 0, OMEGA)
    with pytest.raises(ValueError, match="contiguous"):
        rb.rb_sweeps_n(x.transpose(2, 3), None, 2, OMEGA)
    with pytest.raises(ValueError, match="b must match"):
        rb.rb_sweeps_n(x, x.double(), 2, OMEGA)


def test_odd_i_on_cuda_names_k4(dev):
    prob = czt.Problem.poisson_cube((15, 16, 16), device=dev)
    with pytest.raises(NotImplementedError, match="K4"):
        czt.solve(prob, "sor2sma", omega=OMEGA, itr_max=10)
    r = czt.solve(prob, "sor2sma", omega=OMEGA, itr_max=10, impl="plain")
    assert r.iters == 10
