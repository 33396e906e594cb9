"""The Krylov loop's operator pass (cuda_kernels/blas.py, csrc/blas.cu):
on the CPU, where the loop routes A x and b - A x; on the card, the kernel
against its plain twin (ops/blas.py) bit for bit, and a whole BiCGSTAB
solve on it against the same solve on the twin.

Tests marked ``cuda`` skip where ``torch.cuda.is_available()`` is false
(decided inside the tests, not at import).  This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_blas_cuda.py
"""

import re

import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import blas as cblas
from cubez_tpu_torch.ops import blas
from cubez_tpu_torch.ops import maf as maf_ops
from cubez_tpu_torch.perf import spans
from cubez_tpu_torch.solvers import bicgstab

torch.set_num_threads(1)

OPS = ("calc_ax", "calc_rk")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counting(monkeypatch, module, names):
    """Wrap ``module``'s functions ``names`` to count their calls."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*args, fn=fn, name=name):
            calls[name] += 1
            return fn(*args)

        monkeypatch.setattr(module, name, counted)
    return calls


def _fields(shape, dtype, device, holes: bool, seed=5):
    """(p, b, msk) of ``shape`` (K, I, J): p and b uniform in [-1, 1) over
    the whole array, boundary shell included; msk the standard inner mask,
    with ``holes`` a tenth of its inner nodes zeroed as well."""
    K, I, J = shape
    gen = torch.Generator().manual_seed(seed)
    p, b = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
            for _ in range(2))
    msk = czt.Problem.poisson_cube((I, J, K), dtype=dtype, device="cpu").msk.clone()
    if holes:
        msk[torch.rand(shape, generator=gen) < 0.1] = 0
    return p.to(device), b.to(device), msk.to(device)


def _apply(fns, op, p, b, msk):
    return fns.calc_ax(p, msk) if op == "calc_ax" else fns.calc_rk(p, b, msk)


# ---- on the CPU: the loop's routes -------------------------------------------


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", OPS)
def test_cpu_fields_take_the_plain_twin(op, dtype, holes):
    """A CPU field runs ops/blas.py's function itself: the same values, and
    the pass launches nothing."""
    p, b, msk = _fields((9, 10, 11), dtype, "cpu", holes)
    before = cblas.operator_pass.launches
    assert torch.equal(_apply(cblas, op, p, b, msk), _apply(blas, op, p, b, msk))
    assert cblas.operator_pass.launches == before


@pytest.mark.parametrize("op", OPS)
def test_vector_ops_route_the_constant_operator_to_the_twin_on_the_cpu(
        op, monkeypatch):
    """VectorOps.ax/rk with no MAF coefficients call ops/blas.py's twin on
    CPU fields, never the MAF operator, and launch nothing."""
    twin = _counting(monkeypatch, blas, OPS)
    maf = _counting(monkeypatch, maf_ops, ("calc_ax_maf", "calc_rk_maf"))
    prob = czt.Problem.poisson_cube(8, torch.float64, device="cpu")
    ops = bicgstab.VectorOps(prob, None, lambda v: v)
    p = torch.rand(8, 8, 8, dtype=torch.float64) * prob.msk
    before = cblas.operator_pass.launches
    got = ops.ax(p) if op == "calc_ax" else ops.rk(p, prob.rhs)
    assert twin == {o: int(o == op) for o in OPS}
    assert set(maf.values()) == {0}
    assert cblas.operator_pass.launches == before
    want = (blas.calc_ax(p, prob.msk) if op == "calc_ax"
            else blas.calc_rk(p, prob.rhs, prob.msk))
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", OPS)
def test_vector_ops_maf_branch_keeps_the_maf_operator(op, monkeypatch):
    """With MAF coefficients VectorOps.ax/rk call ops/maf.py's operator, as
    before; neither the twin nor the pass."""
    twin = _counting(monkeypatch, blas, OPS)
    maf = _counting(monkeypatch, maf_ops, ("calc_ax_maf", "calc_rk_maf"))
    prob = czt.Problem.poisson_cube(8, torch.float64, device="cpu", maf=True)
    ops = bicgstab.VectorOps(prob, prob.mc, lambda v: v)
    p = torch.rand(8, 8, 8, dtype=torch.float64) * prob.msk
    before = cblas.operator_pass.launches
    if op == "calc_ax":
        ops.ax(p)
    else:
        ops.rk(p, prob.rhs)
    assert maf == {"calc_ax_maf": int(op == "calc_ax"),
                   "calc_rk_maf": int(op == "calc_rk")}
    assert set(twin.values()) == {0}
    assert cblas.operator_pass.launches == before


@pytest.mark.parametrize("solver,applications", [
    ("pbicgstab", lambda iters: 2 * iters + 1),  # ax twice, rk once
    ("cg", lambda iters: iters + 1),  # ax once, rk once
])
def test_cpu_krylov_solve_applies_the_twin(solver, applications, monkeypatch):
    """A whole CPU Krylov solve applies the operator through the twin, once
    for the start's residual and once or twice an iteration; the pass
    launches nothing."""
    twin = _counting(monkeypatch, blas, OPS)
    prob = czt.Problem.poisson_cube(12, torch.float64, device="cpu")
    before = cblas.operator_pass.launches
    r = czt.solve(prob, solver, omega=0.8, itr_max=4000, precond="jacobi")
    assert r.iters > 2 and r.res < 1e-5
    assert twin["calc_rk"] == 1
    assert twin["calc_ax"] + twin["calc_rk"] == applications(r.iters)
    assert cblas.operator_pass.launches == before


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("solver,precond", [("pbicgstab", "sor2sma"),
                                            ("cg", "jacobi")])
def test_krylov_solve_hands_its_impl_to_the_operator(solver, precond, impl,
                                                     monkeypatch):
    """solve's ``impl`` reaches every application of the constant operator
    (cuda_kernels/blas.py decides there between the pass and the twin), as
    it reaches the preconditioner's route: 'plain' runs the plain twins on
    any device (solvers/api.py)."""
    seen = []
    for name in OPS:
        fn = getattr(cblas, name)

        def recorded(*args, fn=fn):
            seen.append(args[-1])
            return fn(*args)

        monkeypatch.setattr(cblas, name, recorded)
    prob = czt.Problem.poisson_cube(10, torch.float64, device="cpu")
    r = czt.solve(prob, solver, omega=0.8, itr_max=4000, precond=precond,
                  impl=impl)
    assert r.iters > 2 and r.res < 1e-5
    assert len(seen) >= r.iters + 1 and set(seen) == {impl}


def test_launch_counters_leave_out_the_operator():
    """host_us_per_launch divides the step calls' host time by the
    wrappers' launches in spans.LAUNCH_COUNTERS; the operator runs outside
    the step calls, so it is not one of them."""
    assert spans.LAUNCH_COUNTERS == (
        ("rbpack", ("rb_sweeps_n", "rb_single")),
        ("sweeps", ("jacobi_k4", "sor2sma_k4")),
        ("rblines", ("rbl",)),
        ("lines", ("line_j", "line_rb")),
        ("pcr", ("fused_pcr",)),
        ("psor", ("psor_diag",)),
        ("pcr_gs", ("pcr_gs_diag",)),
        ("dist_rbpack", ("dist_rb_sweeps", "exchange_packed")),
        ("dist_sweeps", ("block_sweep",)),
        ("dist_pcr", ("block_pcr",)),
        ("dist_halo", ("halo_exchange", "fold_partials")),
    )


def _refusals(p, msk):
    """(exception, message, call) of what the pass must refuse, for fields
    p and msk that it would take."""
    q = p.clone()

    def strided(t):  # t's values at t's shape, not contiguous
        return torch.stack([t, t], dim=-1)[..., 0]

    return [
        (TypeError, "float32 or float64",
         lambda: cblas.operator_pass(p.half(), msk.half())),
        (ValueError, "contiguous", lambda: cblas.operator_pass(strided(p), msk)),
        (ValueError, "contiguous", lambda: cblas.operator_pass(p, strided(msk))),
        (ValueError, "contiguous",
         lambda: cblas.operator_pass(p, msk, strided(q))),
        (ValueError, "must match", lambda: cblas.operator_pass(p, msk[:-1])),
        (ValueError, "must match", lambda: cblas.operator_pass(p, msk.float())),
        (ValueError, "must match",
         lambda: cblas.operator_pass(p, msk, q[:, :, :-1])),
        (ValueError, "must match", lambda: cblas.operator_pass(p, msk, q.float())),
        (ValueError, "(K, I, J)", lambda: cblas.operator_pass(p[0], msk[0])),
    ]


@pytest.mark.parametrize("case", range(9))
def test_operator_pass_refuses_before_launching(case):
    """The pass's checks run before it loads the kernels: each refusal on
    CPU fields raises and launches nothing."""
    p, _, msk = _fields((6, 7, 8), torch.float64, "cpu", False)
    exc, match, call = _refusals(p, msk)[case]
    before = cblas.operator_pass.launches
    with pytest.raises(exc, match=re.escape(match)):
        call()
    assert cblas.operator_pass.launches == before


# ---- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("shape", [(17, 24, 31), (32, 32, 32), (64, 96, 200),
                                   (256, 256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", OPS)
def test_kernel_is_bitwise_its_twin(dev, op, dtype, shape, holes):
    """The kernel equals ops/blas.py's function on the same CUDA fields bit
    for bit (and, at the small shapes, the twin on the CPU), odd and even
    shapes, a ragged last chunk of planes (64, 96, 200), the standard mask
    and one with interior holes; one launch a call, into a new field."""
    p, b, msk = _fields(shape, dtype, dev, holes)
    before = cblas.operator_pass.launches
    got = _apply(cblas, op, p, b, msk)
    torch.cuda.synchronize()
    assert cblas.operator_pass.launches == before + 1
    assert got.data_ptr() not in (p.data_ptr(), b.data_ptr(), msk.data_ptr())
    assert got.dtype == dtype and got.shape == p.shape
    assert torch.equal(got, _apply(blas, op, p, b, msk))
    if p.numel() <= 2 ** 20:
        assert torch.equal(got.cpu(), _apply(blas, op, p.cpu(), b.cpu(), msk.cpu()))


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(dev):
    """Every CPU refusal holds on the card, and fields on two devices are
    refused too."""
    p, _, msk = _fields((6, 7, 8), torch.float64, dev, False)
    before = cblas.operator_pass.launches
    for exc, match, call in _refusals(p, msk):
        with pytest.raises(exc, match=re.escape(match)):
            call()
    with pytest.raises(ValueError, match="must match"):
        cblas.calc_ax(p, msk.cpu())
    with pytest.raises(ValueError, match="must match"):
        cblas.calc_rk(p, p.cpu(), msk)
    assert cblas.operator_pass.launches == before


@pytest.mark.cuda
def test_pbicgstab_64_on_the_kernel_is_bitwise_the_twins_solve(dev, monkeypatch):
    """A 64^3 float64 pbicgstab with the sor2sma preconditioner on the pass
    gives the history, count and field of the same solve with A x and
    b - A x on the twin, bit for bit; the pass runs twice an iteration and
    once for the start's residual."""
    prob = czt.Problem.poisson_cube(64, torch.float64, device=dev)

    def run():
        r = czt.solve(prob, "pbicgstab", omega=1.1, itr_max=4000,
                      precond="sor2sma")
        torch.cuda.synchronize()
        return r

    before = cblas.operator_pass.launches
    rk = run()
    launches = cblas.operator_pass.launches - before
    monkeypatch.setattr(cblas, "calc_ax",
                        lambda p, msk, impl: blas.calc_ax(p, msk))
    monkeypatch.setattr(cblas, "calc_rk",
                        lambda p, b, msk, impl: blas.calc_rk(p, b, msk))
    rt = run()
    assert cblas.operator_pass.launches - before == launches
    assert rk.iters == rt.iters > 2 and rk.res < 1e-5
    assert launches == 2 * rk.iters + 1
    assert torch.equal(rk.history, rt.history)
    assert torch.equal(rk.x, rt.x)


@pytest.mark.cuda
@pytest.mark.parametrize("solver,precond,applications", [
    ("pbicgstab", "sor2sma", lambda iters: 2 * iters + 1),
    ("cg", "jacobi", lambda iters: iters + 1),
])
def test_plain_krylov_solve_launches_no_operator_pass(dev, solver, precond,
                                                      applications):
    """On CUDA fields ``impl='plain'`` applies the operator through the
    twin and launches no pass; 'auto' launches it once an application."""
    prob = czt.Problem.poisson_cube(32, torch.float64, device=dev)
    for impl in ("plain", "auto"):
        before = cblas.operator_pass.launches
        r = czt.solve(prob, solver, omega=1.1 if solver == "pbicgstab" else 0.8,
                      itr_max=4000, precond=precond, impl=impl)
        torch.cuda.synchronize()
        assert r.iters > 2 and r.res < 1e-5
        launched = cblas.operator_pass.launches - before
        assert launched == (0 if impl == "plain" else applications(r.iters)), impl
