"""The port's perf layer (cubez_tpu_torch/perf) on the CPU, against the
JAX package's analytic functions (cubez_tpu/perf) on the same inputs.

JAX is held to its analytic pieces (the cost table, the memory model, the
halo bytes, the report text): nothing here jits a shard_map or times JAX.
The port's own timings run on CPU tensors at 16^3 at most; what a profile
counts (sections, calls, flops, bytes) is checked exactly, the times only
for sign.  The step labels are checked under torch.profiler on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import cubez_tpu_torch as czt
from cubez_tpu.perf import memory as jmemory
from cubez_tpu.perf import pmlib as jpmlib
from cubez_tpu.perf import profile as jprofile
from cubez_tpu.perf import roofline as jroofline
from cubez_tpu_torch.cuda_kernels import lines, rbpack
from cubez_tpu_torch.parallel.api import dist_route
from cubez_tpu_torch.perf import memory, pmlib, profile, roofline
from cubez_tpu_torch.solvers import steps
from cubez_tpu_torch.solvers.driver import run_iterative
from cubez_tpu_torch.solvers.fused_cache import get_fused_step, relaxation_route

torch.set_num_threads(1)

SEED = 20261018
ITEMSIZE = {"f32": 4, "f64": 8}
LINE_NAMES = ("pcr", "pcr_eda", "pcr_esa", "pcr_j_esa", "pcr_rb", "pcr_rb_esa",
              "pcr_maf", "pcr_rb_maf", "pcr_rb_esa_maf")


# ---- roofline ---------------------------------------------------------------

def test_cost_table_is_jax():
    assert {k: (c.flops_per_pt, c.streams) for k, c in roofline.COSTS.items()} \
        == {k: (c.flops_per_pt, c.streams) for k, c in jroofline.COSTS.items()}
    for n in (1, 2, 6, 14, 126, 510):
        assert roofline.pcr_flops_per_pt(n) == jroofline.pcr_flops_per_pt(n)


@pytest.mark.parametrize("b_is_zero", [False, True])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(jroofline.COSTS))
def test_sweep_cost_point_and_blas_equal_jax(name, dt, b_is_zero):
    """Every point and BLAS key, f32 and f64, with and without a zero b:
    the JAX package's (flops, bytes)."""
    shape = (18, 12, 14)
    assert roofline.sweep_cost(name, shape, ITEMSIZE[dt], b_is_zero) \
        == jroofline.sweep_cost(name, shape, ITEMSIZE[dt], b_is_zero)


@pytest.mark.parametrize("name", LINE_NAMES)
def test_sweep_cost_line_kinds(name):
    """The line kinds: the JAX package's bytes (2 or 3 streams), and the
    port's count of the operations its kernels do (Thomas for K5/K6, PCR
    for P2 and the block lines)."""
    shape = (34, 12, 14)
    npts = 34 * 12 * 14
    maf = name.endswith("_maf")
    for dt in ("f32", "f64"):
        for b0 in (False, True):
            f, nbytes = roofline.sweep_cost(name, shape, ITEMSIZE[dt], b0)
            assert nbytes == jroofline.sweep_cost(name, shape, ITEMSIZE[dt], b0)[1]
            if steps.parse_name(name)[0] == "pcr_gs":
                assert roofline.line_form(name) == "pcr"
                assert f == roofline.pcr_flops_per_pt(32) * npts
            else:
                assert roofline.line_form(name) == "thomas"
                assert f == roofline.thomas_flops_per_pt(32, maf, not b0) * npts
            fp, _ = roofline.sweep_cost(name, shape, ITEMSIZE[dt], b0, form="pcr",
                                        line_n=16)
            assert fp == roofline.pcr_flops_per_pt(16) * npts
    with pytest.raises(ValueError, match="form must be"):
        roofline.sweep_cost(name, shape, 4, form="matmul")


class _CountArith(TorchDispatchMode):
    """Counts the elementwise operations a torch program does: one for each
    output element of an add, subtract, multiply or division, one for each
    input element of a sum."""

    ARITH = {"add", "sub", "mul", "div"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        base = func.__name__.split(".")[0].rstrip("_")
        if base in self.ARITH:
            self.ops += out.numel()
        elif base == "sum":
            self.ops += args[0].numel()
        return out


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("has_b", [False, True])
def test_thomas_count_is_the_twins_arithmetic(maf, has_b):
    """``thomas_flops_per_pt`` is the operation count of the line-Jacobi
    twin (cuda_kernels/lines.py::line_j_plain, every operation of the
    Thomas tile of K5, K6 and K9 'fastdiag', which the kernels match bit
    for bit), counted op by op
    over its inner line points."""
    K, I, J = 12, 7, 9
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((K, I, J))).to(torch.float32)
    b = torch.from_numpy(rng.standard_normal((K, I, J))).to(torch.float32)
    tab = None
    if maf:
        mc = czt.Problem.poisson_cube((I, J, K), device="cpu", maf=True).mc
        tab = rbpack.maf_tables(mc, (K, I, J), torch.float32)
    with _CountArith() as cnt:
        lines.line_j_plain(x, b if has_b else None, 1.0, tab)
    per_pt = cnt.ops / ((K - 2) * (I - 2) * (J - 2))
    assert per_pt == pytest.approx(
        roofline.thomas_flops_per_pt(K - 2, maf, has_b), rel=1e-12)


# ---- memory -----------------------------------------------------------------

@pytest.mark.parametrize("name", czt.SOLVERS)
def test_memory_requirement_equals_jax(name):
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        for ndiv in (1, 8):
            shape = (64, 48, 32)
            assert memory.memory_requirement(shape, name, tdt, ndiv) \
                == jmemory.memory_requirement(shape, name, jdt, ndiv)
            assert memory.report(shape, name, tdt, ndiv) \
                == jmemory.report(shape, name, jdt, ndiv)


# ---- pmlib ------------------------------------------------------------------

def _fill(pm, calc, comm):
    pm.add("Jacobi_kernel", 0.25, kind=calc, flops=3e9, bytes=8e9, calls=40)
    pm.add("Comm_Res_Poisson", 0.0125, kind=comm, bytes=1.5e6, calls=40)
    pm.add("flops_only", 0.5, kind=calc, flops=4e10, calls=3)
    pm.add("unused", 0.0, calls=0)
    pm.add("solve_total", 1.75, kind=calc, calls=40)
    pm.sections["solve_total"].exclusive = False
    pm.add("Jacobi_kernel", 0.125, kind=calc, flops=1e9, bytes=2e9, calls=2)


@pytest.mark.parametrize("hbm,peak", [(3350.0, 67e3), (None, 67e3), (None, None)])
def test_perf_monitor_report_equals_jax(hbm, peak, tmp_path):
    pm, jpm = pmlib.PerfMonitor(hbm, peak), jpmlib.PerfMonitor(hbm, peak)
    _fill(pm, pmlib.CALC, pmlib.COMM)
    _fill(jpm, jpmlib.CALC, jpmlib.COMM)
    assert pm.report() == jpm.report()
    pm.write(tmp_path / "profiling.txt")
    assert (tmp_path / "profiling.txt").read_text() == jpm.report() + "\n"


def test_section_times_on_the_host():
    pm = pmlib.PerfMonitor(device="cpu")
    x = torch.ones(64)
    with pm.section("sweep", pmlib.CALC, flops=64.0, bytes=512.0) as s:
        for _ in range(50):
            x = x * 1.0001
    assert s is pm.sections["sweep"]
    assert s.calls == 1 and s.seconds > 0 and s.flops == 64.0 and s.bytes == 512.0


@pytest.mark.parametrize("card,hbm,f32,f64", [
    ("NVIDIA H100 80GB HBM3", 3350.0, 67e3, 34e3),
    ("NVIDIA H100 PCIe", 2000.0, 51e3, 26e3),
    ("NVIDIA H100 NVL", 3900.0, 60e3, 30e3),
    ("NVIDIA A100-SXM4-80GB", None, None, None),
])
def test_device_table(card, hbm, f32, f64, monkeypatch):
    """The card's data-sheet figures by name; an unknown card gives None
    (the report leaves %SoL blank), never another card's figure; the CPU
    50 GB/s, as the JAX package's."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: card)
    assert pmlib.device_hbm_gbps("cuda:0") == hbm
    assert pmlib.device_peak_gflops("cuda:0", torch.float32) == f32
    assert pmlib.device_peak_gflops("cuda:0", torch.float64) == f64
    assert pmlib.device_peak_gflops("cuda:0", torch.float16) is None
    assert pmlib.device_hbm_gbps("cpu") == 50.0
    assert pmlib.device_peak_gflops("cpu") is None
    assert not any("tpu" in key for key, _ in pmlib.CARDS)


# ---- profile ----------------------------------------------------------------

def test_comm_bytes_per_exchange_equals_jax():
    for bs in ((8, 8, 8), (64, 64, 64), (128, 32, 16)):
        for itemsize in (4, 8):
            assert profile.comm_bytes_per_exchange(bs, itemsize) \
                == jprofile.comm_bytes_per_exchange(bs, itemsize)


@pytest.mark.parametrize("solver,omega", [
    ("sor2sma", 1.5), ("jacobi", 0.8), ("pcr_rb", 1.5)])
def test_profile_solve_serial(solver, omega):
    """16^3 on CPU tensors: the sections of the JAX package's serial
    profile, exactly ``iters`` iterations with their analytic flops and
    bytes (a call of n iterations counted n times, the rest run one at a
    time on step.single)."""
    p = czt.Problem.poisson_cube(16, device="cpu")
    iters = 10
    pm = profile.profile_solve(p, solver, omega, iters=iters)
    assert pm.order == [f"{solver}_sweep", "driver_overhead"]
    sw, drv = pm.sections[f"{solver}_sweep"], pm.sections["driver_overhead"]
    flops1, bytes1 = roofline.sweep_cost(solver, (16, 16, 16), 4, True)
    assert sw.kind == drv.kind == pmlib.CALC
    assert sw.calls == drv.calls == iters
    assert sw.flops == flops1 * iters and sw.bytes == bytes1 * iters
    assert sw.seconds > 0 and drv.seconds >= 0
    assert pm.hbm_gbps == 50.0
    rep = pm.report()
    assert f"{solver}_sweep" in rep and "driver_overhead" in rep


def test_exact_sweeps_run_the_iterations():
    """exact_sweeps runs exactly n iterations of a 6-iteration chain (one
    call and four singles for 10): the field run_iterative reaches in 10
    iterations, bit for bit."""
    p = czt.Problem.poisson_cube(16, device="cpu")
    step, pre, post = relaxation_route(p, "sor2sma", 1.5)
    assert step.iters_per_call == 6 and profile.calls_for(step, 10) == (1, 4)
    x = profile.exact_sweeps(step, 10)(pre(p.x0), pre(p.rhs))
    r = run_iterative(step, p.x0, p.rhs, p.grid.res_normal, 10, eps=0.0,
                      pre=pre, post=post)
    assert r.iters == 10 and torch.equal(post(x), r.x)


def test_profile_solve_refuses_drivers():
    p = czt.Problem.poisson_cube(8, device="cpu")
    for name in ("pbicgstab", "cg", "mg", "fd"):
        with pytest.raises(ValueError, match="relaxation and line solvers"):
            profile.profile_solve(p, name, 1.0, iters=2)


@pytest.mark.parametrize("solver,omega,dtype,route,per_iter", [
    ("sor2sma", 1.5, torch.float32, "pack", None),
    ("jacobi", 0.8, torch.float32, "fused", 1),
    ("pcr_rb", 1.5, torch.float32, "fused", 2),
    ("sor2sma", 1.5, torch.float64, "plain", 2),
])
def test_profile_solve_dist(solver, omega, dtype, route, per_iter):
    """Over eight CPU blocks, (2, 2, 2) at 16^3: the route solve_dist takes,
    its exchanges counted from that route (before each colour on K8/K9 and
    parallel/dist.py, once a call of n iterations on the pack ring), COMM
    bytes the reference's width-1 halo volume a block an exchange, the
    fold once a call."""
    p = czt.Problem.poisson_cube(16, dtype, device="cpu")
    cm = czt.make_mesh(p.grid.shape_kij, devices=["cpu"] * 8, div=(2, 2, 2))
    rt = dist_route(p, cm, solver, omega)
    assert rt.kind == route
    iters = 10
    pm = profile.profile_solve(p, solver, omega, iters=iters, cmesh=cm)
    assert pm.order == ["halo_exchange", "residual_allreduce",
                        f"{solver}_block_sweep"]
    n, rest = profile.calls_for(rt.step, iters)
    n_exch = n + rest if per_iter is None else per_iter * iters
    itemsize = 4 if dtype == torch.float32 else 8
    halo, fold = pm.sections["halo_exchange"], pm.sections["residual_allreduce"]
    sweep = pm.sections[f"{solver}_block_sweep"]
    assert halo.kind == fold.kind == pmlib.COMM and sweep.kind == pmlib.CALC
    assert halo.calls == n_exch > 0
    assert halo.bytes == profile.comm_bytes_per_exchange((8, 8, 8), itemsize) \
        * n_exch > 0
    assert fold.calls == n + rest and fold.bytes == profile.FOLD_BYTES * (n + rest)
    assert sweep.calls == iters and halo.seconds > 0 and fold.seconds > 0
    form, line_n = (None, None) if solver != "pcr_rb" else ("pcr", 8)
    flops1, bytes1 = roofline.sweep_cost(solver, (16, 16, 16), itemsize, True,
                                         form=form, line_n=line_n)
    assert sweep.flops == flops1 * iters and sweep.bytes == bytes1 * iters


def test_profile_solve_dist_gathered():
    """psor over the mesh runs the serial step on the gathered field: no
    exchange an iteration, the block sweep alone."""
    p = czt.Problem.poisson_cube(8, device="cpu")
    cm = czt.make_mesh(p.grid.shape_kij, devices=["cpu"] * 8, div=(2, 2, 2))
    pm = profile.profile_solve(p, "psor", 1.1, iters=3, cmesh=cm)
    assert pm.order == ["psor_block_sweep"]
    assert pm.sections["psor_block_sweep"].calls == 3


# ---- labels -----------------------------------------------------------------

def _events(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_solver_label_under_the_profiler():
    """Under torch.profiler an 8^3 solve records an event named after its
    solver, for each call of the step; solve_dist and a preconditioner's
    steps too."""
    p = czt.Problem.poisson_cube(8, device="cpu")
    before = steps.labeled.entered
    names = _events(lambda: czt.solve(p, "sor2sma", omega=1.5, itr_max=12))
    assert names.count("sor2sma") >= 2  # 12 iterations: two calls of six
    assert steps.labeled.entered > before
    cm = czt.make_mesh(p.grid.shape_kij, devices=["cpu"] * 8, div=(2, 2, 2))
    assert "jacobi" in _events(lambda: czt.solve_dist(
        p, cm, "jacobi", omega=0.8, itr_max=3))
    assert "pcr_rb" in _events(lambda: czt.solve(
        p, "pbicgstab", omega=1.1, itr_max=2, precond="pcr_rb"))


def test_no_label_without_a_profiler(monkeypatch):
    """With no profiler on, a solve never enters the label."""
    entered = []

    def counting(name):
        entered.append(name)
        return torch.autograd.profiler.record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    before = steps.labeled.entered
    p = czt.Problem.poisson_cube(8, device="cpu")
    r = czt.solve(p, "sor2sma", omega=1.5, itr_max=20)
    assert r.iters == 16 and entered == [] and steps.labeled.entered == before
    names = _events(lambda: czt.solve(p, "sor2sma", omega=1.5, itr_max=2))
    assert entered and set(entered) == {"sor2sma"} and "sor2sma" in names


def test_label_carries_the_step_attributes():
    p = czt.Problem.poisson_cube(16, device="cpu")
    raw = get_fused_step("sor2sma", p.grid, 1.5, b_is_zero=True)
    step, pre, post = relaxation_route(p, "sor2sma", 1.5)
    assert step.__wrapped__.__code__ is raw.__code__
    assert step.iters_per_call == raw.iters_per_call == 6
    assert torch.equal(post(pre(p.rhs)), raw.unpad(raw.pad(p.rhs)))
    assert torch.equal(pre(p.x0), raw.pad(p.x0))
    assert step.single is not step and step.single.__wrapped__ is not None
    j, _, _ = relaxation_route(p, "psor", 1.1)
    assert j.check_every_default == 1 and j.single is not None
    fmg, pre, post = relaxation_route(p, "fmg", 1.0)
    assert pre is None and post is None and callable(fmg.fmg_init)
    assert fmg.check_every_default == 2


# ---- the shared routes --------------------------------------------------------

def _masked(n):
    p = czt.Problem.poisson_cube(n, device="cpu")
    msk = p.msk.clone()
    msk[5:8, 6, 7] = 0.0
    return dataclasses.replace(p, msk=msk)


@pytest.mark.parametrize("solver,omega,problem", [
    ("sor2sma", 1.5, "cube"), ("pcr_rb", 1.5, "cube"), ("psor", 1.1, "cube"),
    ("sor2sma", 1.5, "masked"), ("mg", 1.0, "cube")])
def test_solve_runs_the_route(solver, omega, problem):
    """solve's count, history and field at 16^3 are those of the route's
    step driven by hand: the kernel step with its converters, the exact
    serial order's, the plain sweep for a non-standard mask, and an
    extension's step."""
    p = czt.Problem.poisson_cube(16, device="cpu") if problem == "cube" \
        else _masked(16)
    r = czt.solve(p, solver, omega=omega, itr_max=40)
    step, pre, post = relaxation_route(p, solver, omega)
    assert (pre is None) == (problem == "masked" or solver == "mg")
    ref = run_iterative(step, p.x0, p.rhs, p.grid.res_normal, 40,
                        pre=pre, post=post)
    assert r.iters == ref.iters and torch.equal(r.history, ref.history)
    assert torch.equal(r.x, ref.x)


@pytest.mark.parametrize("solver,omega,dtype,kind", [
    ("sor2sma", 1.5, torch.float32, "pack"), ("pcr_rb", 1.5, torch.float32, "fused"),
    ("jacobi_maf", 0.8, torch.float32, "plain"), ("psor", 1.1, torch.float32, "gathered")])
def test_solve_dist_runs_the_route(solver, omega, dtype, kind):
    p = czt.Problem.poisson_cube(16, dtype, device="cpu",
                                 maf=solver.endswith("_maf"))
    cm = czt.make_mesh(p.grid.shape_kij, devices=["cpu"] * 8, div=(2, 2, 2))
    r = czt.solve_dist(p, cm, solver, omega=omega, itr_max=30)
    rt = dist_route(p, cm, solver, omega)
    assert rt.kind == kind
    ref = run_iterative(rt.step, rt.x, rt.b, p.grid.res_normal, 30,
                        pre=rt.pre, post=rt.post)
    assert r.iters == ref.iters and torch.equal(r.history, ref.history)
    assert torch.equal(r.x, rt.out(ref.x))
