"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the tests, not at import).  This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

import cubez_tpu_torch as czt
from cubez_tpu_torch.cuda_kernels import lines as k6
from cubez_tpu_torch.cuda_kernels import rblines as k5
from cubez_tpu_torch.cuda_kernels import rbpack as rb
from cubez_tpu_torch.cuda_kernels import sweeps as k4

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

OMEGA = 1.5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


WRAPPERS = (rb.rb_color, rb.rb_sweeps_n, k4.jacobi_k4, k4.sor2sma_k4,
            k5.rbl, k6.line_j, k6.line_rb)


def _launches():
    return sum(w.launches for w in WRAPPERS)


def _builders(mc):
    """(label, build(shape, dtype, offset, plain)) for every kernel step;
    ``mc`` selects the MAF forms (the window chain at n <= 7)."""
    yield "single b=0", lambda sh, dt, off, pl: rb.make_packed_sweep(
        sh, dt, omega=OMEGA, offset=off, b_is_zero=True, mc=mc, plain=pl)
    yield "single b", lambda sh, dt, off, pl: rb.make_packed_sweep(
        sh, dt, omega=OMEGA, offset=off, b_is_zero=False, mc=mc, plain=pl)
    yield "pair b", lambda sh, dt, off, pl: rb.make_packed_sweep2x(
        sh, dt, omega=OMEGA, offset=off, b_is_zero=False, mc=mc, plain=pl)
    for n in (3, 4, 6):
        yield f"n={n}", lambda sh, dt, off, pl, n=n: rb.make_packed_sweepnx(
            sh, dt, omega=OMEGA, n=n, offset=off, mc=mc, plain=pl)
    for kind in k4.KINDS:
        for bz in (True, False):
            yield f"K4 {kind} b={not bz}", (
                lambda sh, dt, off, pl, kind=kind, bz=bz: k4.make_fused_sweep(
                    kind, sh, dt, omega=OMEGA if kind == "sor2sma" else 0.8,
                    offset=off, b_is_zero=bz, mc=mc, plain=pl))


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 10, 17), (13, 11, 16)])
def test_kernels_match_plain_twins(dev, shape, dtype, offset, maf):
    """float32 fields bitwise equal; float64 within 1e-14 (the twin has no
    fma); residuals to rtol 1e-5 (block partial sums group differently).
    MAF on the stretched grid's coefficients; odd I takes K4 only."""
    mc = None
    if maf:
        K, I, J = shape
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
    gen = torch.Generator().manual_seed(3 + offset)
    x = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    b = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    tol = 0.0 if dtype == torch.float32 else 1e-14
    n_steps = 0
    for label, build in _builders(mc):
        kstep = build(shape, dtype, offset, False)
        pstep = build(shape, dtype, offset, True)
        if kstep is None:  # odd I: no packed layout
            continue
        x0, b0 = kstep.pad(x.to(dev)), kstep.pad(b.to(dev))
        xk, xp = x0.clone(), x0.clone()
        before = _launches()
        for _ in range(3):
            xk, rk = kstep(xk, b0)
            xp, rp = pstep(xp, b0)
        torch.cuda.synchronize()
        assert _launches() > before, label
        assert float((xk - xp).abs().max()) <= tol, label
        torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)
        n_steps += 1
    assert n_steps == (4 if shape[1] % 2 else 10)


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


def test_odd_i_on_cuda_launches_k4(dev):
    """Odd I, where the packed layout refuses, runs K4's colour kernel, and
    stops where the plain twin on the card stops."""
    prob = czt.Problem.poisson_cube((15, 16, 16), device=dev)
    before = k4.sor2sma_k4.launches
    r = czt.solve(prob, "sor2sma", omega=OMEGA, itr_max=2000)
    assert k4.sor2sma_k4.launches > before
    p = czt.solve(prob, "sor2sma", omega=OMEGA, itr_max=2000, impl="plain")
    assert r.iters == p.iters < 2000
    assert torch.equal(r.x, p.x)


@pytest.mark.parametrize("name", ["sor2sma", "jacobi", "pcr_rb", "pcr_j_esa"])
def test_non_standard_mask_on_cuda_raises(dev, name):
    """No kernel takes a mask other than the standard one, so 'auto'
    refuses it on the card; 'plain' runs the plain sweep there."""
    base = czt.Problem.poisson_cube(16, device="cpu")
    msk = base.msk.numpy().copy()
    msk[5:8, 6, 7] = 0.0  # an obstacle
    prob = czt.Problem.from_arrays((16, 16, 16), torch.float32,
                                   base.x0.numpy(), base.rhs.numpy(), msk,
                                   rhs_inner_zero=True, device=dev)
    before = _launches()
    with pytest.raises(NotImplementedError, match="masked"):
        czt.solve(prob, name, omega=0.8, itr_max=50)
    assert _launches() == before
    r = czt.solve(prob, name, omega=0.8, itr_max=50, impl="plain")
    assert r.x.is_cuda and _launches() == before


@pytest.mark.parametrize("name,omega", [
    ("jacobi", 0.8), ("jacobi_maf", 0.8), ("sor2sma_maf", OMEGA),
])
def test_slice_2_solves_on_cuda_match_cpu_twin(dev, name, omega):
    """jacobi (K4), jacobi_maf (K4-MAF) and sor2sma_maf (the packed MAF
    pair) at 32^3: the oracle's counts, the CPU twin's field bit for bit,
    and the MAF launches counted."""
    maf = name.endswith("_maf")
    g = czt.Problem.poisson_cube(32, device=dev, maf=maf)
    c = czt.Problem.poisson_cube(32, device="cpu", maf=maf)
    before = sum(w.maf_launches for w in WRAPPERS)
    rg = czt.solve(g, name, omega=omega, itr_max=10000)
    rc = czt.solve(c, name, omega=omega, itr_max=10000)
    assert rg.iters == rc.iters == (199 if name == "sor2sma_maf" else 1015)
    assert torch.equal(rg.x.cpu(), rc.x)
    assert (sum(w.maf_launches for w in WRAPPERS) > before) == maf


def test_jacobi_kernel_is_out_of_place(dev):
    x = torch.rand(12, 13, 14, device=dev)
    keep = x.clone()
    out, _ = k4.jacobi_k4(x, None, 0.8)
    torch.cuda.synchronize()
    assert torch.equal(x, keep) and out.data_ptr() != x.data_ptr()
    # the boundary shell is carried into the new field
    inner = (slice(1, -1),) * 3
    shell = torch.ones_like(x, dtype=torch.bool)
    shell[inner] = False
    assert torch.equal(out[shell], x[shell])
    with pytest.raises(ValueError, match="out of place"):
        k4.jacobi_k4(x, None, 0.8, out=x)


def test_jacobi_step_alternates_two_buffers(dev):
    """The step writes one of its two buffers, never the field it is
    handed, and its fields equal the plain twin's step by step."""
    shape = (12, 13, 14)
    step = k4.make_fused_sweep("jacobi", shape, torch.float32, omega=0.8,
                               b_is_zero=True)
    twin = k4.make_fused_sweep("jacobi", shape, torch.float32, omega=0.8,
                               b_is_zero=True, plain=True)
    x0 = torch.rand(shape, device=dev)
    keep = x0.clone()
    xk, xp, ptrs = x0, x0.clone(), []
    for _ in range(4):
        xk, _ = step(xk, None)
        xp, _ = twin(xp, None)
        ptrs.append(xk.data_ptr())
        assert torch.equal(xk, xp)
    assert torch.equal(x0, keep)
    assert ptrs[0] == ptrs[2] != ptrs[1] == ptrs[3] != x0.data_ptr()
    # a foreign field (the driver's snapshot) is read, not written
    snap = xp.clone()
    xk, _ = step(snap, None)
    xp, _ = twin(xp, None)
    assert torch.equal(xk, xp) and xk.data_ptr() != snap.data_ptr()


def _line_builders(mc):
    """(label, build(shape, dtype, offset, plain)) for every line step;
    None where a layout refuses (K5 at odd I)."""
    for bz in (True, False):
        yield f"K5 b={not bz}", lambda sh, dt, off, pl, bz=bz: k5.make_rbl_step(
            sh, dt, omega=OMEGA, offset=off, b_is_zero=bz, mc=mc, plain=pl)
        for kind in k6.KINDS:
            yield f"K6 {kind} b={not bz}", (
                lambda sh, dt, off, pl, kind=kind, bz=bz: k6.make_line_step(
                    kind, sh, dt, omega=1.0 if kind == "pcr_j" else OMEGA,
                    offset=off, b_is_zero=bz, mc=mc, plain=pl))


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 10, 17), (13, 11, 16)])
def test_line_kernels_match_plain_twins(dev, shape, dtype, offset, maf):
    """K5 and K6 against their twins on the card: float32 fields bitwise,
    float64 within 1e-14, residuals to rtol 1e-5 (block partials group
    the sum differently).  MAF on the stretched grid's coefficients; odd I
    has no K5 step."""
    mc = None
    if maf:
        K, I, J = shape
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
    gen = torch.Generator().manual_seed(5 + offset)
    x = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    b = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    tol = 0.0 if dtype == torch.float32 else 1e-14
    n_steps = 0
    for label, build in _line_builders(mc):
        kstep = build(shape, dtype, offset, False)
        pstep = build(shape, dtype, offset, True)
        if kstep is None:
            continue
        x0, b0 = kstep.pad(x.to(dev)), kstep.pad(b.to(dev))
        xk, xp = x0.clone(), x0.clone()
        before = _launches()
        for _ in range(3):
            xk, rk = kstep(xk, b0)
            xp, rp = pstep(xp, b0)
        torch.cuda.synchronize()
        assert _launches() > before, label
        assert float((xk - xp).abs().max()) <= tol, label
        torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)
        n_steps += 1
    assert n_steps == (4 if shape[1] % 2 else 6)


@pytest.mark.parametrize("name,omega,iters", [
    ("pcr_rb", OMEGA, 140), ("pcr_rb_maf", OMEGA, 140),
    ("pcr_j_esa", 1.0, 624), ("pcr_rb", OMEGA, None),
])
def test_line_solves_on_cuda_match_cpu_twin(dev, name, omega, iters):
    """The line solvers at 32^3 (and pcr_rb at odd I, (31, 32, 32), on
    K6's red-black form): the oracle's counts, the CPU twin's field bit
    for bit, and the launches of the kernel the dispatch picks."""
    n = 32 if iters else (31, 32, 32)
    maf = name.endswith("_maf")
    g = czt.Problem.poisson_cube(n, device=dev, maf=maf)
    c = czt.Problem.poisson_cube(n, device="cpu", maf=maf)
    wrapper = {"pcr_j_esa": k6.line_j}.get(name, k5.rbl if iters else k6.line_rb)
    before = (wrapper.launches, wrapper.maf_launches)
    rg = czt.solve(g, name, omega=omega, itr_max=10000)
    rc = czt.solve(c, name, omega=omega, itr_max=10000)
    assert rg.iters == rc.iters and (iters is None or rg.iters == iters)
    assert torch.equal(rg.x.cpu(), rc.x)
    assert wrapper.launches > before[0]
    assert (wrapper.maf_launches > before[1]) == maf


def test_line_jacobi_step_alternates_two_buffers(dev):
    """K6's pcr_j step writes one of its two buffers, never the field it
    is handed, and its fields equal the plain twin's step by step."""
    shape = (12, 13, 14)
    mc = czt.Problem.poisson_cube((13, 14, 12), device=dev, maf=True).mc
    for m in (None, mc):
        step = k6.make_line_step("pcr_j", shape, omega=1.0, mc=m)
        twin = k6.make_line_step("pcr_j", shape, omega=1.0, mc=m, plain=True)
        x0 = torch.rand(shape, device=dev)
        keep = x0.clone()
        xk, xp, ptrs = x0, x0.clone(), []
        for _ in range(4):
            xk, _ = step(xk, None)
            xp, _ = twin(xp, None)
            ptrs.append(xk.data_ptr())
            assert torch.equal(xk, xp)
        assert torch.equal(x0, keep)
        assert ptrs[0] == ptrs[2] != ptrs[1] == ptrs[3] != x0.data_ptr()


def test_line_solver_without_two_inner_k_raises_on_cuda(dev):
    """K - 2 < 2 has no line kernel step: 'auto' refuses it on the card,
    'plain' runs the plain line sweep there."""
    prob = czt.Problem.poisson_cube((8, 8, 3), device=dev)
    with pytest.raises(NotImplementedError, match="K - 2 >= 2"):
        czt.solve(prob, "pcr_rb", omega=OMEGA, itr_max=5)
    r = czt.solve(prob, "pcr_rb", omega=OMEGA, itr_max=5, impl="plain")
    assert r.x.is_cuda
    with pytest.raises(ValueError, match="K - 2 >= 2"):
        k6.line_rb(torch.zeros(3, 8, 8, device=dev), None, OMEGA)


# ---- slice 9a: K7 (dist_rbpack) and K8 (dist_sweeps) ------------------------

# (block shape, global shape, mesh coords of the block, split axes)
DIST_BLOCKS = [
    ((16, 16, 16), (32, 32, 32), (1, 0, 1), (True, True, True)),
    ((12, 14, 16), (24, 28, 16), (0, 1, 0), (True, True, False)),
]


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 6])
@pytest.mark.parametrize("case", range(len(DIST_BLOCKS)))
def test_k7_matches_plain_twin(dev, case, n, dtype, maf):
    """K7 against its twin on one extended block with nonzero offsets:
    float32 bitwise, float64 within 1e-14, owned residuals to rtol 1e-5."""
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7

    bs, gs, coords, split = DIST_BLOCKS[case]
    mc = None
    if maf:
        K, I, J = gs
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
    origin = tuple(c * s for c, s in zip(coords, bs))
    kern = k7.make_dist_packed_sweepnx(bs, gs, dtype, omega=OMEGA, n=n,
                                       split=split, h=12, mc=mc)
    twin = k7.make_dist_packed_sweepnx(bs, gs, dtype, omega=OMEGA, n=n,
                                       split=split, h=12, mc=mc, plain=True)
    if n == 6 and min(b for b, s in zip(bs, split) if s) < 12:
        assert kern is None
        return
    tab = kern.block_tables(origin, dev) if maf else None
    Ke, Ie, Je, I2e = k7.ext_dims(bs, kern.hs)
    gen = torch.Generator().manual_seed(7 + n)
    x = (torch.rand((2, Ke, I2e, Je), generator=gen, dtype=dtype) * 2 - 1).to(dev)
    xk, xp = x.clone(), x.clone()
    before = k7.dist_rb_sweeps.launches
    rk = kern(xk, origin, tab)
    rp = twin(xp, origin, tab)
    torch.cuda.synchronize()
    assert k7.dist_rb_sweeps.launches == before + 1
    assert float((xk - xp).abs().max()) <= (0.0 if dtype == torch.float32 else 1e-14)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("variant", [
    ("jacobi", None, "all"), ("sor2sma", 0, "all"), ("sor2sma", 1, "all"),
    ("sor2sma", None, "all"), ("sor2sma", 0, "interior"),
    ("sor2sma", 1, "shell"),
])
def test_k8_matches_plain_twin(dev, variant, with_b, dtype):
    """K8 against its twin on a ghosted block with nonzero offsets (a
    corner block, whose faces hold the physical boundary): float32
    bitwise, float64 within 1e-14, residuals to rtol 1e-5."""
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    kind, colour, region = variant
    bs, gs, origin = (10, 12, 14), (20, 24, 28), (10, 0, 14)
    gen = torch.Generator().manual_seed(11)
    x = (torch.rand(k8.block_layout(bs), generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = (torch.rand(x.shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = b if with_b else None
    geom = (*origin, *gs, 1)
    keep = x.clone()
    before = k8.block_sweep.launches
    xk, rk = k8.block_sweep(x.clone() if kind != "jacobi" else x, b, kind, colour,
                            0.8, geom, region)
    xp, rp = k8.block_sweep_plain(keep.clone(), b, kind, colour, 0.8, geom, region)
    torch.cuda.synchronize()
    assert k8.block_sweep.launches == before + 1
    assert torch.equal(x, keep)  # Jacobi is out of place
    assert float((xk - xp).abs().max()) <= (0.0 if dtype == torch.float32 else 1e-14)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("solver,sync,omega,iters", [
    ("sor2sma", "pack", OMEGA, 199), ("sor2sma_maf", "pack", OMEGA, 199),
    ("sor2sma", "color", OMEGA, 199), ("sor2sma", "overlap", OMEGA, None),
    ("jacobi", "auto", 0.8, 1015),
])
def test_solve_dist_on_cuda_matches_cpu_twin(dev, solver, sync, omega, iters):
    """solve_dist at 32^3 over (2, 2, 2) blocks on one card: the kernels
    stop where the CPU twins stop, with bitwise equal fields (the packed
    path: the serial solve's field too)."""
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    maf = solver.endswith("_maf")
    g = czt.Problem.poisson_cube(32, device=dev, maf=maf)
    c = czt.Problem.poisson_cube(32, device="cpu", maf=maf)
    cg = czt.make_mesh((32, 32, 32), devices=[dev] * 8, div=(2, 2, 2))
    cc = czt.make_mesh((32, 32, 32), devices=["cpu"] * 8, div=(2, 2, 2))
    before = k7.dist_rb_sweeps.launches + k8.block_sweep.launches
    rg = czt.solve_dist(g, cg, solver, omega=omega, itr_max=10000, sync=sync)
    rc = czt.solve_dist(c, cc, solver, omega=omega, itr_max=10000, sync=sync)
    assert k7.dist_rb_sweeps.launches + k8.block_sweep.launches > before
    assert rg.iters == rc.iters and (iters is None or rg.iters == iters)
    assert torch.equal(rg.x.cpu(), rc.x)
    if sync == "pack":
        rs = czt.solve(g, solver, omega=omega, itr_max=10000)
        assert torch.equal(rg.x, rs.x)


# ---- slice 9b: K9 (dist_pcr) and K10 (pcr) ----------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("color", [0, 1, None])
@pytest.mark.parametrize("shape", [(16, 16, 16), (13, 11, 18)])
def test_k10_matches_plain_twin(dev, shape, color, maf, with_b, dtype):
    """K10 against its twin (offset 1): float32 bitwise, float64 within
    1e-14, residuals to rtol 1e-5; the line-Jacobi pass never writes x."""
    from cubez_tpu_torch.cuda_kernels import pcr as k10
    from cubez_tpu_torch.cuda_kernels.rbpack import maf_tables

    tab = None
    if maf:
        K, I, J = shape
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
        tab = maf_tables(mc, shape, dtype)
    gen = torch.Generator().manual_seed(21)
    x = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = b if with_b else None
    keep = x.clone()
    before = k10.fused_pcr.launches
    xk, rk = k10.fused_pcr(x if color is None else x.clone(), b, OMEGA, color, 1, tab)
    xp, rp = k10.fused_pcr_plain(keep.clone(), b, OMEGA, color, 1, tab)
    torch.cuda.synchronize()
    assert k10.fused_pcr.launches == before + 1
    assert torch.equal(x, keep)
    assert float((xk - xp).abs().max()) <= (0.0 if dtype == torch.float32 else 1e-14)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("color", [0, 1, None])
@pytest.mark.parametrize("form", ["pcr", "fastdiag"])
def test_k9_matches_plain_twin(dev, form, color, maf, with_b, dtype):
    """K9 against its twin on a ghosted block at a nonzero origin whose
    faces hold the physical boundary: float32 bitwise, float64 within
    1e-14, residuals to rtol 1e-5."""
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9

    bs, gs, origin = {"pcr": ((10, 12, 14), (20, 24, 28), (10, 0, 14)),
                      "fastdiag": ((20, 12, 14), (20, 24, 28), (0, 12, 0))}[form]
    mc = None
    if maf:
        K, I, J = gs
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
    sweep = k9.make_block_pcr(bs, gs, dtype, omega=OMEGA, color=color, offset=1,
                              b_is_zero=not with_b, maf=maf, mc=mc, solver=form)
    twin = k9.make_block_pcr(bs, gs, dtype, omega=OMEGA, color=color, offset=1,
                             b_is_zero=not with_b, maf=maf, mc=mc, solver=form,
                             plain=True)
    tab = sweep.block_tables(origin, dev) if maf else None
    gen = torch.Generator().manual_seed(23)
    shape = tuple(s + 2 for s in bs)
    x = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    keep = x.clone()
    before = k9.block_pcr.launches
    xk, rk = sweep(x if color is None else x.clone(), b, origin, tab)
    xp, rp = twin(keep.clone(), b, origin, tab)
    torch.cuda.synchronize()
    assert k9.block_pcr.launches == before + 1
    assert torch.equal(x, keep)
    assert float((xk - xp).abs().max()) <= (0.0 if dtype == torch.float32 else 1e-14)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("solver,div,form", [
    ("pcr_rb", (2, 2, 2), "block_pcr"),
    ("pcr_rb_maf", (2, 2, 2), "block_pcr_maf"),
    ("pcr_j_esa", (2, 2, 2), "block_pcr"),
    ("pcr_rb", (1, 2, 4), "block_pcr_fastdiag"),
    ("pcr_rb_maf", (1, 2, 4), "block_pcr_fastdiag_maf"),
])
def test_solve_dist_lines_on_cuda_go_through_k9(dev, solver, div, form):
    """A float32 line solve_dist on CUDA blocks with the standard mask
    launches K9 (its launch counter, by form), stops where the CPU twins
    stop, with bitwise equal fields."""
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9

    maf = solver.endswith("_maf")
    omega = 1.0 if solver == "pcr_j_esa" else OMEGA
    g = czt.Problem.poisson_cube(32, device=dev, maf=maf)
    c = czt.Problem.poisson_cube(32, device="cpu", maf=maf)
    cg = czt.make_mesh((32, 32, 32), devices=[dev] * 8, div=div)
    cc = czt.make_mesh((32, 32, 32), devices=["cpu"] * 8, div=div)
    before = k9.block_pcr.variant_launches.get(form, 0)
    rg = czt.solve_dist(g, cg, solver, omega=omega, itr_max=10000)
    assert k9.block_pcr.variant_launches.get(form, 0) > before
    rc = czt.solve_dist(c, cc, solver, omega=omega, itr_max=10000)
    assert rg.iters == rc.iters
    assert torch.equal(rg.x.cpu(), rc.x)


def test_wrappers_never_hand_a_cuda_tensor_to_a_twin(dev, monkeypatch):
    """K9's and K10's wrappers launch their kernels for CUDA tensors: with
    every twin made to raise, the wrappers still run."""
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
    from cubez_tpu_torch.cuda_kernels import pcr as k10

    def boom(*a, **k):
        raise AssertionError("a twin ran on a CUDA tensor")

    for mod, name in ((k10, "fused_pcr_plain"), (k10, "pcr_solve"),
                      (k10, "pcr_solve_var"), (k9, "block_pcr_plain"),
                      (k9, "pcr_solve_var"), (k9, "relax_dp")):
        monkeypatch.setattr(mod, name, boom)
    x = torch.rand(12, 10, 11, device=dev)
    for color in (0, 1, None):
        k10.fused_pcr(x.clone(), None, OMEGA, color)
        for form, gs in (("pcr", (20, 16, 22)), ("fastdiag", (10, 16, 22))):
            k9.block_pcr(x.clone(), None, form, color, OMEGA, (0, 8, 0, *gs, 0))
    torch.cuda.synchronize()
