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


WRAPPERS = (rb.rb_single, rb.rb_sweeps_n, k4.jacobi_k4, k4.sor2sma_k4,
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
        rb.rb_single(x.half(), None, OMEGA)
    with pytest.raises(ValueError, match="contiguous"):
        rb.rb_sweeps_n(x.transpose(2, 3), None, 2, OMEGA)
    with pytest.raises(ValueError, match="b must match"):
        rb.rb_sweeps_n(x, x.double(), 2, OMEGA)


# rb_sweeps_n's edges (csrc/rbpack.cu): K - 2 < 2n, J % 4 != 0 (no aligned
# copies), one tile and several, odd packed rows, a tall region
RBN_EDGES = ((6, 10, 9), (5, 12, 14), (16, 16, 16), (13, 10, 17),
             (40, 22, 46), (37, 22, 45), (24, 130, 70))


@pytest.mark.parametrize("setting", [("rows", None, None), ("tile", None, None),
                                     ("tile", 12, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", RBN_EDGES)
def test_rb_sweeps_forms_match_plain_twin(dev, shape, dtype, setting,
                                         monkeypatch):
    """Both forms of rb_sweeps_n (the tile form also at forced small
    regions and k chunks, so that a CTA takes several work items) against
    the twin: constant and MAF, zero and streamed b (the row form), n = 1,
    2, 3, 6 (the tile form: its n with a zero b, and n = 1, K1's launch,
    with both), offsets 0 and 1.  ``out`` is poisoned
    with NaN, so every point must be written; x is never written; float32
    bitwise, float64 within 1e-14, residuals to rtol 1e-5."""
    form, rows, kchunk = setting
    monkeypatch.setattr(rb, "_force_plan",
                        dict(form=form, rows=rows, kchunk=kchunk))
    K, I, J = shape
    gen = torch.Generator().manual_seed(K * I + J)
    x = rb.pack_rb(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = rb.pack_rb(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype, device=dev)[0].mc
    tol = 0.0 if dtype == torch.float32 else 1e-14
    cases = [(n, maf, bb) for n in ((1, 2, 3, 6) if form == "rows" else (1, rb.TILE_N))
             for maf in (False, True)
             for bb in ((None, b) if form == "rows" or n == 1 else (None,))]
    for n, maf, bb in cases:
        tab = rb.maf_tables(mc, shape, dtype) if maf else None
        for offset in (0, 1):
            launch = rb.RbSweeps(n, OMEGA, offset, tab)
            x0, out = x.clone(), torch.full_like(x, float("nan"))
            before = rb.rb_sweeps_n.launches
            rk = launch(x, bb, out)
            xp = x.clone()
            _, rp = rb.packed_sweeps_plain(xp, bb, n, OMEGA, offset, tab)
            torch.cuda.synchronize()
            where = (n, maf, bb is not None, offset, launch.plan)
            assert launch.plan.form == form and rb.rb_sweeps_n.launches == before + 1
            assert torch.equal(x, x0), where
            assert bool(torch.isfinite(out).all()), where
            assert float((out - xp).abs().max()) <= tol, where
            torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)


@pytest.mark.parametrize("form", rb.FORMS)
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_single_step_is_one_launch_an_iteration(dev, form, maf, with_b, dtype,
                                                monkeypatch):
    """K1 (make_packed_sweep) in each form: one rb_single launch a call
    (both colours and the fold), the field the twin's two colours (float32
    bitwise, float64 within 1e-14) at offsets 0 and 1, the handed field
    never written, out poisoned with NaN fully written, and a repeated
    run's r2 bit for bit."""
    monkeypatch.setattr(rb, "_force_plan", {"form": form})
    for shape in ((16, 16, 16), (37, 22, 45), (6, 10, 9)):
        K, I, J = shape
        mc = None
        if maf:
            mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                    device=dev)[0].mc
        gen = torch.Generator().manual_seed(K + I + J)
        x = rb.pack_rb(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
        b = rb.pack_rb(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
        for offset in (0, 1):
            kw = dict(omega=OMEGA, offset=offset, b_is_zero=not with_b, mc=mc)
            step = rb.make_packed_sweep(shape, dtype, **kw)
            twin = rb.make_packed_sweep(shape, dtype, plain=True, **kw)
            keep = x.clone()
            step(x, b)  # its buffers, then poison the one the next call writes
            before = (rb.rb_single.launches, rb.rb_sweeps_n.launches)
            y, r = step(x, b)
            y.fill_(float("nan"))
            y, r = step(x, b)
            yp, rp = twin(x.clone(), b)
            torch.cuda.synchronize()
            where = (shape, offset, step.launcher.plan.form)
            assert step.launcher.plan.form == form
            assert (rb.rb_single.launches, rb.rb_sweeps_n.launches) == (
                before[0] + 2, before[1]), where
            assert torch.equal(x, keep), where
            assert bool(torch.isfinite(y).all()), where
            tol = 0.0 if dtype == torch.float32 else 1e-14
            assert float((y - yp).abs().max()) <= tol, where
            torch.testing.assert_close(r, rp, rtol=1e-5, atol=0)
            assert torch.equal(step(x, b)[1], r)


def test_single_plan_picks_the_tiles_beyond_the_l2(dev):
    """At 256^3 f32 the single step takes the tile form (one pass a
    launch), the twin's field."""
    shape = (256, 256, 256)
    step = rb.make_packed_sweep(shape, torch.float32, omega=OMEGA, b_is_zero=True)
    x = rb.pack_rb(torch.rand(shape, device=dev) * 2 - 1)
    y, r2 = step(x, None)
    want, rp = rb.make_packed_sweep(shape, torch.float32, omega=OMEGA,
                                    b_is_zero=True, plain=True)(x.clone(), None)
    torch.cuda.synchronize()
    assert step.launcher.plan.form == "tile"
    assert torch.equal(y, want)
    torch.testing.assert_close(r2, rp, rtol=1e-5, atol=0)


def test_solve_replays_through_the_single_launch(dev):
    """The 32^3 solve stops at 199 with the CPU twin's field, its stopping
    chunk replayed by rb_single launches from the snapshot."""
    g = czt.Problem.poisson_cube(32, device=dev)
    before = rb.rb_single.launches
    rg = czt.solve(g, "sor2sma", omega=OMEGA, itr_max=10000)
    rc = czt.solve(czt.Problem.poisson_cube(32, device="cpu"), "sor2sma",
                   omega=OMEGA, itr_max=10000)
    assert rg.iters == rc.iters == 199
    # chunks of 18 (check_every 16 in calls of 6): the stopping one starts
    # at 198, and one single iteration replays it to 199
    assert rb.rb_single.launches - before == 1
    assert torch.equal(rg.x.cpu(), rc.x)


def test_rb_sweeps_plan_picks_the_tiles_beyond_the_l2(dev):
    """At 256^3 f32 (x and out 268 MB) the chain at chain_depth launches
    the tile form, one launch a call, out of place, the twin's field."""
    shape = (256, 256, 256)
    n = rb.chain_depth(shape)
    step = rb.make_packed_sweepnx(shape, torch.float32, omega=OMEGA, n=n)
    x = rb.pack_rb(torch.rand(shape, device=dev) * 2 - 1)
    x0 = x.clone()
    before = rb.rb_sweeps_n.launches
    y, r2 = step(x, None)
    xp = x.clone()
    _, rp = rb.packed_sweeps_plain(xp, None, n, OMEGA)
    torch.cuda.synchronize()
    assert step.launcher.plan.form == "tile" and n == rb.TILE_N
    assert rb.rb_sweeps_n.launches == before + 1
    assert torch.equal(x, x0) and torch.equal(y, xp)
    torch.testing.assert_close(r2, rp, rtol=1e-5, atol=0)


def test_rb_sweeps_history_repeats_bitwise(dev, monkeypatch):
    """The residual folds are in a fixed order: two runs give the same
    bits, in both forms."""
    x = rb.pack_rb(torch.rand((40, 22, 46), device=dev) * 2 - 1)
    for form in rb.FORMS:
        monkeypatch.setattr(rb, "_force_plan", {"form": form})
        launch = rb.RbSweeps(rb.TILE_N, OMEGA, 0, None)
        a = launch(x, None, torch.empty_like(x)).clone()
        assert torch.equal(a, launch(x, None, torch.empty_like(x)))


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
    """No kernel takes a mask other than the standard one, so 'auto' runs
    the plain masked sweep on the card (steps.make_step, the JAX package's
    jnp route; it no longer raises): no kernel launches, and the count and
    field are the CPU twin's (the field within 1e-6: the same elementwise
    operations on both devices; r2's sums group differently)."""
    base = czt.Problem.poisson_cube(16, device="cpu")
    msk = base.msk.numpy().copy()
    msk[5:8, 6, 7] = 0.0  # an obstacle
    probs = [czt.Problem.from_arrays((16, 16, 16), torch.float32,
                                     base.x0.numpy(), base.rhs.numpy(), msk,
                                     rhs_inner_zero=True, device=d)
             for d in (dev, "cpu")]
    before = _launches()
    r = czt.solve(probs[0], name, omega=0.8, itr_max=50)
    assert r.x.is_cuda and _launches() == before
    c = czt.solve(probs[1], name, omega=0.8, itr_max=50)
    assert r.iters == c.iters
    torch.testing.assert_close(r.x.cpu(), c.x, rtol=0, atol=1e-6)


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
    """K - 2 < 2 has no line kernel step: 'auto' runs the plain line sweep
    on the card (the JAX package's jnp route; it no longer raises), no
    kernel launches, the count and field are the CPU twin's (within 1e-6,
    as above); K6's wrapper itself still refuses such a field."""
    before = _launches()
    r = czt.solve(czt.Problem.poisson_cube((8, 8, 3), device=dev), "pcr_rb",
                  omega=OMEGA, itr_max=5)
    assert r.x.is_cuda and _launches() == before
    c = czt.solve(czt.Problem.poisson_cube((8, 8, 3), device="cpu"), "pcr_rb",
                  omega=OMEGA, itr_max=5)
    assert r.iters == c.iters
    torch.testing.assert_close(r.x.cpu(), c.x, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="K - 2 >= 2"):
        k6.line_rb(torch.zeros(3, 8, 8, device=dev), None, OMEGA)


# ---- slice 11: K5 and K6 on the shared-memory line tile ---------------------

# (K, I, J) at the tile's edges: K - 2 of 2 and 3 inner rows, K - 2 not a
# multiple of a tile's thread rows, line counts not a multiple of L, odd J,
# odd I (K6's red-black form; K5 refuses it)
TILE_EDGES = [(4, 10, 37), (5, 9, 33), (13, 12, 45), (39, 9, 70), (7, 6, 3)]
# (TILE_LINES, TILE_THREADS): the default, and settings that change the
# thread rows a lane and the tiles a row
TILE_SETTINGS = [(32, 256), (8, 64), (16, 128), (64, 256)]


@pytest.fixture
def tile_setting(request, monkeypatch):
    lines_max, threads = request.param
    monkeypatch.setattr(k6, "TILE_LINES", lines_max)
    monkeypatch.setattr(k6, "TILE_THREADS", threads)
    return request.param


@pytest.mark.parametrize("tile_setting", TILE_SETTINGS, indirect=True)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", TILE_EDGES)
def test_line_tile_edges_match_plain_twins(dev, shape, dtype, tile_setting):
    """Every K5/K6 step, constant and MAF, zero and streamed b, offsets 0
    and 1, at the tile's edges and several tile settings: float32 fields
    bitwise the twins', float64 within chip_smoke.py's 1e-14, residuals to
    rtol 1e-5."""
    K, I, J = shape
    gen = torch.Generator().manual_seed(11 + K)
    x = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    b = torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1
    tol = 0.0 if dtype == torch.float32 else 1e-14
    mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                            device=dev)[0].mc
    n_steps = 0
    for m in (None, mc):
        for offset in (0, 1):
            for label, build in _line_builders(m):
                kstep = build(shape, dtype, offset, False)
                pstep = build(shape, dtype, offset, True)
                if kstep is None:
                    continue
                x0, b0 = kstep.pad(x.to(dev)), kstep.pad(b.to(dev))
                xk, xp = x0.clone(), x0.clone()
                for _ in range(2):
                    xk, rk = kstep(xk, b0)
                    xp, rp = pstep(xp, b0)
                torch.cuda.synchronize()
                where = f"{label} MAF={m is not None} offset={offset}"
                assert float((xk - xp).abs().max()) <= tol, where
                torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0, msg=where)
                n_steps += 1
    assert n_steps == 2 * 2 * (4 if I % 2 else 6)


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_line_jacobi_copies_the_faces(dev, dtype, maf):
    """line_j writes every value of ``out``: handed a NaN-poisoned out, it
    leaves the face lines and the k = 0 and K-1 planes equal to x and the
    rest equal to the twin's, and x untouched."""
    shape = (13, 12, 45)
    K, I, J = shape
    tab = None
    if maf:
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
        tab = rb.maf_tables(mc, shape, dtype)
    gen = torch.Generator().manual_seed(3)
    x = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    keep = x.clone()
    out = torch.full_like(x, float("nan"))
    got, _ = k6.line_j(x, None, 1.0, tab, out=out)
    want, _ = k6.line_j_plain(x, None, 1.0, tab)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and torch.equal(x, keep)
    assert bool(torch.isfinite(got).all())
    face = torch.ones(shape, dtype=torch.bool, device=dev)
    face[1:-1, 1:-1, 1:-1] = False
    assert torch.equal(got[face], x[face])
    tol = 0.0 if dtype == torch.float32 else 1e-14
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("kind", ["K5", "pcr_j", "pcr_rb"])
def test_line_steps_allocate_no_field_scratch(dev, kind, maf):
    """After a warm-up call a line step allocates only its partial sums:
    no (K, I, J)-sized scratch (the Thomas values stay in shared memory)."""
    shape = (48, 48, 48) if kind != "pcr_rb" else (48, 47, 48)
    K, I, J = shape
    mc = czt.Problem.poisson_cube((I, J, K), device=dev, maf=True).mc if maf else None
    if kind == "K5":
        step = k5.make_rbl_step(shape, omega=OMEGA, b_is_zero=True, mc=mc)
    else:
        step = k6.make_line_step(kind, shape, omega=1.0 if kind == "pcr_j" else OMEGA,
                                 b_is_zero=True, mc=mc)
    x = step.pad(torch.rand(shape, device=dev))
    for _ in range(3):  # line-Jacobi makes its two fields here
        x, _ = step(x, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    x, r = step(x, None)
    torch.cuda.synchronize()
    field = x.numel() * x.element_size()
    assert torch.cuda.max_memory_allocated(dev) - base < field // 8
    assert bool(torch.isfinite(r))


def test_line_tile_launch_refuses_bad_settings(dev, monkeypatch):
    """The kernels check the tile settings they are handed and return an
    error the wrapper raises: threads not a multiple of a warp, or more
    than line_tile.cuh's bound."""
    x = torch.rand(8, 8, 8, device=dev)
    for threads in (48, 512):  # not a multiple of a warp; past the bound
        monkeypatch.setattr(k6, "TILE_THREADS", threads)
        with pytest.raises(RuntimeError, match="CUDA error"):
            k6.line_j(x, None, 1.0)


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


# K10's line form at its slab edges (K - 2 = 1, 2, 31, 32, 33, 63, 126,
# 510 rows; odd and ragged I and J), and a line past the registers (the
# tile form)
K10_SHAPES = [(16, 16, 16), (13, 11, 18), (3, 9, 40), (4, 8, 7), (33, 10, 35),
              (34, 7, 33), (35, 12, 66), (65, 9, 12), (128, 6, 37), (512, 5, 6),
              (600, 5, 9)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("color", [0, 1, None])
@pytest.mark.parametrize("shape", K10_SHAPES)
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
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("kind", ["pcr_rb", "pcr"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (35, 12, 66), (600, 5, 9)])
def test_k10_step_one_launch_a_call(dev, shape, kind, maf, dtype):
    """make_fused_pcr_step on the line form makes one launch a call (pcr_rb:
    both colours, a grid-wide sync between them), the tile form one a
    colour; the fields are the twin's passes (float32 bitwise, float64
    within 1e-14), 'pcr' never writes x, and r2 repeats bit for bit."""
    from cubez_tpu_torch.cuda_kernels import pcr as k10

    K, I, J = shape
    mc = None
    if maf:
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
    tab = k10.maf_tables(mc, shape, dtype) if maf else None
    gen = torch.Generator().manual_seed(K)
    x = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    step = k10.make_fused_pcr_step(kind, shape, dtype, omega=OMEGA, offset=1,
                                   mc=mc)
    keep = x.clone()
    before = k10.fused_pcr.launches
    xk, rk = step(x if kind == "pcr" else x.clone(), b)
    torch.cuda.synchronize()
    lines = step.launcher.plan.form == "lines"
    assert lines == (K - 2 <= 512)
    assert k10.fused_pcr.launches - before == (1 if lines or kind == "pcr" else 2)
    if kind == "pcr":
        xp, rp = k10.fused_pcr_plain(keep.clone(), b, OMEGA, None, 1, tab)
    else:
        xp, r0 = k10.fused_pcr_plain(keep.clone(), b, OMEGA, 0, 1, tab)
        xp, r1 = k10.fused_pcr_plain(xp, b, OMEGA, 1, 1, tab)
        rp = r0 + r1
    assert torch.equal(x, keep)
    assert float((xk - xp).abs().max()) <= (0.0 if dtype == torch.float32 else 1e-14)
    torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)
    r_first = rk.clone()
    _, again = step(x if kind == "pcr" else keep.clone(), b)
    assert torch.equal(again, r_first)


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


# ---- slice 10: K8 and K9 over all the blocks of the card in one launch -------

# (global shape, division): cubic blocks, K-unsplit blocks, non-cubic ones
BATCH_MESHES = [((32, 32, 32), (2, 2, 2)), ((32, 32, 32), (1, 2, 2)),
                ((24, 28, 32), (2, 2, 2))]
BATCH_VARIANTS = (
    [("k8", kind, colour, region) for kind, colour, region in (
        ("jacobi", None, "all"), ("sor2sma", 0, "all"), ("sor2sma", 1, "all"),
        ("sor2sma", None, "all"), ("sor2sma", 0, "interior"),
        ("sor2sma", 1, "shell"))]
    + [("k9", form, colour, maf) for form in ("pcr", "fastdiag")
       for colour in (0, 1, None) for maf in (False, True)])


def _dist_counters():
    from cubez_tpu_torch.cuda_kernels import dist_halo
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    return (k8.block_sweep.launches + k9.block_pcr.launches
            + dist_halo.halo_exchange.launches + dist_halo.fold_partials.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", range(len(BATCH_MESHES)))
@pytest.mark.parametrize("variant", BATCH_VARIANTS)
def test_batched_launch_matches_twin(dev, variant, mesh, dtype):
    """One launch over every block of the mesh on the card against the
    batched twin: float32 bitwise, float64 within 1e-14; the folded r2
    within rtol 1e-5 of the twins' (partials grouped by CTA)."""
    from cubez_tpu_torch.cuda_kernels import dist_halo
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    gshape, div = BATCH_MESHES[mesh]
    cm = czt.make_mesh(gshape, devices=[dev] * (div[0] * div[1] * div[2]), div=div)
    bshape = cm.block_shape(gshape)
    origins = cm.offsets(gshape)
    gen = torch.Generator().manual_seed(31 + mesh)
    shape = tuple(v + 2 for v in bshape)
    xs = [(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
          for _ in origins]
    bs = [(torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
          for _ in origins]
    keep = [x.clone() for x in xs]
    res = dist_halo.Residual(dev)
    res.start()
    before = k8.block_sweep.launches + k9.block_pcr.launches
    if variant[0] == "k8":
        _, kind, colour, region = variant
        got = k8.sweep_blocks([x.clone() for x in xs] if kind != "jacobi" else xs,
                              bs, kind, colour, 0.8, origins, gshape, 1, region,
                              res=res)
        want, r2s = k8.sweep_blocks_plain([x.clone() for x in keep], bs, kind,
                                          colour, 0.8, origins, gshape, 1, region)
    else:
        _, form, colour, maf = variant
        if form == "fastdiag" and div[0] != 1:
            form = "pcr"
        tabs = None
        if maf:
            mc = czt.Problem.manufactured_stretched(
                (gshape[1], gshape[2], gshape[0]), dtype=dtype, device=dev)[0].mc
            tabs = [k9.block_maf_tables(mc, o, bshape, gshape, dtype, form).to(dev)
                    for o in origins]
        got = k9.pcr_blocks([x.clone() for x in xs] if colour is not None else xs,
                            bs, form, colour, OMEGA, origins, gshape, 1, tabs,
                            res=res)
        want, r2s = k9.pcr_blocks_plain([x.clone() for x in keep], bs, form,
                                        colour, OMEGA, origins, gshape, 1, tabs)
    r2 = res.total()
    torch.cuda.synchronize()
    assert k8.block_sweep.launches + k9.block_pcr.launches == before + 1
    assert all(torch.equal(x, k) for x, k in zip(xs, keep))  # out of place
    tol = 0.0 if dtype == torch.float32 else 1e-14
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= tol
    torch.testing.assert_close(r2, sum(r2s), rtol=1e-5, atol=0)


@pytest.mark.parametrize("mesh", range(len(BATCH_MESHES)))
def test_exchange_and_fold_kernels_match_twins(dev, mesh):
    """The exchange kernel (one launch, and gather then scatter through
    the staging buffer) against its twin, bitwise, edges untouched; the
    fold against its twin within rtol 1e-15."""
    from cubez_tpu_torch.cuda_kernels import dist_halo
    from cubez_tpu_torch.parallel.halo import FaceExchange

    gshape, div = BATCH_MESHES[mesh]
    cm = czt.make_mesh(gshape, devices=[dev] * (div[0] * div[1] * div[2]), div=div)
    table = [[-1 if (nb := cm.neighbor(b, f // 2, 1 if f % 2 else -1)) is None
              else nb for f in range(6)] for b in range(cm.size)]
    gen = torch.Generator().manual_seed(41)
    shape = tuple(v + 2 for v in cm.block_shape(gshape))
    xs = [torch.rand(shape, generator=gen).to(dev) for _ in range(cm.size)]
    want = dist_halo.halo_exchange_plain([x.clone() for x in xs], table)
    before = dist_halo.halo_exchange.launches
    got = FaceExchange(cm)([x.clone() for x in xs])
    ex = FaceExchange(cm)
    split = [x.clone() for x in xs]
    ex.collect(split)
    ex.write(split)
    torch.cuda.synchronize()
    assert dist_halo.halo_exchange.launches == before + 3
    for w, g, s_ in zip(want, got, split):
        assert torch.equal(g, w) and torch.equal(s_, w)
    p = torch.rand(3001, generator=gen).to(dev)
    got = float(dist_halo.fold_partials(p, 3001))
    want = float(dist_halo.fold_partials_plain(p.cpu()))
    assert abs(got - want) <= 1e-15 * want


# (solver, sync, omega, division, the step's launches: exchange, sweep, fold)
STEP_LAUNCHES = [("sor2sma", "color", OMEGA, (2, 2, 2), 5),
                 ("sor2sma", "iter", OMEGA, (2, 2, 2), 3),
                 ("sor2sma", "overlap", OMEGA, (2, 2, 2), 9),
                 ("jacobi", "auto", 0.8, (2, 2, 2), 3),
                 ("pcr_rb", "auto", OMEGA, (2, 2, 2), 5),
                 ("pcr_rb_maf", "auto", OMEGA, (2, 2, 2), 5),
                 ("pcr_j_esa", "auto", 1.0, (2, 2, 2), 3),
                 ("pcr_rb", "auto", OMEGA, (1, 2, 2), 5),
                 ("pcr_j_esa", "auto", 1.0, (1, 2, 2), 3)]


def _dist_step(name, sync, omega, cm, p):
    from cubez_tpu_torch.parallel import dist_fused

    kind = {"sor2sma": "sor2sma", "jacobi": "jacobi", "pcr_j_esa": "pcr"}.get(
        name, "pcr_rb")
    if sync == "overlap":
        return dist_fused.make_dist_fused_overlap_step(p, cm, omega, b_is_zero=True)
    return dist_fused.make_dist_fused_step(
        p, cm, kind, omega, b_is_zero=True, sync="iter" if sync == "iter" else "color")


@pytest.mark.parametrize("path", STEP_LAUNCHES)
def test_dist_step_launch_count(dev, path):
    """One step of each dist path on eight (four) blocks of the card makes
    exactly its launches (the wrappers' counters: exchange, K8/K9, fold);
    with the edge ghosts poisoned by NaN its field and r2 are finite and
    equal to the clean run's."""
    from cubez_tpu_torch.parallel import dist_fused

    name, sync, omega, div, launches = path
    p = czt.Problem.poisson_cube(32, device=dev, maf=name.endswith("_maf"))
    cm = czt.make_mesh((32, 32, 32), devices=[dev] * (div[0] * div[1] * div[2]),
                       div=div)
    step, poisoned = (_dist_step(name, sync, omega, cm, p) for _ in range(2))
    clean = dist_fused.to_block_state(cm, p.x0)
    dirty = [x.clone() for x in clean]
    for x in dirty:
        e = torch.zeros(x.shape, dtype=torch.int32)
        for ax in range(3):
            idx = [slice(None)] * 3
            for end in (0, -1):
                idx[ax] = end
                e[tuple(idx)] += 1
        x[(e >= 2).to(dev)] = float("nan")
    clean, _ = step(clean, None)  # the first call makes the buffers
    dirty, _ = poisoned(dirty, None)
    torch.cuda.synchronize()
    before = _dist_counters()
    clean, r_c = step(clean, None)
    torch.cuda.synchronize()
    assert _dist_counters() - before == launches
    dirty, r_d = poisoned(dirty, None)
    own = (slice(1, -1),) * 3
    assert torch.isfinite(r_d) and torch.equal(r_c, r_d)
    for a, b in zip(clean, dirty):
        assert torch.isfinite(b[own]).all() and torch.equal(a[own], b[own])


@pytest.mark.parametrize("solver,div", [("sor2sma", (2, 2, 2)),
                                        ("pcr_rb", (2, 2, 2)),
                                        ("pcr_rb", (1, 2, 2))])
def test_dist_solves_are_deterministic(dev, solver, div):
    """Two identical dist solves on the card give bitwise equal histories
    and fields (the fold sums in a fixed order, no atomics)."""
    p = czt.Problem.poisson_cube(32, device=dev)
    cm = czt.make_mesh((32, 32, 32), devices=[dev] * (div[0] * div[1] * div[2]),
                       div=div)
    kw = dict(omega=OMEGA, itr_max=10000,
              sync="color" if solver == "sor2sma" else "auto")
    r1 = czt.solve_dist(p, cm, solver, **kw)
    r2 = czt.solve_dist(p, cm, solver, **kw)
    assert r1.iters == r2.iters
    assert torch.equal(r1.history, r2.history) and torch.equal(r1.x, r2.x)


# ---- K4 on plane tiles; K7 and the pack ring in one launch each -------------

# the main paths' shapes, odd I, the ragged one, and the tiles' edges: I and
# J no multiple of the 32-wide tiles, K - 2 = 1 and 2, a last k chunk short
K4_SHAPES = [(128, 128, 128), (125, 125, 125), (37, 22, 45), (3, 33, 35),
             (4, 31, 65), (130, 45, 97)]


@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_k4_tile_kernels_match_twins(dev, shape, dtype, maf, with_b):
    """jacobi_k4 at n = 1 and JACOBI_N and sor2sma_k4 at offsets 0 and 1 against
    their twins: float32 bitwise, float64 within 1e-14, r2 to rtol 1e-5;
    one launch a call; x never written."""
    tab = None
    if maf:
        K, I, J = shape
        mc = czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                                device=dev)[0].mc
        tab = rb.maf_tables(mc, shape, dtype)
    gen = torch.Generator().manual_seed(sum(shape))
    x = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev)
    b = (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1).to(dev) if with_b else None
    keep = x.clone()
    tol = 0.0 if dtype == torch.float32 else 1e-14
    for n in (1, k4.JACOBI_N):
        before = k4.jacobi_k4.launches
        got, rk = k4.jacobi_k4(x, b, 0.8, tab, n=n)
        want, rp = k4.jacobi_n_plain(x, b, 0.8, tab, n)
        torch.cuda.synchronize()
        assert k4.jacobi_k4.launches == before + 1
        assert float((got - want).abs().max()) <= tol, n
        torch.testing.assert_close(rk, rp if n > 1 else rp.reshape(()), rtol=1e-5,
                                   atol=0)
    for offset in (0, 1):
        before = k4.sor2sma_k4.launches
        got, rk = k4.sor2sma_k4(x, b, OMEGA, offset, tab)
        want = x.clone()
        rp = k4.sor2sma_plain(want, b, OMEGA, offset, tab)
        torch.cuda.synchronize()
        assert k4.sor2sma_k4.launches == before + 1
        assert float((got - want).abs().max()) <= tol, offset
        torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)
    assert torch.equal(x, keep)


@pytest.mark.parametrize("kind", ["jacobi", "sor2sma"])
def test_k4_steps_launch_once_a_call(dev, kind):
    """The steps make one launch a call (n = JACOBI_N Jacobi iterations, or
    one red-black iteration) and their single forms one; the fields equal
    the plain steps' bit for bit, the handed field is never written, and
    two runs give the same r2 bit for bit (fixed-order fold)."""
    shape = (40, 35, 70)
    kw = dict(omega=0.8 if kind == "jacobi" else OMEGA, b_is_zero=True)
    step = k4.make_fused_sweep(kind, shape, torch.float32, **kw)
    twin = k4.make_fused_sweep(kind, shape, torch.float32, plain=True, **kw)
    x0 = torch.rand(shape, device=dev)
    keep = x0.clone()
    counter = k4.jacobi_k4 if kind == "jacobi" else k4.sor2sma_k4
    xk, xp, r2s = x0, x0.clone(), []
    for s_k, s_p in ((step, twin), (step, twin), (step.single, twin.single)):
        before = counter.launches
        xk, rk = s_k(xk, None)
        xp, rp = s_p(xp, None)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert torch.equal(xk, xp)
        torch.testing.assert_close(rk, rp, rtol=1e-5, atol=0)
        r2s.append(rk.clone())
    assert torch.equal(x0, keep)
    again = x0
    for s_k, r in zip((step, step, step.single), r2s):
        again, rk = s_k(again, None)
        assert torch.equal(rk, r)


# (global shape, division): cubic blocks, K-unsplit blocks, non-cubic ones
PACK_MESHES = [((32, 32, 32), (2, 2, 2)), ((32, 32, 32), (1, 2, 2)),
               ((24, 28, 32), (2, 2, 2)), ((32, 16, 16), (2, 1, 1))]


def _pack_state(gshape, div, n, dev, dtype=torch.float32, seed=0):
    """Extended packed blocks of a seeded field, on the card, whose ring
    cells inside the grid hold other seeded values (as K7 leaves them);
    cells past the grid keep the packing's zeros."""
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7
    from cubez_tpu_torch.parallel import dist_pack

    cm = czt.make_mesh(gshape, devices=[dev] * (div[0] * div[1] * div[2]), div=div)
    hs = tuple(2 * n if d > 1 else 0 for d in div)
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(gshape, generator=gen, dtype=dtype) * 2 - 1
    st = dist_pack.to_packed_state(cm, x.to(dev), hs)
    bs = cm.block_shape(gshape)
    Ke, Ie, Je, _ = k7.ext_dims(bs, hs)
    for b, o in enumerate(cm.offsets(gshape)):
        idx = [torch.arange(e) + (oo - h) for e, oo, h in zip((Ke, Ie, Je), o, hs)]
        inside = ((idx[0] >= 0) & (idx[0] < gshape[0]))[:, None, None] & (
            (idx[1] >= 0) & (idx[1] < gshape[1]))[None, :, None] & (
            (idx[2] >= 0) & (idx[2] < gshape[2]))[None, None, :]
        noise = torch.rand(st[b].shape, generator=gen, dtype=dtype) * 2 - 1
        st[b] = torch.where(k7.pack_rb(inside.float()).to(dev) > 0, noise.to(dev),
                            st[b])
    return cm, bs, hs, st


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 6])
@pytest.mark.parametrize("mesh", range(len(PACK_MESHES)))
def test_batched_k7_matches_twin(dev, mesh, n, dtype, maf):
    """K7 over every block of the mesh in one launch against its twin on
    each block: float32 bitwise, float64 within 1e-14, the folded r2 within
    rtol 1e-5 of the twins' sums."""
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7

    gshape, div = PACK_MESHES[mesh]
    cm, bs, hs, xs = _pack_state(gshape, div, n, dev, dtype, seed=mesh)
    if any(h > s for h, s in zip(hs, bs)):
        pytest.skip("blocks thinner than the ring")
    origins = cm.offsets(gshape)
    tabs = None
    if maf:
        mc = czt.Problem.manufactured_stretched(
            (gshape[1], gshape[2], gshape[0]), dtype=dtype, device=dev)[0].mc
        kern = k7.make_dist_packed_sweepnx(bs, gshape, dtype, omega=OMEGA, n=n,
                                           split=tuple(d > 1 for d in div),
                                           mc=mc)
        tabs = [kern.block_tables(o, dev) for o in origins]
    keep = [x.clone() for x in xs]
    launch = k7.BlockRbSweeps(n, OMEGA, bs, gshape, hs, origins)
    before = k7.dist_rb_sweeps.launches
    r2 = launch(xs, tabs)
    want = [x.clone() for x in keep]
    rp = [k7.dist_sweeps_plain(w, n, OMEGA, k7.geometry(bs, gshape, hs, o),
                               None if tabs is None else t)
          for w, o, t in zip(want, origins, tabs or [None] * len(xs))]
    torch.cuda.synchronize()
    assert k7.dist_rb_sweeps.launches == before + 1
    tol = 0.0 if dtype == torch.float32 else 1e-14
    for g, w in zip(xs, want):
        assert float((g - w).abs().max()) <= tol
    torch.testing.assert_close(r2, torch.stack(rp).sum(0), rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [1, 2, 6])
@pytest.mark.parametrize("mesh", range(len(PACK_MESHES)))
def test_pack_exchange_matches_twins(dev, mesh, n):
    """The one-launch ring refresh against its twin (the owner gather) and
    the three-phase transitive copy, bitwise, edges and corners included;
    one launch."""
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7
    from cubez_tpu_torch.parallel import dist_pack

    gshape, div = PACK_MESHES[mesh]
    cm, bs, hs, xs = _pack_state(gshape, div, n, dev, seed=10 + mesh)
    if any(h > s for h, s in zip(hs, bs)):
        pytest.skip("blocks thinner than the ring")
    want = dist_pack.exchange_ghosts_packed([x.clone() for x in xs], cm, bs, hs)
    twin = k7.exchange_packed_plain([x.clone() for x in xs], div, bs, hs)
    before = k7.exchange_packed.launches
    got = k7.PackExchange(div, bs, hs)([x.clone() for x in xs])
    torch.cuda.synchronize()
    assert k7.exchange_packed.launches == before + 1
    for g, t, w in zip(got, twin, want):
        assert torch.equal(g, w) and torch.equal(t, w)


@pytest.mark.parametrize("maf", [False, True])
def test_pack_step_launches_twice_a_call(dev, maf):
    """On one card the pack step is the ring refresh and one K7 launch a
    call (its single form too), with no copy and no host fold; its fields
    and r2 equal the CPU twin's."""
    from cubez_tpu_torch.cuda_kernels import dist_rbpack as k7
    from cubez_tpu_torch.parallel import dist_pack

    g = czt.Problem.poisson_cube(32, device=dev, maf=maf)
    c = czt.Problem.poisson_cube(32, device="cpu", maf=maf)
    cg = czt.make_mesh((32, 32, 32), devices=[dev] * 8, div=(2, 2, 2))
    cc = czt.make_mesh((32, 32, 32), devices=["cpu"] * 8, div=(2, 2, 2))
    sg = dist_pack.make_dist_packed_step(g, cg, OMEGA)
    sc = dist_pack.make_dist_packed_step(c, cc, OMEGA)
    xg = dist_pack.to_packed_state(cg, g.x0, sg.hs)
    xc = dist_pack.to_packed_state(cc, c.x0, sc.hs)
    for kg, kc in ((sg, sc), (sg, sc), (sg.single, sc.single)):
        before = (k7.exchange_packed.launches, k7.dist_rb_sweeps.launches)
        xg, rg = kg(xg, None)
        xc, rc = kc(xc, None)
        torch.cuda.synchronize()
        assert (k7.exchange_packed.launches, k7.dist_rb_sweeps.launches) == (
            before[0] + 1, before[1] + 1)
        assert rg.shape == (kg.iters_per_call,)
        for a, b in zip(xg, xc):
            assert torch.equal(a.cpu(), b)
        torch.testing.assert_close(rg.cpu(), rc, rtol=1e-5, atol=0)


# ---- slice 4: the Krylov solvers with their preconditioners on the kernels ---

KRYLOV_CASES = [
    # solver, preconditioner, omega, counter of its kernel
    ("pbicgstab", "sor2sma", 1.1, "rb_sweeps_n"),
    ("pbicgstab", "jacobi", 0.8, "jacobi_k4"),
    ("pbicgstab", "pcr_rb", 1.1, "rbl"),
    ("pbicgstab", "pcr_j_esa", 1.0, "line_j"),
    ("pbicgstab_maf", "sor2sma_maf", 1.1, "rb_sweeps_n"),
    ("cg", "jacobi", 0.8, "jacobi_k4"),
]


@pytest.mark.parametrize("solver,precond,omega,counter", KRYLOV_CASES)
def test_krylov_64_on_kernels_is_bitwise_its_plain_solve(dev, solver, precond,
                                                         omega, counter):
    """A float32 64^3 Krylov solve whose preconditioner runs on the kernels
    gives the plain-twin solve's count, history and field bit for bit (the
    kernels are bitwise their twins, the BLAS the same torch ops); the
    preconditioner's kernel is launched, for sor2sma as K2's pair with b,
    four calls an application and two applications an iteration."""
    from cubez_tpu_torch.cuda_kernels import lines as k6_
    from cubez_tpu_torch.cuda_kernels import rblines as k5_

    wrappers = {"rb_sweeps_n": rb.rb_sweeps_n, "jacobi_k4": k4.jacobi_k4,
                "rbl": k5_.rbl, "line_j": k6_.line_j}
    w = wrappers[counter]
    p = czt.Problem.poisson_cube(64, device=dev, maf=solver.endswith("_maf"))
    before = w.launches
    rk = czt.solve(p, solver, omega=omega, itr_max=4000, precond=precond)
    torch.cuda.synchronize()
    launches = w.launches - before
    rp = czt.solve(p, solver, omega=omega, itr_max=4000, precond=precond,
                   impl="plain")
    torch.cuda.synchronize()
    assert w.launches - before == launches  # the plain solve launches none
    assert rk.iters == rp.iters and rk.res < 1e-5
    assert torch.equal(rk.history, rp.history) and torch.equal(rk.x, rp.x)
    # launches a preconditioner application of 8 sweeps: K2's pair runs 2
    # a launch, K4 JACOBI_N, K5 a launch a colour, K6 a launch a sweep
    per_apply = {"rb_sweeps_n": 4, "jacobi_k4": 8 // k4.JACOBI_N, "rbl": 16,
                 "line_j": 8}[counter]
    applies = rk.iters * (1 if solver == "cg" else 2) + (solver == "cg")
    assert launches == per_apply * applies


def test_krylov_precon_result_is_its_own_on_cuda(dev):
    """The K4 and K6 line-Jacobi steps return one of two buffers they own:
    precon(p) must still hold after precon(s) (the BiCGSTAB order)."""
    from cubez_tpu_torch.solvers import bicgstab

    p = czt.Problem.poisson_cube(32, device=dev)
    v, w = (torch.rand(32, 32, 32, device=dev) * p.msk for _ in range(2))
    for name in ("jacobi", "pcr_j_esa", "sor2sma", "pcr_rb"):
        pre = bicgstab.make_precon(p, name, 0.8)
        first = pre(v)
        kept = first.clone()
        pre(w)
        torch.cuda.synchronize()
        assert torch.equal(first, kept), name


@pytest.mark.parametrize("solver,precond,omega", [
    ("pbicgstab", "sor2sma", 1.1), ("pbicgstab", "pcr_rb", 1.1),
    ("cg", "jacobi", 0.8),
])
def test_solve_dist_krylov_on_cuda_blocks(dev, solver, precond, omega):
    """Krylov solve_dist with eight blocks on the card runs its
    preconditioner on K8 or K9 and stops where the CPU blocks' twins stop,
    on the same field to float32 rounding of the dots' fold."""
    from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
    from cubez_tpu_torch.cuda_kernels import dist_sweeps as k8

    g = czt.Problem.poisson_cube(32, device=dev)
    c = czt.Problem.poisson_cube(32, device="cpu")
    cgm = czt.make_mesh((32, 32, 32), devices=[dev] * 8, div=(2, 2, 2))
    ccm = czt.make_mesh((32, 32, 32), devices=["cpu"] * 8, div=(2, 2, 2))
    before = k8.block_sweep.launches + k9.block_pcr.launches
    rg = czt.solve_dist(g, cgm, solver, omega=omega, itr_max=4000,
                        precond=precond)
    torch.cuda.synchronize()
    assert k8.block_sweep.launches + k9.block_pcr.launches > before
    rc = czt.solve_dist(c, ccm, solver, omega=omega, itr_max=4000,
                        precond=precond)
    assert abs(rg.iters - rc.iters) <= 1 and rg.res < 1e-5
    assert czt.max_error(g.grid, rg.x) == pytest.approx(
        czt.max_error(c.grid, rc.x), rel=1e-2)


@pytest.mark.parametrize("path", ["pbicgstab sor2sma", "pbicgstab pcr_rb",
                                  "cg jacobi", "dist pbicgstab sor2sma"])
def test_krylov_syncs_the_host_once_an_iteration(dev, path):
    """The Krylov loop waits for the card once an iteration (the residual
    and the next rho in one transfer): four more iterations cost four more
    synchronizing operations (torch.cuda's sync debug mode counts them)."""
    import warnings

    words = path.split()
    dist = words[0] == "dist"
    solver, precond = words[-2:]
    p = czt.Problem.poisson_cube(32, device=dev)
    cm = czt.make_mesh((32, 32, 32), devices=[dev] * 8, div=(2, 2, 2))

    def syncs(itr_max):
        kw = dict(omega=0.8 if precond == "jacobi" else 1.1, itr_max=itr_max,
                  eps=1e-30, precond=precond)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                r = (czt.solve_dist(p, cm, solver, **kw) if dist
                     else czt.solve(p, solver, **kw))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        n = sum("synchroniz" in str(w.message) for w in caught)
        return r.iters, n

    syncs(3)  # the kernels' first launches (build, plans) out of the count
    (i3, n3), (i7, n7) = syncs(3), syncs(7)
    assert (i3, i7) == (2, 6)
    assert n7 - n3 == i7 - i3, (n3, n7)


# ---- slice 6: P1 (psor) and P2 (pcr_gs) on the diagonal layout -------------

# (K, I, J): a ragged and a tall shape, one inner row, and the progress
# counters between CTAs of one sweep (P1 past one chunk; P2 wherever its
# items outnumber one CTA)
DIAG_SHAPES = [(32, 32, 32), (37, 22, 45), (6, 140, 150), (70, 20, 18),
               (3, 7, 5), (70, 140, 150)]


def _diag_inputs(shape, dtype, dev, seed):
    from cubez_tpu_torch.ops import psor_scan

    gen = torch.Generator().manual_seed(seed)
    skew, _, _ = psor_scan.make_skew(shape)
    x, b = ((torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1)
            .to(dtype) for _ in range(2))
    return skew(x).to(dev), skew(b).to(dev)


def _diag_mc(shape, dtype, dev, maf):
    if not maf:
        return None
    K, I, J = shape
    return czt.Problem.manufactured_stretched((I, J, K), dtype=dtype,
                                              device=dev)[0].mc


def _sweeps_match_twin_calls(kfn, pfn, S, sweeps, launches, what):
    """Two launches of ``sweeps`` sweeps (``kfn``, in place) against as
    many calls of the plain twin ``pfn``: the field bit for bit after each
    launch, each sweep's r2 within 1e-12 relative (float64 sums in another
    order), one count a launch (``launches()``), and the same r2 bits from
    the same start (the fold's order is fixed)."""
    Sk, Sp = S.clone(), S.clone()
    before = launches()
    first = None
    for call in range(2):
        Sk, rk = kfn(Sk)
        rk = rk.reshape(-1).clone()
        rp = []
        for _ in range(sweeps):
            Sp, r = pfn(Sp)
            rp.append(float(r))
        torch.cuda.synchronize()
        assert torch.equal(Sk, Sp), f"{what}: launch {call}"
        assert rk.numel() == sweeps
        for got, want in zip(rk.tolist(), rp):
            assert got == pytest.approx(want, rel=1e-12, abs=0)
        first = rk if first is None else first
    assert launches() - before == 2
    again, ra = kfn(S.clone())
    torch.cuda.synchronize()
    assert torch.equal(ra.reshape(-1), first)


@pytest.mark.parametrize("sweeps", [1, 4])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", DIAG_SHAPES)
def test_p1_is_bitwise_its_twin(dev, shape, dtype, maf, sweeps):
    """Two launches of P1 of one or four sweeps (in place) equal as many
    sweeps of the plain twin bit for bit, float32 and float64; each sweep's residual to 1e-12 (both float64
    sums, in another order), the same bits from run to run; one count a
    launch."""
    from cubez_tpu_torch.cuda_kernels import psor as p1
    from cubez_tpu_torch.ops import psor_scan

    S, B = _diag_inputs(shape, dtype, dev, sum(shape))
    mc = _diag_mc(shape, dtype, dev, maf)
    launch = p1.PsorSweep(1.1, mc, sweeps=sweeps)
    before_maf = p1.psor_diag.maf_launches
    _sweeps_match_twin_calls(
        lambda S_: p1.psor_diag(S_, B, 1.1, mc, launcher=launch),
        lambda S_: psor_scan.psor_diag_plain(S_, B, 1.1, mc), S, sweeps,
        lambda: p1.psor_diag.launches, f"P1 {shape} {dtype} maf={maf}")
    assert launch.plan.sweeps == sweeps
    assert p1.psor_diag.maf_launches - before_maf == (3 if maf else 0)
    assert _build_lib().cz_psor_threads_per_block() == p1.THREADS


def _build_lib():
    from cubez_tpu_torch.cuda_kernels import _build

    return _build.load()


@pytest.mark.parametrize("sweeps", [1, 4])
@pytest.mark.parametrize("form", ["lines", "tile"])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", DIAG_SHAPES + [(600, 14, 12)])
def test_p2_is_bitwise_its_twin(dev, shape, dtype, maf, form, sweeps):
    """Two launches of P2 of one or four sweeps in either form (the tile
    form forced on short lines; 598-row lines take it by themselves) equal
    as many sweeps of the plain twin bit for bit; each sweep's residual to 1e-12, the same bits from run to run;
    one count a launch."""
    from cubez_tpu_torch.cuda_kernels import pcr_gs as p2
    from cubez_tpu_torch.ops import pcr_gs

    if form == "lines" and p2.plan(shape[0] - 2, dtype, maf).form == "tile":
        pytest.skip("lines past the line form")
    S, B = _diag_inputs(shape, dtype, dev, 7 * sum(shape))
    mc = _diag_mc(shape, dtype, dev, maf)
    launch = p2.PcrGsSweep(1.5, mc, form=None if form == "lines" else "tile",
                           sweeps=sweeps)
    tabs = launch.tables(S)
    key = (form, maf)
    _sweeps_match_twin_calls(
        lambda S_: p2.pcr_gs_diag(S_, B, 1.5, mc, launcher=launch),
        lambda S_: pcr_gs.pcr_gs_diag_plain(S_, B, 1.5, tabs), S, sweeps,
        lambda: p2.pcr_gs_diag.variant_launches.get(key, 0),
        f"P2 {shape} {dtype} maf={maf} {form}")
    assert launch.plan.form == form and launch.plan.sweeps == sweeps


def test_diag_launchers_refuse_sweeps_past_the_card(dev):
    """A launch of more sweeps than the card holds together raises before
    anything runs; nothing drops to fewer sweeps."""
    from cubez_tpu_torch.cuda_kernels import pcr_gs as p2
    from cubez_tpu_torch.cuda_kernels import psor as p1

    S, B = _diag_inputs((64, 64, 64), torch.float32, dev, 5)
    before = (p1.psor_diag.launches, p2.pcr_gs_diag.launches)
    with pytest.raises(ValueError, match="do not fit"):
        p1.PsorSweep(1.1, sweeps=10 ** 4)(S, B)
    with pytest.raises(ValueError, match="do not fit"):
        p2.PcrGsSweep(1.5, sweeps=10 ** 5)(S, B)
    assert (p1.psor_diag.launches, p2.pcr_gs_diag.launches) == before


@pytest.mark.parametrize("name,omega", [("psor", 1.1), ("psor_maf", 1.1),
                                        ("pcr", 1.5), ("pcr_esa_maf", 1.5)])
def test_diag_solves_on_cuda_are_bitwise_their_plain_solves(dev, name, omega):
    """A 32^3 float32 solve on P1/P2 gives the plain-twin solve's count
    and field bit for bit and its history to 1e-12 (float64 sums of dp^2
    in another order), with one launch of n sweeps a call and a host check
    a call, the stopping call replayed on the one-sweep launch: ceil(iters
    / n) launches and the stop's singles."""
    from cubez_tpu_torch.cuda_kernels import pcr_gs as p2
    from cubez_tpu_torch.cuda_kernels import psor as p1
    from cubez_tpu_torch.solvers.fused_cache import get_fused_step

    w = p1.psor_diag if name.startswith("psor") else p2.pcr_gs_diag
    p = czt.Problem.poisson_cube(32, device=dev, maf=name.endswith("_maf"))
    kind = "psor" if name.startswith("psor") else "pcr_gs"
    n = get_fused_step(kind, p.grid, omega, mc=p.mc).iters_per_call
    assert n > 1
    before = w.launches
    r = czt.solve(p, name, omega=omega, itr_max=4000)
    torch.cuda.synchronize()
    calls = -(-r.iters // n)
    singles = r.iters - n * (calls - 1) if r.iters % n else 0
    assert w.launches - before == calls + singles
    rp = czt.solve(p, name, omega=omega, itr_max=4000, impl="plain")
    torch.cuda.synchronize()
    assert w.launches - before == calls + singles  # the plain solve launches none
    assert r.iters == rp.iters and r.res < 1e-5 and torch.equal(r.x, rp.x)
    # the sums of dp^2, float64 on both sides, fold in another order
    torch.testing.assert_close(r.history, rp.history, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["psor", "pcr"])
def test_gathered_diag_step_runs_where_the_blocks_are(dev, name):
    """solve_dist's gathered psor/pcr step is built for the first block's
    device, not the problem's: a CUDA problem on a mesh of CPU blocks runs
    the twin one sweep a call and gives the serial host solve's count,
    field and history bit for bit, launching no kernel."""
    from cubez_tpu_torch.cuda_kernels import pcr_gs as p2
    from cubez_tpu_torch.cuda_kernels import psor as p1
    from cubez_tpu_torch.parallel.dist import make_gathered_step

    p = czt.Problem.poisson_cube(12, device=dev)
    cm = czt.make_mesh((12, 12, 12), devices=["cpu"] * 8, div=(2, 2, 2))
    step, _, _ = make_gathered_step(p, cm, name, 1.1)
    assert step.iters_per_call == 1 and step.single is step
    before = (p1.psor_diag.launches, p2.pcr_gs_diag.launches)
    rd = czt.solve_dist(p, cm, name, omega=1.1, itr_max=4000)
    rs = czt.solve(czt.Problem.poisson_cube(12, device="cpu"), name, omega=1.1,
                   itr_max=4000)
    assert (p1.psor_diag.launches, p2.pcr_gs_diag.launches) == before
    assert rd.iters == rs.iters > 0
    assert torch.equal(rd.x.cpu(), rs.x) and torch.equal(rd.history.cpu(), rs.history)
    # a CPU problem on a mesh of the card runs the n-sweep launches there
    pc = czt.Problem.poisson_cube(12, device="cpu")
    step, _, _ = make_gathered_step(pc, czt.make_mesh((12, 12, 12), devices=[dev] * 8,
                                                      div=(2, 2, 2)), name, 1.1)
    assert step.iters_per_call > 1


def test_diag_solvers_refuse_a_nonstandard_mask_on_cuda(dev):
    """psor and pcr with a mask other than the standard one raise
    ValueError before anything launches."""
    import dataclasses

    from cubez_tpu_torch.cuda_kernels import pcr_gs as p2
    from cubez_tpu_torch.cuda_kernels import psor as p1

    before = (p1.psor_diag.launches, p2.pcr_gs_diag.launches)
    for name in ("psor", "pcr", "pcr_eda_maf"):
        p = czt.Problem.poisson_cube(16, device=dev, maf=name.endswith("_maf"))
        msk = p.msk.clone()
        msk[5, 5, 5] = 0.0
        with pytest.raises(ValueError, match="standard cube inner mask"):
            czt.solve(dataclasses.replace(p, msk=msk), name, omega=1.1,
                      itr_max=10)
    assert (p1.psor_diag.launches, p2.pcr_gs_diag.launches) == before


def test_mg_results_are_their_own_on_cuda(dev):
    """Two mg preconditioner applications: the first result stays intact,
    though the finest level's K4 alternates between two buffers of its own
    that the second application rewrites; a solve's field is not
    rewritten by a later solve either."""
    from cubez_tpu_torch.solvers import bicgstab

    p = czt.Problem.poisson_cube(20, device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    v, w = (torch.rand((20,) * 3, device=dev, generator=gen) * p.msk
            for _ in range(2))
    pre = bicgstab.make_precon(p, "mg", 1.0)
    first = pre(v)
    kept = first.clone()
    pre(w)
    assert torch.equal(first, kept)
    r1 = czt.solve(p, "mg", omega=1.0, itr_max=3)
    x1 = r1.x.clone()
    import dataclasses

    czt.solve(dataclasses.replace(p, x0=r1.x), "mg", omega=1.0, itr_max=3)
    assert torch.equal(r1.x, x1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mg_fine_level_runs_k4_in_both_dtypes(dev, dtype):
    """On CUDA mg's finest level smooths on K4 in float32 and float64, nu1 +
    nu2 = 2 launches a V-cycle and never its twin: a departure from the
    JAX package, which picks its fused smoother for float32 on a TPU only,
    so that no plain twin runs on the card's path.  The field equals a
    plain-twin solve's bit for bit (float32) or to 1e-13."""
    p = czt.Problem.poisson_cube(40, dtype=dtype, device=dev)
    k4.sor2sma_k4.launches = 0
    r = czt.solve(p, "mg", omega=1.0, itr_max=100)
    torch.cuda.synchronize()
    # chunks of check_every_default = 2 cycles, and the replay of an odd
    # stop from its chunk's start (driver.run_iterative)
    cycles = r.iters + 2 * (r.iters % 2)
    assert k4.sor2sma_k4.launches == 2 * cycles
    rp = czt.solve(p, "mg", omega=1.0, itr_max=100, impl="plain")
    assert rp.iters == r.iters
    if dtype == torch.float32:
        assert torch.equal(rp.x, r.x)
    else:
        torch.testing.assert_close(rp.x, r.x, rtol=0, atol=1e-13)


def test_profile_solve_on_the_card(dev):
    """The perf layer on the card: profile_solve's sections timed with CUDA
    events, %SoL against the card's table entry, and over eight blocks on
    the card the pack route's COMM rows."""
    from cubez_tpu_torch.perf import pmlib
    from cubez_tpu_torch.perf.profile import profile_solve

    p = czt.Problem.poisson_cube(64, device=dev)
    pm = profile_solve(p, "sor2sma", OMEGA, iters=20)
    assert pm.order == ["sor2sma_sweep", "driver_overhead"]
    assert pm.sections["sor2sma_sweep"].seconds > 0
    assert pm.device == dev and pm.hbm_gbps == pmlib.device_hbm_gbps(dev)
    cm = czt.make_mesh(p.grid.shape_kij, devices=[dev] * 8, div=(2, 2, 2))
    pm = profile_solve(p, "sor2sma", OMEGA, iters=20, cmesh=cm)
    assert pm.order == ["halo_exchange", "residual_allreduce",
                        "sor2sma_block_sweep"]
    assert all(pm.sections[s].seconds > 0 and pm.sections[s].calls > 0
               for s in pm.order[:2])


def test_solver_label_on_the_card(dev):
    """Under torch.profiler a solve's K1/K3 launches run inside its
    ``sor2sma`` label; with no profiler on the label is never entered."""
    from cubez_tpu_torch.solvers import steps

    p = czt.Problem.poisson_cube(32, device=dev)
    before = steps.labeled.entered
    r = czt.solve(p, "sor2sma", omega=OMEGA, itr_max=10000)
    assert r.iters == 199 and steps.labeled.entered == before
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        czt.solve(p, "sor2sma", omega=OMEGA, itr_max=10000)
        torch.cuda.synchronize()
    evs = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges = [(e.time_range.start, e.time_range.end) for e in evs
              if e.name == "sor2sma" and e.device_type == cpu]
    launches = {e.id: e for e in evs if e.device_type == cpu
                and e.name.startswith("cu") and "Launch" in e.name}
    kernels = [e for e in evs if e.device_type != cpu
               and "sweeps_kernel" in e.name]
    assert ranges and kernels and steps.labeled.entered > before
    for k in kernels:
        ln = launches[k.id]
        assert any(a <= ln.time_range.start and ln.time_range.end <= b
                   for a, b in ranges)
