"""K10's line form (csrc/pcr.cu ``pcr_lines_kernel`` on csrc/pcr_warp.cuh)
on the CPU: its stage schedule and its work items, emulated, and its plan.

The kernel runs only on the card.  Here the warp's layout is emulated in
torch as the kernel holds it: a line's row k = lane + 32 m in register m
of lane ``lane``, a stride s < 32 a lane rotation of each slab with the
wrapped lanes taking the neighbouring slab's value, a stride s >= 32 the
lane's own register m -+ s / 32, rows past the line zero.  That emulation
must give ``pcr_solve`` / ``pcr_reduce_var`` bit for bit at the edges of
the slabs (n = 1, 2, 31, 32, 33, 63, 126 and 510), so a wrong carry or a
missed zero shows before the card.  The work items (a window of 32
columns of one row: 16 colour lines or 32 line-Jacobi lines) must cover
each line once."""

import numpy as np
import pytest
import torch

from cubez_tpu_torch.cuda_kernels import pcr as k10
from cubez_tpu_torch.ops.pcr import num_stage, pcr_reduce_var

torch.set_num_threads(1)

EDGES = [1, 2, 31, 32, 33, 63, 126, 510]
DTYPES = [torch.float32, torch.float64]


def _slabs(n):
    return k10.line_plan(n).slabs


def to_lanes(v, M):
    """(n, L) rows -> (M, 32, L) registers, rows past n zero."""
    n = v.shape[0]
    out = torch.zeros((M * 32,) + v.shape[1:], dtype=v.dtype)
    out[:n] = v
    return out.reshape((M, 32) + v.shape[1:])


def from_lanes(r, n):
    return r.reshape((-1,) + r.shape[2:])[:n]


def _lane_row(M, shape_tail):
    lane = torch.arange(32).reshape((1, 32) + (1,) * len(shape_tail))
    m = torch.arange(M).reshape((M, 1) + (1,) * len(shape_tail))
    return lane, lane + 32 * m


def rows_below(v, S):
    """pcr_warp.cuh rows_below: row k - S, zero below row 0."""
    M = v.shape[0]
    lane, _ = _lane_row(M, v.shape[2:])
    zero = torch.zeros_like(v[:1])
    if S < 32:
        r = torch.roll(v, S, dims=1)  # __shfl_sync(v, (lane - S) & 31)
        prev = torch.cat([zero, r[:-1]])  # slab m - 1's rotation
        return torch.where(lane >= S, r, prev)
    t = S // 32
    return torch.cat([zero.expand((min(t, M),) + v.shape[1:]), v[:max(M - t, 0)]])


def rows_above(v, S, n=None):
    """pcr_warp.cuh rows_above: row k + S, zero from row n on (None: only
    past the registers' rows, rows_above<..., false>)."""
    M = v.shape[0]
    lane, k = _lane_row(M, v.shape[2:])
    zero = torch.zeros_like(v[:1])
    if S < 32:
        r = torch.roll(v, -S, dims=1)  # __shfl_sync(v, (lane + S) & 31)
        nxt = torch.cat([r[1:], zero])
        hi = torch.where(lane + S < 32, r, nxt)
    else:
        t = S // 32
        hi = torch.cat([v[min(t, M):], zero.expand((min(t, M),) + v.shape[1:])])
    if n is None:
        return hi
    return torch.where(k + S >= n, torch.zeros_like(hi), hi)


def warp_tab(d, tab, pn):
    """pcr_warp_tab on registers d (M, 32, L), ``tab`` the stage tables
    padded with zeros to 32 M a row (stage_tables(..., width)): no row is
    tested against n, the rows past it stay +0."""
    M = d.shape[0]
    _, k = _lane_row(M, d.shape[2:])

    def at(row, off=0):  # tab[row][k - off]; k - off < 0 is not taken
        kk = (k - off).clamp(min=0).reshape(-1)
        return tab[row][kk].reshape(k.shape)

    for p in range(pn - 1):
        S = 1 << p
        lo, hi = rows_below(d, S), rows_above(d, S)
        d = at(3 * p + 2) * ((d - at(3 * p) * lo) - at(3 * p + 1) * hi)
    S = 1 << (pn - 1)
    fin = 3 * (pn - 1)
    lo, hi = rows_below(d, S), rows_above(d, S)
    x_lo = (d - at(fin) * hi) * at(fin + 2)
    x_hi = (d - at(fin + 1, S) * lo) * at(fin + 2, S)
    return torch.where(k < S, x_lo, x_hi)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def warp_var(a, c, d, n, pn):
    """pcr_warp_var on registers (M, 32, L) each."""
    for p in range(pn - 1):
        S = 1 << p
        al, ar = rows_below(a, S), rows_above(a, S, n)
        cl, cr = rows_below(c, S), rows_above(c, S, n)
        dl, dr = rows_below(d, S), rows_above(d, S, n)
        e = 1.0 / ((1.0 - a * cl) - c * ar)
        a, c, d = (-e * a) * al, (-e * c) * cr, e * ((d - a * dl) - c * dr)
    S = 1 << (pn - 1)
    M = d.shape[0]
    _, k = _lane_row(M, d.shape[2:])
    ah, cl = rows_above(a, S, n), rows_below(c, S)
    dl, dh = rows_below(d, S), rows_above(d, S, n)
    x_lo = (d - c * dh) * (1.0 / (1.0 - ah * c))
    x_hi = (d - a * dl) * (1.0 / (1.0 - a * cl))
    return torch.where(k < S, x_lo, x_hi)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", EDGES)
def test_warp_schedule_bitwise_vs_table_solve(n, dtype):
    """Constant coefficients: the registers' stages give pcr_solve's
    solution bit for bit (the stage tables of build_tables)."""
    rng = np.random.default_rng(n)
    d = torch.tensor(rng.standard_normal((n, 5))).to(dtype)
    pn = num_stage(n)
    M = _slabs(n)
    tab = torch.from_numpy(k10.build_tables(n, dtype))
    want = k10.pcr_solve(d, tab, pn)
    padded = k10.stage_tables(n, dtype, torch.device("cpu"), 32 * M)
    assert torch.equal(padded[:, :n], tab) and not padded[:, n:].any()
    regs = warp_tab(to_lanes(d, M), padded, pn)
    # bit for bit, signs of zeros included; the padding rows stay +0
    assert torch.equal(_bits(from_lanes(regs, n)), _bits(want))
    assert not _bits(regs.reshape((-1,) + regs.shape[2:])[n:]).any()
    got = from_lanes(regs, n)
    # and the line is solved: residual of the tridiagonal system
    a = torch.full((n,), -1.0 / 6.0, dtype=torch.float64)
    a[0] = 0
    c = torch.full((n,), -1.0 / 6.0, dtype=torch.float64)
    c[-1] = 0
    x = got.double()
    r = x.clone()
    r[1:] += a[1:, None] * x[:-1]
    r[:-1] += c[:-1, None] * x[1:]
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((r - d.double()).abs().max()) < tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", EDGES)
def test_warp_schedule_bitwise_vs_variable_solve(n, dtype):
    """Variable coefficients (a[0] = 0, c[n-1] = 0, as a line's ends): the
    registers' stages give pcr_reduce_var's solution bit for bit."""
    rng = np.random.default_rng(1000 + n)
    a = torch.tensor(rng.uniform(-0.3, 0.0, (n, 4))).to(dtype)
    c = torch.tensor(rng.uniform(-0.3, 0.0, (n, 4))).to(dtype)
    d = torch.tensor(rng.standard_normal((n, 4))).to(dtype)
    a[0] = 0
    c[-1] = 0
    pn = num_stage(n)
    want = pcr_reduce_var(a, c, d, pn)
    M = _slabs(n)
    got = from_lanes(warp_var(to_lanes(a, M), to_lanes(c, M), to_lanes(d, M),
                              n, pn), n)
    assert torch.equal(_bits(got), _bits(want))


def test_rows_past_the_line_read_as_zero():
    """A row's neighbours above the line's end are zero, whatever the
    padding rows of the last slab hold, and rows below 0 are zero."""
    n, M = 33, 2
    v = to_lanes(torch.arange(1.0, n + 1).reshape(n, 1), M)
    v.reshape(-1)[n:] = 99.0  # garbage in the padding
    for S in (1, 16, 31, 32):
        hi = from_lanes(rows_above(v, S, n), n).reshape(-1)
        want = torch.zeros(n)
        want[:max(n - S, 0)] = torch.arange(1.0 + S, n + 1)
        assert torch.equal(hi, want), S
        lo = from_lanes(rows_below(v, S), n).reshape(-1)
        want = torch.zeros(n)
        want[S:] = torch.arange(1.0, n + 1 - S)
        assert torch.equal(lo, want), S


@pytest.mark.parametrize("n,form,slabs", [
    (1, "lines", 1), (32, "lines", 1), (33, "lines", 2), (126, "lines", 4),
    (254, "lines", 8), (510, "lines", 16), (512, "lines", 16), (513, "tile", 0),
])
def test_line_plan(n, form, slabs):
    """Lines up to 512 rows run in registers, the fewest slabs that hold
    them, where the line form's shared memory (the padded stage tables and
    a window's right-hand sides) fits a CTA; longer ones, and those whose
    work item does not fit, take the shared-memory tile form."""
    for dtype in DTYPES:
        item = torch.empty((), dtype=dtype).element_size()
        for maf in (False, True):
            for jacobi in (False, True):
                plan = k10.line_plan(n, dtype, maf, jacobi)
                fits = form == "lines" and k10.PcrPlan(
                    "lines", n, slabs=slabs).smem(item, jacobi, maf) <= k10.SMEM_CTA
                fits = fits and (not maf or slabs <= k10.MAF_SLABS[item])
                if fits:
                    assert (plan.form, plan.slabs) == ("lines", slabs)
                    assert n <= 32 * plan.slabs < 64 * max(n, 16)
                    assert plan.stride % 2 == 1  # no bank conflicts
                else:
                    assert plan.form == "tile" and plan.tile_lines >= 1
    # the 128^3 and 512^3 float32 paths run in registers (MAF at 512^3 on
    # the tiles); the profiling hook forces either form
    for n_, m in ((126, 4), (510, 16)):
        assert k10.line_plan(n_, torch.float32, False, True).slabs == m
    assert k10.line_plan(510, torch.float32, True).form == "tile"
    assert k10.line_plan(254, torch.float32, True).slabs == 8
    assert k10.line_plan(254, torch.float64, True).form == "tile"
    assert k10.line_plan(126, torch.float64, True).slabs == 4
    k10._force_plan = {"form": "lines"}
    try:
        assert k10.line_plan(510, torch.float32, True).slabs == 16
        k10._force_plan = {"form": "tile"}
        assert k10.line_plan(126, torch.float32).form == "tile"
    finally:
        k10._force_plan = {}


def _window_lines(I, J, colour, offset):
    """The (i, j) lines each work item of a pass solves, as the kernel
    walks them (pcr_lines_kernel: rows, windows, line_column)."""
    jac = colour is None
    j_first = 0 if jac else 1
    wins = -(-(J - j_first) // k10.WINDOW)
    rows = I if jac else I - 2
    seen = []
    for w in range(rows * wins):
        wi, wj = divmod(w, wins)
        i = wi if jac else wi + 1
        j0 = j_first + k10.WINDOW * wj
        for ll in range(k10.WINDOW if jac else k10.WINDOW // 2):
            if jac:
                j = j0 + ll
            else:
                j = j0 + 2 * ll
                j = j if (i + j + offset) % 2 == colour else j + 1
            if 1 <= i <= I - 2 and 1 <= j <= J - 2:
                seen.append((i, j))
    return seen


@pytest.mark.parametrize("shape", [(5, 16, 16), (5, 13, 18), (5, 9, 70),
                                   (5, 130, 33)])
def test_work_items_cover_each_line_once(shape):
    """Each colour pass's work items cover the lines of its colour once,
    the line-Jacobi pass's every inner line once; the lane that builds a
    line's rows (column j0 + lane, line lane // 2 or lane) is the slot the
    warp solves it in."""
    _, I, J = shape
    for offset in (0, 1):
        for colour in (0, 1, None):
            seen = _window_lines(I, J, colour, offset)
            want = {(i, j) for i in range(1, I - 1) for j in range(1, J - 1)
                    if colour is None or (i + j + offset) % 2 == colour}
            assert len(seen) == len(set(seen)) and set(seen) == want
            jac = colour is None
            for j0 in (0, 1, 33):
                for lane in range(32):
                    j = j0 + lane
                    slot = lane if jac else lane // 2
                    line_j = j0 + slot if jac else j0 + 2 * slot
                    if not jac and (3 + line_j + offset) % 2 != colour:
                        line_j += 1
                    if jac or (3 + j + offset) % 2 == colour:
                        assert line_j == j


@pytest.mark.parametrize("kind", ["pcr", "pcr_rb"])
@pytest.mark.parametrize("maf", [False, True])
def test_steps_on_cpu_equal_the_colour_passes(kind, maf):
    """A 'pcr_rb' step is colour 0 then colour 1 of the twin, in place; a
    'pcr' step the line-Jacobi pass into one of its two fields, x only
    read.  r2 is the passes' sum."""
    import cubez_tpu_torch as czt

    shape = (14, 12, 13)
    K, I, J = shape
    mc = czt.Problem.poisson_cube((I, J, K), device="cpu", maf=True).mc if maf else None
    tab = k10.maf_tables(mc, shape, torch.float32) if maf else None
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    b = torch.tensor(rng.standard_normal(shape).astype(np.float32))
    step = k10.make_fused_pcr_step(kind, shape, omega=1.3, offset=1, mc=mc)
    keep = x.clone()
    got, r2 = step(x.clone() if kind == "pcr_rb" else x, b)
    if kind == "pcr":
        want, rw = k10.fused_pcr_plain(keep.clone(), b, 1.3, None, 1, tab)
        assert torch.equal(x, keep) and got.data_ptr() != x.data_ptr()
    else:
        want, r0 = k10.fused_pcr_plain(keep.clone(), b, 1.3, 0, 1, tab)
        want, r1 = k10.fused_pcr_plain(want, b, 1.3, 1, 1, tab)
        rw = r0 + r1
    assert torch.equal(got, want)
    assert float(r2) == float(rw)


def test_launcher_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="passes"):
        k10.PcrLines((1, 0), 1.5)
    with pytest.raises(ValueError, match="passes"):
        k10.PcrLines((None, 0), 1.5)
    with pytest.raises(ValueError, match="inner row"):
        k10.line_plan(0)
    assert k10.make_fused_pcr_step("pcr_rb", (2, 8, 8), omega=1.5) is None
    with pytest.raises(ValueError, match="kind"):
        k10.make_fused_pcr_step("pcr_gs", (8, 8, 8), omega=1.5)
