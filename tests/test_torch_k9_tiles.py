"""K9's launch geometry and the constant 'pcr' form's stage tables
(``cubez_tpu_torch/csrc/dist_pcr.cu``): the host's plans (lines a CTA,
shared memory, CTAs and so partial sums a block), the launch arguments the
wrapper builds, its constants against the sources, and the contract that
lets a constant line run the d chain alone: tables evolved by the
variable stage's own operations give pcr_solve_var's solution bit for bit.
No kernel runs here; tests/test_torch_cuda_kernels.py holds the kernels
against their twins on the card."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cubez_tpu_torch.cuda_kernels import _build, dist_halo
from cubez_tpu_torch.cuda_kernels import dist_pcr as k9
from cubez_tpu_torch.cuda_kernels import lines as k6
from cubez_tpu_torch.cuda_kernels import pcr as k10
from cubez_tpu_torch.ops.pcr import num_stage
from cubez_tpu_torch.parallel import dist_fused

CSRC = Path(k9.__file__).resolve().parent.parent / "csrc"
F32, F64 = torch.float32, torch.float64
ITEM = {F32: 4, F64: 8}
KIB = 1024
SMEM_CTA = 227 * KIB  # an H100 CTA's shared memory
SMEM_SM = 228 * KIB   # an H100 SM's, 1 KB of it kept for each resident CTA
SEED = 17


@pytest.mark.parametrize("color", [0, None])
@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n", [66, 130, 258, 514])
@pytest.mark.parametrize("form", ["pcr", "fastdiag"])
def test_plans_fit_shared_memory(form, n, dtype, maf, color):
    """Every form at the solved line lengths (n = lk + 2 rows; 'fastdiag'
    lines hold lk = n - 2 values): L a power of two up to 32 dividing the
    CTA, shared memory under an H100 CTA's; the constant 'pcr' form holds
    two buffers of d and takes the most lines that leave room for eight
    CTAs an SM, MAF 'pcr' six of a, c and d, 'fastdiag' line_tile.cuh's
    tile."""
    bs = (n - 2, 64, 63)
    pl = k9.plan(form, bs, dtype, maf, color)
    L = pl.lines
    assert L in (1, 2, 4, 8, 16, 32) and pl.threads % L == 0
    assert pl.smem + 8 * 256 // 32 <= SMEM_CTA
    if form == "fastdiag":
        assert pl.solve == "tile" and (L, pl.smem) == k6.line_tile(n - 2, dtype, maf)
        assert pl.threads == k6.TILE_MAX_THREADS
        return
    assert pl.threads == k9.PCR_THREADS
    per_line = (6 if maf else 2) * n * ITEM[dtype]
    assert pl.smem == per_line * L
    if maf:
        assert pl.solve == "var" and L == k10.tile_lines(n, dtype, True)
        return
    assert pl.solve == "tab"

    def eight_fit(lines):
        return 8 * (2 * n * lines * ITEM[dtype] + 64 + KIB) <= SMEM_SM

    assert eight_fit(L) and (L == 32 or not eight_fit(2 * L))


@pytest.mark.parametrize("dtype", [F32, F64])
def test_tab_lines_at_the_solved_sizes(dtype):
    """128^3 over (2, 2, 2) and 512^3: 64^3 and 256^3 blocks."""
    want = {F32: (32, 8), F64: (16, 4)}[dtype]
    assert (k9.tab_lines(66, dtype), k9.tab_lines(258, dtype)) == want


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_fastdiag_raises_past_the_longest_line(dtype, maf):
    """A 'fastdiag' line past the tile raises, naming the limit: no
    fallback to another kernel."""
    kmax = k6.max_tile_k(dtype, maf)
    assert k9.plan("fastdiag", (kmax, 8, 8), dtype, maf, 0).lines == 1
    with pytest.raises(ValueError, match=f"K <= {kmax}"):
        k9.plan("fastdiag", (kmax + 1, 8, 8), dtype, maf, 0)


@pytest.mark.parametrize("per_sm,want", [(4, 32), (8, 32), (16, 16), (32, 8)])
def test_tab_lines_leave_room_for_the_ctas(monkeypatch, per_sm, want):
    """The constant 'pcr' form's lines a CTA follow TAB_CTAS_PER_SM: at
    n = 66 in float32 (528 bytes a line, 1 KB kept a CTA) 8 CTAs an SM
    take 32 lines, 16 take 16, 32 take 8; and ``plan`` takes them."""
    monkeypatch.setattr(k9, "TAB_CTAS_PER_SM", per_sm)
    assert k9.tab_lines(66, F32) == want
    assert k9.plan("pcr", (64, 8, 8), F32, False, 0).lines == want


def _cta_of_lines(form, pl, bs, origin, gshape, offset, color):
    """{CTA id: columns it holds} from the columns each launch covers,
    placed as csrc/dist_pcr.cu's ``place`` puts them: a colour's lanes in
    row i (the colour's j of each pair), or every column of the ghosted
    block for the line-Jacobi pass; 'pcr' CTAs (x along a row, y a row),
    'fastdiag' tiles numbered along rows."""
    lk, li, lj = bs
    k0, i0, j0 = origin
    lanes = lj + 2 if color is None else (lj + 1) // 2
    per_row = -(-lanes // pl.lines)
    out = {}
    rows = range(li + 2) if color is None else range(li)
    for row in rows:
        if color is None:
            cols = [(row, j) for j in range(lj + 2)]
        else:
            i = row + 1
            gi = i0 + i - 1
            first = 1 if (color + gi + j0 + 1 + offset) % 2 else 2
            cols = [(i, j) for j in range(first, lj + 1, 2)]
        for m, c in enumerate(cols):
            cta = row * per_row + m // pl.lines
            out.setdefault(cta, []).append(c)
    return out


@pytest.mark.parametrize("color", [0, 1, None])
@pytest.mark.parametrize("form,bs,gshape,origin", [
    ("pcr", (64, 64, 64), (128, 128, 128), (64, 0, 64)),
    ("pcr", (10, 12, 15), (20, 24, 30), (0, 12, 15)),
    ("pcr", (256, 6, 9), (512, 12, 18), (256, 6, 0)),
    ("fastdiag", (128, 64, 64), (128, 128, 128), (0, 64, 0)),
    ("fastdiag", (20, 12, 13), (20, 24, 26), (0, 0, 13)),
    ("fastdiag", (256, 6, 9), (256, 12, 18), (0, 6, 9)),
])
def test_partials_count_the_ctas(form, bs, gshape, origin, color):
    """A block's partials (one a CTA) match the CTAs that cover its
    columns: every column of the launch in a CTA of the plan, at most L
    columns a CTA, and every owned line of the colour (or every line)
    covered once."""
    for maf in (False, True):
        pl = k9.plan(form, bs, F32, maf, color)
        ctas = _cta_of_lines(form, pl, bs, origin, gshape, 1, color)
        assert max(ctas) < pl.ctas and max(map(len, ctas.values())) <= pl.lines
        if form == "pcr":
            lanes = bs[2] + 2 if color is None else (bs[2] + 1) // 2
            assert (pl.gx, pl.gy) == (-(-lanes // pl.lines),
                                      bs[1] + (2 if color is None else 0))
        else:
            assert pl.gy == 1
        covered = sorted(c for cs in ctas.values() for c in cs)
        assert len(covered) == len(set(covered))
        if color is None:
            assert len(covered) == (bs[1] + 2) * (bs[2] + 2)


class _Lib:
    """Stands in for the built library: the launch arguments are built on
    the host without a card."""

    def __getattr__(self, name):
        return name


def _prepare(monkeypatch, launcher, xs, outs=None):
    monkeypatch.setattr(k9, "check_blocks", lambda *a: None)
    monkeypatch.setattr(_build, "load", lambda: _Lib())
    return launcher._prepare(xs, None, outs)


@pytest.mark.parametrize("color", [0, None])
@pytest.mark.parametrize("form,div", [("pcr", (2, 2, 2)), ("pcr", (1, 2, 2)),
                                      ("fastdiag", (1, 2, 2))])
def test_launch_arguments(monkeypatch, form, div, color):
    """What BlockPcr hands csrc/dist_pcr.cu's ``launch``: four pointers a
    block (x, b, its table, out) then the Thomas factors; the integer
    layout the kernel reads, the plan's L and grid; partial slots = the
    plan's CTAs times the blocks; the constant 'pcr' form's table pointer
    is its wall pattern's ``pattern_table``, shared by blocks of one
    pattern."""
    gshape = (16, 20, 24)
    bs = tuple(g // d for g, d in zip(gshape, div))
    origins = [(a * bs[0], b * bs[1], c * bs[2]) for a in range(div[0])
               for b in range(div[1]) for c in range(div[2])]
    xs = [torch.zeros(tuple(v + 2 for v in bs)) for _ in origins]
    outs = None if color is not None else [torch.zeros_like(x) for x in xs]
    launcher = k9.BlockPcr(form, color, 1.5, origins, gshape, 1)
    prep = _prepare(monkeypatch, launcher, xs, outs)
    assert prep.fn == "cz_block_pcr_f32"
    (parr, iarr, slots), = prep.calls
    n = len(xs)
    pl = k9.plan(form, bs, F32, False, color)
    ints = list(iarr)
    assert ints[:16] == [n, k9.FORMS.index(form), -1 if color is None else color,
                         pl.lines, num_stage(bs[0] + 2), 0, pl.gx, pl.gy, -1,
                         *bs, *gshape, 1]
    assert ints[16:] == [v for o in origins for v in o]
    assert slots == pl.ctas * n and len(parr) == 4 * n + 1
    tabs = [parr[4 * i + 2] for i in range(n)]
    if form == "pcr":
        want = [k9.pattern_table(o[0], bs[0], gshape[0], F32, "cpu").data_ptr()
                for o in origins]
        assert tabs == want and len(set(tabs)) == (2 if div[0] == 2 else 1)
        assert parr[4 * n] is None
    else:
        assert tabs == [None] * n and parr[4 * n] is not None


def test_host_constants_match_the_kernel_source():
    """The block bound, the 'pcr' CTA's threads and the tile's threads are
    the sources'; the kernel reads four pointers a block and sizes the
    forms' shared memory as ``plan`` does; K9 runs line_tile.cuh and
    pcr.cuh's table and variable solves."""
    src = (CSRC / "dist_pcr.cu").read_text()
    m = re.search(r"constexpr int kMaxBlocks = (\d+);", src)
    assert m and int(m.group(1)) == dist_halo.MAX_BLOCKS
    m = re.search(r"constexpr int kPcrThreads = (\d+);", (CSRC / "pcr.cuh").read_text())
    assert m and int(m.group(1)) == k9.PCR_THREADS
    m = re.search(r"constexpr int kTileMaxThreads = (\d+);",
                  (CSRC / "line_tile.cuh").read_text())
    assert m and int(m.group(1)) == k6.TILE_MAX_THREADS
    assert "ptrs + 4 * b" in src and "ptrs[4 * n]" in src
    assert "(maf ? 6 : 2) * size_t(n) * a.L * sizeof(T)" in src
    assert "tile_smem_bytes(a.lk, a.L, sizeof(T), kMaf)" in src
    for call in ("relax_tile<", "pcr_solve_tab(", "pcr_solve_var("):
        assert call in src


def test_wrappers_take_no_scratch():
    """The 'fastdiag' tile keeps the Thomas values on chip: no K9 entry
    point takes or makes a scratch field, and the step makes none."""
    for fn in (k9.BlockPcr, k9.pcr_blocks, k9.block_pcr, k9.make_block_pcr):
        assert "scratch" not in inspect.signature(fn).parameters
    assert not hasattr(k9, "make_scratch")
    assert "scratch" not in inspect.getsource(dist_fused._make_line_step)


# (name, k0, Kg) for lk = n - 2: which end rows of a block's line lie on a
# physical K wall
PATTERNS = {"bottom": (0, 3), "top": (2, 3), "both": (0, 1), "neither": (1, 3)}


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("n", [4, 5, 66, 130, 258])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_pattern_tables_give_the_variable_solve(dtype, n, pattern):
    """The constant 'pcr' contract: a block's tables, built by
    pcr_reduce_var's recurrence in the field's type, run through
    ``pcr.pcr_solve`` (the kernel's pcr_solve_tab), equal
    ``pcr_solve_var`` on a = c = -R6 at the stencil rows bitwise, on
    seeded d; ``build_tables``' float64 evolution is no substitute."""
    lk = n - 2
    k0, kg = PATTERNS[pattern]
    k0, Kg = k0 * lk, kg * lk
    rows = k9.stencil_rows(k0, lk, Kg)
    assert not rows[0] and not rows[-1]
    assert bool(rows[1]) == (pattern in ("top", "neither"))
    assert bool(rows[lk]) == (pattern in ("bottom", "neither"))
    r6 = torch.tensor(k9._R6[dtype], dtype=dtype)
    a = torch.where(rows, -r6, torch.zeros((), dtype=dtype))[:, None].repeat(1, 9)
    d = torch.from_numpy(np.random.default_rng(SEED + n).standard_normal((n, 9))).to(dtype)
    pn = num_stage(n)
    tab = k9.pattern_table(k0, lk, Kg, dtype, "cpu")
    assert tab.shape == (3 * (pn - 1) + 3, n) and tab.dtype == dtype
    want = k10.pcr_solve_var(a, a.clone(), d, pn)
    assert torch.equal(k10.pcr_solve(d, tab, pn), want)
    assert torch.equal(tab, k10.var_tables(a[:, 0].contiguous(), a[:, 0].contiguous(), pn))


@pytest.mark.parametrize("color", [0, None])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("dtype", [F32, F64])
def test_tab_solve_of_a_block_is_the_twin(dtype, pattern, color):
    """The constant 'pcr' kernel's algorithm on the host: the twin's right-
    hand sides solved on the block's pattern table and relaxed on the
    colour's lines give ``block_pcr_plain``'s block and r2 bit for bit."""
    lk, li, lj = 10, 6, 7
    k0, kg = PATTERNS[pattern]
    geom = (k0 * lk, 4, 0, kg * lk, 16, 7, 1)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((lk + 2, li + 2, lj + 2))).to(dtype)
    b = torch.from_numpy(rng.standard_normal(x.shape)).to(dtype)
    want, r_want = k9.block_pcr_plain(x.clone(), b, "pcr", color, 1.5, geom)

    def tab_solve(a, c, d, pn):
        return k10.pcr_solve(d, k9.pattern_table(geom[0], lk, geom[3], dtype, "cpu"), pn)

    mp = pytest.MonkeyPatch()
    mp.setattr(k9, "pcr_solve_var", tab_solve)
    try:
        got, r_got = k9.block_pcr_plain(x.clone(), b, "pcr", color, 1.5, geom)
    finally:
        mp.undo()
    assert torch.equal(got, want) and torch.equal(r_got, r_want)
