"""The shared-memory tile of the line kernels K5 and K6
(``cubez_tpu_torch/csrc/line_tile.cuh``): the host's choice of lines a
tile and of its shared memory (``lines.line_tile``), and the tile counts
the wrappers size their partial sums by (``lines.tile_plan``).  No kernel
runs here; tests/test_torch_cuda_kernels.py holds the kernels against
their twins on the card."""

import inspect
import re
from pathlib import Path

import pytest
import torch

from cubez_tpu_torch.cuda_kernels import lines as k6
from cubez_tpu_torch.cuda_kernels import rblines as k5

CSRC = Path(k6.__file__).resolve().parent.parent / "csrc"
F32, F64 = torch.float32, torch.float64
ITEM = {F32: 4, F64: 8}
KIB = 1024
SMEM_CTA = 227 * KIB  # an H100 CTA's shared memory
SMEM_SM = 228 * KIB   # an H100 SM's, 1 KB of it kept for each resident CTA


def _bytes(K, dtype, maf, L):
    """The tile's shared memory: the k tables (Q and E, or MAF's wzm, wzp
    and c3: 2K or 3K values), then (K - 2) L values of d, and as many of q
    (then e) for MAF."""
    return ((3 if maf else 2) * K + (K - 2) * L * (2 if maf else 1)) * ITEM[dtype]


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("K", [4, 5, 130, 258, 514, 1026])
def test_tile_fits_shared_memory(K, dtype, maf):
    """L is a power of two up to 32 and the tile fits one CTA with the
    static fold array; a tile of twice the lines would not have kept room
    for two CTAs an SM at L >= 16, and below 16 would not fit at all."""
    L, nbytes = k6.line_tile(K, dtype, maf)
    assert L in (1, 2, 4, 8, 16, 32)
    assert nbytes == _bytes(K, dtype, maf, L)
    assert nbytes + k6.SMEM_STATIC <= SMEM_CTA

    def two_fit(lines):
        return 2 * (_bytes(K, dtype, maf, lines) + k6.SMEM_STATIC + KIB) <= SMEM_SM

    if L >= 16 and L < 32:
        assert not two_fit(2 * L)
    if L < 16:
        assert not two_fit(16)
        assert _bytes(K, dtype, maf, 2 * L) + k6.SMEM_STATIC > SMEM_CTA


@pytest.mark.parametrize("K,dtype,maf,L,nbytes", [
    (128, F32, False, 32, (2 * 128 + 126 * 32) * 4),      # 128^3: 17 KB
    (128, F32, True, 32, (3 * 128 + 2 * 126 * 32) * 4),   # 128^3 MAF: 33 KB
    (512, F32, False, 32, (2 * 512 + 510 * 32) * 4),      # 512^3: 68 KB, two CTAs
    (512, F32, True, 16, (3 * 512 + 2 * 510 * 16) * 4),   # 16 lines keep two
    (512, F64, True, 16, (3 * 512 + 2 * 510 * 16) * 8),   # one CTA an SM
    (1026, F64, True, 8, (3 * 1026 + 2 * 1024 * 8) * 8),
])
def test_tile_at_the_solved_sizes(K, dtype, maf, L, nbytes):
    assert k6.line_tile(K, dtype, maf) == (L, nbytes)


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("K", [4, 130, 258, 514])
def test_float32_lines_keep_sixteen_lines_a_tile(K, maf):
    assert k6.line_tile(K, F32, maf)[0] >= 16


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_raises_past_the_longest_line(dtype, maf):
    """The longest line fits at L = 1; one value more raises, naming the
    limit."""
    kmax = k6.max_tile_k(dtype, maf)
    L, nbytes = k6.line_tile(kmax, dtype, maf)
    assert L == 1 and nbytes + k6.SMEM_STATIC <= SMEM_CTA
    with pytest.raises(ValueError, match=f"K <= {kmax}"):
        k6.line_tile(kmax + 1, dtype, maf)


@pytest.mark.parametrize("max_lines", [1, 8, 16, 64])
def test_max_lines_caps_the_tile(max_lines):
    """The cap (``TILE_LINES``, the tuning knob of tools/prof_lines.py)
    bounds L; a 128^3 line fits any of them twice an SM."""
    assert k6.line_tile(130, F32, False, max_lines) == (
        max_lines, _bytes(130, F32, False, max_lines))


def _tiles_brute(kind, shape, L):
    """(number of tiles, most lines in a tile of one launch, the tiles'
    ids) from the lines each kind relaxes, placed one by one: K5 a
    colour's packed (i2, j), line-Jacobi every (i, j), K6's colour the
    (i, j) of that colour, numbered along j within a row."""
    K, I, J = shape[-3:]
    rows = []
    if kind == "line_rb":
        for colour in (0, 1):
            for offset in (0, 1):
                rows.append([[j for j in range(J) if (i + j + offset) % 2 == colour]
                             for i in range(I)])
    else:
        rows.append([list(range(J)) for _ in range(I)])
    lanes = max(len(r) for rs in rows for r in rs)
    ids, most = set(), 0
    for rs in rows:  # one launch each
        tiles = {}
        for i, r in enumerate(rs):
            for q, _ in enumerate(r):
                t = i * -(-lanes // L) + q // L
                tiles[t] = tiles.get(t, 0) + 1
        ids |= set(tiles)
        most = max(most, *tiles.values())
    return len(ids), most, sorted(ids)


@pytest.mark.parametrize("maf", [False, True])
@pytest.mark.parametrize("kind,shape", [
    ("rbl", (2, 130, 64, 128)), ("rbl", (2, 4, 11, 45)), ("rbl", (2, 39, 4, 33)),
    ("line_j", (130, 128, 128)), ("line_j", (5, 13, 37)), ("line_j", (4, 3, 70)),
    ("line_rb", (128, 127, 128)), ("line_rb", (5, 9, 33)), ("line_rb", (13, 10, 17)),
])
def test_partials_count_the_tiles(kind, shape, maf):
    """The wrapper's partials (one a tile) match the tiles that cover the
    launch's lines, each tile at most L lines; threads are a multiple of
    L and of a warp, within the kernels' bound."""
    L, threads, tiles = k6.tile_plan(kind, shape, F32, maf)
    assert L == k6.line_tile(shape[-3], F32, maf)[0]
    n, most, ids = _tiles_brute(kind, shape, L)
    assert tiles == n and ids == list(range(n)) and most <= L
    assert threads % 32 == 0 and threads % L == 0
    assert threads <= k6.TILE_MAX_THREADS


def test_host_constants_match_the_kernel_source():
    """The host's bound on a tile's threads is line_tile.cuh's; K5, K6 and
    K9 (its 'fastdiag' form) include the tile and call relax_tile, and the
    one-thread Thomas (lines.cuh's relax_line) is gone."""
    tile = (CSRC / "line_tile.cuh").read_text()
    m = re.search(r"constexpr int kTileMaxThreads = (\d+);", tile)
    assert m and int(m.group(1)) == k6.TILE_MAX_THREADS
    for src in ("lines.cu", "rblines.cu", "dist_pcr.cu"):
        text = (CSRC / src).read_text()
        assert '#include "line_tile.cuh"' in text and "relax_tile<" in text
        assert "relax_line" not in text and "lines.cuh" not in text
    assert not (CSRC / "lines.cuh").exists()


@pytest.mark.parametrize("fn,gone", [
    (k5.rbl, ("g", "e")), (k6.line_j, ("e",)), (k6.line_rb, ("g", "e")),
])
def test_wrappers_take_no_scratch(fn, gone):
    """The tile keeps the Thomas values on chip: no wrapper takes a
    scratch field (line_j keeps ``out``, its second field)."""
    params = inspect.signature(fn).parameters
    assert not set(gone) & set(params)
    assert ("out" in params) == (fn is k6.line_j)
