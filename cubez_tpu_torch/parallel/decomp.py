"""3D block-decomposition search (PyTorch port's copy of
``cubez_tpu/parallel/decomp.py``; the CBrick findOptimalDivision
equivalent, CB_SubDomain_stub.h:255,434-491, cz_Evaluate.cpp:103-159).

Enumerates all factorizations (dz, dx, dy) of the block count and scores
them the way CBrick documents (volume balance, then communication surface,
then cubeness).  Deterministic; ties prefer more division along J, then I,
as the JAX package does.  Pure Python: the JAX package's native C++ search
gives the same answers and is not needed here.
"""

from __future__ import annotations

import math


def _divisions(nproc: int):
    out = []
    for dz in range(1, nproc + 1):
        if nproc % dz:
            continue
        rest = nproc // dz
        for dx in range(1, rest + 1):
            if rest % dx:
                continue
            out.append((dz, dx, rest // dx))
    return out


def score_division(div, gsize):
    """Lower is better: (max block volume, halo surface per block, cubeness)."""
    dz, dx, dy = div
    nk, ni, nj = gsize
    bk, bi, bj = math.ceil(nk / dz), math.ceil(ni / dx), math.ceil(nj / dy)
    vol = bk * bi * bj
    surf = 0
    if dz > 1:
        surf += 2 * bi * bj
    if dx > 1:
        surf += 2 * bk * bj
    if dy > 1:
        surf += 2 * bk * bi
    ext = sorted((bk, bi, bj))
    return (vol, surf, ext[2] / ext[0])


def auto_division(nproc: int, gsize) -> tuple[int, int, int]:
    """Best (dz, dx, dy) for a (nk, ni, nj) global grid.  The search allows
    uneven blocks like CBrick; ``make_mesh`` requires even ones."""
    cands = [
        d for d in _divisions(nproc)
        if d[0] <= gsize[0] and d[1] <= gsize[1] and d[2] <= gsize[2]
    ]
    if not cands:
        raise ValueError(f"cannot divide {gsize} over {nproc} devices")
    return min(cands, key=lambda d: (score_division(d, gsize), -d[2], -d[1]))
