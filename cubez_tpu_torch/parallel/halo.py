"""Width-1 halo exchange on a block list (PyTorch port of
``cubez_tpu/parallel/halo.py``; CBrick's 6-face Isend/Irecv halo sync,
BrickComm::Comm_S_node wrapped by CZ::Comm_S, cz_comm.cpp:23-38).

``FaceExchange`` is the distributed steps' exchange: one kernel launch a
card for the blocks that share it (cuda_kernels/dist_halo.py), a ``copy_``
a face between blocks on different cards, the kernel's twin for CPU
blocks.  It fills face ghosts only; ``refresh_ghosts`` below fills whole
planes (edges too) and serves ``exchange_halo``.

A distributed field is a list of block tensors (mesh.py).  A ghost plane
is a slice copy from the neighbour block's owned face; blocks on a mesh
edge keep zero ghosts there, as ``ppermute`` fills them.  Axes go in the
order Z, X, Y, each copying planes that span the ghosts of the axes
already refreshed, so edge ghosts hold consistent two-hop values (the
7-point stencil never reads them: NOFACE=6, CB_Define_stub.h:31-35).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..cuda_kernels import dist_halo
from ..cuda_kernels.dist_halo import psum_all  # noqa: F401 (re-export)
from .mesh import CubeMesh


def refresh_ghosts(padded, cmesh: CubeMesh):
    """Write width-1 ghost planes in place into (lk+2, li+2, lj+2) blocks
    (owned cells at [1, l+1) on each axis) from the mesh neighbours' owned
    faces.  Ghosts past a mesh edge are left as they are."""
    for axis in range(3):
        n = padded[0].shape[axis] - 2
        for b, blk in enumerate(padded):
            for step, dst, src in ((1, n + 1, 1), (-1, 0, n)):
                nb = cmesh.neighbor(b, axis, step)
                if nb is not None:
                    blk.select(axis, dst).copy_(padded[nb].select(axis, src))
    return padded


def pad_zeros(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad a local block by 1 on every side (for b and mask
    companions)."""
    return F.pad(x, (1, 1, 1, 1, 1, 1))


def exchange_halo(blocks, cmesh: CubeMesh):
    """Blocks (lk, li, lj) -> new padded (lk+2, li+2, lj+2) blocks with the
    neighbours' ghosts (zeros at physical boundaries)."""
    return refresh_ghosts([pad_zeros(b) for b in blocks], cmesh)


def global_offsets(cmesh: CubeMesh, gshape):
    """(k0, i0, j0) global start of each block's owned cells."""
    return cmesh.offsets(gshape)


class FaceExchange:
    """Refresh the face ghosts of a ghosted block list (edge and corner
    ghosts untouched: no kernel reads them).  Blocks that share a card
    exchange in one launch on it (dist_halo.Exchange); a face between two
    cards is a ``copy_`` (untested: the test rig has one card); CPU blocks,
    or every block with ``plain``, run the twin.

    ``collect`` and ``write`` split the refresh for the overlap step: on
    each card ``collect`` gathers the neighbours' faces into a staging
    buffer in one launch on a side stream (the caller's interior pass runs
    meanwhile on the current stream), ``write`` makes the current stream
    wait for it and scatters them into the ghosts in one more, and copies
    the faces between cards.  CPU blocks do the whole refresh in
    ``write``."""

    def __init__(self, cmesh: CubeMesh, plain: bool = False):
        self.cmesh = cmesh
        self.plain = plain
        self._layout = None

    def _setup(self, xs):
        """Group the blocks by device: for each card, its block indices,
        its exchange and (made at the first ``collect``) its side stream
        and split exchanges; and the (block, face, neighbour) copies that
        no kernel covers."""
        groups = {}
        for b, x in enumerate(xs):
            groups.setdefault(x.device, []).append(b)
        cards, rest = [], []
        for dev, idx in groups.items():
            on_card = dev.type == "cuda" and not self.plain
            local = {b: i for i, b in enumerate(idx)}
            table = []
            for b in idx:
                row = []
                for f in range(6):
                    nb = self.cmesh.neighbor(b, f // 2, 1 if f % 2 else -1)
                    if nb is not None and on_card and nb in local:
                        row.append(local[nb])
                    else:
                        row.append(-1)
                        if nb is not None:
                            rest.append((b, f, nb))
                table.append(row)
            if on_card:
                cards.append({"dev": dev, "idx": idx, "table": table,
                              "copy": dist_halo.Exchange(table)})
        self._layout = cards, rest

    def _cards(self, xs):
        if self._layout is None:
            self._setup(xs)
        return self._layout

    @staticmethod
    def _blocks(xs, card):
        idx = card["idx"]
        return xs if len(idx) == len(xs) else [xs[i] for i in idx]

    @staticmethod
    def _rest(xs, rest):
        for b, f, nb in rest:
            dist_halo.ghost_face(xs[b], f).copy_(dist_halo.owned_face(xs[nb], f))

    def __call__(self, xs):
        cards, rest = self._cards(xs)
        for card in cards:
            card["copy"](self._blocks(xs, card))
        self._rest(xs, rest)
        return xs

    def collect(self, xs):
        cards, _ = self._cards(xs)
        for card in cards:
            dev = card["dev"]
            if "side" not in card:
                x0 = xs[card["idx"][0]]
                st = torch.empty(len(card["idx"]) * dist_halo.staging_size(
                    tuple(v - 2 for v in x0.shape)), dtype=x0.dtype, device=dev)
                card["side"] = torch.cuda.Stream(dev)
                card["gather"] = dist_halo.Exchange(card["table"], "gather", st)
                card["scatter"] = dist_halo.Exchange(card["table"], "scatter", st)
            side = card["side"]
            side.wait_stream(torch.cuda.current_stream(dev))
            card["gather"](self._blocks(xs, card), side.cuda_stream)

    def write(self, xs):
        cards, rest = self._cards(xs)
        for card in cards:
            torch.cuda.current_stream(card["dev"]).wait_stream(card["side"])
            card["scatter"](self._blocks(xs, card))
        self._rest(xs, rest)
        return xs
