"""Width-1 halo exchange on a block list (PyTorch port of
``cubez_tpu/parallel/halo.py``; CBrick's 6-face Isend/Irecv halo sync,
BrickComm::Comm_S_node wrapped by CZ::Comm_S, cz_comm.cpp:23-38).

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


def psum_all(partials) -> torch.Tensor:
    """Sum of per-block partials in float64, folded in block order on block
    0's device, so the result does not depend on the run."""
    dev = partials[0].device
    acc = partials[0].to(dev, torch.float64)
    for p in partials[1:]:
        acc = acc + p.to(dev, torch.float64)
    return acc


def global_offsets(cmesh: CubeMesh, gshape):
    """(k0, i0, j0) global start of each block's owned cells."""
    return cmesh.offsets(gshape)
