"""Block mesh for the 3D decomposition (PyTorch port of
``cubez_tpu/parallel/mesh.py``; the CBrick SubDomain layer,
cz_Evaluate.cpp:103-159).

The JAX package drives a ``jax.sharding.Mesh`` of devices from one
process through ``shard_map``.  The port keeps that single-controller
design without a collective library: a :class:`CubeMesh` holds the
division (dz, dx, dy) over the (K, I, J) axes and one torch device per
block, and a distributed field is a list of block tensors, blocks in
(z, x, y) row-major order.  ``ppermute`` becomes slice copies between
block tensors (halo.py, dist_pack.py, dist_fused.py) and ``psum`` a sum of
per-block partials in a fixed block order (``halo.psum_all``).

Several blocks may share a device (``["cuda:0"] * 8`` runs eight blocks
on one card, ``["cpu"] * 8`` on the host, the counterpart of the JAX
tests' eight virtual CPU devices).  With every block on one device all
launches and copies go to that device's current stream in program order.
Blocks on several GPUs take peer copies, which PyTorch orders on the
current streams of both devices.
"""

from __future__ import annotations

import dataclasses

import torch

from .decomp import auto_division

AXES = ("z", "x", "y")


@dataclasses.dataclass(frozen=True)
class CubeMesh:
    """``div`` = (dz, dx, dy); ``devices[b]`` holds block ``b`` =
    (iz * dx + ix) * dy + iy."""

    div: tuple[int, int, int]
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, b: int) -> tuple[int, int, int]:
        """(iz, ix, iy) of block ``b``."""
        _, dx, dy = self.div
        return b // (dx * dy), (b // dy) % dx, b % dy

    def neighbor(self, b: int, axis: int, step: int):
        """The block one step along mesh ``axis`` (0 z, 1 x, 2 y) from
        ``b``, or None past the mesh edge."""
        c = list(self.coords(b))
        c[axis] += step
        if not 0 <= c[axis] < self.div[axis]:
            return None
        _, dx, dy = self.div
        return (c[0] * dx + c[1]) * dy + c[2]

    def block_shape(self, gshape) -> tuple[int, int, int]:
        """(lk, li, lj) of every block; ValueError unless each axis of the
        (K, I, J) ``gshape`` divides evenly."""
        if any(g % d for g, d in zip(gshape, self.div)):
            raise ValueError(f"grid {tuple(gshape)} not divisible by mesh "
                             f"{self.div}")
        return tuple(g // d for g, d in zip(gshape, self.div))

    def offsets(self, gshape) -> list[tuple[int, int, int]]:
        """Global (k0, i0, j0) origin of each block's owned cells."""
        bs = self.block_shape(gshape)
        return [tuple(c * n for c, n in zip(self.coords(b), bs))
                for b in range(self.size)]

    def shard(self, arr: torch.Tensor) -> list[torch.Tensor]:
        """Global (K, I, J) field -> its blocks, each a contiguous tensor
        of its own on its device."""
        lk, li, lj = self.block_shape(arr.shape)
        return [
            arr[k0:k0 + lk, i0:i0 + li, j0:j0 + lj].to(
                self.devices[b], copy=True, memory_format=torch.contiguous_format)
            for b, (k0, i0, j0) in enumerate(self.offsets(arr.shape))
        ]

    def gather(self, blocks, device=None) -> torch.Tensor:
        """Blocks (owned cells only) -> the global field, on ``device``
        (default: block 0's)."""
        device = blocks[0].device if device is None else torch.device(device)
        lk, li, lj = blocks[0].shape
        dz, dx, dy = self.div
        out = torch.empty((dz * lk, dx * li, dy * lj), dtype=blocks[0].dtype,
                          device=device)
        for b, blk in enumerate(blocks):
            iz, ix, iy = self.coords(b)
            out[iz * lk:(iz + 1) * lk, ix * li:(ix + 1) * li,
                iy * lj:(iy + 1) * lj] = blk
        return out


def make_mesh(gsize, devices=None, div=None) -> CubeMesh:
    """Build a (z, x, y) block mesh for a (nk, ni, nj) grid.

    ``devices``: one torch device (or name) per block, blocks in (z, x, y)
    row-major order, repeats allowed; default one block per visible CUDA
    device (never the CPU unless the caller passes CPU devices).  ``div``
    pins the division like the reference's gdv_x/y/z args (main.cpp:19-30);
    otherwise the auto-search (findOptimalDivision).  Every axis of the
    grid must divide evenly."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices "
                               "(e.g. ['cpu'] * 8) to run blocks elsewhere")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if div is None:
        div = auto_division(n, gsize)
    div = tuple(int(d) for d in div)
    dz, dx, dy = div
    if dz * dx * dy != n:
        raise ValueError(f"division {div} does not match {n} devices")
    for g, d, name in zip(gsize, div, AXES):
        if g % d:
            raise ValueError(f"grid axis {name}={g} not divisible by {d}")
    return CubeMesh(div=div, devices=devices)
