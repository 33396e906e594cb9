"""Distributed layer: the block mesh, halo exchange and the distributed
steps (PyTorch port of ``cubez_tpu/parallel``)."""

from .api import solve_dist
from .mesh import CubeMesh, make_mesh

__all__ = ["CubeMesh", "make_mesh", "solve_dist"]
