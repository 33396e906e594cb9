"""The Krylov loop's operator as one pass (csrc/blas.cu): the constant-
coefficient 7-point ``calc_ax(p, msk)`` and ``calc_rk(p, b, msk)`` of
ops/blas.py.

For a CPU tensor, or under ``impl`` 'plain' (solvers/api.py: the plain
twins on any device), they call ops/blas.py's functions, their plain
twins; this module alone decides which of the two computes the operator.
For a CUDA tensor under 'auto' they launch the kernel on the current
stream into a new field (``torch.empty_like``: BiCGSTAB reads the last
iteration's A x after this one's, so the output is never a reused
buffer), or raise on what it cannot take: another dtype than
float32/float64, a non-contiguous field, or fields of other shapes,
dtypes or devices than p's.  The kernel is bitwise its twin (csrc/blas.cu
states the arithmetic).  ``operator_pass`` counts the launches of both in
``operator_pass.launches``.
"""

from __future__ import annotations

import torch

from ..ops import blas as plain
from . import _build
from .dist_halo import current_stream
from .rbpack import _SUFFIX


def operator_pass(p, msk, b=None):
    """Launch the pass on CUDA fields: ``(b - A p) * msk`` with b, else
    ``A p * msk`` (the twins' ``(nbr_sum(p) - 6 p) * msk``)."""
    if p.dtype not in _SUFFIX:
        raise TypeError(f"the operator pass takes float32 or float64, not {p.dtype}")
    if p.dim() != 3:
        raise ValueError(f"the operator pass takes (K, I, J) fields, not {tuple(p.shape)}")
    for t in (p, msk) if b is None else (p, msk, b):
        if t.shape != p.shape or t.dtype != p.dtype or t.device != p.device:
            raise ValueError("the operator pass: msk and b must match p's "
                             "shape, dtype and device")
        if not t.is_contiguous():
            raise ValueError("the operator pass takes contiguous fields")
    out = torch.empty_like(p)
    dev = p.get_device()
    K, I, J = p.shape
    rc = getattr(_build.load(), f"cz_calc_ax_{_SUFFIX[p.dtype]}")(
        p.data_ptr(), None if b is None else b.data_ptr(), msk.data_ptr(),
        out.data_ptr(), K, I, J, dev, current_stream(dev))
    _build.check(rc, "calc_ax")
    operator_pass.launches += 1
    return out


operator_pass.launches = 0


def calc_ax(p, msk, impl: str = "auto"):
    """A p for the constant-coefficient 7-point operator, masked (ops/blas.py
    ``calc_ax``): the kernel for a CUDA p under 'auto', else the twin."""
    if impl == "plain" or not p.is_cuda:
        return plain.calc_ax(p, msk)
    return operator_pass(p, msk)


def calc_rk(p, b, msk, impl: str = "auto"):
    """r = b - A p, masked (ops/blas.py ``calc_rk``): the kernel for a CUDA
    p under 'auto', else the twin."""
    if impl == "plain" or not p.is_cuda:
        return plain.calc_rk(p, b, msk)
    return operator_pass(p, msk, b)
