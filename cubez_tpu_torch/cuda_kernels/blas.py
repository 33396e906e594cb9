"""The Krylov loop's passes (csrc/blas.cu): the constant-coefficient
7-point ``calc_ax(p, msk)`` and ``calc_rk(p, b, msk)`` of ops/blas.py, and
its vector work, the maps ``bicg_1``, ``triad`` and ``axpy``, the dots
``dot1`` and ``dot2``, and the fused ``dots_t`` and ``update_xr``.

For a CPU tensor, or under ``impl`` 'plain' (solvers/api.py: the plain
twins on any device), each function calls ops/blas.py's function of the
same name, its plain twin; this module alone decides which of the two
computes it.  For a CUDA tensor under 'auto' it launches the pass on the
current stream into new fields (``torch.empty_like``: BiCGSTAB reads the
last iteration's A x after this one's, and the old p, s and r after the
new ones, so no output is a reused buffer), or raises on what the pass
cannot take: another dtype than float32/float64, a non-contiguous field,
fields of other shapes, dtypes or devices than the first, or a scalar
that is not 0-d.  The operator pass and the maps are bitwise their twins;
a dot differs from its twin by its summation order alone, which is fixed,
so it is the same bits in every run (csrc/blas.cu states the
arithmetic).  The scalars stay on the card: a 0-d tensor of the fields'
dtype and device is read by the pass through its pointer.
``operator_pass.launches`` counts the operator's launches,
``vector_pass.launches`` the vector passes' (a pass with dots is two
kernels, the pass and the fold of its partials, counted once) and
``vector_pass.op_launches`` each pass's.  Inside ``vector_impl(impl)`` the
vector ops take that ``impl`` whatever their callers pass.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..ops import blas as plain
from . import _build
from .dist_halo import current_stream
from .rbpack import _SUFFIX


def _check_fields(what: str, p, fields):
    """Raise unless ``p`` and ``fields`` are contiguous (K, I, J) float32 or
    float64 fields of p's shape, dtype and device."""
    if p.dtype not in _SUFFIX:
        raise TypeError(f"the {what} takes float32 or float64, not {p.dtype}")
    if p.dim() != 3:
        raise ValueError(f"the {what} takes (K, I, J) fields, not {tuple(p.shape)}")
    for t in fields:
        if t.shape != p.shape or t.dtype != p.dtype or t.device != p.device:
            raise ValueError(f"the {what}: every field must match the first's "
                             "shape, dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"the {what} takes contiguous fields")


def _passes(v, impl: str) -> bool:
    """Whether a field ``v`` takes a pass under ``impl``, or the twin."""
    return impl != "plain" and v.is_cuda


_vector_impl = None  # vector_impl's impl while it is entered


@contextlib.contextmanager
def vector_impl(impl: str):
    """Run the vector maps and dots under ``impl`` within the block,
    whatever impl their callers pass; the operator keeps its caller's.  A
    solve under 'plain' inside ``vector_impl('auto')`` runs its
    preconditioner and operator on their twins and its vector work on the
    passes, as 'auto' does, so its dots sum in the passes' order and the
    two solves differ by the preconditioner and operator alone."""
    global _vector_impl
    saved, _vector_impl = _vector_impl, impl
    try:
        yield
    finally:
        _vector_impl = saved


def _vector_passes(v, impl: str) -> bool:
    """Whether a field ``v`` takes a vector pass under ``impl``, or the
    twin."""
    return _passes(v, _vector_impl or impl)


def operator_pass(p, msk, b=None):
    """Launch the pass on CUDA fields: ``(b - A p) * msk`` with b, else
    ``A p * msk`` (the twins' ``(nbr_sum(p) - 6 p) * msk``)."""
    _check_fields("operator pass", p, (p, msk) if b is None else (p, msk, b))
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
    if not _passes(p, impl):
        return plain.calc_ax(p, msk)
    return operator_pass(p, msk)


def calc_rk(p, b, msk, impl: str = "auto"):
    """r = b - A p, masked (ops/blas.py ``calc_rk``): the kernel for a CUDA
    p under 'auto', else the twin."""
    if not _passes(p, impl):
        return plain.calc_rk(p, b, msk)
    return operator_pass(p, msk, b)


# pass: (its number in csrc/blas.cu, fields read besides msk, scalars,
# fields written, dots)
_PASSES = {
    "bicg_1": (0, 3, 2, 1, 0),
    "triad": (1, 2, 1, 1, 0),
    "axpy": (2, 2, 1, 1, 0),
    "dot1": (3, 1, 0, 0, 1),
    "dot2": (4, 2, 0, 0, 1),
    "dots_t": (5, 2, 0, 0, 2),
    "update_xr": (6, 6, 2, 2, 2),
}
_grids: dict = {}  # (pass, dtype, device, points): the pass's CTAs


def _grid(lib, op: str, p) -> int:
    key = (op, p.dtype, p.device, p.numel())
    grid = _grids.get(key)
    if grid is None:
        out = ctypes.c_int(0)
        _build.check(getattr(lib, f"cz_vec_grid_{_SUFFIX[p.dtype]}")(
            _PASSES[op][0], p.numel(), p.get_device(), ctypes.byref(out)),
            f"{op} grid")
        grid = _grids[key] = out.value
    return grid


def vector_pass(op: str, fields, scalars, msk):
    """Launch pass ``op`` of csrc/blas.cu on CUDA ``fields`` (in the order
    of its twin's arguments) with its 0-d ``scalars`` and the mask: the
    tuple of the fields it writes, then of its 0-d dots."""
    code, n_in, n_s, n_out, n_dot = _PASSES[op]
    if len(fields) != n_in or len(scalars) != n_s:
        raise TypeError(f"the {op} pass takes {n_in} fields and {n_s} scalars")
    p = fields[0]
    _check_fields(f"{op} pass", p, (*fields, msk))
    scalars = [plain.scalar(a, p) for a in scalars]
    if any(a.dim() != 0 for a in scalars):
        raise ValueError(f"the {op} pass takes 0-d scalars")
    lib = _build.load()
    grid = _grid(lib, op, p)
    outs = [torch.empty_like(p) for _ in range(n_out)]
    dots = part = None
    if n_dot:
        dots = torch.empty(n_dot, dtype=p.dtype, device=p.device)
        part = torch.empty(grid * n_dot, dtype=p.dtype, device=p.device)
    ptrs = [t.data_ptr() for t in fields] + [None] * (6 - n_in)
    ptrs.append(msk.data_ptr())
    ptrs += [a.data_ptr() for a in scalars] + [None] * (2 - n_s)
    ptrs += [t.data_ptr() for t in outs] + [None] * (2 - n_out)
    ptrs += [None, None] if dots is None else [part.data_ptr(), dots.data_ptr()]
    dev = p.get_device()
    rc = getattr(lib, f"cz_vec_pass_{_SUFFIX[p.dtype]}")(
        code, (ctypes.c_void_p * 13)(*ptrs), p.numel(), grid, dev,
        current_stream(dev))
    _build.check(rc, op)
    vector_pass.launches += 1
    vector_pass.op_launches[op] += 1
    return (*outs, *(() if dots is None else dots.unbind()))


vector_pass.launches = 0
vector_pass.op_launches = dict.fromkeys(_PASSES, 0)


def bicg_1(p, r, q, beta, omega, msk, impl: str = "auto"):
    """p = r + beta (p - omega q) on inner nodes (ops/blas.py ``bicg_1``)."""
    if not _vector_passes(p, impl):
        return plain.bicg_1(p, r, q, beta, omega, msk)
    return vector_pass("bicg_1", (p, r, q), (beta, omega), msk)[0]


def triad(x, y, a, msk, impl: str = "auto"):
    """a x + y on inner nodes (ops/blas.py ``triad``)."""
    if not _vector_passes(x, impl):
        return plain.triad(x, y, a, msk)
    return vector_pass("triad", (x, y), (a,), msk)[0]


def axpy(x, a, p, msk, impl: str = "auto"):
    """x + a p on inner nodes (ops/blas.py ``axpy``)."""
    if not _vector_passes(x, impl):
        return plain.axpy(x, a, p, msk)
    return vector_pass("axpy", (x, p), (a,), msk)[0]


def dot1(p, msk, impl: str = "auto"):
    """sum p^2 over inner nodes (ops/blas.py ``dot1``)."""
    if not _vector_passes(p, impl):
        return plain.dot1(p, msk)
    return vector_pass("dot1", (p,), (), msk)[0]


def dot2(p, q, msk, impl: str = "auto"):
    """sum p q over inner nodes (ops/blas.py ``dot2``)."""
    if not _vector_passes(p, impl):
        return plain.dot2(p, q, msk)
    return vector_pass("dot2", (p, q), (), msk)[0]


def dots_t(t, s, msk, impl: str = "auto"):
    """(dot2(t, s), dot1(t)) in one read (ops/blas.py ``dots_t``)."""
    if not _vector_passes(t, impl):
        return plain.dots_t(t, s, msk)
    return vector_pass("dots_t", (t, s), (), msk)


def update_xr(x, p_, s_, t_, s, r0, alpha, omega, msk, impl: str = "auto"):
    """(x, r, dot1(r), dot2(r, r0)) of BiCGSTAB's iteration end in one pass
    (ops/blas.py ``update_xr``)."""
    if not _vector_passes(x, impl):
        return plain.update_xr(x, p_, s_, t_, s, r0, alpha, omega, msk)
    return vector_pass("update_xr", (x, p_, s_, t_, s, r0), (alpha, omega), msk)
