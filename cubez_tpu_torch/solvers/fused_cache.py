"""Dispatch to the packed red-black steps (PyTorch port of the sor2sma part
of ``cubez_tpu/solvers/fused_cache.py``).

The JAX package caches built steps because a rebuilt closure forces a jit
re-trace; PyTorch runs eagerly and the kernel library is loaded once, so
building a step is cheap and nothing is cached here.
"""

from __future__ import annotations

from ..cuda_kernels import rbpack


def get_fused_step(kind: str, grid, omega: float, mc=None,
                   plain: bool = False, b_is_zero: bool = False):
    """The packed step for ``kind`` in the JAX package's order: the n-window
    chain (n = 6, 4, 3) when the RHS is zero, else the pair (which streams
    b), else the single sweep.  None when the packed layout does not apply
    (odd I, MAF coefficients).  ``plain`` makes the step run the plain twins
    on any device; otherwise the kernels run for CUDA tensors."""
    if kind != "sor2sma":
        raise NotImplementedError(f"no packed step for '{kind}'")
    shape, dtype = grid.shape_kij, grid.dtype
    kw = dict(omega=omega, mc=mc, plain=plain)
    step = None
    if b_is_zero and mc is None:
        for n in (6, 4, 3):
            step = rbpack.make_packed_sweepnx(shape, dtype, n=n, **kw)
            if step is not None:
                break
    if step is None:
        step = rbpack.make_packed_sweep2x(shape, dtype, b_is_zero=b_is_zero,
                                          **kw)
    if step is None:
        step = rbpack.make_packed_sweep(shape, dtype, b_is_zero=b_is_zero,
                                        **kw)
    return step


def pad_unpad(kind: str, grid, step):
    """(pad, unpad) converters for the step's state layout."""
    if hasattr(step, "pad"):
        return step.pad, step.unpad
    raise NotImplementedError(
        f"'{kind}' has no ported state layout (the unpacked fused sweep, "
        "K4 in ROADMAP.md, is not ported)"
    )
