"""Unpacked point sweeps (PyTorch/CUDA port of
``cubez_tpu/pallas_kernels/sweeps.py``, the fused sweep K4).

Layout: the (K, I, J) field itself, contiguous.  ``pad_k2`` is a
contiguous copy (the solve's state must be a tensor of its own, since the
red-black step updates in place) and ``unpad_k2`` its inverse; the TPU
kernel's K pad of 2 and (8, 128) tile padding are dropped, and the kernels
mask on the true bounds.

Two kernels (csrc/sweeps.cu), each in a constant-coefficient and a MAF
form, with a zero or a streamed right-hand side:

* ``jacobi_k4``: one Jacobi iteration, out of place: it writes a second
  field and never the one it was handed (the driver's stopping-chunk
  replay starts from its snapshot); the step owns two such fields and
  alternates between them;
* ``sor2sma_k4``: one red-black iteration in place, two colour launches.

For a CPU tensor each runs its plain twin, ``jacobi_plain`` /
``sor2sma_plain``, with the arithmetic of ``cuda_kernels/rbpack.py``'s
contracts (bitwise equal to the kernels and to the JAX package's
interpreted kernel in float32).  Colour c holds the points with
(i + j + k + offset + 1) % 2 == c (the JAX kernel's ``_iota_masks``).
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .rbpack import (_R6, _SUFFIX, _fma, check_tab, count, maf_r, maf_tables,
                     ptr, stream, table_views)

KINDS = ("jacobi", "sor2sma")


def pad_k2(a: torch.Tensor) -> torch.Tensor:
    """(K, I, J) field -> the sweeps' state: a contiguous copy.  Apply to x
    and b alike."""
    return a.clone(memory_format=torch.contiguous_format)


def unpad_k2(a: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`pad_k2` (the state is the field of ``shape``)."""
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"state shape {tuple(a.shape)} != {tuple(shape)}")
    return a


# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------


def _dp(x, b, omega, tab):
    """dp on the interior (K-2, I-2, J-2) of the field x (rbpack.py's
    contracts; ``tab`` from ``maf_tables`` selects MAF)."""
    K, I, J = x.shape
    inner = (slice(1, -1),) * 3
    cen = x[inner]
    nb = {"zm": x[:-2, 1:-1, 1:-1], "zp": x[2:, 1:-1, 1:-1],
          "xm": x[1:-1, :-2, 1:-1], "xp": x[1:-1, 2:, 1:-1],
          "ym": x[1:-1, 1:-1, :-2], "yp": x[1:-1, 1:-1, 2:]}
    b = None if b is None else b[inner]
    om = torch.tensor(omega, dtype=x.dtype, device=x.device)
    if tab is None:
        ss = (nb["zm"] + nb["zp"]) + (nb["xm"] + nb["xp"]) + (nb["ym"] + nb["yp"])
        if b is not None:
            ss = ss - b
        r6 = torch.tensor(_R6[x.dtype], dtype=x.dtype, device=x.device)
        return _fma(ss, r6, -cen) * om
    t = table_views(tab, (K, I, J))
    zi, xi, yi = (slice(1, -1), None, None), (None, slice(1, -1), None), slice(1, -1)
    w = {"wzm": t["wzm"][zi], "wzp": t["wzp"][zi], "wxp": t["wxp"][xi],
         "wxm": t["wxm"][xi], "wyp": t["wyp"][yi], "wym": t["wym"][yi]}
    r = maf_r(w, nb)
    if b is not None:
        r = r + b
    dd = 2.0 * ((t["c1"][xi] + t["c2"][yi]) + t["c3"][zi])
    return (r / dd - cen) * om


def jacobi_plain(x, b, omega: float, tab=None):
    """Plain twin of ``jacobi_k4``: (new field, float64 sum of dp^2)."""
    dp = _dp(x, b, omega, tab)
    out = x.clone()
    out[1:-1, 1:-1, 1:-1] += dp
    return out, (dp * dp).sum(dtype=torch.float64)


def _colour(shape, colour, offset, device):
    """Interior points of ``colour``: (i + j + k + offset + 1) % 2 == c."""
    K, I, J = shape
    k = torch.arange(1, K - 1, device=device)[:, None, None]
    i = torch.arange(1, I - 1, device=device)[None, :, None]
    j = torch.arange(1, J - 1, device=device)[None, None, :]
    return (k + i + j + offset + 1) % 2 == colour


def sor2sma_plain(x, b, omega: float, offset: int = 0, tab=None):
    """Plain twin of ``sor2sma_k4``: one red-black iteration in place;
    returns the float64 sum of dp^2 over both colours."""
    r2 = torch.zeros((), dtype=torch.float64, device=x.device)
    for c in (0, 1):
        dp = torch.where(_colour(x.shape, c, offset, x.device),
                         _dp(x, b, omega, tab), 0.0)
        x[1:-1, 1:-1, 1:-1] += dp
        r2 = r2 + (dp * dp).sum(dtype=torch.float64)
    return r2


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check(x, b, tab):
    if not x.is_cuda:
        raise ValueError("kernel launch needs a CUDA tensor")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"unpacked sweeps take float32 or float64, not {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"need a contiguous (K, I, J) field, got "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    if x.numel() >= 2**31:
        raise ValueError("field too large for 32-bit indexing")
    if b is not None and (
        b.shape != x.shape or b.dtype != x.dtype
        or b.device != x.device or not b.is_contiguous()
    ):
        raise ValueError("b must match x in shape, dtype, device and layout")
    check_tab(x, tab, tuple(x.shape))


def jacobi_k4(x, b, omega: float, tab=None, out=None, partials=None):
    """Launch ``jacobi_kernel``: one Jacobi iteration into ``out`` (a new
    field when None; never ``x``, which is only read); ``tab``
    (``maf_tables``) selects the MAF form; ``partials`` is a (K*I,) scratch
    of x's dtype, allocated when None.  Returns (out, float64 sum of dp^2 on
    the device).  A CPU tensor runs the plain twin."""
    if not x.is_cuda:
        return jacobi_plain(x, b, omega, tab)
    _check(x, b, tab)
    K, I, J = x.shape
    if not x.numel():
        return x.clone(), torch.zeros((), dtype=torch.float64, device=x.device)
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
          or not out.is_contiguous() or out.data_ptr() == x.data_ptr()):
        raise ValueError("out must match x in shape, dtype, device and layout, "
                         "and must not be x (the update is out of place)")
    if partials is None:
        partials = torch.empty(K * I, dtype=x.dtype, device=x.device)
    elif (partials.shape != (K * I,) or partials.dtype != x.dtype
          or partials.device != x.device):
        raise ValueError(f"partials must be a ({K * I},) {x.dtype} tensor on "
                         f"{x.device}")
    lib = _build.load()
    rc = getattr(lib, f"cz_k4_jacobi_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), ptr(b), ptr(tab), out.data_ptr(), partials.data_ptr(),
        K, I, J, omega, x.device.index, stream(x),
    )
    _build.check(rc, "jacobi_k4")
    count(jacobi_k4, tab)
    return out, partials.sum(dtype=torch.float64)


jacobi_k4.launches = jacobi_k4.maf_launches = 0


def sor2sma_k4(x, b, omega: float, offset: int = 0, tab=None):
    """Launch ``rb_color_unpacked_kernel`` twice (colour 0, then 1): one
    red-black iteration in place; ``tab`` selects the MAF form.  Returns
    the float64 sum of dp^2 over both colours (on the device).  A CPU
    tensor runs the plain twin."""
    if not x.is_cuda:
        return sor2sma_plain(x, b, omega, offset, tab)
    _check(x, b, tab)
    K, I, J = x.shape
    rows = max(K - 2, 0) * max(I - 2, 0)
    if not rows or J < 3:
        return torch.zeros((), dtype=torch.float64, device=x.device)
    lib = _build.load()
    fn = getattr(lib, f"cz_k4_rb_color_{_SUFFIX[x.dtype]}")
    partials = torch.empty(2, rows, dtype=x.dtype, device=x.device)
    for c in (0, 1):
        rc = fn(x.data_ptr(), ptr(b), ptr(tab), partials[c].data_ptr(), K, I, J,
                c, offset, omega, x.device.index, stream(x))
        _build.check(rc, "sor2sma_k4")
        count(sor2sma_k4, tab)
    return partials.sum(dtype=torch.float64)


sor2sma_k4.launches = sor2sma_k4.maf_launches = 0


# --------------------------------------------------------------------------
# builder (the JAX package's name and step contract)
# --------------------------------------------------------------------------


def make_fused_sweep(kind: str, shape, dtype=torch.float32, *, omega: float,
                     offset: int = 0, b_is_zero: bool = False, mc=None,
                     plain: bool = False):
    """``step(x, b) -> (x, r2)`` on the unpacked state (``pad_k2``), r2 a
    0-d float64 tensor.  ``kind``: 'jacobi' (x is only read; on CUDA the
    returned field is one of two buffers the step owns, the one that is not
    x, so it holds until the call after next) or 'sor2sma' (x is updated in
    place and returned).  ``mc``
    (MafCoeffs) selects the MAF update; ``b_is_zero`` ignores ``b``;
    ``plain`` runs the twin on any device."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    if dtype not in _SUFFIX:
        raise TypeError(f"unpacked sweeps take float32 or float64, not {dtype}")
    tab = maf_tables(mc, shape, dtype)
    if kind == "jacobi" and plain:
        def step(x, b):
            return jacobi_plain(x, None if b_is_zero else b, omega, tab)
    elif kind == "jacobi":
        bufs = []  # two fields and the partials, made at the first CUDA call

        def step(x, b):
            if not x.is_cuda:
                return jacobi_k4(x, None if b_is_zero else b, omega, tab)
            if not bufs:
                K, I, _ = x.shape
                bufs.extend((torch.empty_like(x), torch.empty_like(x),
                             torch.empty(K * I, dtype=x.dtype, device=x.device)))
            # ping-pong: write the buffer that is not x; a foreign x (the
            # start, or the driver's snapshot in its replay) is only read
            out = bufs[1] if x.data_ptr() == bufs[0].data_ptr() else bufs[0]
            return jacobi_k4(x, None if b_is_zero else b, omega, tab,
                             out=out, partials=bufs[2])
    else:
        sweep = sor2sma_plain if plain else sor2sma_k4

        def step(x, b):
            return x, sweep(x, None if b_is_zero else b, omega, offset, tab)

    step.iters_per_call = 1
    step.single = step
    step.pad = pad_k2
    step.unpad = functools.partial(unpad_k2, shape=tuple(shape))
    return step
