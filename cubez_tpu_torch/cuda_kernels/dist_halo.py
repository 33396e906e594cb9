"""The ghost exchange and the residual fold of the distributed block steps,
one launch each for all the blocks of a card (csrc/dist_halo.cu), and the
launch-argument cache that K8's and K9's wrappers share.

``Exchange`` copies every face ghost cell of every block from the
neighbour's owned face across it (parallel/halo.py::refresh_ghosts copies
whole planes, axis by axis, one ``copy_`` a plane).  Edge and corner ghosts
are left as they are: no kernel of the port reads them.  Its twin is
``halo_exchange_plain``.  Mode 'gather' and 'scatter' split the copy in two
through a staging buffer, for the overlap step.

``Residual`` holds one step's sums of dp^2: the kernels write one partial a
CTA into its buffer (one per device, allocated at the step's first call and
reused), and ``total`` folds each device's buffer in float64 in one launch
(``fold_partials``, a fixed order, no atomics), then sums the devices and
the twins' per-block sums with ``psum_all`` (which parallel/halo.py
exports).  Its twin is ``fold_partials_plain``.

The wrappers are thin: a launcher object (``Exchange`` here,
dist_sweeps.BlockSweeps, dist_pcr.BlockPcr) checks a set of blocks fully
the first time it sees their pointers and builds its ctypes argument
arrays then (``Launches``); a later call with the same pointers checks the
first block's dtype, shape and layout and launches with the arrays it
built.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .rbpack import _SUFFIX

MAX_BLOCKS = 32  # blocks in one launch (csrc/dist_halo.cu kMaxBlocks)
MODES = ("copy", "gather", "scatter")
_THREADS = 256

# the handle of a device's current stream; the public API builds a Stream
# object on every call, a few microseconds on these launches' host path
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(index: int) -> int:
    """The raw handle of device ``index``'s current CUDA stream."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def face_size(block_shape, f: int) -> int:
    """Cells of face ``f`` (2 axis + side) of a block with owned shape
    ``block_shape``: the product of the two other axes."""
    lk, li, lj = block_shape
    return (li * lj, lk * lj, lk * li)[f // 2]


def staging_size(block_shape) -> int:
    """Staging cells a block takes: its six faces."""
    return sum(face_size(block_shape, f) for f in range(6))


def ghost_face(x, f: int):
    """The face cells of ghost plane ``f`` (2 axis + side) of ``x``."""
    axis, side = divmod(f, 2)
    return x.select(axis, x.shape[axis] - 1 if side else 0)[1:-1, 1:-1]


def owned_face(src, f: int):
    """The owned face of ``src`` that fills face ``f`` of its neighbour
    above (side 0: src's last owned plane) or below (side 1: its first)."""
    axis, side = divmod(f, 2)
    return src.select(axis, 1 if side else src.shape[axis] - 2)[1:-1, 1:-1]


def halo_exchange_plain(xs, table):
    """Twin of ``halo_exchange`` (mode 'copy'): ``table[b][f]`` the index in
    ``xs`` of the block across face f of block b (-1 past the mesh edge);
    every face ghost cell of every block copied from it, edges and corners
    untouched."""
    for x, row in zip(xs, table):
        for f, nb in enumerate(row):
            if nb >= 0:
                ghost_face(x, f).copy_(owned_face(xs[nb], f))
    return xs


def check_blocks(what, *groups):
    """Raise unless every tensor of the groups (lists, None entries
    allowed) is a contiguous float32/float64 CUDA tensor of the first
    one's shape, dtype and device."""
    x0 = groups[0][0]
    if not x0.is_cuda or x0.dtype not in _SUFFIX:
        raise ValueError(f"{what} takes float32 or float64 CUDA blocks")
    for group in groups:
        for t in group or ():
            if t is not None and (t.shape != x0.shape or t.dtype != x0.dtype
                                  or t.device != x0.device
                                  or not t.is_contiguous()):
                raise ValueError(f"{what}: blocks must share shape, dtype and "
                                 "device and be contiguous")


def _ptrs(group):
    return () if group is None else tuple(
        None if t is None else t.data_ptr() for t in group)


class Launches:
    """The launches of one launcher for a set of blocks: built once by
    ``build(xs, *groups)`` (which checks the blocks fully) and kept for the
    pointers they were built from."""

    def __init__(self, build):
        self._build = build
        self._cache = {}

    def get(self, xs, *groups):
        key = (_ptrs(xs), *map(_ptrs, groups))
        prep = self._cache.get(key)
        if prep is None:
            if len(self._cache) >= 8:
                self._cache.clear()
            prep = self._cache[key] = self._build(xs, *groups)
        else:
            x0 = xs[0]
            if (x0.shape != prep.shape or x0.dtype != prep.dtype
                    or not x0.is_contiguous()):
                raise ValueError("the blocks changed shape, dtype or layout "
                                 "at the same addresses")
        return prep


class Prepared:
    """Built launch arguments: ``calls`` a list of (ctypes pointer array,
    ctypes int array, partial slots) of the launches; ``fn`` the C entry
    point; ``device`` its index; the first block's ``shape`` and
    ``dtype``."""

    def __init__(self, x0, fn, calls):
        self.shape, self.dtype = x0.shape, x0.dtype
        self.device = x0.get_device()
        self.fn = fn
        self.calls = calls


def chunks(n: int):
    """(lo, hi) of the launches over n blocks, MAX_BLOCKS at most each."""
    return [(lo, min(lo + MAX_BLOCKS, n)) for lo in range(0, n, MAX_BLOCKS)]


def pointer_array(vals):
    return (ctypes.c_void_p * len(vals))(*vals)


def int_array(vals):
    return (ctypes.c_int * len(vals))(*vals)


class Exchange:
    """The exchange over the ghosted blocks of one card (one shape) in
    ``mode`` 'copy', 'gather' or 'scatter', ``table`` as in
    ``halo_exchange_plain`` and ``staging`` the buffer of the split modes
    (block b's six faces at b * staging_size).  ``__call__(xs, stream)``
    launches on ``stream`` (a raw handle; default the current one); splits
    above MAX_BLOCKS."""

    def __init__(self, table, mode: str = "copy", staging=None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
        self.table, self.mode, self.staging = table, mode, staging
        self._launches = Launches(self._prepare)

    def _prepare(self, xs):
        check_blocks("halo_exchange", xs)
        x0 = xs[0]
        bshape = tuple(v - 2 for v in x0.shape)
        st = self.staging
        if self.mode != "copy" and (
                st is None or st.dtype != x0.dtype or st.device != x0.device
                or st.numel() < len(xs) * staging_size(bshape)):
            raise ValueError("staging must hold every block's faces")
        lk, li, lj = bshape
        grid_x = -(-max(li * lj, lk * lj, lk * li) // _THREADS)
        ptrs = [x.data_ptr() for x in xs]
        calls = []
        for lo, hi in chunks(len(xs)):
            vals = []
            for b in range(lo, hi):
                vals.append(ptrs[b])
                vals.extend(ptrs[n] if n >= 0 else None for n in self.table[b])
            vals.append(None if st is None else st.data_ptr())
            calls.append((pointer_array(vals), int_array(
                (hi - lo, lo, lk, li, lj, MODES.index(self.mode), grid_x,
                 x0.get_device())), 0))
        fn = getattr(_build.load(), f"cz_halo_exchange_{_SUFFIX[x0.dtype]}")
        return Prepared(x0, fn, calls)

    def __call__(self, xs, stream=None):
        prep = self._launches.get(xs)
        s = current_stream(prep.device) if stream is None else stream
        for parr, iarr, _ in prep.calls:
            _build.check(prep.fn(parr, iarr, s), "halo_exchange")
            halo_exchange.launches += 1
        return xs


def halo_exchange(xs, table, mode: str = "copy", staging=None, stream=None):
    """Launch the exchange over the ghosted blocks ``xs`` once (an
    ``Exchange`` built for this call)."""
    return Exchange(table, mode, staging)(xs, stream)


halo_exchange.launches = 0  # the exchange's launches, by every launcher


def fold_partials_plain(partials) -> torch.Tensor:
    """Twin of ``fold_partials``: the float64 sum of ``partials``."""
    return partials.to(torch.float64).sum()


def fold_partials(partials, n: int, out=None) -> torch.Tensor:
    """Launch the fold: the float64 sum of ``partials[:n]`` (float32 or
    float64, on the card) into the 0-d float64 ``out`` (new when None).
    A CPU tensor runs the twin."""
    if not partials.is_cuda:
        return fold_partials_plain(partials[:n])
    if partials.dtype not in _SUFFIX or not partials.is_contiguous() \
            or n > partials.numel():
        raise ValueError("partials must be a contiguous float32/float64 "
                         "vector of at least n values")
    if out is None:
        out = torch.empty((), dtype=torch.float64, device=partials.device)
    dev = partials.get_device()
    rc = getattr(_build.load(), f"cz_fold_partials_{_SUFFIX[partials.dtype]}")(
        partials.data_ptr(), n, out.data_ptr(), dev, current_stream(dev))
    _build.check(rc, "fold_partials")
    fold_partials.launches += 1
    return out


fold_partials.launches = 0


def psum_all(partials) -> torch.Tensor:
    """Sum of per-block partials in float64, folded in block order on block
    0's device, so the result does not depend on the run."""
    dev = partials[0].device
    acc = partials[0].to(dev, torch.float64)
    for p in partials[1:]:
        acc = acc + p.to(dev, torch.float64)
    return acc


class Residual:
    """One step's sum of dp^2.  ``start()`` before the step's first pass;
    a kernel launch takes ``slots(x, n)`` (the address of n partials in the
    buffer of x's device, grown at the first calls and reused after); a
    twin hands its per-block sums to ``add``; ``total()`` folds them into a
    0-d float64 on ``device`` (block 0's)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._buf = {}  # device index -> partials buffer
        self._used = {}
        self._plain = []

    def start(self):
        self._used.clear()
        self._plain = []

    def slots(self, x, n: int) -> int:
        dev = x.get_device()
        off = self._used.get(dev, 0)
        buf = self._buf.get(dev)
        if buf is None or buf.dtype != x.dtype or buf.numel() < off + n:
            new = torch.empty(max(off + n, 2 * (0 if buf is None else buf.numel())),
                              dtype=x.dtype, device=x.device)
            if off:
                new[:off].copy_(buf[:off])
            buf = self._buf[dev] = new
        self._used[dev] = off + n
        return buf.data_ptr() + off * buf.element_size()

    def add(self, r2s):
        self._plain.extend(r2s)

    def total(self) -> torch.Tensor:
        parts = [fold_partials(self._buf[d], n) for d, n in self._used.items()]
        parts += self._plain
        if len(parts) == 1 and parts[0].device == self.device:
            return parts[0]
        parts.sort(key=lambda t: t.device != self.device)  # stable: ours first
        return psum_all(parts)
