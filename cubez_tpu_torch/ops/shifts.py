"""Zero-filled shift primitives (PyTorch port of ``cubez_tpu/ops/shifts.py``).

``shift(x, axis, d)`` returns a tensor of the same shape with
``out[idx] = x[idx + d]`` along ``axis`` and zero where ``idx + d`` is out
of range.  Out-of-range reads only ever land on masked (boundary) nodes.
"""

from __future__ import annotations

import torch


def shift(x: torch.Tensor, axis: int, d: int) -> torch.Tensor:
    """out[i] = x[i + d] along ``axis``, zero-filled at the edges."""
    if d == 0:
        return x
    n = x.shape[axis]
    out = torch.zeros_like(x)
    if d > 0:
        out.narrow(axis, 0, n - d).copy_(x.narrow(axis, d, n - d))
    else:
        out.narrow(axis, -d, n + d).copy_(x.narrow(axis, 0, n + d))
    return out


def nbr6(x: torch.Tensor):
    """The six face neighbours of every node, zero beyond the array edge:
    (xm, xp, ym, yp, zm, zp) for layout (K, I, J), x = I (axis 1),
    y = J (axis 2), z = K (axis 0)."""
    xp = shift(x, 1, +1)
    xm = shift(x, 1, -1)
    yp = shift(x, 2, +1)
    ym = shift(x, 2, -1)
    zp = shift(x, 0, +1)
    zm = shift(x, 0, -1)
    return xm, xp, ym, yp, zm, zp
