"""SPH scalar files, the reference's solution dump (fileout_t,
cz_utility.f90:17-47): a copy of the pure-Python ``write_sph`` writer and
of ``read_sph`` in ``cubez_tpu/utils/native.py``, on tensors.  The bytes
equal the JAX package's for the same field.

The file is six Fortran unformatted records (a little-endian int32 length
before and after each payload): (sv_type, d_type) = (1, 1), the sizes
(imax, jmax, kmax), the origin and the pitch (3 float32 each), (step,
time) (int32, float32), and the float32 data with i fastest, then j, then
k.
"""

from __future__ import annotations

import struct

import numpy as np
import torch


def _rec(f, payload: bytes):
    f.write(struct.pack("<i", len(payload)))
    f.write(payload)
    f.write(struct.pack("<i", len(payload)))


def write_sph(path, field_kij, org=(0.0, 0.0, 0.0), pitch=(1.0, 1.0, 1.0),
              step=0, time=0.0) -> None:
    """Write the (K, I, J) field (a tensor on any device, or an array) as
    float32 in SPH order: the (K, J, I) transpose, i fastest."""
    if isinstance(field_kij, torch.Tensor):
        field_kij = field_kij.detach().cpu().numpy()
    f = np.asarray(field_kij, dtype=np.float32)
    nk, ni, nj = f.shape
    data = np.ascontiguousarray(f.transpose(0, 2, 1).reshape(-1))
    with open(str(path), "wb") as out:
        _rec(out, struct.pack("<ii", 1, 1))
        _rec(out, struct.pack("<iii", ni, nj, nk))
        _rec(out, struct.pack("<fff", *[float(v) for v in org]))
        _rec(out, struct.pack("<fff", *[float(v) for v in pitch]))
        _rec(out, struct.pack("<if", int(step), float(time)))
        _rec(out, data.astype("<f4").tobytes())


def read_sph(path):
    """Read a scalar SPH file: (field (K, I, J) float32 numpy, org, pitch,
    step, time)."""
    with open(str(path), "rb") as f:
        def rec():
            (n,) = struct.unpack("<i", f.read(4))
            payload = f.read(n)
            f.read(4)
            return payload

        struct.unpack("<ii", rec())  # (sv_type, d_type)
        ni, nj, nk = struct.unpack("<iii", rec())
        org = struct.unpack("<fff", rec())
        pitch = struct.unpack("<fff", rec())
        step, time = struct.unpack("<if", rec())
        data = np.frombuffer(rec(), dtype="<f4").reshape(nk, nj, ni)
    return data.transpose(0, 2, 1), org, pitch, step, time
