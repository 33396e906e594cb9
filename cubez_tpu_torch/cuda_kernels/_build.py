"""Build and load the port's CUDA kernels.

``csrc/rbpack.cu`` has a plain C interface.  It is compiled with ``nvcc``
for sm_90a into a shared library at first use and loaded with ctypes; the
library lands in ``cubez_tpu_torch/_build/`` under a name keyed by the hash
of the source and the flags, so an edit rebuilds and an unchanged source is
reused.  A missing ``nvcc`` or a failed build raises: there is no other way
to run a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "rbpack.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no contraction beyond the source's explicit fma: the fields must be
    # bitwise equal to the plain twin
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built"
    )


def _declare(lib):
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    u32 = ctypes.c_uint
    lib.cz_threads_per_block.argtypes = []
    lib.cz_threads_per_block.restype = i32
    lib.cz_error_string.argtypes = [i32]
    lib.cz_error_string.restype = ctypes.c_char_p
    for t in ("f32", "f64"):
        fn = getattr(lib, f"cz_rb_color_{t}")
        fn.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, f64, u32, i32, vp]
        fn.restype = i32
        fn = getattr(lib, f"cz_rb_sweeps_max_blocks_{t}")
        fn.argtypes = [i32, ctypes.POINTER(i32)]
        fn.restype = i32
        fn = getattr(lib, f"cz_rb_sweeps_n_{t}")
        fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, f64, u32, i32,
                       i32, vp]
        fn.restype = i32


def load(rebuild: bool = False):
    """The loaded kernel library, built first if needed (always, with
    ``rebuild``, unless this process has loaded it already)."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"librbpack_{tag[:16]}.so"
        log = so.with_suffix(".log")
        if rebuild or not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                    f"{r.stdout}{r.stderr}"
                )
            log.write_text(r.stdout + r.stderr)
            os.replace(tmp, so)  # atomic: concurrent builds race safely
        build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return lib


def check(rc: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = _lib.cz_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
