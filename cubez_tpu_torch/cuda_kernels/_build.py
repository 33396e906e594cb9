"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` has a plain C interface.  At first use each is compiled
with ``nvcc`` for sm_90a, all at once in parallel processes, and the
objects are linked into one shared library, loaded with ctypes.  The
library lands in ``cubez_tpu_torch/_build/`` under a name keyed by the hash
of every source and header and the flags, so an edit rebuilds and an
unchanged tree is reused.  A missing ``nvcc`` or a failed build raises:
there is no other way to run a kernel.
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
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3",
    # no contraction beyond the source's explicit fma: the fields must be
    # bitwise equal to the plain twin
    "--fmad=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)


def sources() -> list[Path]:
    """The kernel sources, one object each."""
    return sorted(CSRC.glob("*.cu"))


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
    vp, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
    pvp, pi32 = ctypes.POINTER(vp), ctypes.POINTER(i32)
    lib.cz_threads_per_block.argtypes = []
    lib.cz_threads_per_block.restype = i32
    lib.cz_error_string.argtypes = [i32]
    lib.cz_error_string.restype = ctypes.c_char_p
    lib.cz_pcr_threads_per_block.argtypes = []
    lib.cz_pcr_threads_per_block.restype = i32
    lib.cz_dist_max_blocks.argtypes = []
    lib.cz_dist_max_blocks.restype = i32
    lib.cz_psor_threads_per_block.argtypes = []
    lib.cz_psor_threads_per_block.restype = i32
    for t in ("f32", "f64"):
        for name, args in (
            # rbpack.cu: (form, n, maf, has_b, smem, device, out); (ptrs,
            # iargs, omega, stream)
            ("rbn_max_blocks", [i32, i32, i32, i32, i32, i32,
                                ctypes.POINTER(i32)]),
            ("rbn_sweeps", [pvp, pi32, f64, vp]),
            # sweeps.cu (K4: kind, n, maf, aligned, smem, device, out)
            ("k4_max_blocks", [i32, i32, i32, i32, i32, i32, ctypes.POINTER(i32)]),
            ("k4_sweep", [pvp, pi32, f64, vp]),
            # lines.cu (K6) and rblines.cu (K5)
            # (..., maf, lines a tile, threads, tiles, device, stream)
            ("line_j", [vp, vp, vp, vp, vp, i32, i32, i32, f64, i32, i32, i32,
                        i32, i32, vp]),
            ("line_rb_color", [vp, vp, vp, vp, i32, i32, i32, i32, i32, f64,
                               i32, i32, i32, i32, i32, vp]),
            ("rbl_color", [vp, vp, vp, vp, i32, i32, i32, i32, i32, f64, i32,
                           i32, i32, i32, i32, vp]),
            # dist_rbpack.cu (K7) and dist_sweeps.cu (K8)
            ("dist_rb_max_blocks", [i32, i32, ctypes.POINTER(i32)]),
            ("dist_rb_sweeps", [pvp, pi32, f64, vp]),
            ("pack_exchange", [pvp, pi32, vp]),
            ("block_sweep_max_blocks", [i32, ctypes.POINTER(i32)]),
            ("block_sweep", [pvp, pi32, f64, vp, vp]),
            # dist_halo.cu (the exchange and the fold of K8/K9's steps)
            ("halo_exchange", [pvp, pi32, vp]),
            ("fold_partials", [vp, i32, vp, i32, vp]),
            # pcr.cu (K10) and dist_pcr.cu (K9)
            ("fused_pcr", [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                           i32, f64, i32, i32, i32, i32, vp]),
            # (slabs, maf, smem, device, out); (ptrs, iargs, omega, stream)
            ("pcr_lines_max_blocks", [i32, i32, i32, i32, ctypes.POINTER(i32)]),
            ("pcr_lines", [pvp, pi32, f64, vp]),
            ("block_pcr", [pvp, pi32, f64, vp, vp]),
            # psor.cu (P1) and pcr_gs.cu (P2): (ptrs, iargs, omega,
            # stream); P2's occupancy (slabs, maf, smem, device, out)
            ("psor_sweep", [pvp, pi32, f64, vp]),
            ("pcr_gs_max_blocks", [i32, i32, i32, i32, ctypes.POINTER(i32)]),
            ("pcr_gs_sweep", [pvp, pi32, f64, vp]),
            # blas.cu: (p, b or NULL, msk, out, K, I, J, device, stream);
            # the vector passes (op, points, device, out) and (op, ptrs,
            # points, grid, device, stream)
            ("calc_ax", [vp, vp, vp, vp, i32, i32, i32, i32, vp]),
            ("vec_grid", [i32, i64, i32, ctypes.POINTER(i32)]),
            ("vec_pass", [i32, pvp, i64, i32, i32, vp]),
        ):
            fn = getattr(lib, f"cz_{name}_{t}")
            fn.argtypes = args
            fn.restype = i32


def _run(cmds):
    """Run the commands in parallel; raise naming the first that failed.
    Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{out}")
    return "".join(outs)


def load(rebuild: bool = False):
    """The loaded kernel library, built first if needed (always, with
    ``rebuild``, unless this process has loaded it already)."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC.glob("*.cu*")):
            h.update(f.name.encode() + b"\0" + f.read_bytes())
        so = BUILD_DIR / f"libcz_{h.hexdigest()[:16]}.so"
        log = so.with_suffix(".log")
        if rebuild or not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = f"{so.name}.{os.getpid()}"
            nvcc = _nvcc()
            objs = [BUILD_DIR / f"{tmp}.{src.stem}.o" for src in sources()]
            out = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(sources(), objs)])
            lib_tmp = BUILD_DIR / f"{tmp}.tmp"
            out += _run([[nvcc, *ARCH, "-shared", "-o", str(lib_tmp),
                          *map(str, objs)]])
            for o in objs:
                o.unlink()
            log.write_text(out)
            os.replace(lib_tmp, so)  # atomic: concurrent builds race safely
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
