"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Every ``csrc/*.cu`` file has a plain C interface.  At first use they are
compiled for Hopper (``sm_90a``), one ``nvcc`` per source started
together, linked into one shared library under ``<checkout>/build/kernels``
and loaded with ``ctypes``.  The library's name carries a hash of the
sources and flags, so an edited source is rebuilt and a built one is
reused.  Nothing here runs at import: this module needs neither ``nvcc``
nor a GPU until :func:`library` is called.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# argument types of each C entry point; every one ends with the stream
SIGNATURES = {
    "repro_placement": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I,
                        _I, _I, _I, _P),
    "repro_wire_encode": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
    "repro_wire_decode": (_P, _L, _P, _P, _L, _I, _I, _I, _I, _P),
    "repro_lif_window": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _L, _L, _I, _I, _P, _I, _I, _F, _F, _F, _F, _I,
                         _F, _F, _F, _F, _P),
    "repro_flush_window": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _L, _I, _I, _L, _L, _L, _L, _L, _I, _I,
                           _I, _P),
    "repro_synapse_deliver": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _L, _P, _L, _L, _P),
    "repro_bucket_scatter": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P),
    "repro_ssd_chunk": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                        _I, _P),
    "repro_ssd_chunk_tc": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                           _I, _P),
    "repro_admission": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _I, _I, _I, _I, _P),
    "repro_admission_tenants": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "repro_bucket_trace": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_ring_run": (_P, _P, _I, _I, _I, _I, _I, _P),
    "repro_torus_rotate": (_P, _L, _L, _L, _I, _I, _I, _I, _I, *(_I,) * 8,
                           *(_P,) * 6, _P),
    "repro_tenant_exchange": (*(_P,) * 22, _I, _I, _I, _I, _I, _F, _I, _I,
                              _I, _I, *(_I,) * 8, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels cannot be built on this machine")
    return found


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet.

    Returns its path and the compiler's output (``-Xptxas -v``: registers,
    shared memory and spills of each kernel; empty when already built).
    """
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + src.read_bytes())
    lib_path = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    procs = [subprocess.Popen([compiler, *NVCC_FLAGS, "-c", str(src),
                               "-o", str(obj)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = lib_path.parent / f"{lib_path.name}.{tag}.tmp"
    link = subprocess.run([compiler, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n"
                           f"{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_rank_max_window.argtypes = (_I, _I)
            lib.repro_rank_max_window.restype = _L
            lib.repro_error_string.argtypes = (ctypes.c_int,)
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


MAX_DEST = 256             # destinations the ranker takes (kMaxDest)


@functools.lru_cache(maxsize=None)
def max_window(n_dest: int, arrays: int) -> int:
    """The longest window the ranker of ``csrc/dest_rank.cuh`` takes for
    ``n_dest`` destinations with ``arrays`` 4-byte values staged per
    event (its shared memory bounds a cluster's chunks)."""
    return library().repro_rank_max_window(n_dest, arrays)
