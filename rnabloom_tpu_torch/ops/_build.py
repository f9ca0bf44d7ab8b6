"""Build and load the port's native code at first use.

* ``kernels()`` compiles ``csrc/cell_insert.cu`` with ``nvcc`` for sm_90a
  into ``build/kernels/`` at the repository root and binds its plain C entry
  points with ctypes.  It needs the CUDA toolkit; there is no fallback.
* ``native_reader()`` compiles the JAX package's FASTX reader
  (``rnabloom_tpu/native/fastxio.cpp``) into ``build/native/`` for the host
  it runs on and points the reused ``rnabloom_tpu.io.native`` module at that
  library, so the committed ``_fastxio.so`` (built with -march=native on
  another CPU) is never loaded.  Without a C++ toolchain the reused module
  falls back to its pure-Python reader, as the JAX package does.

Both builds write to a temporary file and rename it into place, so
concurrent processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_ROOT, "build")
KERNEL_SRC = os.path.join(_PKG, "csrc", "cell_insert.cu")
KERNEL_LIB = os.path.join(BUILD_DIR, "kernels", "libcell_insert.so")
READER_SRC = os.path.join(_ROOT, "rnabloom_tpu", "native", "fastxio.cpp")
READER_LIB = os.path.join(BUILD_DIR, "native", "_fastxio.so")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_kernels: Optional[ctypes.CDLL] = None
build_seconds = 0.0  # wall time of the last kernel build in this process


def _stale(lib: str, src: str) -> bool:
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def _compile(cmd_prefix, out: str) -> subprocess.CompletedProcess:
    """Run ``cmd_prefix + ["-o", tmp]``; on success rename tmp to ``out``."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        proc = subprocess.run(cmd_prefix + ["-o", tmp], capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
        return proc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")
    return path


def kernels() -> ctypes.CDLL:
    """The cell-insert kernel library, built on first call."""
    global _kernels, build_seconds
    with _lock:
        if _kernels is not None:
            return _kernels
        if _stale(KERNEL_LIB, KERNEL_SRC):
            t0 = time.time()
            proc = _compile([_nvcc(), *NVCC_FLAGS, KERNEL_SRC], KERNEL_LIB)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {KERNEL_SRC}:\n{proc.stderr}")
            build_seconds = time.time() - t0
        lib = ctypes.CDLL(KERNEL_LIB)
        ptr, i64, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint
        for name, args in (
            ("cell_set_u8", [ptr, i64, ptr, i64, ptr]),
            ("cell_add_i32", [ptr, i64, ptr, i64, ptr]),
            ("cell_add_u16", [ptr, i64, ptr, i64, ptr]),
            ("cell_add_mf8", [ptr, ptr, i64, ptr, i64, u32, ptr]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _kernels = lib
        return lib


def native_reader() -> bool:
    """Point ``rnabloom_tpu.io.native`` at a reader built for this host;
    True when the native reader is in use."""
    from rnabloom_tpu.io import native

    with _lock:
        if native._lib is None and not native._build_failed:
            if _stale(READER_LIB, READER_SRC) and shutil.which("g++"):
                _compile(["g++", "-O3", "-shared", "-fPIC", READER_SRC, "-lz"], READER_LIB)
            # if that build failed (no toolchain, no zlib) the path stays
            # missing and the reused module drops to its pure-Python reader
            native._LIB = READER_LIB
    return native.available()
