"""Build and load the port's native code at first use.

* ``kernels()``, ``walk_kernels()`` and ``lr_kernels()`` compile
  ``csrc/cell_insert.cu``, ``csrc/walk_greedy.cu`` and
  ``csrc/lr_kernels.cu`` with ``nvcc`` for sm_90a, each into its own
  library under ``build/kernels/`` at the repository root (rebuilt when its
  source is newer), and bind their plain C entry points with ctypes.  They
  need the CUDA toolkit; there is no fallback.  ``build_all()`` starts
  every ``nvcc`` at once.
* ``build_reader()`` compiles the port's FASTX reader
  (``native/fastxio.cpp``) with ``g++`` into ``build/native/`` for the host
  it runs on; ``io/native.py`` loads it.  Without a C++ toolchain (or zlib)
  the build fails, ``io.native.available()`` is False and the callers take
  the pure-Python reader, as the JAX package does.

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
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_ROOT, "build")
KERNEL_SRC = os.path.join(_PKG, "csrc", "cell_insert.cu")
KERNEL_LIB = os.path.join(BUILD_DIR, "kernels", "libcell_insert.so")
WALK_SRC = os.path.join(_PKG, "csrc", "walk_greedy.cu")
WALK_LIB = os.path.join(BUILD_DIR, "kernels", "libwalk_greedy.so")
LR_SRC = os.path.join(_PKG, "csrc", "lr_kernels.cu")
LR_LIB = os.path.join(BUILD_DIR, "kernels", "liblr_kernels.so")
READER_SRC = os.path.join(_PKG, "native", "fastxio.cpp")
READER_LIB = os.path.join(BUILD_DIR, "native", "_fastxio.so")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}  # source -> nvcc wall time in this process
build_logs: Dict[str, str] = {}  # source -> nvcc's ptxas report (registers, spills) of a build in this process


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


def _nvcc_build(src: str, lib: str) -> None:
    """Build ``lib`` from ``src`` when it is missing or older; raises with
    nvcc's output when the build fails."""
    if not _stale(lib, src):
        return
    t0 = time.time()
    proc = _compile([_nvcc(), *NVCC_FLAGS, src], lib)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    build_seconds[src] = time.time() - t0
    build_logs[src] = proc.stderr


_P, _I64, _U32, _INT, _U64 = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int, ctypes.c_ulonglong,
)

# library -> (source, entry points with their argument types)
_SIGNATURES = {
    KERNEL_LIB: (KERNEL_SRC, {
        "cell_set_u8": [_P, _I64, _P, _I64, _P],
        "cell_add_i32": [_P, _I64, _P, _I64, _P],
        "cell_add_u16": [_P, _I64, _P, _I64, _P],
        "cell_add_mf8_batch": [_P, _P, _I64, _I64, _P, _I64, _U32, _P],
    }),
    WALK_LIB: (WALK_SRC, {
        # buf pos fh rh hist status hops path_min min_cov bound, W max_len
        # cycle_window, cbf layout size_log2 num_hash decode kms, k stranded
        # left lookahead superstep_hops max_supersteps, stream
        "walk_greedy": [_P] * 10 + [_INT] * 3 + [_P, _INT, _INT, _INT, _P, _U64] + [_INT] * 6 + [_P],
        # walk_greedy's, then ring_fh ring_rh, R probe_depth, rpkbf fpkbf,
        # pkbf_size_log2 pkbf_num_hash read_dist frag_dist, stream
        "walk_pair": [_P] * 10 + [_INT] * 3 + [_P, _INT, _INT, _INT, _P, _U64] + [_INT] * 6
        + [_P, _P, _INT, _INT, _P, _P] + [_INT] * 4 + [_P],
        # walk_greedy's, then tip_probe_depth back, stream
        "walk_naive": [_P] * 10 + [_INT] * 3 + [_P, _INT, _INT, _INT, _P, _U64] + [_INT] * 8 + [_P],
    }),
    LR_LIB: (LR_SRC, {
        # codes offsets, n_reads total, k stranded, hash valid, stream
        "lr_kmer_keys": [_P, _P, _I64, _I64, _INT, _INT, _P, _P, _P],
        # hash valid offsets aoff, n_reads n_anchors, k n w_min w_max, out ok, stream
        "lr_randstrobe_keys": [_P] * 4 + [_I64, _I64] + [_INT] * 4 + [_P, _P, _P],
        # n w_max: the bytes of dynamic shared memory lr_randstrobe_keys takes
        "lr_randstrobe_smem": [_INT, _INT],
        # unitigs U L, reads R Lr, tgt start, min_depth, votes (null: an older source's table) polished depth,
        # stream
        "consensus_vote": [_P, _I64, _I64, _P, _I64, _I64, _P, _P, _INT, _P, _P, _P, _P],
    }),
}


def _load(lib_path: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(lib_path)
        if lib is not None:
            return lib
        src, fns = _SIGNATURES[lib_path]
        _nvcc_build(src, lib_path)
        lib = ctypes.CDLL(lib_path)
        for name, args in fns.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _libs[lib_path] = lib
        return lib


def kernels() -> ctypes.CDLL:
    """The cell-insert kernel library, built on first call."""
    return _load(KERNEL_LIB)


def walk_kernels() -> ctypes.CDLL:
    """The walk kernel library (greedy, pair and naive modes), built on first call."""
    return _load(WALK_LIB)


def lr_kernels() -> ctypes.CDLL:
    """The long-read kernel library (k-mer keys, randstrobes, consensus
    vote), built on first call."""
    return _load(LR_LIB)


def build_all() -> Dict[str, float]:
    """Build every stale kernel library at once, one ``nvcc`` per source
    started together, and load them; returns source -> build seconds."""
    with ThreadPoolExecutor(len(_SIGNATURES)) as pool:
        builds = [pool.submit(_nvcc_build, src, lib) for lib, (src, _) in _SIGNATURES.items()]
        for b in builds:
            b.result()  # raises with nvcc's output
    for lib in _SIGNATURES:
        _load(lib)
    return dict(build_seconds)


def build_reader() -> str:
    """Path of the FASTX reader library, built for this host when it is
    missing or older than its source; raises when the build fails."""
    with _lock:
        if _stale(READER_LIB, READER_SRC):
            if not shutil.which("g++"):
                raise RuntimeError("g++ not found: cannot build the native FASTX reader")
            proc = _compile(["g++", "-O3", "-shared", "-fPIC", READER_SRC, "-lz"], READER_LIB)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {READER_SRC}:\n{proc.stderr}")
    return READER_LIB
