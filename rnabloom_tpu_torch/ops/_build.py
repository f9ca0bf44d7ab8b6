"""Build and load the port's native code at first use.

* ``kernels()``, ``walk_kernels()`` and ``lr_kernels()`` compile
  ``csrc/cell_insert.cu``, ``csrc/walk_greedy.cu`` and
  ``csrc/lr_kernels.cu`` with ``nvcc`` for sm_90a, each into its own
  library under ``build/kernels/`` at the repository root (rebuilt when its
  source is newer), and bind their plain C entry points with ctypes.  The
  walk kernel's source gives six libraries (``-DWALK_PART``): the
  count-min layouts' greedy mode, their pair and naive modes, the
  exact-count layouts, the count-min layouts with terminators, and the
  sharded count-min and exact-count layouts (a mesh's shards read in
  place), so that its instantiations compile in six ``nvcc`` at once.  They need the CUDA toolkit; there is no fallback.
  ``build_all()`` starts every ``nvcc`` at once.
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
WALK_PN_LIB = os.path.join(BUILD_DIR, "kernels", "libwalk_pair_naive.so")
WALK_EXACT_LIB = os.path.join(BUILD_DIR, "kernels", "libwalk_exact.so")
WALK_TERM_LIB = os.path.join(BUILD_DIR, "kernels", "libwalk_terminators.so")
WALK_SHARDED_LIB = os.path.join(BUILD_DIR, "kernels", "libwalk_sharded.so")
WALK_SHARDED_EXACT_LIB = os.path.join(BUILD_DIR, "kernels", "libwalk_sharded_exact.so")
WALK_COUNT_MIN_LIBS = (WALK_LIB, WALK_PN_LIB)
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
build_seconds: Dict[str, float] = {}  # library -> nvcc wall time in this process
build_logs: Dict[str, str] = {}  # library -> nvcc's ptxas report (registers, spills) of a build in this process
# library -> its nvcc flags beyond NVCC_FLAGS
_DEFINES = {WALK_LIB: ["-DWALK_PART=1"], WALK_PN_LIB: ["-DWALK_PART=2"], WALK_EXACT_LIB: ["-DWALK_PART=3"],
            WALK_TERM_LIB: ["-DWALK_PART=4"], WALK_SHARDED_LIB: ["-DWALK_PART=5"],
            WALK_SHARDED_EXACT_LIB: ["-DWALK_PART=6"]}


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
    proc = _compile([_nvcc(), *NVCC_FLAGS, *_DEFINES.get(lib, []), src], lib)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    build_seconds[lib] = time.time() - t0
    build_logs[lib] = proc.stderr


_P, _I64, _U32, _INT, _U64 = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int, ctypes.c_ulonglong,
)

_WALK_COMMON = [_P] * 10 + [_INT] * 3 + [_P, _INT, _INT, _INT, _P, _U64] + [_INT] * 6
_WALK_GATES = [_P, _INT, _INT, _P, _INT, _INT]
_WALK_PAIR = [_P, _P, _INT, _INT, _P, _P] + [_INT] * 4

# the walk libraries' entry points with their argument types
_WALK_ENTRIES = {
    # buf pos fh rh hist status hops path_min min_cov bound, W max_len
    # cycle_window, cbf layout size_log2 num_hash decode kms, k stranded
    # left lookahead superstep_hops max_supersteps, then the gates: dbgbf
    # dbgbf_size_log2 dbgbf_num_hash (null: count-min), terminators
    # term_size_log2 term_num_hash (null: none), stream
    "walk_greedy": _WALK_COMMON + _WALK_GATES + [_P],
    # walk_greedy's, then ring_fh ring_rh, R probe_depth, rpkbf fpkbf,
    # pkbf_size_log2 pkbf_num_hash read_dist frag_dist, stream
    "walk_pair": _WALK_COMMON + _WALK_GATES + _WALK_PAIR + [_P],
    # walk_greedy's, then tip_probe_depth back, stream
    "walk_naive": _WALK_COMMON + _WALK_GATES + [_INT] * 2 + [_P],
}
# the sharded libraries' entry points: each mode's arguments, then the
# shard tables (device pointer) and log2 of the shard count, stream; and
# peer access (device, peer)
_WALK_SHARDED_ENTRIES = {
    "walk_greedy_sharded": _WALK_COMMON + _WALK_GATES + [_P, _INT, _P],
    "walk_pair_sharded": _WALK_COMMON + _WALK_GATES + _WALK_PAIR + [_P, _INT, _P],
    "walk_naive_sharded": _WALK_COMMON + _WALK_GATES + [_INT] * 2 + [_P, _INT, _P],
    "walk_peer_access": [_INT, _INT],
}

# library -> (source, entry points with their argument types)
_SIGNATURES = {
    KERNEL_LIB: (KERNEL_SRC, {
        "cell_set_u8": [_P, _I64, _P, _I64, _P],
        "cell_add_i32": [_P, _I64, _P, _I64, _P],
        "cell_add_u16": [_P, _I64, _P, _I64, _P],
        # table batch slots numel idx n salt base stream
        "cell_add_mf8_batch": [_P, _P, _I64, _I64, _P, _I64, _U32, _U32, _P],
        # table numel idx vals n stream
        "cell_max_i32": [_P, _I64, _P, _P, _I64, _P],
        "cell_max_u16": [_P, _I64, _P, _P, _I64, _P],
        "cell_max_u8": [_P, _I64, _P, _P, _I64, _P],
        # table size_log2 scratch scratch_log2 hashes n h valid valid_lanes dec_first salt words stream
        **{f"cell_conservative_values_{t}": [_P, _INT, _P, _INT, _P, _I64, _INT, _P, _INT, _P, _U32, _P, _P]
           for t in ("i32", "u16", "u8")},
        # table numel size_log2 hashes n h valid valid_lanes words stream
        **{f"cell_conservative_raise_{t}": [_P, _I64, _INT, _P, _I64, _INT, _P, _INT, _P, _P]
           for t in ("i32", "u16", "u8")},
    }),
    WALK_LIB: (WALK_SRC, _WALK_ENTRIES),
    WALK_PN_LIB: (WALK_SRC, _WALK_ENTRIES),
    WALK_EXACT_LIB: (WALK_SRC, _WALK_ENTRIES),
    WALK_TERM_LIB: (WALK_SRC, _WALK_ENTRIES),
    WALK_SHARDED_LIB: (WALK_SRC, _WALK_SHARDED_ENTRIES),
    WALK_SHARDED_EXACT_LIB: (WALK_SRC, _WALK_SHARDED_ENTRIES),
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


def walk_kernels(exact: bool = False, greedy: bool = True, terminators: bool = False,
                 sharded: bool = False) -> ctypes.CDLL:
    """The walk kernel library that holds a mode (``greedy``, else pair and
    naive) of the count-min layouts, with ``exact`` every mode of the
    exact-count ones, or with ``terminators`` every mode of the count-min
    layouts with terminators; with ``sharded`` every mode of the sharded
    count-min (or ``exact``: exact-count) layouts; built on first call."""
    if sharded:
        return _load(WALK_SHARDED_EXACT_LIB if exact else WALK_SHARDED_LIB)
    if exact:
        return _load(WALK_EXACT_LIB)
    if terminators:
        return _load(WALK_TERM_LIB)
    return _load(WALK_LIB if greedy else WALK_PN_LIB)


def lr_kernels() -> ctypes.CDLL:
    """The long-read kernel library (k-mer keys, randstrobes, consensus
    vote), built on first call."""
    return _load(LR_LIB)


def build_all() -> Dict[str, float]:
    """Build every stale kernel library at once, one ``nvcc`` per library
    started together, and load them; returns library -> build seconds."""
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
