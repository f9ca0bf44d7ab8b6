"""ctypes bindings for the native FASTQ/FASTA batch reader.

The port's copy of ``rnabloom_tpu/io/native.py`` for the two readers its
stages call.  ``ops/_build.py::build_reader`` compiles the port's
``native/fastxio.cpp`` into ``build/native/`` for the host it runs on, at
first use; without a C++ toolchain (or zlib) ``available()`` is False and
the callers take the pure-Python reader, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        from ..ops import _build

        try:
            dll = ctypes.CDLL(_build.build_reader())
            dll.fx_open.restype = ctypes.c_void_p
            dll.fx_open.argtypes = [ctypes.c_char_p]
            dll.fx_close.argtypes = [ctypes.c_void_p]
            dll.fx_next_batch.restype = ctypes.c_long
            dll.fx_next_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.POINTER(ctypes.c_long),
            ]
            dll.fx_next_masked_batch.restype = ctypes.c_long
            dll.fx_next_masked_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ]
            _lib = dll
        except Exception:
            _build_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def read_code_batches(
    path: str,
    batch_size: int,
    max_len: int,
    min_qual: int,
    min_len: int,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Yield (codes (B, L) uint8, lengths (B,), reads_parsed_so_far).

    Native parse + Phred/ACGT segmentation + 2-bit encode; long segments
    arrive pre-chunked with (min_len - 1)-base overlaps.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastxio unavailable")
    h = lib.fx_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            codes = np.empty((batch_size, max_len), np.uint8)
            lens = np.empty(batch_size, np.int32)
            parsed = ctypes.c_long(0)
            n = lib.fx_next_batch(
                h, batch_size, max_len, min_qual, min_len, codes, lens,
                ctypes.byref(parsed),
            )
            if n < 0:
                raise IOError(f"native parse error in {path}")
            if n == 0:
                return
            yield codes[:n], lens[:n], int(parsed.value)
    finally:
        lib.fx_close(h)


def read_masked_batches(
    path: str,
    batch_size: int,
    max_len: int,
    min_qual: int,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (codes (B, L) uint8, lengths (B,), avg_qual (B,) float32) —
    ONE row per read, low-quality/ambiguous bases masked to 4 (quality
    segments are the runs of codes < 4).  The paired stage-2 feeder."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastxio unavailable")
    h = lib.fx_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            codes = np.empty((batch_size, max_len), np.uint8)
            lens = np.empty(batch_size, np.int32)
            avgq = np.empty(batch_size, np.float32)
            n = lib.fx_next_masked_batch(h, batch_size, max_len, min_qual, codes, lens, avgq)
            if n < 0:
                raise IOError(f"native parse error in {path}")
            if n == 0:
                return
            yield codes[:n], lens[:n], avgq[:n]
    finally:
        lib.fx_close(h)
