"""2-bit packed sequence files (.nbits) — intermediate fragment storage.

The port's copy of ``rnabloom_tpu/io/nbits.py``: fragments are stored as a
little-endian int32 length followed by ceil(len/4) bytes of 2-bit packed
bases (4 bases per byte, first base in the low bits), the format of
NucleotideBitsWriter.java / NucleotideBitsReader.java.  Used for the
stage-2 fragment stratification files.
"""

from __future__ import annotations

import gzip
import struct
from typing import Iterator

import numpy as np

from ..utils import seq as sequtils


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


class NbitsWriter:
    def __init__(self, path: str):
        self._f = _open(path, "wb")

    def write_codes(self, codes: np.ndarray) -> None:
        """Write a 2-bit code array (rare residual N/4 codes store as A,
        matching the reference's ACGT-only format)."""
        n = len(codes)
        padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
        padded[:n] = np.where(codes < 4, codes, 0)
        quads = padded.reshape(-1, 4)
        packed = quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
        self._f.write(struct.pack("<i", n))
        self._f.write(packed.astype(np.uint8).tobytes())

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_nbits_codes(path: str) -> Iterator[np.ndarray]:
    """Yield 2-bit code arrays, one per stored fragment."""
    with _open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (n,) = struct.unpack("<i", head)
            nbytes = (n + 3) // 4
            data = np.frombuffer(f.read(nbytes), dtype=np.uint8)
            codes = np.empty(nbytes * 4, dtype=np.uint8)
            codes[0::4] = data & 3
            codes[1::4] = (data >> 2) & 3
            codes[2::4] = (data >> 4) & 3
            codes[3::4] = (data >> 6) & 3
            yield codes[:n]


def read_nbits(path: str) -> Iterator[str]:
    for codes in read_nbits_codes(path):
        yield sequtils.decode(codes)
