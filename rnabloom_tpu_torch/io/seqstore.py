"""Disk-backed random-access sequence store (2-bit packed).

The port's copy of ``rnabloom_tpu/io/seqstore.py``: only a compact
offset/length index stays in host RAM (~12 B per sequence); the bases live
2-bit packed in one flat file read with ``os.pread``.  Stage 3 spools its
emitted transcripts here for the non-redundant pass (the streamed analog
of generateNonRedundantTranscripts re-reading transcripts.fa,
RNABloom.java:5676).

``len``, integer and slice ``__getitem__``, iteration and a cheap
``lengths`` array; appends and reads may interleave.  Non-ACGT codes are
stored as A, the ``.nbits`` contract (io/nbits.py).
"""

from __future__ import annotations

import os
from array import array
from typing import Iterator, Union

import numpy as np


class SeqStore:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w+b")  # w+: appends and preads interleave
        self._dirty = False
        self._off = array("q", [0])  # byte offsets, n+1 entries
        self._len = array("i")  # base counts

    # -- writing ----------------------------------------------------------

    def append(self, codes: np.ndarray) -> int:
        """Store one 2-bit code array; returns its index."""
        n = len(codes)
        padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
        padded[:n] = np.where(np.asarray(codes) < 4, codes, 0)  # N -> A (nbits contract)
        quads = padded.reshape(-1, 4)
        packed = (
            quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
        ).astype(np.uint8)
        self._f.write(packed.tobytes())
        self._dirty = True
        self._off.append(self._off[-1] + len(packed))
        self._len.append(n)
        return len(self._len) - 1

    # -- reading ----------------------------------------------------------

    @property
    def lengths(self) -> np.ndarray:
        return np.frombuffer(self._len, dtype=np.int32).copy() if self._len else np.zeros(0, np.int32)

    def __len__(self) -> int:
        return len(self._len)

    def _read_one(self, i: int) -> np.ndarray:
        if self._dirty:
            self._f.flush()
            self._dirty = False
        off = self._off[i]
        n = self._len[i]
        nbytes = (n + 3) // 4
        data = np.frombuffer(os.pread(self._f.fileno(), nbytes, off), np.uint8)
        codes = np.empty(nbytes * 4, dtype=np.uint8)
        codes[0::4] = data & 3
        codes[1::4] = (data >> 2) & 3
        codes[2::4] = (data >> 4) & 3
        codes[3::4] = (data >> 6) & 3
        return codes[:n]

    def __getitem__(self, i: Union[int, slice]):
        if isinstance(i, slice):
            return [self._read_one(j) for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self._read_one(i)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self._read_one(i)

    # -- lifecycle --------------------------------------------------------

    def close(self, delete: bool = False) -> None:
        if not self._f.closed:
            self._f.close()
        if delete:
            try:
                os.remove(self.path)
            except OSError:
                pass

    def __enter__(self) -> "SeqStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
