"""Host-side sequence codecs and read segmentation (numpy-vectorized).

The port's copy of the functions of ``rnabloom_tpu/utils/seq.py`` that
its stages call: byte<->code conversion, reverse complement,
quality/ACGT-based read segmenting (the Phred33 + nucleotide regex gating
of the reference's filtered readers, SeqUtils.java:1432-1438), fixed-shape
batch packing and length quartiles.

Bases are 2-bit codes A=0 C=1 G=2 T/U=3; 4 = N/invalid/padding — the same
convention as the device code.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ASCII -> code lookup (uppercase+lowercase ACGTU; everything else = 4)
_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _chars, _code in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("TtUu", 3)):
    for _c in _chars:
        _CODE_LUT[ord(_c)] = _code

_BASE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP_LUT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def encode(seq: str) -> np.ndarray:
    """ASCII string -> uint8 codes."""
    return _CODE_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return _BASE_LUT[np.minimum(codes, 4)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    return _COMP_LUT[codes[::-1]]


def revcomp(seq: str) -> str:
    return decode(revcomp_codes(encode(seq)))


def segment_read(
    codes: np.ndarray,
    quals: Optional[np.ndarray],
    min_qual: int,
    min_len: int,
) -> List[np.ndarray]:
    """Split a read into kept segments.

    A base is kept iff it is an unambiguous nucleotide and (when qualities
    are given) its Phred33 score >= min_qual.  Maximal runs of kept bases of
    length >= min_len become segments — the vectorized equivalent of the
    reference's regex pipeline (Phred33 pattern then [ACGTU] pattern).
    """
    keep = codes < 4
    if quals is not None:
        keep &= quals >= (33 + min_qual)
    if keep.all():
        return [codes] if len(codes) >= min_len else []
    # run-length extraction of True runs
    padded = np.concatenate(([False], keep, [False]))
    diff = np.diff(padded.astype(np.int8))
    starts = np.flatnonzero(diff == 1)
    ends = np.flatnonzero(diff == -1)
    return [codes[s:e] for s, e in zip(starts, ends) if e - s >= min_len]


def pack_batch(
    segments: Sequence[np.ndarray], batch: int, length: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-length code arrays into a fixed (batch, length) matrix.

    Segments longer than ``length`` are truncated — use chunk_segments()
    first for long inputs.  Returns (codes, lengths); unused rows/cells are
    4 (invalid).
    """
    out = np.full((batch, length), 4, dtype=np.uint8)
    lens = np.zeros(batch, dtype=np.int32)
    for i, seg in enumerate(segments[:batch]):
        n = min(len(seg), length)
        out[i, :n] = seg[:n]
        lens[i] = n
    return out, lens


def chunk_segments(
    segments: Iterable[np.ndarray], length: int, overlap: int
) -> List[np.ndarray]:
    """Split long segments into <=length chunks overlapping by ``overlap``
    bases (k-1 for k-mer coverage continuity across chunk boundaries)."""
    out = []
    step = length - overlap
    assert step > 0
    for seg in segments:
        if len(seg) <= length:
            out.append(seg)
        else:
            for s in range(0, len(seg) - overlap, step):
                out.append(seg[s : s + length])
    return out


def quartiles(values: np.ndarray) -> Tuple[float, float, float]:
    """(q1, median, q3) with the reference's Common.java convention."""
    v = np.sort(np.asarray(values))
    n = len(v)
    if n == 0:
        return (0.0, 0.0, 0.0)

    def med(a):
        m = len(a)
        if m == 0:
            return 0.0
        h = m // 2
        return float(a[h]) if m % 2 else float(a[h - 1] + a[h]) / 2.0

    half = n // 2
    q1 = med(v[:half])
    q3 = med(v[half + (n % 2) :])
    return q1, med(v), q3
