"""Banded edit distance and percent identity.

The port's copy of what stage 3 calls of ``rnabloom_tpu/utils/align.py``:
host-side equivalents of SeqUtils.getPercentIdentity (banded edit
distance, SeqUtils.java:164-272).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def banded_edit_distance(a: np.ndarray, b: np.ndarray, band: Optional[int] = None) -> int:
    """Levenshtein distance within a diagonal band (O(n*band))."""
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return max(n, m)
    if band is None:
        band = max(abs(n - m) + 8, (max(n, m) // 10) + 1)
    band = max(band, abs(n - m) + 1)
    INF = n + m + 1
    # rows indexed by diagonal offset j - i in [-band, band]
    prev = np.full(2 * band + 1, INF, np.int32)
    for off in range(0, band + 1):  # row 0: distance to b[:j] is j
        if off <= m:
            prev[band + off] = off
    for i in range(1, n + 1):
        cur = np.full(2 * band + 1, INF, np.int32)
        lo = max(0, i - band)
        hi = min(m, i + band)
        for j in range(lo, hi + 1):
            off = j - i
            if j == 0:
                cur[band + off] = i
                continue
            sub = prev[band + off] + (a[i - 1] != b[j - 1])
            ins = cur[band + off - 1] + 1 if off - 1 >= -band else INF
            dele = prev[band + off + 1] + 1 if off + 1 <= band else INF
            cur[band + off] = min(sub, ins, dele)
        prev = cur
    off = m - n
    if abs(off) > band:
        return INF
    return int(prev[band + off])


def percent_identity(a: np.ndarray, b: np.ndarray) -> float:
    """1 - edits / max_len, via banded edit distance (SeqUtils :164-272)."""
    n, m = len(a), len(b)
    if max(n, m) == 0:
        return 0.0
    d = banded_edit_distance(a, b)
    return max(0.0, 1.0 - d / max(n, m))
