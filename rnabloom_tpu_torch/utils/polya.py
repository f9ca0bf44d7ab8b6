"""Poly-A tail detection.

The port's copy of the tail finder of ``rnabloom_tpu/utils/polya.py``, a
port of util/PolyATailFinder.java: windowed poly-A seed search scanning
right-to-left with a running seed-length identity (findPolyASeed
:200-275) and window-chained tail growth across bounded gaps
(findPolyATail :317-337).  Operates on 2-bit code arrays (A=0 C=1 G=2
T=3).  Stage 2 uses it to file poly-A-tailed fragments first when
``-a`` asks for it; stage 3's writer flips poly-T-headed transcripts
(``find_polyt_head``) and annotates PAS motifs (``find_pas_positions``);
the long-read correction orients each read onto its sense strand
(``orient_long_read``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

# PolyATailFinder.POLY_A_SIGNALS (:29-34) — PMID 27382025
PAS_MOTIFS = [
    "AATAAA", "ATTAAA", "AGTAAA", "TATAAA", "CATAAA", "GATAAA",
    "AATATA", "AATACA", "AATAGA", "AAAAAG", "ACTAAA", "AAGAAA",
    "AATGAA", "TTTAAA", "AAAACA", "GGGGCT", "AATAAT", "AACAAA",
    "ATTACA", "ATTATA", "AACAAG", "AATAAG", "TTTTTT",
]


@dataclass(frozen=True)
class PolyAProfile:
    """PolyATailFinder knobs (:49-55 defaults, :70-89 profiles)."""

    seed_length: int = 12
    min_identity: float = 0.9
    max_gap: int = 4
    window: int = 100
    pas_search_start: int = 60  # bases upstream of the cleavage site
    pas_search_end: int = 5


ONT = PolyAProfile()


def _is_a(codes: np.ndarray, i: int) -> bool:
    return codes[i] == 0


def _percent_a(codes: np.ndarray, start: int, end: int) -> float:
    if end <= start:
        return 0.0
    return float(np.count_nonzero(codes[start:end] == 0)) / (end - start)


def _find_polya_seed(
    codes: np.ndarray, search_start: int, search_end: int, p: PolyAProfile
) -> Optional[Tuple[int, int]]:
    """findPolyASeed (PolyATailFinder.java:200-275), statement for
    statement: slide a seed_length window right-to-left tracking its A
    count; the best region opens at the first window with identity >=
    min_identity and its start advances while identity holds; then the
    end trims trailing non-A bases and a region flush with search_start
    extends left through consecutive As."""
    L = p.seed_length
    if not (0 <= search_start < search_end and search_end - search_start >= L):
        return None
    num_a = int(np.count_nonzero(codes[search_end - L : search_end] == 0))
    best: Optional[list] = None
    if num_a / L >= p.min_identity:
        best = [search_end - L, search_end]
    for i in range(search_end - L - 1, search_start - 1, -1):
        if num_a > 0 and _is_a(codes, i + L):
            num_a -= 1
        if _is_a(codes, i):
            num_a += 1
            ident = num_a / L
            if best is None:
                if ident >= p.min_identity:
                    best = [i, i + L]
            else:
                if ident >= p.min_identity:
                    best[0] = i
                else:
                    break
        elif best is not None and num_a / L < p.min_identity:
            break
    if best is not None:
        while best[1] - best[0] > L and not _is_a(codes, best[1] - 1):
            best[1] -= 1
        if best[0] == search_start:
            while best[0] > 0 and _is_a(codes, best[0] - 1):
                best[0] -= 1
        return best[0], best[1]
    return None


def find_polya_tail(
    codes: np.ndarray, profile: PolyAProfile = ONT
) -> Optional[Tuple[int, int]]:
    """findPolyATail (:317-337): seed in the last ``window`` bases, then
    chain earlier windows while they adjoin within max_gap or the
    intervening gap itself is >= min_identity A."""
    n = len(codes)
    search_end = n
    search_start = max(0, search_end - profile.window)
    best = _find_polya_seed(codes, search_start, search_end, profile)
    while best is not None and search_start > 0:
        search_end = best[0]
        search_start = max(0, search_end - profile.window)
        prev = _find_polya_seed(codes, search_start, search_end, profile)
        if prev is not None and (
            prev[1] + profile.max_gap >= best[0]
            or _percent_a(codes, prev[1], best[0]) >= profile.min_identity
        ):
            best = (prev[0], best[1])
        else:
            break
    return best


def find_polyt_head(
    codes: np.ndarray, profile: PolyAProfile = ONT
) -> Optional[Tuple[int, int]]:
    """(start, end) of a poly-T head near the 5' end (antisense tail) —
    the poly-A engine over the reverse complement."""
    rc = (3 - codes[::-1]).astype(codes.dtype)
    rc = np.where(codes[::-1] > 3, codes[::-1], rc)  # keep pads invalid
    hit = find_polya_tail(rc, profile)
    if hit is None:
        return None
    n = len(codes)
    return (n - hit[1], n - hit[0])


def find_pas_positions(
    seq: str, tail_start: int, profile: PolyAProfile = ONT
) -> List[int]:
    """PAS motif positions in [cleavage - pas_search_start,
    cleavage - pas_search_end) (hasPolyASignal/getPolyASignalPositions,
    PolyATailFinder.java:126-192)."""
    lo = max(0, tail_start - profile.pas_search_start)
    hi = max(0, tail_start - profile.pas_search_end)
    region = seq[lo:hi].upper()
    out = []
    for motif in PAS_MOTIFS:
        idx = region.find(motif)
        while idx >= 0:
            out.append(lo + idx)
            idx = region.find(motif, idx + 1)
    return sorted(set(out))


def orient_long_read(codes: np.ndarray, profile: PolyAProfile = ONT):
    """(oriented_codes, had_tail, flipped): flip poly-T-headed reads onto the
    sense strand; trim nothing (trimming is the caller's policy).  As in the
    JAX package the flip is ``3 - codes[::-1]`` in the codes' own dtype, so
    an N (4) becomes 255, which later stages see as an invalid base."""
    tail = find_polya_tail(codes, profile)
    head = find_polyt_head(codes, profile)
    if head is not None and (tail is None or (head[1] - head[0]) > (tail[1] - tail[0])):
        return (3 - codes[::-1]).astype(codes.dtype), True, True
    return codes, tail is not None, False
