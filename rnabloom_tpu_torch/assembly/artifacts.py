"""Assembly artifact detection and trimming.

The port's copy of what stage 3 calls of ``rnabloom_tpu/assembly/artifacts.py``,
host-side equivalents of the reference's artifact family (GraphUtils):
  * reverse-complement / hairpin artifacts: a sequence whose tail is the
    reverse complement of its head (template switching during library prep)
    — trimReverseComplementArtifact :7762/:7918/:8588 + hairpin trimming
    :8059-8304.  The reference aligns the sequence to its own revcomp with
    banded percent identity; here the fold point is located with exact
    seed matching plus a mismatch-tolerant extension.
  * chimeras: both halves were previously assembled separately but the
    junction has no support — isChimera :7674; detected from the screening
    filter's seen-k-mer profile.
  * template switches and blunt ends: the seen-profile signatures of
    isTemplateSwitch :8305/:8434 and isBluntEndArtifact :8535-8585.
  * low-complexity unpaired reads: the 1/2/3-mer frequency test of
    isLowComplexityShort (SeqUtils.java:499-547), the single-end ingest's
    gate; and low-complexity regions of long reads, split out of each read
    before its correction (trimLowComplexityRegions, SeqUtils.java:773-961).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(codes.dtype)


def find_rc_fold(codes: np.ndarray, seed: int = 16, max_mismatch_frac: float = 0.1) -> Optional[int]:
    """Detect a self-revcomp fold: suffix == rc(prefix).

    Returns the fold midpoint (trim position) or None.  Seeds on the last
    ``seed`` bases: finds rc(tail seed) in the head region, then verifies
    the implied palindromic overlap with a mismatch budget.
    """
    n = len(codes)
    if n < 2 * seed:
        return None
    tail = codes[n - seed :]
    probe = _revcomp(tail)
    # search for probe in the first half
    half = n // 2 + seed
    hay = codes[:half]
    if len(hay) < seed:
        return None
    win = np.lib.stride_tricks.sliding_window_view(hay, seed)
    hits = np.flatnonzero((win == probe).all(axis=1))
    if len(hits) == 0:
        return None
    p = int(hits[0])
    # implied arm length: sequence[p:] folds back onto itself
    arm = (n - p) // 2
    a = codes[p : p + arm]
    b = _revcomp(codes[n - arm : n])
    mism = int((a != b).sum())
    if arm >= seed and mism <= max(1, int(arm * max_mismatch_frac)):
        return p + arm  # keep [0, fold)
    return None


def _kmer_positions(codes: np.ndarray, k: int):
    """dict: k-mer bytes -> sorted positions (exact, host-side)."""
    n = len(codes) - k + 1
    if n <= 0:
        return {}
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    pos: dict = {}
    for i in range(n):
        pos.setdefault(win[i].tobytes(), []).append(i)
    return pos


def trim_hairpin(
    codes: np.ndarray, k: int, percent_identity: float = 0.9
) -> np.ndarray:
    """Hairpin trimming by self-revcomp k-mer matching
    (trimHairpinBySequenceMatching, GraphUtils.java:8059-8205).

    Seeds every k-th k-mer within 200 k-mers of the head (then the tail);
    a seed whose reverse complement occurs downstream marks a fold.  Short
    loops cut at the fold midpoint outright (keeping the longer half);
    long candidate loops first verify the two arms at >= percent_identity
    (arms may differ in length and fold internally — cases the simple
    suffix-fold scan misses)."""
    from ..utils import align

    n = len(codes) - k + 1
    if n < 4:
        return codes
    half_n = n // 2
    max_seed_depth = min(half_n, 200)
    max_loop = max(200, half_n)
    max_loop_diam = max_loop // 2
    pos = _kmer_positions(codes, k)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)

    def cut_at(half_idx: int) -> np.ndarray:
        # keep the longer half (the reference keeps [half:] when the fold
        # midpoint is left of center, else [:half]) — in k-mer index space
        if half_idx < half_n:
            return codes[half_idx:]
        return codes[: half_idx + k - 1]

    def check(i: int, j: int) -> Optional[np.ndarray]:
        half = (i + j) // 2
        if i >= j - max_loop:
            return cut_at(half)
        # verify arm identity outside the loop allowance
        a0, a1 = i, half - max_loop_diam + 1
        if a1 <= a0:
            return None
        left = codes[a0 : a1 + k - 1]
        right = _revcomp(codes[j - (a1 - a0) + 1 : j + k])
        if align.percent_identity(left, right) >= percent_identity:
            return cut_at(half)
        return None

    # head-anchored scan
    for i in range(0, max_seed_depth, k):
        rc = _revcomp(win[i]).tobytes()
        hits = pos.get(rc)
        if hits:
            import bisect

            z = bisect.bisect_right(hits, i)
            if z < len(hits):
                out = check(i, hits[z])
                if out is not None:
                    return out
            break
    # tail-anchored scan
    for i in range(n - 1, max(n - 1 - max_seed_depth, -1), -k):
        rc = _revcomp(win[i]).tobytes()
        hits = pos.get(rc)
        if hits:
            import bisect

            z = bisect.bisect_left(hits, i)
            if z > 0:
                j = hits[z - 1]
                out = check(j, i)
                if out is not None:
                    return out
            break
    return codes


def trim_rc_artifact(codes: np.ndarray, k: int = 0) -> np.ndarray:
    """Trim self-revcomp artifacts: the quick suffix-fold scan first
    (trimReverseComplementArtifact :7762/:7918/:8588), then — when a k is
    given — the full hairpin matcher for unequal arms / internal folds
    (trimHairpinBySequenceMatching :8059-8205)."""
    fold = find_rc_fold(codes)
    if fold is not None:
        return codes[:fold]
    if k > 0 and len(codes) >= 4 * k:
        return trim_hairpin(codes, k)
    return codes


def is_chimera(seen: np.ndarray, valid: np.ndarray, k: int, min_arm: int = 10) -> bool:
    """Chimera signature over a screening-filter profile of a sequence's
    k-mers: a long fully-seen head arm and a long fully-seen tail arm
    separated by a short unseen junction (isChimera :7674).
    """
    n = len(seen)
    idx = np.flatnonzero(valid)
    if len(idx) < 2 * min_arm + 1:
        return False
    s = seen[idx]
    unseen = np.flatnonzero(~s)
    if len(unseen) == 0 or len(unseen) >= k:
        return False
    lo, hi = unseen[0], unseen[-1]
    if hi - lo + 1 != len(unseen):
        return False  # unseen k-mers are not one contiguous junction
    return lo >= min_arm and (len(s) - hi - 1) >= min_arm


def template_switch_tip(
    seen: np.ndarray, valid: np.ndarray, k: int, min_tip: int = 3
) -> Optional[Tuple[int, int]]:
    """K-mer range of the unassembled tip if the seen-profile matches the
    template-switch signature (isTemplateSwitch :8434 / isTemplateSwitch2
    :8305): one end previously assembled, the other end an unassembled tip
    whose reverse complement may echo the assembled backbone.  The k-mers
    adjacent to the junction (the fold-back loop, up to k of them) are
    excluded from the tip.  Returns None when the profile doesn't match;
    the caller must still check the tip's revcomp against the screen.
    """
    idx = np.flatnonzero(valid)
    n = len(idx)
    if n < min_tip + 2:
        return None
    s = seen[idx]
    if s[-1] and not s[0]:
        # unassembled prefix tip (isTemplateSwitch2; loop slack 2k)
        j = int(np.flatnonzero(~s)[-1]) + 1  # assembled suffix = [j, n)
        tip_end = max(j - 2 * k, 0)
        if tip_end >= min_tip and (~s[:j]).mean() >= 0.5:
            return int(idx[0]), int(idx[tip_end - 1]) + 1
        return None
    if s[0] and not s[-1]:
        # unassembled suffix tip (isTemplateSwitch; loop slack k)
        i = int(np.flatnonzero(~s)[0])  # assembled prefix = [0, i)
        tip_start = min(i + k, n)
        if n - tip_start >= min_tip and (~s[tip_start:]).mean() >= 0.5:
            return int(idx[tip_start]), int(idx[-1]) + 1
    return None


def blunt_end_candidate(
    seen: np.ndarray,
    valid: np.ndarray,
    counts: np.ndarray,
    d: int,
    max_depth: int,
):
    """Candidate blunt-end artifact needing graph-depth confirmation, or
    None (isBluntEndArtifact :8535-8585 coverage/stub conditions).

    Returns (side, end_kmer, alt_kmer, stub_len) in VALID-k-mer index
    space: ``side`` is 'r' when the unassembled stub is at the right end
    (the reference's first branch) else 'l'; ``end_kmer`` indexes the
    sequence's terminal k-mer (the stub end that must be a graph DEAD END
    within max_depth); ``alt_kmer`` the last/first assembled k-mer (from
    which an ASSEMBLED-restricted continuation of >= stub_len must exist);
    ``stub_len`` the unassembled stub's k-mer count.
    """
    idx = np.flatnonzero(valid)
    if len(idx) < 3 or max_depth <= 0:
        return None
    s = seen[idx]
    c = counts[idx]
    n = len(s)
    edge = min(max_depth, n)
    left_cov = c[:edge].min()
    right_cov = c[-edge:].min()

    def med(x):
        return float(np.median(x)) if len(x) else 0.0

    if s[0] and (not s[-1] or left_cov > right_cov):
        i = int(np.flatnonzero(~s)[0]) if not s.all() else n
        if i == n or i < n - d:
            return None
        if med(c[:i]) > med(c[i:]):
            return ("r", int(idx[n - 1]), int(idx[i - 1]), n - i)
        return None
    if s[-1] and (not s[0] or left_cov < right_cov):
        if s.all():
            return None
        j = int(np.flatnonzero(~s)[-1])
        if j > d:
            return None
        if med(c[j + 1 :]) > med(c[: j + 1]):
            return ("l", int(idx[0]), int(idx[j + 1]), j + 1)
        return None
    return None


# Low-complexity detectors: the reference's 1/2/3-mer frequency tests
# (SeqUtils.java:370-683).  The Java early-returns on a counter crossing its
# threshold; counters only grow, so testing the FINAL counts is equivalent —
# which makes every detector a handful of numpy bincounts.

_LC_THR_SHORT = 0.95  # SeqUtils.java:61
_LC_THR_LONG = 0.89  # SeqUtils.java:62


def _freqs123(codes: np.ndarray):
    """(nf1, nf2, nf3, pair_ok, triple_ok): base/di/tri counts over valid
    (non-N) windows plus the validity masks of each pair/triple window."""
    v = codes < 4
    nf1 = np.bincount(codes[v], minlength=4)[:4]
    a, b = codes[:-1].astype(np.int64), codes[1:].astype(np.int64)
    pair_ok = v[:-1] & v[1:]
    c = codes[2:].astype(np.int64)
    triple_ok = pair_ok[:-1] & v[2:]
    return nf1, (a, b, pair_ok), (a[:-1], b[:-1], c, triple_ok)


def _dinuc_bias(nf1: np.ndarray, t1: int) -> bool:
    """Any two-base content >= t1 (the detectors' shared final check)."""
    for i in range(4):
        for j in range(i + 1, 4):
            if nf1[i] + nf1[j] >= t1:
                return True
    return False


def is_low_complexity_short(codes: np.ndarray) -> bool:
    """isLowComplexityShort (SeqUtils.java:499-547): unmasked 1/2/3-mer
    frequency thresholds at 0.95 plus the dinucleotide-content check."""
    n = len(codes)
    if n <= 2:
        return False
    t1 = min(32767, round(n * _LC_THR_SHORT))
    t2 = min(32767, round(n // 2 * _LC_THR_SHORT))
    t3 = min(32767, round(n // 3 * _LC_THR_SHORT))
    nf1, (a, b, pok), (x, y, z, tok) = _freqs123(codes)
    if nf1.max(initial=0) >= t1:
        return True
    nf2 = np.bincount((a * 4 + b)[pok], minlength=16)
    if nf2.max(initial=0) >= t2:
        return True
    nf3 = np.bincount((x * 16 + y * 4 + z)[tok], minlength=64)
    if nf3.max(initial=0) >= t3:
        return True
    return _dinuc_bias(nf1, t1)


def is_low_complexity2(codes: np.ndarray) -> bool:
    """isLowComplexity2 (SeqUtils.java:370-415): transition-masked di/tri
    counts (uniform windows excluded) at thresholds 0.95 / 0.95/2 / 0.95/3."""
    n = len(codes)
    if n <= 2:
        return False
    t1 = min(127, round(n * _LC_THR_SHORT))
    t2 = min(127, round(n * _LC_THR_SHORT / 2))
    t3 = min(127, round(n * _LC_THR_SHORT / 3))
    nf1, (a, b, pok), (x, y, z, tok) = _freqs123(codes)
    if nf1.max(initial=0) >= t1:
        return True
    nf2 = np.bincount((a * 4 + b)[pok & (a != b)], minlength=16)
    if nf2.max(initial=0) >= t2:
        return True
    nonuni = ~((x == y) & (y == z))
    nf3 = np.bincount((x * 16 + y * 4 + z)[tok & nonuni], minlength=64)
    if nf3.max(initial=0) >= t3:
        return True
    return _dinuc_bias(nf1, t1)


def is_low_complexity_long(codes: np.ndarray) -> bool:
    """isLowComplexityLong (SeqUtils.java:585-660): 0.89 thresholds;
    di/tri windows counted only inside non-uniform triples; ends with the
    dinucleotide-content check AND the reference's pairwise nf2-sum scan."""
    n = len(codes)
    if n <= 6:
        return False
    t1 = round(n * _LC_THR_LONG)
    t2 = round(n * _LC_THR_LONG / 2.0)
    t3 = round(n * _LC_THR_LONG / 3.0)
    nf1, (a, b, pok), (x, y, z, tok) = _freqs123(codes)
    if nf1.max(initial=0) >= t1:
        return True
    # pair (p, p+1) is gated by the uniformity of its covering triple
    # (p-1, p, p+1); the leading pair (0, 1) by triple (0, 1, 2)
    tri_nonuni = ~((x == y) & (y == z))  # per triple start index
    pair_gate = np.empty(len(a), bool)
    pair_gate[0] = tri_nonuni[0] if len(tri_nonuni) else True
    pair_gate[1:] = tri_nonuni
    nf2 = np.bincount((a * 4 + b)[pok & pair_gate], minlength=16).reshape(4, 4)
    if nf2.max(initial=0) >= t2:
        return True
    nf3 = np.bincount((x * 16 + y * 4 + z)[tok & tri_nonuni], minlength=64)
    if nf3.max(initial=0) >= t3:
        return True
    if _dinuc_bias(nf1, t1):
        return True
    # pairwise nf2 bias with the reference's (k >= i, l >= j) scan order
    for i in range(4):
        for j in range(4):
            count = nf2[i, j]
            for kk in range(i, 4):
                for ll in range(j, 4):
                    if (i != kk or j != ll) and count + nf2[kk, ll] >= t2:
                        return True
    return False


def extract_non_low_complexity_segments(codes: np.ndarray, window: int = 50, min_len: int = 1) -> List[Tuple[int, int]]:
    """Base ranges whose local 50 bp windows are not low-complexity
    (trimLowComplexityRegions, SeqUtils.java:773-961: windowed
    isLowComplexityLong with kept-region merging)."""
    n = len(codes)
    if n == 0:
        return []
    bad = np.zeros(n, bool)
    for s in range(0, n, window // 2):
        w = codes[s : s + window]
        if len(w) >= window // 2 and is_low_complexity_long(w):
            bad[s : s + window] = True
    segs = []
    start = None
    for i in range(n):
        if not bad[i]:
            if start is None:
                start = i
        else:
            if start is not None and i - start >= min_len:
                segs.append((start, i))
            start = None
    if start is not None and n - start >= min_len:
        segs.append((start, n))
    return segs
