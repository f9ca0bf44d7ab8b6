"""k-mer size selection and distinct-k-mer estimates from a read sample.

The port's copy of ``rnabloom_tpu/utils/kselect.py``.  The reference parses
k as a list or range ('25,26,30-50:5') and picks the k maximising the
number of non-singleton unique k-mers, estimated by ntCard
(RNABloom.java:5700-5743, :6938-6974); here, as in the JAX package, the
estimates come from an int32 count-min sketch over a bounded read sample
(``-k LIST``, ``-ntcard``), or from an ntCard ``.hist`` file (``-hist``).
The sketches live on ``device`` (the card unless the caller asks for the
CPU), where their inserts are the ``add`` op of the insert kernel.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..bloom import filters
from ..bloom.filters import CountingConfig
from ..graph import engine
from ..io import fastx
from ..ops import nthash
from ..utils import seq as sequtils


def parse_k_spec(spec: str) -> List[int]:
    """'25,26,30-50:5' -> [25, 26, 30, 35, 40, 45, 50]."""
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            rng, _, step = part.partition(":")
            lo, hi = rng.split("-")
            out.extend(range(int(lo), int(hi) + 1, int(step) if step else 1))
        else:
            out.append(int(part))
    return sorted(set(out))


def _insert(sketch: torch.Tensor, ccfg: CountingConfig, codes: np.ndarray, k: int) -> None:
    """Count every canonical k-mer of a (B, L) code batch into the sketch."""
    fh, rh, valid = nthash.rolling_hash(torch.from_numpy(codes).to(sketch.device), k, stranded=False)
    h = nthash.multi_hash(nthash.canonical(fh, rh), k, ccfg.num_hash)
    filters.counting_increment_cm(sketch, ccfg, h, valid=valid)


def count_nonsingletons(
    reads: Sequence[np.ndarray], k: int, sketch_log2: int = 22, *, device="cuda"
) -> Tuple[int, int]:
    """(distinct_estimate, nonsingleton_estimate) over the sample: cells
    of a 2^sketch_log2 int32 count-min sketch that are > 0 and > 1."""
    ccfg = CountingConfig(size_log2=sketch_log2, num_hash=2, scratch_log2=18)
    counts = filters.make_counting(ccfg, device=engine.require_device(device))
    L = max((len(r) for r in reads), default=0)
    if L < k:
        return 0, 0
    B = 512
    for s in range(0, len(reads), B):
        chunk = reads[s : s + B]
        arr = np.full((len(chunk), L), 4, np.uint8)
        for i, r in enumerate(chunk):
            arr[i, : len(r)] = r
        _insert(counts, ccfg, arr, k)
    c = counts[: ccfg.size]
    # cell-level estimates (collision-inflated equally across k values)
    return filters._count_nonzero(c), filters._count_nonzero(c > 1)


def select_k(paths: Sequence[str], k_values: Sequence[int], sample_size: int = 2000, *, device="cuda") -> int:
    """The k maximising non-singleton unique k-mers over the first
    ``sample_size`` reads of ``paths``; on a tie the first k wins."""
    device = engine.require_device(device)
    if len(k_values) == 1:
        return k_values[0]
    reads: List[np.ndarray] = []
    for path in paths:
        for _, s, _ in fastx.read_seqs(path):
            reads.append(sequtils.encode(s))
            if len(reads) >= sample_size:
                break
        if len(reads) >= sample_size:
            break
    best_k, best_score = k_values[0], -1
    for k in k_values:
        _, nonsingleton = count_nonsingletons(reads, k, device=device)
        if nonsingleton > best_score:
            best_k, best_score = k, nonsingleton
    return best_k


class NTCardHistogram:
    """Parser for an ntCard ``.hist`` file (util/NTCardHistogram.java:35-95).

    The file holds ``F0``/``F1`` totals and per-multiplicity unique-k-mer
    counts (``1..65535``); ``-hist`` sizes the filters from its F0."""

    MAX_COUNT = 65535

    def __init__(self, path: str):
        self.f0 = 0  # distinct k-mers
        self.f1 = 0  # total k-mers
        self.counts = np.zeros(self.MAX_COUNT + 1, np.int64)
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 2:
                    continue
                key, val = parts
                if key == "F0":
                    self.f0 = int(val)
                elif key == "F1":
                    self.f1 = int(val)
                elif key.isdigit():
                    c = int(key)
                    if 1 <= c <= self.MAX_COUNT:
                        self.counts[c] = int(val)

    @property
    def num_unique(self) -> int:
        return self.f0

    @property
    def num_singletons(self) -> int:
        return int(self.counts[1])

    def min_cov_threshold(self, percentile: float = 0.05) -> int:
        """Smallest multiplicity c where the histogram turns upward after
        the error spike (getMinCovThreshold-style heuristic): the first
        local minimum of the count histogram."""
        c = self.counts
        for i in range(2, self.MAX_COUNT):
            if c[i] > 0 and c[i] <= c[i + 1]:
                return i
        return 2


def estimate_num_unique_kmers(
    paths: Sequence[str], k: int, sample_size: int = 10000, sketch_log2: int = 26, *, device="cuda"
) -> int:
    """Distinct-k-mer estimate for filter sizing (``-ntcard``, in place of
    the external ntCard; RNABloom.java:6986-7012 uses ntCard's F0).

    Counts the distinct k-mers of the first ``sample_size`` reads (each cut
    to 512 bases, those shorter than k skipped) in a 2^sketch_log2-cell
    int32 sketch, then scales by total reads / sampled reads (an
    overestimate while coverage grows, which is safe for sizing)."""
    ccfg = CountingConfig(size_log2=sketch_log2, num_hash=2, scratch_log2=16)
    sketch = filters.make_counting(ccfg, device=engine.require_device(device))
    sampled = 0
    total = 0
    max_len = 512
    batch: List[np.ndarray] = []

    def flush(batch):
        if not batch:
            return
        L = max(len(b) for b in batch)
        codes = np.full((len(batch), L), 4, np.uint8)
        for i, b in enumerate(batch):
            codes[i, : len(b)] = b
        _insert(sketch, ccfg, codes, k)

    for path in paths:
        for _, s, _ in fastx.read_seqs(path):
            total += 1
            if sampled < sample_size:
                codes = sequtils.encode(s[:max_len])
                if len(codes) >= k:
                    batch.append(codes)
                    sampled += 1
                    if len(batch) == 64:
                        flush(batch)
                        batch = []
    flush(batch)
    # the JAX package sums the nonzero cells in float32 (its kselect.py:177),
    # exact below 2^24; at most 10,000 reads of at most 512 bases stay
    # under that, so the int64 count here is the same number
    distinct = filters._count_nonzero(sketch[: ccfg.size])
    if sampled == 0:
        return 0
    return int(distinct * max(total / sampled, 1.0))
