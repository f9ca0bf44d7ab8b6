"""Scalar reference-semantics oracle: a slow, Java-faithful simulator of the
reference's per-k-mer decision points, used to *measure* how often the
port's batched approximations change a decision.

The port's copy of ``rnabloom_tpu/oracle/refsim.py``, with what
``oracle/divergence.py`` calls (pure Python; the JAX package's naive-walk
and paired-end extension models, which it does not call, are left out).
``tests/test_torch_oracle.py`` holds each function against the original.

Everything here mirrors the reference control flow statement-for-statement
(cited per function) over an idealized exact graph — a Python dict of
k-mer -> count standing in for dbgbf+cbf with zero false positives and no
counter saturation.  The decision oracle builds the same graph with
oversized int32 filters in exact-count mode so both sides see identical
counts; any remaining disagreement is then purely the decision-logic
deviation documented in graph/traverse.py and assembly/transcripts.py.

Reference quirk worth knowing (it shapes what "parity" means for tips): the
member Kmer.hasDepthRight/Left (graph/Kmer.java:407-486 and
CanonicalKmer.java:438-516) never consult the graph — every level pushes all
4 successor iterators unconditionally, so the walk always reaches ``depth``
and the function returns true for any depth >= 1.  The naiveExtend* family
calls THESE (GraphUtils.java:6794-6860), so the reference's "naive" walks
stop at every >=2-way branch and at any existing left variant, with no
actual depth filtering.  The static GraphUtils.hasDepthRight/Left
(:6680-6778) do a real graph-checked DFS and are used by represented()
(:746, :810)."""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

NUCLEOTIDES = "ACGT"
# SeqUtils.java:52-59 — variant iteration skips the original base, in ACGT order
ALT_NUCLEOTIDES = {
    "A": "CGT",
    "C": "AGT",
    "G": "ACT",
    "T": "ACG",
}


class ExactGraph:
    """Idealized BloomFilterDeBruijnGraph (graph/BloomFilterDeBruijnGraph.java).

    ``counts[kmer]`` is getCount(kmer): the reference stores the first insert
    in dbgbf only and returns cbf+1 (:552-569, :399-412), which for an exact
    store is simply the occurrence multiplicity.  ``read_pairs``/
    ``frag_pairs`` model rpkbf/fpkbf as exact sets of (left, right) k-mer
    pairs at the configured distances (:476-508).
    """

    def __init__(
        self,
        k: int,
        read_pair_dist: int = 0,
        frag_pair_dist: int = 0,
        counts: Optional[Dict[str, float]] = None,
    ):
        self.k = k
        self.read_pair_dist = read_pair_dist
        self.frag_pair_dist = frag_pair_dist
        self.counts: Dict[str, float] = counts or {}
        self.read_pairs: Set[Tuple[str, str]] = set()
        self.frag_pairs: Set[Tuple[str, str]] = set()

    # -- construction ------------------------------------------------------

    def add_seq(self, seq: str, read_pairs: bool = False) -> None:
        """Sequential per-read add (RNABloom SeqToGraphWorker -> graph.add,
        BloomFilterDeBruijnGraph.java:399-412 with exact storage)."""
        k = self.k
        for i in range(len(seq) - k + 1):
            km = seq[i : i + k]
            self.counts[km] = self.counts.get(km, 0.0) + 1.0
        if read_pairs and self.read_pair_dist > 0:
            self._add_pairs(seq, self.read_pair_dist, self.read_pairs)

    def _add_pairs(self, seq: str, d: int, dest: Set[Tuple[str, str]]) -> None:
        k = self.k
        n = len(seq) - k + 1
        for i in range(n - d):
            dest.add((seq[i : i + k], seq[i + d : i + d + k]))

    # -- queries -----------------------------------------------------------

    def get_count(self, kmer: str) -> float:
        return self.counts.get(kmer, 0.0)

    def contains(self, kmer: str) -> bool:
        return kmer in self.counts

    def get_kmers(self, seq: str) -> List[str]:
        """HashFunction.getKmers (bloom/hash/HashFunction.java:55-85):
        every window, including zero-count ones."""
        k = self.k
        return [seq[i : i + k] for i in range(len(seq) - k + 1)]

    def assemble(self, kmers: Sequence[str]) -> str:
        """BloomFilterDeBruijnGraph.assemble (:1236-1252)."""
        if not kmers:
            return ""
        return kmers[0] + "".join(km[-1] for km in kmers[1:])


# ---------------------------------------------------------------------------
# neighbor iteration (graph/Kmer.java)
# ---------------------------------------------------------------------------


def successors(g: ExactGraph, kmer: str, min_cov: float = 1.0) -> List[str]:
    """Kmer.getSuccessors (graph/Kmer.java:240-255): ACGT order, kept when
    getCount >= minKmerCov."""
    base = kmer[1:]
    return [base + c for c in NUCLEOTIDES if g.get_count(base + c) >= min_cov]


def predecessors(g: ExactGraph, kmer: str, min_cov: float = 1.0) -> List[str]:
    """Kmer.getPredecessors (graph/Kmer.java:211-226)."""
    base = kmer[:-1]
    return [c + base for c in NUCLEOTIDES if g.get_count(c + base) >= min_cov]


def left_variants(g: ExactGraph, kmer: str, min_cov: float = 1.0) -> List[str]:
    """Kmer.getLeftVariants (graph/Kmer.java:359-379): alt-nucleotide order."""
    return [
        c + kmer[1:]
        for c in ALT_NUCLEOTIDES[kmer[0]]
        if g.get_count(c + kmer[1:]) >= min_cov
    ]


def right_variants(g: ExactGraph, kmer: str, min_cov: float = 1.0) -> List[str]:
    """Kmer.getRightVariants (graph/Kmer.java:381-401)."""
    return [
        kmer[:-1] + c
        for c in ALT_NUCLEOTIDES[kmer[-1]]
        if g.get_count(kmer[:-1] + c) >= min_cov
    ]


def max_cov_successor(g: ExactGraph, kmer: str, min_cov: float) -> Optional[str]:
    """Kmer.getMaxCovSuccessor (graph/Kmer.java:303-329): strict >, so the
    first base in ACGT order wins count ties."""
    best, best_count = None, -1.0
    base = kmer[1:]
    for c in NUCLEOTIDES:
        cnt = g.get_count(base + c)
        if cnt >= min_cov and cnt > best_count:
            best, best_count = base + c, cnt
    return best


def max_cov_predecessor(g: ExactGraph, kmer: str, min_cov: float) -> Optional[str]:
    """Kmer.getMaxCovPredecessor (graph/Kmer.java:331-357)."""
    best, best_count = None, -1.0
    base = kmer[:-1]
    for c in NUCLEOTIDES:
        cnt = g.get_count(c + base)
        if cnt >= min_cov and cnt > best_count:
            best, best_count = c + base, cnt
    return best


# ---------------------------------------------------------------------------
# depth probes
# ---------------------------------------------------------------------------


def has_depth_right(g: ExactGraph, kmer: str, depth: int) -> bool:
    """Static GraphUtils.hasDepthRight (GraphUtils.java:6680-6703): DFS over
    graph-contained successors.  Faithful to the deque mechanics, including
    the quirk that an *empty* successor deque still counts as a frontier
    level when pushed — so true needs a chain of depth-1 contained k-mers
    plus one more expansion attempt, not depth contained levels."""
    frontier: deque = deque()
    frontier.append(deque(successors(g, kmer)))
    while frontier:
        alts = frontier[-1]
        if not alts:
            frontier.pop()
        else:
            frontier.append(deque(successors(g, alts.popleft())))
        if len(frontier) >= depth:
            return True
    return False


def has_depth_left(g: ExactGraph, kmer: str, depth: int) -> bool:
    """Static GraphUtils.hasDepthLeft (GraphUtils.java:6705-6728)."""
    frontier: deque = deque()
    frontier.append(deque(predecessors(g, kmer)))
    while frontier:
        alts = frontier[-1]
        if not alts:
            frontier.pop()
        else:
            frontier.append(deque(predecessors(g, alts.popleft())))
        if len(frontier) >= depth:
            return True
    return False


# ---------------------------------------------------------------------------
# lookahead scoring + greedy extension (GraphUtils.java:249-625, 1906-1998)
# ---------------------------------------------------------------------------


def get_max_median_coverage_right(g: ExactGraph, source: str, lookahead: int) -> float:
    """GraphUtils.getMaxMedianCoverageRight (GraphUtils.java:249-310):
    max over depth-``lookahead`` paths (source included) of the minimum
    count along the path; a dead end before full depth scores 0."""
    neighbors = deque(successors(g, source))
    if not neighbors:
        return 0.0 if lookahead > 0 else g.get_count(source)
    path: List[str] = [source]
    cursor = neighbors.popleft()
    path.append(cursor)
    frontier: deque = deque([neighbors])
    best_cov = 0.0
    while frontier:
        if len(path) < lookahead:
            neighbors = deque(successors(g, cursor))
            if neighbors:
                cursor = neighbors.popleft()
                path.append(cursor)
                frontier.append(neighbors)
                continue
        if len(path) == lookahead:
            path_cov = min(g.get_count(km) for km in path)
            if best_cov < path_cov:
                best_cov = path_cov
        while frontier:
            neighbors = frontier[-1]
            path.pop()
            if not neighbors:
                frontier.pop()
            else:
                cursor = neighbors.popleft()
                path.append(cursor)
                break
    return best_cov


def get_max_median_coverage_left(g: ExactGraph, source: str, lookahead: int) -> float:
    """GraphUtils.getMaxMedianCoverageLeft (GraphUtils.java:375-499)."""
    neighbors = deque(predecessors(g, source))
    if not neighbors:
        return 0.0 if lookahead > 0 else g.get_count(source)
    path: List[str] = [source]
    cursor = neighbors.popleft()
    path.append(cursor)
    frontier: deque = deque([neighbors])
    best_cov = 0.0
    while frontier:
        if len(path) < lookahead:
            neighbors = deque(predecessors(g, cursor))
            if neighbors:
                cursor = neighbors.popleft()
                path.append(cursor)
                frontier.append(neighbors)
                continue
        if len(path) == lookahead:
            path_cov = min(g.get_count(km) for km in path)
            if best_cov < path_cov:
                best_cov = path_cov
        while frontier:
            neighbors = frontier[-1]
            path.pop()
            if not neighbors:
                frontier.pop()
            else:
                cursor = neighbors.popleft()
                path.append(cursor)
                break
    return best_cov


def greedy_extend_right_once(
    g: ExactGraph, candidates: Sequence[str], lookahead: int
) -> Optional[str]:
    """GraphUtils.greedyExtendRightOnce (GraphUtils.java:501-525): best
    lookahead score, ties broken by higher candidate count, then first in
    iteration (ACGT) order."""
    if not candidates:
        return None
    if len(candidates) == 1:
        return candidates[0]
    best_cov = -1.0
    best = None
    for km in candidates:
        c = get_max_median_coverage_right(g, km, lookahead)
        if c > best_cov:
            best, best_cov = km, c
        elif c == best_cov and g.get_count(km) > g.get_count(best):
            best = km
    return best


def greedy_extend_left_once(
    g: ExactGraph, candidates: Sequence[str], lookahead: int
) -> Optional[str]:
    """GraphUtils.greedyExtendLeftOnce (GraphUtils.java:563-587)."""
    if not candidates:
        return None
    if len(candidates) == 1:
        return candidates[0]
    best_cov = -1.0
    best = None
    for km in candidates:
        c = get_max_median_coverage_left(g, km, lookahead)
        if c > best_cov:
            best, best_cov = km, c
        elif c == best_cov and g.get_count(km) > g.get_count(best):
            best = km
    return best


def greedy_extend_right(
    g: ExactGraph, source: str, lookahead: int, bound: int
) -> List[str]:
    """GraphUtils.greedyExtendRight (GraphUtils.java:1961-1976)."""
    ext: List[str] = []
    cur = source
    for _ in range(bound):
        cur = greedy_extend_right_once(g, successors(g, cur), lookahead)
        if cur is None:
            break
        ext.append(cur)
    return ext


def greedy_extend_left(
    g: ExactGraph, source: str, lookahead: int, bound: int
) -> List[str]:
    """GraphUtils.greedyExtendLeft (GraphUtils.java:1906-1921): result in
    left-to-right order (addFirst)."""
    ext: List[str] = []
    cur = source
    for _ in range(bound):
        cur = greedy_extend_left_once(g, predecessors(g, cur), lookahead)
        if cur is None:
            break
        ext.insert(0, cur)
    return ext


# ---------------------------------------------------------------------------
# naive extension (GraphUtils.java:6780-6950)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# max-coverage path (GraphUtils.java:1591-1674)
# ---------------------------------------------------------------------------


def get_max_coverage_path(
    g: ExactGraph,
    left: str,
    right: str,
    bound: int,
    lookahead: int,
    min_cov: float,
) -> Optional[List[str]]:
    """GraphUtils.getMaxCoveragePath (GraphUtils.java:1591-1674): greedy
    max-count walk right from ``left``; if it misses ``right``, greedy walk
    left from ``right`` and stitch at the first intersection."""
    left_path_set: Set[str] = set()
    left_path: List[str] = []
    best = left
    for _ in range(bound):
        best = max_cov_successor(g, best, min_cov)
        if best is None:
            break
        if best == right:
            return left_path
        if best in left_path_set:
            break
        left_path_set.add(best)
        left_path.append(best)

    right_path_set: Set[str] = set()
    right_path: List[str] = []
    best = right
    for _ in range(bound):
        best = max_cov_predecessor(g, best, min_cov)
        if best is None:
            break
        if best == left:
            return right_path
        if best in right_path_set:
            return None
        if best in left_path_set:
            if is_low_complexity_short(best):
                return None
            right_path.insert(0, best)
            try:
                idx = len(left_path) - 1 - left_path[::-1].index(best)
            except ValueError:
                continue
            return left_path[:idx] + right_path
        right_path_set.add(best)
        right_path.insert(0, best)
    return None


def restrict(g: ExactGraph, bf: Set[str]) -> ExactGraph:
    """Graph view through a Bloom filter: the bf-variant getSuccessors/
    getPredecessors (graph/Kmer.java:257-301) keep a neighbor only when
    bf.lookup && graph count > 0.  With exact sets that is a count-dict
    intersection; counts keep their graph values."""
    out = ExactGraph(
        g.k,
        g.read_pair_dist,
        g.frag_pair_dist,
        counts={km: c for km, c in g.counts.items() if km in bf},
    )
    out.read_pairs = g.read_pairs
    out.frag_pairs = g.frag_pairs
    return out


def get_max_coverage_path_bf(
    g_bf: ExactGraph, left: str, right: str, bound: int, lookahead: int
) -> Optional[List[str]]:
    """GraphUtils.getMaxCoveragePath bf variant (GraphUtils.java:1677-1775):
    per-step choice is greedyExtendRightOnce over the restricted graph (not
    the max-count successor), and there is no low-complexity gate at the
    stitch point.  ``g_bf`` must be a ``restrict()`` view."""
    left_path_set: Set[str] = set()
    left_path: List[str] = []
    best: Optional[str] = left
    for _ in range(bound):
        neighbors = successors(g_bf, best, 1.0)
        if not neighbors:
            break
        if len(neighbors) == 1:
            best = neighbors[0]
        else:
            best = greedy_extend_right_once(g_bf, neighbors, lookahead)
        if best == right:
            return left_path
        if best in left_path_set:
            break
        left_path_set.add(best)
        left_path.append(best)

    right_path_set: Set[str] = set()
    right_path: List[str] = []
    best = right
    for _ in range(bound):
        neighbors = predecessors(g_bf, best, 1.0)
        if not neighbors:
            break
        if len(neighbors) == 1:
            best = neighbors[0]
        else:
            best = greedy_extend_left_once(g_bf, neighbors, lookahead)
        if best == left:
            return right_path
        if best in left_path_set:
            right_path.insert(0, best)
            try:
                idx = len(left_path) - 1 - left_path[::-1].index(best)
            except ValueError:
                continue
            return left_path[:idx] + right_path
        if best not in right_path_set:
            right_path_set.add(best)
            right_path.insert(0, best)
        else:
            return None
    return None


# ---------------------------------------------------------------------------
# sequence utilities (SeqUtils.java, Common.java)
# ---------------------------------------------------------------------------


def get_median(vals: Sequence[float]) -> float:
    """Common.getMedian (util/Common.java:41-50)."""
    a = sorted(vals)
    n = len(a)
    half = n // 2
    if n % 2 == 0:
        return (a[half - 1] + a[half]) / 2.0
    return a[half]


def get_min_med_max(vals: Sequence[float]) -> Tuple[float, float, float]:
    """GraphUtils.getMinMedMaxKmerCoverage (GraphUtils.java:219-228)."""
    return min(vals), get_median(vals), max(vals)


def levenshtein(s: str, t: str) -> int:
    """SeqUtils.getDistance (util/SeqUtils.java:190-235)."""
    if s == t:
        return 0
    if not s:
        return len(t)
    if not t:
        return len(s)
    v0 = list(range(len(t) + 1))
    for i, cs in enumerate(s):
        v1 = [i + 1]
        for j, ct in enumerate(t):
            v1.append(min(v1[j] + 1, v0[j + 1] + 1, v0[j] + (cs != ct)))
        v0 = v1
    return v0[len(t)]


def get_percent_identity(a: str, b: str) -> float:
    """SeqUtils.getPercentIdentity (util/SeqUtils.java:164-175)."""
    d = levenshtein(a, b)
    m = max(len(a), len(b))
    if m == 0:
        return 0.0
    return (m - d) / m


def is_low_complexity_short(seq: str) -> bool:
    """SeqUtils.isLowComplexityShort (util/SeqUtils.java:499-560): running
    1/2/3-mer frequencies against 0.95-scaled thresholds."""
    n = len(seq)
    if n < 3:
        return True
    t1 = round(n * 0.95)
    t2 = round(n // 2 * 0.95)
    t3 = round(n // 3 * 0.95)
    f1: Dict[str, int] = {}
    f2: Dict[str, int] = {}
    f3: Dict[str, int] = {}
    for i in range(n):
        c = seq[i]
        f1[c] = f1.get(c, 0) + 1
        if f1[c] >= t1:
            return True
        if i + 1 < n:
            d = seq[i : i + 2]
            f2[d] = f2.get(d, 0) + 1
            if f2[d] >= t2:
                return True
        if i + 2 < n:
            d = seq[i : i + 3]
            f3[d] = f3.get(d, 0) + 1
            if f3[d] >= t3:
                return True
    return False


# ---------------------------------------------------------------------------
# error correction (GraphUtils.java:3711-4048)
# ---------------------------------------------------------------------------


def correct_mismatches(
    kmers: List[str], g: ExactGraph, cov_threshold: float, min_cov: float
) -> bool:
    """GraphUtils.correctMismatches (GraphUtils.java:3913-3996): in-place
    right/left variant substitution of isolated low-coverage k windows."""
    corrected = False
    n = len(kmers)
    k = g.k

    for i in range(1, n - k):
        if g.get_count(kmers[i]) < cov_threshold:
            if g.get_count(kmers[i - 1]) >= cov_threshold and g.get_count(
                kmers[i + k]
            ) >= cov_threshold:
                tail = kmers[i + k][:-1]  # graph.getPrefix(right)
                best_alt = None
                best_cov = get_median(
                    [g.get_count(kmers[j]) for j in range(i, i + k - 1)]
                )
                for var in right_variants(g, kmers[i], 1.0):
                    alt = var + tail
                    alt_kmers = g.get_kmers(alt)
                    if alt_kmers:
                        covs = [g.get_count(km) for km in alt_kmers]
                        mn, md, _ = get_min_med_max(covs)
                        if mn >= min_cov and md > best_cov:
                            best_cov = md
                            best_alt = alt_kmers
                if best_alt is not None:
                    for j in range(k):
                        kmers[i + j] = best_alt[j]
                    corrected = True

    for i in range(n - 2, k - 1, -1):
        if g.get_count(kmers[i]) < cov_threshold:
            if g.get_count(kmers[i + 1]) >= cov_threshold and g.get_count(
                kmers[i - k]
            ) >= cov_threshold:
                head = kmers[i - k][1:]  # graph.getSuffix(left)
                best_alt = None
                best_cov = get_median(
                    [g.get_count(kmers[j]) for j in range(i - k + 1, i + 1)]
                )
                for var in left_variants(g, kmers[i], 1.0):
                    alt = head + var
                    alt_kmers = g.get_kmers(alt)
                    if alt_kmers:
                        covs = [g.get_count(km) for km in alt_kmers]
                        mn, md, _ = get_min_med_max(covs)
                        if mn >= min_cov and md > best_cov:
                            best_cov = md
                            best_alt = alt_kmers
                if best_alt is not None:
                    for j in range(k):
                        kmers[i - k + 1 + j] = best_alt[j]
                    corrected = True
    return corrected


def correct_error_helper(
    kmers: List[str],
    g: ExactGraph,
    lookahead: int,
    max_indel: int,
    cov_threshold: float,
    percent_identity: float,
    min_cov: float,
) -> Optional[List[str]]:
    """GraphUtils.correctErrorHelper (GraphUtils.java:3711-3911): segment the
    read at below-threshold k-mers; repair left tips, SNV bubbles (gap == k)
    and general gaps via a max-coverage bridge; right-tip pass; then
    correctMismatches.  Returns the corrected k-mer list or None if
    unchanged."""
    corrected = False
    n = len(kmers)
    k = g.k
    expected_gap = k

    out: List[str] = []
    bad_since = 0
    for i in range(n):
        km = kmers[i]
        if g.get_count(km) >= cov_threshold:
            if bad_since > 0:
                if not out:
                    # left edge (GraphUtils.java:3735-3780)
                    lv = left_variants(g, kmers[i - 1], min_cov)
                    if not lv:
                        out.extend(kmers[:i])
                    elif bad_since >= lookahead:
                        tip_med = get_median(
                            [g.get_count(kmers[j]) for j in range(i)]
                        )
                        greedy = greedy_extend_left(g, km, lookahead, bad_since)
                        if (
                            len(greedy) == bad_since
                            and get_median([g.get_count(x) for x in greedy])
                            > tip_med
                        ):
                            if (
                                get_percent_identity(
                                    g.assemble(greedy), g.assemble(kmers[:i])
                                )
                                >= percent_identity
                            ):
                                corrected = True
                                out.extend(greedy)
                            elif (
                                not predecessors(g, kmers[0], 1.0)
                                and bad_since < k
                            ):
                                corrected = True  # blunt end: drop the tip
                            else:
                                out.extend(kmers[:i])
                        else:
                            out.extend(kmers[:i])
                    else:
                        corrected = True  # short left tip: drop
                elif bad_since == expected_gap:
                    # SNV bubble (GraphUtils.java:3782-3821)
                    left_edge = kmers[i - bad_since]
                    right_edge = kmers[i - 1]
                    best_kmers = None
                    best_cov = 1.4e-45  # Java Float.MIN_VALUE (positive!)
                    for c in NUCLEOTIDES:
                        test = g.get_kmers(left_edge + c + right_edge)
                        if test:
                            covs = [g.get_count(x) for x in test]
                            mn, md, _ = get_min_med_max(covs)
                            if mn >= min_cov and md > best_cov:
                                best_cov = md
                                best_kmers = test
                    if best_kmers is not None and best_cov >= min_cov:
                        out.extend(best_kmers)
                        corrected = True
                    else:
                        out.extend(kmers[i - bad_since : i])
                else:
                    # general gap: max-coverage bridge (GraphUtils.java:3822-3858)
                    path = get_max_coverage_path(
                        g, out[-1], km, bad_since + max_indel, lookahead, min_cov
                    )
                    if path is None:
                        out.extend(kmers[i - bad_since : i])
                    else:
                        alt_len = len(path)
                        if (
                            bad_since - max_indel <= alt_len <= bad_since + max_indel
                            and (
                                alt_len <= k + max_indel
                                or get_percent_identity(
                                    g.assemble(path),
                                    g.assemble(kmers[i - bad_since : i]),
                                )
                                >= percent_identity
                            )
                        ):
                            out.extend(path)
                            corrected = True
                        else:
                            out.extend(kmers[i - bad_since : i])
                bad_since = 0
            out.append(km)
        else:
            bad_since += 1

    if 0 < bad_since < n:
        # right edge (GraphUtils.java:3863-3898)
        i = n - bad_since
        rv = right_variants(g, kmers[i], min_cov)
        if not rv:
            out.extend(kmers[i:])
        elif bad_since >= lookahead:
            tip_med = get_median([g.get_count(kmers[i + j]) for j in range(bad_since)])
            greedy = greedy_extend_right(g, kmers[i - 1], lookahead, bad_since)
            if (
                len(greedy) == bad_since
                and get_median([g.get_count(x) for x in greedy]) > tip_med
            ):
                if (
                    get_percent_identity(g.assemble(greedy), g.assemble(kmers[i:]))
                    >= percent_identity
                ):
                    corrected = True
                    out.extend(greedy)
                elif not successors(g, kmers[-1], 1.0) and bad_since < k:
                    corrected = True  # blunt end
                else:
                    out.extend(kmers[i:])
            else:
                out.extend(kmers[i:])
        else:
            corrected = True  # short right tip: drop

    corrected = correct_mismatches(out, g, cov_threshold, min_cov) or corrected
    if corrected:
        return out
    return None


def se_cov_threshold(
    covs: Sequence[float], max_cov_gradient: float, cov_fpr: float
) -> Optional[float]:
    """The correctErrorsSE threshold scan (GraphUtils.java:3997-4046): walk
    the sorted coverages downward from the (1-covFPR) quantile until the
    drop exceeds maxCovGradient; None when no threshold is found."""
    n = len(covs)
    if n == 0:
        return None
    a = sorted(covs)
    n_fp = round(n * cov_fpr)
    start = n - 1 - n_fp
    if start < 0:
        return None
    threshold = a[start]
    for i in range(start - 1, -1, -1):
        c = a[i]
        if threshold * max_cov_gradient > c:
            return threshold
        threshold = c
    return None


def correct_errors_se(
    seq: str,
    g: ExactGraph,
    lookahead: int,
    max_indel: int,
    max_cov_gradient: float,
    cov_fpr: float,
    percent_identity: float,
    min_cov: float,
) -> Optional[str]:
    """GraphUtils.correctErrorsSE (GraphUtils.java:3997-4048): returns the
    corrected sequence, or None when unchanged (no threshold found or the
    helper made no change)."""
    kmers = g.get_kmers(seq)
    if not kmers:
        return None
    threshold = se_cov_threshold(
        [g.get_count(km) for km in kmers], max_cov_gradient, cov_fpr
    )
    if threshold is None:
        return None
    fixed = correct_error_helper(
        kmers, g, lookahead, max_indel, threshold, percent_identity, min_cov
    )
    if fixed is None:
        return None
    return g.assemble(fixed)


# ---------------------------------------------------------------------------
# paired-k-mer extension scoring (GraphUtils.java:5792-5840, 6206-6310)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# redundancy screen (GraphUtils.java:711-824)
# ---------------------------------------------------------------------------


def represented(
    kmers: Sequence[str],
    g: ExactGraph,
    screen: Set[str],
    lookahead: int,
    max_indel: int,
    max_edge_clip: int,
    percent_identity: float,
) -> bool:
    """GraphUtils.represented (GraphUtils.java:711-824): a sequence is
    redundant iff every unseen stretch is explainable — edges shorter than
    maxEdgeClipLength (or deeper alternatives exist), interior gaps repaired
    by a max-coverage re-walk within percent identity and ±maxIndelSize.

    ``screen`` is the exact-set stand-in for the screening Bloom filter.
    Re-walks (greedy edge extensions and gap bridges) traverse the
    *screen-restricted* graph — the reference passes the screening BF as
    the ``bf`` argument of the bf-variant traversals (:746-749, :785,
    :812), so test paths may only use previously-assembled k-mers."""
    n = len(kmers)
    max_idx = n - 1
    k = g.k
    max_bubble = g.read_pair_dist + k
    last_found = -1
    g_bf = restrict(g, screen)

    i = 0
    while i < n:
        if kmers[i] in screen:
            start = i
            end = i
            for j in range(i + 1, n):
                if kmers[j] in screen:
                    end = j
                else:
                    break
            assembled_range = end - start + 1
            if assembled_range >= lookahead:
                if start > 0:
                    if last_found < 0:
                        if start >= max_edge_clip or has_depth_left(
                            g, kmers[0], max_edge_clip - start
                        ):
                            test = greedy_extend_left(
                                g_bf, kmers[start], lookahead, start
                            )
                            if len(test) != start or (
                                get_percent_identity(
                                    g.assemble(test), g.assemble(kmers[0:start])
                                )
                                < percent_identity
                            ):
                                return False
                    else:
                        expected = start - last_found - 1
                        if expected > max_bubble:
                            return False
                        num_missing = k - expected
                        left = last_found
                        right = start
                        if num_missing > 0:
                            for _ in range(num_missing):
                                if left == 0 or kmers[left - 1] not in screen:
                                    break
                                left -= 1
                            for _ in range(num_missing):
                                if right == max_idx or kmers[right + 1] not in screen:
                                    break
                                right += 1
                            expected = right - left - 1
                        test = get_max_coverage_path_bf(
                            g_bf,
                            kmers[left],
                            kmers[right],
                            expected + max_indel,
                            lookahead,
                        )
                        if test is None:
                            return False
                        tlen = len(test)
                        if (
                            tlen < expected - max_indel
                            or tlen > expected + max_indel
                            or get_percent_identity(
                                g.assemble(test),
                                g.assemble(kmers[left + 1 : right]),
                            )
                            < percent_identity
                        ):
                            return False
                last_found = end
            i = end
        i += 1

    if last_found >= 0:
        if last_found < max_idx:
            expected = n - last_found - 1
            if expected >= max_edge_clip or has_depth_right(
                g, kmers[max_idx], max_edge_clip - expected
            ):
                test = greedy_extend_right(
                    g_bf, kmers[last_found], lookahead, expected
                )
                if len(test) != expected or (
                    get_percent_identity(
                        g.assemble(test), g.assemble(kmers[last_found + 1 : n])
                    )
                    < percent_identity
                ):
                    return False
        return True
    return False
