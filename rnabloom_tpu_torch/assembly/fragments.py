"""Stage 2: fragment reconstruction from read pairs.

Port of ``rnabloom_tpu/assembly/fragments.py`` (FragmentAssembler,
RNABloom.java:2038-2321, and the GraphUtils connect family).  Per batch of
read pairs (right mate reverse-complemented into fragment orientation):

  1. error-correct both mates with a shared pair threshold (``correct``);
  2. take the largest exact suffix-prefix overlap of the mates;
  3. otherwise bridge the gap: one batch of greedy walks right from each
     left mate's tail k-mer and left from each right mate's head k-mer
     (the walk kernel on the card); a pair connects when the right head
     lies on the right walk, the left tail on the left walk, or the two
     walks share a k-mer;
  4. keep the longest range supported by consecutive read-pair k-mers;
  5. score the fragment by its minimum k-mer coverage (float32);
  6. with ``-extend``, extend each fragment right then left by naive walks
     that stop at branches and back branches (the walk kernel's naive
     mode on the card).

``rescue_unconnected`` (``-rescue``) retries pairs that stage 2 left
unconnected, steps 2-5 against the stage-2b fragment graph.

The host code is the JAX package's, line for line; the graph queries and
walks run on the graph's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..graph import engine, traverse
from ..graph.dbg import GraphConfig, GraphState
from ..utils import seq as sequtils
from . import correct

@dataclass
class FragmentParams:
    min_overlap: int = 10
    bound: int = 500  # max gap walk length
    num_pairs_required: int = 1
    min_fragment_length: int = 0  # defaults to 2k downstream
    extend_fragments: bool = False
    lookahead: int = 3  # -lookahead: traversal lookahead depth
    ec_params: correct.CorrectParams = None

    def __post_init__(self):
        if self.ec_params is None:
            self.ec_params = correct.CorrectParams()


@dataclass
class Fragment:
    codes: np.ndarray  # uint8, fragment sequence
    min_cov: float  # a float32 count, held as a Python float
    length: int
    connected: bool  # overlap/bridge success (vs unconnected mates)


def find_overlaps(
    left: np.ndarray, left_len: np.ndarray, right: np.ndarray, right_len: np.ndarray,
    min_overlap: int,
) -> np.ndarray:
    """Largest exact suffix(left)-prefix(right) overlap per pair (0 = none).

    Rolling polynomial hashes of every left suffix and right prefix are
    built in one O(L) scan of (B,) vector ops; candidate sizes match where
    the hashes agree (largest first), and the winner is verified exactly —
    O(B*L) total instead of the O(B*L^2) per-size equality scans.
    """
    B, L = left.shape
    max_o = int(min(left_len.max(initial=0), right_len.max(initial=0)))
    best = np.zeros(B, dtype=np.int32)
    if max_o < min_overlap:
        return best
    MUL = np.uint64(0x100000001B3)  # FNV prime
    rows = np.arange(B)
    suf = np.zeros((B, max_o + 1), np.uint64)  # suf[:, o] = hash(left[ll-o:ll])
    pre = np.zeros((B, max_o + 1), np.uint64)  # pre[:, o] = hash(right[:o])
    powm = np.uint64(1)
    with np.errstate(over="ignore"):
        for o in range(1, max_o + 1):
            lcol = left[rows, np.maximum(left_len - o, 0)].astype(np.uint64) + np.uint64(1)
            suf[:, o] = lcol * powm + suf[:, o - 1]
            rcol = right[:, o - 1].astype(np.uint64) + np.uint64(1)
            pre[:, o] = pre[:, o - 1] * MUL + rcol
            powm = powm * MUL
    o_ax = np.arange(max_o + 1)[None, :]
    okmask = (
        (suf == pre)
        & (o_ax >= min_overlap)
        & (o_ax <= left_len[:, None])
        & (o_ax <= right_len[:, None])
    )
    cand = np.max(np.where(okmask, o_ax, 0), axis=1).astype(np.int32)
    # exact verification of the selected size, vectorized over the batch
    # (hash collisions are ~2^-64, but correctness must not hinge on that)
    hit = np.flatnonzero(cand)
    if len(hit):
        j = np.arange(max_o)[None, :]
        o_h = cand[hit][:, None]
        lpos = np.clip(left_len[hit][:, None] - o_h + j, 0, L - 1)
        lv = left[hit[:, None], lpos]
        rv = right[hit][:, :max_o]
        eq = np.all((j >= o_h) | (lv == rv), axis=1)
        best[hit[eq]] = cand[hit[eq]]
        for b in hit[~eq]:  # collision: per-row scan fallback (cosmically rare)
            for o in range(int(cand[b]) - 1, min_overlap - 1, -1):
                if (left[b, left_len[b] - o : left_len[b]] == right[b, :o]).all():
                    best[b] = o
                    break
    return best


def _pair_support(graph, cfg: GraphConfig, codes) -> np.ndarray:
    """(B, P) read-pair k-mer support plane (entry i covers pair (i, i+d))."""
    return engine.pair_support_both(graph, cfg, codes, 0, cfg.read_pair_distance)[1]


def _validate(graph, cfg: GraphConfig, codes):
    """(counts, valid, read-pair support) as numpy, from one hashing pass."""
    return engine.counts_and_read_support(graph, cfg, codes)


def supported_ranges_np(
    sup: np.ndarray, lengths: np.ndarray, k: int, d: int, num_required: int
) -> List[Optional[Tuple[int, int]]]:
    """Per row: largest supported base range [s, e) or None, from a
    precomputed support plane.  Rows whose full pair window is supported
    take the vectorized fast path; only gapped rows walk the Python scan."""
    B = sup.shape[0]
    out: List[Optional[Tuple[int, int]]] = [None] * B
    n_kmers = np.maximum(lengths.astype(np.int64) - k + 1, 0)
    m = n_kmers - d  # pair-window length per row
    cols = np.arange(sup.shape[1])[None, :]
    allsup = np.all(sup | (cols >= m[:, None]), axis=1)
    for b in range(B):
        if m[b] < 1:
            continue
        if allsup[b] and num_required <= m[b]:
            out[b] = (0, int(n_kmers[b]) + k - 1)  # whole row supported
            continue
        segs = pair_break_segments(
            sup[b, : m[b]], d, num_required, int(n_kmers[b])
        )
        if not segs:
            continue
        s, e = max(segs, key=lambda se: se[1] - se[0])
        out[b] = (s, e + k - 1)  # kmer range -> base range
    return out


def pair_break_segments(
    supported: np.ndarray, d: int, num_required: int, n_kmers: int
) -> List[Tuple[int, int]]:
    """Supported k-mer index ranges (breakWithReadPairedKmers :4184-4311)."""
    segments: List[Tuple[int, int]] = []
    start, end = -1, -1
    streak = 0
    for i in range(len(supported)):
        if supported[i]:
            streak += 1
            if streak >= num_required:
                if start < 0:
                    start = i - num_required + 1
                end = i + d
        else:
            if start >= 0 and i >= end:
                segments.append((start, end + 1))
                start, end = -1, -1
            streak = 0
    if start >= 0:
        segments.append((start, min(end + 1, n_kmers)))
    return segments


def longest_supported_range(
    graph: GraphState, cfg: GraphConfig, codes_batch: np.ndarray,
    lengths: np.ndarray, num_required: int,
) -> List[Optional[Tuple[int, int]]]:
    """Per row: largest supported base range [s, e) or None."""
    sup = _pair_support(graph, cfg, codes_batch)
    return supported_ranges_np(sup, np.asarray(lengths), cfg.k, cfg.read_pair_distance, num_required)


def assemble_fragments_batch(
    graph: GraphState,
    cfg: GraphConfig,
    left: np.ndarray,
    left_len: np.ndarray,
    right: np.ndarray,
    right_len: np.ndarray,
    params: FragmentParams,
    error_correct: bool = True,
) -> List[Optional[Fragment]]:
    """Assemble fragments for a batch of oriented read pairs.

    left/right: (B, L) uint8 codes, right already reverse-complemented into
    fragment orientation.  Returns one Fragment (or None) per pair."""
    k = cfg.k
    B, L = left.shape

    if error_correct:
        # 1. error correction with shared pair thresholds (indel repairs
        # change mate lengths)
        both = np.concatenate([left, right], axis=0)
        both_len = np.concatenate([left_len, right_len])
        pair_ids = np.concatenate([np.arange(B), np.arange(B)])
        both, both_len, _ = correct.correct_batch(graph, cfg, both, both_len, params.ec_params, pair_ids)
        left, right = both[:B], both[B:]
        left_len, right_len = both_len[:B], both_len[B:]

    # 2. direct overlap
    overlaps = find_overlaps(left, left_len, right, right_len, params.min_overlap)

    # 3. bridge unconnected pairs through the graph
    need_bridge = np.flatnonzero((overlaps == 0) & (left_len >= k) & (right_len >= k))
    bridges = bridge_pairs(graph, cfg, left, left_len, right, right_len, need_bridge, params, overlaps)

    # 4. build fragment sequences
    frags_codes: List[Optional[np.ndarray]] = []
    for b in range(B):
        ll, rl = int(left_len[b]), int(right_len[b])
        if overlaps[b] > 0:
            seq = np.concatenate([left[b, :ll], right[b, overlaps[b] : rl]])
        elif b in bridges:
            seq = np.concatenate([left[b, :ll], bridges[b], right[b, :rl]])
        else:
            frags_codes.append(None)
            continue
        frags_codes.append(seq)

    # 5. read-pair validation + min coverage, batched
    connected_rows = [b for b, s in enumerate(frags_codes) if s is not None]
    results: List[Optional[Fragment]] = [None] * B
    if connected_rows:
        maxlen = max(len(frags_codes[b]) for b in connected_rows)
        # both dims pad to powers of two, as in the JAX package
        pad_len = 1 << max(8, (max(maxlen, k + cfg.read_pair_distance + 1) - 1).bit_length())
        n_rows = 1 << max(6, (len(connected_rows) - 1).bit_length())
        batch = np.full((n_rows, pad_len), 4, np.uint8)
        lens = np.zeros(n_rows, np.int32)
        for i, b in enumerate(connected_rows):
            s = frags_codes[b]
            batch[i, : len(s)] = s
            lens[i] = len(s)

        counts, valid, sup = _validate(graph, cfg, batch)
        ranges = supported_ranges_np(sup, lens, k, cfg.read_pair_distance, params.num_pairs_required)

        for i, b in enumerate(connected_rows):
            r = ranges[i]
            if r is None:
                continue
            s, e = r
            seq = frags_codes[b][s:e]
            ks, ke = s, e - k + 1
            v = valid[i, ks:ke]
            if not v.any():
                continue
            mc = float(counts[i, ks:ke][v].min())
            results[b] = Fragment(codes=seq, min_cov=mc, length=len(seq), connected=True)

    if params.extend_fragments:
        # -extend (FragmentAssembler, RNABloom.java:2264-2278): naive-extend
        # connected fragments outward, stopping at branches and tips
        rows = [b for b in range(B) if results[b] is not None]
        if rows:
            results = _naive_extend_fragments(graph, cfg, results, rows, params)
    return results


def _naive_extend_fragments(
    graph: GraphState, cfg: GraphConfig, results: List[Optional[Fragment]], rows: List[int], params: FragmentParams
) -> List[Optional[Fragment]]:
    """Extend each fragment right then left with branch-stopping walks:
    naive mode WITH back-branch checks (naiveExtendRight,
    GraphUtils.java:6835).  The buffer and the lane count pad to powers of
    two as in the JAX package: the padding decides when walks go FULL."""
    maxlen = max(results[b].length for b in rows)
    pad = 1 << max(8, (maxlen + 2 * params.bound - 1).bit_length())
    n_rows = 1 << max(6, (len(rows) - 1).bit_length())
    wcfg = traverse.WalkConfig(max_len=pad, lookahead=params.lookahead, check_back_branches=True)
    wcfg_l = traverse.WalkConfig(max_len=pad, lookahead=params.lookahead, left=True, check_back_branches=True)

    seeds = np.full((n_rows, maxlen), 4, np.uint8)
    lens = np.zeros(n_rows, np.int64)
    for i, b in enumerate(rows):
        f = results[b]
        seeds[i, : f.length] = f.codes
        lens[i] = f.length
    st = traverse.make_walks(cfg, wcfg, seeds, lens, device=engine.device_of(graph))
    st = engine.extend_walks(st, graph, cfg, wcfg, 1.0, params.bound, mode="naive")
    # the left extension re-seeds on the device
    st = traverse.revcomp_reseed(cfg, wcfg_l, st.buf, st.pos)
    st = engine.extend_walks(st, graph, cfg, wcfg_l, 1.0, params.bound, mode="naive")
    lbuf, lpos, _ = traverse.harvest(st)
    final = revcomp_rows(lbuf, lpos.astype(np.int64))

    for i, b in enumerate(rows):
        f = results[b]
        results[b] = Fragment(codes=final[i, : lpos[i]], min_cov=f.min_cov, length=int(lpos[i]), connected=f.connected)
    return results


def bridge_seeds(
    cfg: GraphConfig, left: np.ndarray, left_len: np.ndarray, right: np.ndarray, rows: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(right-walk seeds, left-walk seeds) of ``rows``: each left
    sequence's tail k-mer, and the reverse complement of each right
    sequence's head k-mer."""
    k = cfg.k
    seeds_r = np.stack([left[b, left_len[b] - k : left_len[b]] for b in rows]).astype(np.uint8)
    seeds_l = np.stack([sequtils.revcomp_codes(right[b, :k]) for b in rows]).astype(np.uint8)
    return seeds_r, seeds_l


def bridge_walk_configs(cfg: GraphConfig, params: FragmentParams):
    """(right, left) walk configs of the bridge walks."""
    k = cfg.k
    return (
        traverse.WalkConfig(max_len=k + params.bound, lookahead=params.lookahead),
        traverse.WalkConfig(max_len=k + params.bound, lookahead=params.lookahead, left=True),
    )


def bridge_pairs(
    graph: GraphState,
    cfg: GraphConfig,
    left: np.ndarray,
    left_len: np.ndarray,
    right: np.ndarray,
    right_len: np.ndarray,
    rows: np.ndarray,
    params: FragmentParams,
    overlaps: np.ndarray,
) -> dict:
    """Bidirectional gap bridging for ``rows`` (GraphUtils.connect
    :5092-5325).  Mutates ``overlaps`` in place for pairs that turn out to
    overlap; returns {row: gap codes} for bridged pairs."""
    k = cfg.k
    bridges: dict = {}
    if len(rows) == 0:
        return bridges
    seeds_r, seeds_l = bridge_seeds(cfg, left, left_len, right, rows)
    wcfg, wcfg_l = bridge_walk_configs(cfg, params)
    dev = engine.device_of(graph)
    nr = len(rows)
    if not cfg.stranded:
        # canonical hashing is strand-symmetric, so the left walks are more
        # right walks: both directions ride one walk batch
        st = traverse.make_walks(cfg, wcfg, np.concatenate([seeds_r, seeds_l]), device=dev)
        st = engine.extend_walks(st, graph, cfg, wcfg, 1.0, params.bound, mode="greedy")
        both, bpos, _ = traverse.harvest(st)
        buf, pos = both[:nr], bpos[:nr]
        buf_l, pos_l = both[nr : 2 * nr], bpos[nr : 2 * nr]
    else:
        st = traverse.make_walks(cfg, wcfg, seeds_r, device=dev)
        st = engine.extend_walks(st, graph, cfg, wcfg, 1.0, params.bound, mode="greedy")
        buf, pos, _ = traverse.harvest(st)
        buf, pos = buf[:nr], pos[:nr]
        st = traverse.make_walks(cfg, wcfg_l, seeds_l, device=dev)
        st = engine.extend_walks(st, graph, cfg, wcfg_l, 1.0, params.bound, mode="greedy")
        buf_l, pos_l, _ = traverse.harvest(st)
        buf_l, pos_l = buf_l[:nr], pos_l[:nr]

    # RW rows: left extension + right sequence's head k-mer, fragment
    # orientation
    rw_all = revcomp_rows(buf_l, pos_l.astype(np.int64))
    # (a) right head k-mer on the right-going walk
    idx_a = find_kmer_rows(buf, pos, np.stack([right[b, :k] for b in rows]))
    # (b) left tail k-mer on the left-going walk
    needles_b = np.stack([left[b, left_len[b] - k : left_len[b]] for b in rows])
    idx_b = find_kmer_rows(rw_all, pos_l, needles_b)

    for j, b in enumerate(rows):
        idx = int(idx_a[j])
        if idx >= 0:
            if idx >= k:
                bridges[b] = buf[j, k:idx]  # gap bases between the sequences
            else:
                overlaps[b] = k - idx  # sequences overlap by k - idx bases
            continue
        er = int(pos_l[j]) - k  # extension bases preceding the right sequence
        if er <= 0:
            continue
        rw = rw_all[j, : pos_l[j]]
        jdx = int(idx_b[j])
        if jdx >= 0:
            if jdx + k <= er:
                bridges[b] = rw[jdx + k : er]
            else:
                overlaps[b] = jdx + k - er
            continue
        # (c) meet in the middle: first shared k-mer between the walks; the
        # meeting k-mer must end before the right head (its on-head
        # placements are cases (a)/(b), already failed)
        lw = buf[j, : pos[j]]
        if len(lw) > k and er >= k:
            ij = _first_common_kmer(lw, rw[:er], k)
            if ij is not None:
                i, jj = ij
                bridges[b] = np.concatenate([lw[k : i + k], rw[jj + k : er]])
    return bridges


def connect_segments_batch(
    graph: GraphState,
    cfg: GraphConfig,
    segments: List[List[np.ndarray]],
    params: FragmentParams,
) -> List[np.ndarray]:
    """Re-join each read's quality-split segments through the graph
    (GraphUtils.connect(segments) :4836-4897).  Segments chain left to
    right by overlap or bridge walk, one wave of junctions per batch; when a
    junction fails the longest chain wins.  Returns one code array per
    read (empty for reads with no usable segment)."""
    k = cfg.k
    chains: List[np.ndarray] = [(segs[0] if segs else np.zeros(0, np.uint8)) for segs in segments]
    best: List[np.ndarray] = list(chains)
    max_segs = max((len(s) for s in segments), default=0)
    for wave in range(1, max_segs):
        rows = [
            i for i, segs in enumerate(segments)
            if len(segs) > wave and len(chains[i]) >= k and len(segs[wave]) >= k
        ]
        if not rows:
            break
        # power-of-two widths, as in the JAX package
        Lc = 1 << (max(max(len(chains[i]) for i in rows), k) - 1).bit_length()
        Rc = 1 << (max(max(len(segments[i][wave]) for i in rows), k) - 1).bit_length()
        B = len(rows)
        lbuf = np.full((B, Lc), 4, np.uint8)
        llen = np.zeros(B, np.int64)
        rbuf = np.full((B, Rc), 4, np.uint8)
        rlen = np.zeros(B, np.int64)
        for j, i in enumerate(rows):
            c, s = chains[i], segments[i][wave]
            lbuf[j, : len(c)] = c
            llen[j] = len(c)
            rbuf[j, : len(s)] = s
            rlen[j] = len(s)
        overlaps = find_overlaps(lbuf, llen, rbuf, rlen, params.min_overlap)
        need = np.flatnonzero(overlaps == 0)
        bridges = bridge_pairs(graph, cfg, lbuf, llen, rbuf, rlen, need, params, overlaps)
        for j, i in enumerate(rows):
            seg = segments[i][wave]
            if overlaps[j] > 0:
                chains[i] = np.concatenate([chains[i], seg[overlaps[j] :]])
            elif j in bridges:
                chains[i] = np.concatenate([chains[i], bridges[j], seg])
            else:
                # junction failed: the longest chain survives; restart
                if len(chains[i]) > len(best[i]):
                    best[i] = chains[i]
                chains[i] = seg
    for i in range(len(segments)):
        if len(chains[i]) > len(best[i]):
            best[i] = chains[i]
    return best


def revcomp_rows(buf: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Row-wise reverse complement of buf[b, :pos[b]], left-aligned
    (vectorized; pad stays 4)."""
    B, L = buf.shape
    j = np.arange(L)[None, :]
    src = np.clip(pos[:, None].astype(np.int64) - 1 - j, 0, L - 1)
    vals = np.take_along_axis(buf, src, axis=1)
    return np.where(
        j < pos[:, None], np.where(vals < 4, 3 - vals, 4), 4
    ).astype(np.uint8)


def find_kmer_rows(hay: np.ndarray, hay_len: np.ndarray, needle: np.ndarray) -> np.ndarray:
    """First index of ``needle[b]`` in ``hay[b, :hay_len[b]]`` per row, -1 if
    absent.  One (B, W) boolean AND-reduction per needle base replaces the
    per-row sliding-window scans."""
    B, W = hay.shape
    k = needle.shape[1]
    if W < k:
        return np.full(B, -1, np.int32)
    nW = W - k + 1
    match = np.ones((B, nW), bool)
    for j in range(k):
        match &= hay[:, j : j + nW] == needle[:, j : j + 1]
    match &= (np.arange(nW)[None, :] + k) <= hay_len[:, None]
    any_hit = match.any(axis=1)
    return np.where(any_hit, match.argmax(axis=1), -1).astype(np.int32)


def _first_common_kmer(
    lw: np.ndarray, rw: np.ndarray, k: int
) -> Optional[Tuple[int, int]]:
    """First (i, j) with lw[i:i+k] == rw[j:j+k]; j is the LAST occurrence in
    rw (shortest splice).  Host-side dict scan over two bounded walks."""
    if len(rw) < k:
        return None
    seen: dict = {}
    for j in range(len(rw) - k + 1):
        w = rw[j : j + k]
        if (w == 4).any():
            continue
        seen[w.tobytes()] = j  # later j wins
    if not seen:
        return None
    for i in range(len(lw) - k + 1):
        j = seen.get(lw[i : i + k].tobytes())
        if j is not None:
            return i, j
    return None


def _find_subarray(haystack: np.ndarray, needle: np.ndarray) -> int:
    n, m = len(haystack), len(needle)
    if m == 0 or n < m:
        return -1
    # vectorized sliding compare
    windows = np.lib.stride_tricks.sliding_window_view(haystack, m)
    hits = np.flatnonzero((windows == needle).all(axis=1))
    return int(hits[0]) if len(hits) else -1


def coverage_order_of_magnitude(c: float) -> int:
    """E0..E5 stratification (RNABloom.getCoverageOrderOfMagnitude :2353)."""
    if c >= 1e5:
        return 5
    if c >= 1e4:
        return 4
    if c >= 1e3:
        return 3
    if c >= 1e2:
        return 2
    if c >= 1e1:
        return 1
    return 0


def rescue_unconnected(
    graph: GraphState,
    cfg: GraphConfig,
    left: np.ndarray,
    left_len: np.ndarray,
    right: np.ndarray,
    right_len: np.ndarray,
    params: FragmentParams,
) -> List[Optional[Fragment]]:
    """Retry connecting unconnected read pairs against the rebuilt
    fragment graph (rescueUnconnectedMultiThreaded, RNABloom.java:
    2392-2668).  The caller corrects the reads against the read graph, so
    correction is skipped and only the overlap, graph-bridge and
    pair-validation steps run against ``graph`` (the stage-2b fragment
    graph, whose k-mers may bridge gaps the read graph could not)."""
    return assemble_fragments_batch(graph, cfg, left, left_len, right, right_len, params, error_correct=False)
