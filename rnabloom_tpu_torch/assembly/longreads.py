"""Long-read (ONT/PacBio) correction and subsampling.

Port of ``rnabloom_tpu/assembly/longreads.py``, the stage-2 equivalent of
LongReadCorrectionWorker / correctLongSequenceWindowed (RNABloom.java:
3671-3868, GraphUtils.java:3021-3186): long reads are noisy, so their
k-mers split into "solid" runs (count >= threshold in the graph built from
all long reads) separated by error gaps.  Per read:

  1. poly-A/T orientation onto the sense strand (PolyATailFinder),
  2. low-complexity region splitting,
  3. solid-segment extraction + graph bridging of short gaps (bounded greedy
     walk from the left segment anchored by the right segment's first solid
     k-mer — the windowed re-assembly of correctLongSequenceWindowed),
  4. zero-coverage splits (assembleValidKmers / findGaps) where bridging
     fails, emitting the corrected segments.

The count queries are plain torch on the graph's device and the bridge and
edge walks are greedy walks (the walk kernel on the card); the rest is host
numpy, as in the JAX package.

Also the subsamplers of ``-lrsub`` (SeqSubsampler): a sequential
longest-first novelty gate over a host count-min table, keyed by k-mers
(``kmerBased`` :120), strobemers (``strobemerBased`` :339) or window
minimizers (``minimizerBased`` :50), and the greedy minimal covering set
(``minimalSet`` :483).  The k-mer and strobemer keys come from
``ops/lr_keys.py`` (the hand-written kernels on the card), 32-bit as in the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..graph import engine, traverse
from ..graph.dbg import GraphConfig, GraphState
from ..ops import lr_keys, nthash
from ..utils import polya, seq as sequtils
from . import artifacts

@dataclass
class LongReadParams:
    min_kmer_cov: float = 2.0  # solid k-mer threshold
    max_gap: int = 200  # bridgeable error gap (bases)
    min_segment_kmers: int = 5  # min solid run to anchor on
    min_seq_len: int = 200
    window: int = 500  # correction window (parity with the reference)
    batch_size: int = 64
    orient: bool = True


def _solid_runs(solid: np.ndarray, min_run: int) -> List[Tuple[int, int]]:
    padded = np.concatenate(([False], solid, [False]))
    d = np.diff(padded.astype(np.int8))
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    return [(s, e) for s, e in zip(starts, ends) if e - s >= min_run]


def correct_batch(
    graph: GraphState,
    cfg: GraphConfig,
    reads: List[np.ndarray],
    params: LongReadParams,
) -> List[List[np.ndarray]]:
    """Correct a batch of long reads; returns corrected segments per read."""
    k = cfg.k
    L = max((len(r) for r in reads), default=0)
    L = max(L, k + 1)
    B = len(reads)
    codes = np.full((B, L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
    counts_d, valid_d = engine.count_step(graph, cfg, codes)
    counts = counts_d.cpu().numpy()
    valid = valid_d.cpu().numpy()

    # collect bridge jobs: (read, left_run_end, right_run_start)
    per_read_runs: List[List[Tuple[int, int]]] = []
    bridge_jobs: List[Tuple[int, int, int]] = []
    edge_jobs: List[Tuple[int, int, int]] = []  # (read, side 0=L/1=R, bound)
    for b, r in enumerate(reads):
        n = max(len(r) - k + 1, 0)
        solid = (counts[b, :n] >= params.min_kmer_cov) & valid[b, :n]
        runs = _solid_runs(solid, params.min_segment_kmers)
        per_read_runs.append(runs)
        for j in range(len(runs) - 1):
            gap = runs[j + 1][0] - runs[j][1]
            if 0 < gap <= params.max_gap:
                bridge_jobs.append((b, j, j + 1))
        # edge re-walks: anchoring on full min_segment_kmers runs clips
        # every read's raw ends (~50-150 bp at 7% error), which erased
        # short transcripts' termini from the whole corrected set.  The
        # graph knows the true terminus (its coverage ends where the
        # transcript does), so walk outward from the first/last anchor,
        # bounded by the raw edge length + indel slack — the windowed
        # corrector's tip repair (correctLongSequenceWindowed edge
        # windows, GraphUtils.java:3125-3161), not a raw-bases passthrough
        if runs:
            lhead = runs[0][0]
            if lhead > 0:
                edge_jobs.append((b, 0, min(lhead + 8, params.max_gap)))
            rtail = n - runs[-1][1]
            if rtail > 0:
                edge_jobs.append((b, 1, min(rtail + 8, params.max_gap)))

    # batched bridge walks (left run tail -> right run head anchor)
    bridges: dict = {}
    if bridge_jobs:
        seeds = np.zeros((len(bridge_jobs), k), np.uint8)
        anchors = []
        for i, (b, jl, jr) in enumerate(bridge_jobs):
            le = per_read_runs[b][jl][1]  # left run end (kmer idx, excl)
            seeds[i] = reads[b][le - 1 : le - 1 + k]
            rs = per_read_runs[b][jr][0]
            anchors.append(reads[b][rs : rs + k])
        wcfg = traverse.WalkConfig(max_len=k + params.max_gap + k)
        st = traverse.make_walks(cfg, wcfg, seeds, device=graph.cbf.device)
        st = engine.extend_walks(
            st, graph, cfg, wcfg, params.min_kmer_cov, params.max_gap + k, mode="greedy"
        )
        buf, pos, _ = traverse.harvest(st)
        for i, (b, jl, jr) in enumerate(bridge_jobs):
            walk = buf[i, : pos[i]]
            hit = _find(walk, anchors[i])
            if hit >= k:
                bridges[(b, jl)] = ("gap", walk[k:hit])
            elif hit >= 0:
                # anchor overlaps the seed tail: trim the right run's head
                bridges[(b, jl)] = ("overlap", k - hit)

    # batched edge walks (left edges walk the reverse complement)
    edges: dict = {}
    if edge_jobs:
        eseeds = np.zeros((len(edge_jobs), k), np.uint8)
        for i, (b, side, _bound) in enumerate(edge_jobs):
            runs = per_read_runs[b]
            if side == 0:
                s0 = runs[0][0]
                eseeds[i] = sequtils.revcomp_codes(reads[b][s0 : s0 + k])
            else:
                e0 = runs[-1][1]
                eseeds[i] = reads[b][e0 - 1 : e0 - 1 + k]
        ebounds = np.zeros((1 << max(6, (len(edge_jobs) - 1).bit_length()),), np.int32)
        ebounds[: len(edge_jobs)] = [j[2] for j in edge_jobs]
        ewcfg = traverse.WalkConfig(max_len=k + params.max_gap + 8)
        est = traverse.make_walks(cfg, ewcfg, eseeds, device=graph.cbf.device)
        est = engine.extend_walks(est, graph, cfg, ewcfg, params.min_kmer_cov, ebounds, mode="greedy")
        ebuf, epos, _ = traverse.harvest(est)
        for i, (b, side, _bound) in enumerate(edge_jobs):
            ext = ebuf[i, k : epos[i]]
            if len(ext):
                edges[(b, side)] = (
                    sequtils.revcomp_codes(ext) if side == 0 else ext
                )

    # stitch per read.  An unbridgeable gap KEEPS the original bases — the
    # reference's windowed corrector emits the uncorrected window when
    # repair fails (correctLongSequenceWindowed, GraphUtils.java:3155-3161)
    # and never splits the read mid-correction; splitting only at gaps
    # longer than max_gap (previously every failed bridge split the read,
    # which shattered 7%-error reads into sub-window scraps and collapsed
    # long-read assembly recall to ~0).
    out: List[List[np.ndarray]] = []
    for b, r in enumerate(reads):
        runs = per_read_runs[b]
        if not runs:
            out.append([])
            continue
        segments: List[np.ndarray] = []
        cur = [r[runs[0][0] : runs[0][1] + k - 1]]
        ledge = edges.get((b, 0))
        if ledge is not None:
            cur.insert(0, ledge)
        for j in range(len(runs) - 1):
            e = runs[j][1]
            s2 = runs[j + 1][0]
            nxt = r[s2 : runs[j + 1][1] + k - 1]
            fix = bridges.get((b, j))
            if fix is None:
                if s2 - e > params.max_gap:
                    segments.append(np.concatenate(cur))
                    cur = [nxt]
                else:
                    # keep the original (uncorrected) gap bases
                    join = e + k - 1  # first base not yet emitted
                    if s2 >= join:
                        cur.append(r[join:s2])
                        cur.append(nxt)
                    else:
                        cur.append(nxt[join - s2 :])
            elif fix[0] == "gap":
                cur.append(fix[1])
                cur.append(nxt)
            else:  # overlap: drop the duplicated head of the right run
                trim = fix[1]
                cur.append(nxt[trim:] if trim < len(nxt) else nxt[:0])
        redge = edges.get((b, 1))
        if redge is not None:
            cur.append(redge)
        segments.append(np.concatenate(cur))
        out.append([s for s in segments if len(s) >= k])
    return out


def _find(haystack: np.ndarray, needle: np.ndarray) -> int:
    n, m = len(haystack), len(needle)
    if m == 0 or n < m:
        return -1
    win = np.lib.stride_tricks.sliding_window_view(haystack, m)
    hits = np.flatnonzero((win == needle).all(axis=1))
    return int(hits[0]) if len(hits) else -1


@dataclass
class LongCorrectionResult:
    """Corrected reads split the reference's way
    (CorrectedLongReadsWriterWorker2.writeToFile, RNABloom.java:3525-3546):
    ``long`` segments (>= min_seq_len, the OLC input), ``short`` segments
    (corrected but below the length threshold), and ``repeats`` — reads
    whose entire sequence is low-complexity (LongReadCorrectionWorker
    :3768-3772), kept verbatim."""

    long: List[np.ndarray]
    polya: List[bool]
    short: List[np.ndarray]
    short_polya: List[bool]
    repeats: List[np.ndarray]


def correct_long_reads(
    graph: GraphState,
    cfg: GraphConfig,
    reads: List[np.ndarray],
    params: LongReadParams,
) -> LongCorrectionResult:
    """Full long-read stage 2 over a chunk of reads.

    Reads are oriented, low-complexity-split, graph-corrected, and
    rc-artifact-trimmed; corrected segments are classified long/short by
    ``min_seq_len`` and fully-low-complexity reads go to ``repeats``.
    """
    oriented: List[np.ndarray] = []
    polya_flags: List[bool] = []
    repeats: List[np.ndarray] = []
    for r in reads:
        if params.orient:
            r, has_tail, _ = polya.orient_long_read(r)
        else:
            has_tail = False
        segs = artifacts.extract_non_low_complexity_segments(
            r, min_len=params.min_seq_len
        )
        if not segs:
            if len(r) >= cfg.k:
                repeats.append(r)
            continue
        if len(segs) > 1:
            has_tail = False  # multi-segment: tail ownership is ambiguous
        for s, e in segs:
            oriented.append(r[s:e])
            polya_flags.append(has_tail)

    result = LongCorrectionResult([], [], [], [], repeats)
    B = params.batch_size
    for s in range(0, len(oriented), B):
        chunk = oriented[s : s + B]
        segs = correct_batch(graph, cfg, chunk, params)
        for i, seglist in enumerate(segs):
            multi = len(seglist) > 1
            for seg in seglist:
                seg = artifacts.trim_rc_artifact(seg, k=cfg.k)
                if len(seg) < cfg.k:
                    continue
                fl = polya_flags[s + i] and not multi
                if len(seg) >= params.min_seq_len:
                    result.long.append(seg)
                    result.polya.append(fl)
                else:
                    result.short.append(seg)
                    result.short_polya.append(fl)
    return result


def _np_multi_hash(base: np.ndarray, k: int, m: int) -> np.ndarray:
    """Vectorized NTM64 multi-hash on host: (N,) u64 -> (N, m) u64."""
    seed, shift = np.uint64(nthash.MULTI_SEED), np.uint64(nthash.MULTI_SHIFT)
    out = np.empty((base.shape[0], m), np.uint64)
    out[:, 0] = base
    with np.errstate(over="ignore"):
        for i in range(1, m):
            t = base * (np.uint64(i) ^ (np.uint64(k) * seed))
            t = t ^ (t >> shift)
            out[:, i] = t
    return out


def _host_gate(
    per_read_keys,
    k: int,
    max_multiplicity: int,
    sketch_log2: int,
    num_hash: int = 2,
) -> List[int]:
    """Sequential longest-first novelty gate over a host count-min table
    (the reference subsamplers are order-dependent sequential scans)."""
    table = np.zeros((1 << sketch_log2) + 1, np.int32)
    mask = np.uint64((1 << sketch_log2) - 1)
    order = sorted(range(len(per_read_keys)), key=lambda i: -per_read_keys[i].shape[0])
    keep: List[int] = []
    for i in order:
        keys = per_read_keys[i]
        if keys.size == 0:
            continue
        hs = _np_multi_hash(keys, k, num_hash)
        idx = ((hs >> np.uint64(1)) & mask).astype(np.int64)
        c = table[idx].min(axis=1)
        if (c < max_multiplicity).any():
            keep.append(i)
            np.add.at(table, idx.ravel(), 1)
    return sorted(keep)


def subsample_minimizer_based(
    cfg: GraphConfig,
    reads: List[np.ndarray],
    max_multiplicity: int = 5,
    w: int = 10,
    sketch_log2: int = 24,
    *,
    device,
) -> List[int]:
    """Minimizer-novelty subsampling (SeqSubsampler.minimizerBased :50):
    a read is kept iff any of its window minimizers has been seen fewer
    than max_multiplicity times.  The keys are hashed on ``device``."""
    from ..olc import overlap as olc_overlap

    keys = [np.empty(0, np.uint64)] * len(reads)
    usable = [i for i, r in enumerate(reads) if len(r) >= cfg.k + w]
    if usable:
        L = max(len(reads[i]) for i in usable)
        codes = np.full((len(usable), L), 4, np.uint8)
        lens = np.zeros(len(usable), np.int32)
        for j, i in enumerate(usable):
            codes[j, : len(reads[i])] = reads[i]
            lens[j] = len(reads[i])
        mins = olc_overlap.extract_minimizers(codes, lens, cfg.k, w, device=device)
        for j, i in enumerate(usable):
            keys[i] = mins.key[mins.read == j]
    return _host_gate(keys, cfg.k, max_multiplicity, sketch_log2)


def minimal_set(cfg: GraphConfig, reads: List[np.ndarray], sketch_log2: int = 24, *, device) -> List[int]:
    """Greedy minimal covering set (SeqSubsampler.minimalSet :483): visit
    reads longest-first, keep a read only if it contributes at least one
    unseen k-mer."""
    keys = lr_keys.kmer_keys(reads, cfg.k, cfg.stranded, device=device)
    return _host_gate(keys, cfg.k, 1, sketch_log2)


def subsample_strobemer_based(
    cfg: GraphConfig,
    reads: List[np.ndarray],
    max_multiplicity: int = 5,
    n: int = 3,
    w_min: int = 11,
    w_max: int = 50,
    sketch_log2: int = 24,
    *,
    device,
) -> List[int]:
    """Strobemer-novelty subsampling (SeqSubsampler.strobemerBased :339):
    like the k-mer variant but keyed by randstrobe hashes, which tolerate
    long-read indels between strobes."""
    keys = lr_keys.strobemer_keys(reads, cfg.k, n, w_min, w_max, cfg.stranded, device=device)
    return _host_gate(keys, cfg.k, max_multiplicity, sketch_log2)


def subsample_kmer_based(
    cfg: GraphConfig,
    reads: List[np.ndarray],
    max_multiplicity: int = 5,
    sketch_log2: int = 24,
    *,
    device,
) -> List[int]:
    """Indices of reads kept by k-mer novelty (SeqSubsampler.kmerBased).

    Reads are visited longest-first; a read is kept iff any of its k-mers
    has been counted < max_multiplicity times, then its k-mers are counted.
    """
    keys = lr_keys.kmer_keys(reads, cfg.k, cfg.stranded, device=device)
    return _host_gate(keys, cfg.k, max_multiplicity, sketch_log2)
