"""Overlap-layout: the nr pass's unitigs and the long-read uniqueOLC.

The port's copy of ``rnabloom_tpu/olc/layout.py``'s ``layout_unitigs``,
``stitch_path`` and the internal uniqueOLC flow
(olc/OverlapLayoutConsensus.uniqueOLC :1129-1228, the reference's
long-read stage 3, without external binaries):

  1. all-vs-all overlap + unique-read extraction
     (overlapWithMinimapAndExtractUnique :108, extractUniqueFromOverlaps
     Layout.java:1642 — containment + interior-depth screen)
  2. overlap unique reads -> unitigs (``layout_unitigs``:
     overlapWithMinimapAndLayoutSimple :500, extractSimplePaths
     Layout.java:3349; stage 3's nr pass runs it over the emitted
     transcripts, generateNonRedundantTranscripts RNABloom.java:5676)
  3. map all reads to unitigs (mapWithMinimapFiltered :661)
  4. polish unitigs by banded realignment (consensusWithRacon :849 -> see
     olc/consensus.py)
  5. overlap polished unitigs, prune with poly-A + binomial edge filter,
     lay out greedy max-weight paths (overlapWithMinimapAndLayoutGreedy
     :566, extractGreedyPaths Layout.java:3726)

The minimizer keys are hashed on the caller's device; the rest is host
numpy and dicts, as in the JAX package.  Each step's wall time goes to a
``utils/timer`` span: ``olc_overlaps``, ``olc_unique``, ``olc_unitigs``,
``olc_placement``, ``olc_polish`` and ``olc_layout``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..utils.timer import span
from . import consensus as cns
from .graph import build_graph, vid, vread
from .overlap import (
    KIND_Q_CONTAINED, KIND_T_CONTAINED, OverlapParams, Overlaps, classify_batch, extract_minimizers_reads,
    find_overlaps,
)

_RC = np.array([3, 2, 1, 0, 4], np.uint8)


@dataclass
class UniqueOLCResult:
    transcripts: List[np.ndarray]  # 2-bit codes
    counts: List[float]  # length-normalized read support per transcript
    n_unique: int = 0
    n_unitigs: int = 0
    n_paths: int = 0


def stitch_path(path: List[Tuple[int, int]], reads: Sequence[np.ndarray]) -> np.ndarray:
    """Overlay a layout path of (oriented vid, stitch offset)."""
    if len(path) == 1:
        v, _ = path[0]
        r = reads[vread(v)]
        return _RC[r[::-1]] if v & 1 else np.array(r, np.uint8)
    end = max(off + len(reads[vread(v)]) for v, off in path)
    out = np.full(end, 4, np.uint8)
    # later reads overwrite earlier ones in their overlap (the bases agree
    # but for residual errors)
    for v, off in path:
        r = reads[vread(v)]
        if v & 1:
            r = _RC[r[::-1]]
        out[off : off + len(r)] = r
    return out


def layout_unitigs(
    reads: Sequence[np.ndarray], k: int, params: OverlapParams, *, device
) -> Tuple[List[np.ndarray], List[List[Tuple[int, int]]], Set[int]]:
    """Unitigs (maximal unambiguous chains) over a read set, its minimizer
    keys hashed on ``device``.  Returns (unitig codes, paths, contained
    read ids)."""
    mins = extract_minimizers_reads(reads, k, params.w, device=device)
    overlaps = find_overlaps(mins, params)
    g, contained = build_graph(overlaps, mins.lengths, params)
    g.remove_redundant_nodes()
    g.remove_transitive_edges(fuzz=params.diag_band)
    paths = g.simple_paths()
    in_graph = {vread(v) for v in g.vertices()}
    unitigs = [stitch_path(p, reads) for p in paths]
    # reads with no dovetails and not contained pass through as unitigs
    for r in range(len(reads)):
        if r not in in_graph and r not in contained:
            unitigs.append(np.array(reads[r], np.uint8))
            paths.append([(vid(r, 0), 0)])
    return unitigs, paths, contained


def extract_unique(
    ov: Overlaps,
    lengths: np.ndarray,
    params: OverlapParams,
    min_seq_depth: int = 1,
    polya_flags: Optional[Sequence[bool]] = None,
) -> List[int]:
    """Reads that survive containment removal and the interior-depth screen.

    A read is contained when another read covers it end to end within
    max_overhang; contained reads carrying a poly-A tail are kept when
    their container has none (the reference's polyAInfoMap special case,
    Layout.java findContainedTargetOverlaps overloads).  With
    min_seq_depth > 1, reads whose interior is not covered by at least
    min_seq_depth-1 overlapping reads are dropped as unsupported.
    """
    n = len(lengths)
    bin_size = 100
    need_depth = min_seq_depth > 1
    depth = [None] * n  # per-read interior coverage histograms

    kinds = classify_batch(ov, np.asarray(lengths), params)
    ev = np.flatnonzero((kinds == KIND_Q_CONTAINED) | (kinds == KIND_T_CONTAINED))
    is_q = kinds[ev] == KIND_Q_CONTAINED
    reads_ev = np.where(is_q, ov.q[ev], ov.t[ev])
    partners = np.where(is_q, ov.t[ev], ov.q[ev])
    # first containment record per read wins (record order)
    uniq_r, first_idx = np.unique(reads_ev, return_index=True)
    contained_by: Dict[int, int] = dict(zip(uniq_r.tolist(), partners[first_idx].tolist()))
    if need_depth and len(ov):
        # range-add via +1/-1 difference marks + one global cumsum: every
        # read gets (bins + 1) slots, so each event's -1 lands in its own
        # read's range and nothing carries across reads
        bins = np.maximum(np.asarray(lengths, np.int64), 1) // bin_size + 1
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(bins + 1, out=offs[1:])
        acc = np.zeros(offs[-1] + 1, np.int32)
        for side_r, s0, e0 in ((ov.q, ov.q_start, ov.q_end), (ov.t, ov.t_start, ov.t_end)):
            start = offs[side_r] + s0 // bin_size
            stop = offs[side_r] + np.minimum(e0 // bin_size + 1, bins[side_r])
            np.add.at(acc, start, 1)
            np.add.at(acc, stop, -1)
        flat = np.cumsum(acc)
        depth = [flat[offs[r] : offs[r] + bins[r]] for r in range(n)]

    kept: List[int] = []
    for r in range(n):
        container = contained_by.get(r)
        if container is not None:
            if polya_flags is None or not polya_flags[r] or polya_flags[container]:
                continue
        if need_depth:
            h = depth[r]
            clip_bins = params.max_overhang // bin_size + 1
            interior = (
                h[clip_bins:-clip_bins] if h is not None and len(h) > 2 * clip_bins
                else (h if h is not None else np.zeros(1, np.int32))
            )
            if interior.size and int(interior.min()) < min_seq_depth - 1:
                continue
        kept.append(r)
    return kept


def unique_olc(
    reads: Sequence[np.ndarray],
    k: int,
    params: Optional[OverlapParams] = None,
    polya_flags: Optional[Sequence[bool]] = None,
    sample_lengths: Optional[np.ndarray] = None,
    min_seq_depth: int = 1,
    polish_min_depth: int = 2,
    polya_finder=None,
    seed_indices: Optional[Sequence[int]] = None,
    external_overlaps: Optional[Overlaps] = None,
    *,
    device,
) -> UniqueOLCResult:
    """Full internal uniqueOLC: unique reads -> unitigs -> polish ->
    greedy transcript layout, the minimizer keys hashed on ``device``.

    ``seed_indices``: run the unique-extraction/unitig steps over this
    subset only (the -lrsub seed reads; RNABloom.java:7424 passes the
    seed FASTA as uniqueOLC's input while ALL corrected reads are still
    mapped for polish and counts).

    ``external_overlaps``: precomputed ava overlap set (an interop PAF
    read back through io.paf.paf_to_overlaps) used for unique extraction
    instead of the internal minimizer engine (ignored when seeding)."""
    params = params or OverlapParams()
    if not reads:
        return UniqueOLCResult([], [])
    with span("olc_overlaps"):
        all_mins = extract_minimizers_reads(reads, k, params.w, device=device)
        lens = all_mins.lengths

    # 1. unique-read extraction (over the seeds when subsampling)
    if seed_indices is not None:
        sub = list(seed_indices)
        with span("olc_overlaps"):
            s_mins = extract_minimizers_reads([reads[i] for i in sub], k, params.w, device=device)
            overlaps = find_overlaps(s_mins, params)
        s_polya = [polya_flags[i] for i in sub] if polya_flags is not None else None
        with span("olc_unique"):
            kept_sub = extract_unique(overlaps, s_mins.lengths, params, min_seq_depth, s_polya)
        kept = [sub[i] for i in kept_sub] or sub
    else:
        # external ava overlaps (a minimap2 PAF through io.paf.paf_to_overlaps)
        # stand in for the internal engine in the unique-extraction step —
        # the reference's overlap source (olc/OverlapLayoutConsensus.java:78-106)
        with span("olc_overlaps"):
            overlaps = external_overlaps if external_overlaps is not None else find_overlaps(all_mins, params)
        with span("olc_unique"):
            kept = extract_unique(overlaps, lens, params, min_seq_depth, polya_flags)
        if not kept:
            kept = list(range(len(reads)))
    unique_reads = [reads[i] for i in kept]

    # 2. unitigs over unique reads
    with span("olc_unitigs"):
        unitigs, _, _ = layout_unitigs(unique_reads, k, params, device=device)
    if not unitigs:
        return UniqueOLCResult([], [], n_unique=len(kept))

    # 3. map ALL reads to unitigs
    with span("olc_placement"):
        umins = extract_minimizers_reads(unitigs, k, params.w, device=device)
        placements = cns.place_reads(all_mins, umins, lens, params)

    # 4. polish
    with span("olc_polish"):
        polished = cns.polish(unitigs, reads, placements, min_depth=polish_min_depth, device=device)

    # 5. greedy layout over polished unitigs
    with span("olc_layout"):
        return _greedy_transcripts(
            polished, placements, k, params, sample_lengths, polya_finder,
            n_unique=len(kept), n_unitigs=len(unitigs), device=device,
        )


def _greedy_transcripts(
    polished: Sequence[np.ndarray],
    placements,
    k: int,
    params: OverlapParams,
    sample_lengths: Optional[np.ndarray],
    polya_finder,
    n_unique: int = 0,
    n_unitigs: int = 0,
    *,
    device,
) -> UniqueOLCResult:
    """Step 5 of uniqueOLC: overlap the polished unitigs and extract
    binomial-filtered greedy max-weight paths."""
    pmins = extract_minimizers_reads(polished, k, params.w, device=device)
    plens = pmins.lengths
    p_overlaps = find_overlaps(pmins, params)
    g, p_contained = build_graph(p_overlaps, plens, params)
    g.remove_redundant_nodes()
    g.remove_transitive_edges(fuzz=params.diag_band)
    if polya_finder is not None:
        g.prune_polya([polya_finder(u) for u in polished])
    read_counts = cns.normalized_read_counts(placements, plens)
    g.add_mapping_support(cns.junction_placements(placements))
    if sample_lengths is not None and len(sample_lengths):
        g.filter_edges_binomial(read_counts, np.asarray(sample_lengths))

    transcripts: List[np.ndarray] = []
    counts: List[float] = []
    in_graph = {vread(v) for v in g.vertices()}
    greedy = g.greedy_paths(read_counts)
    for path, c in greedy:
        transcripts.append(stitch_path(path, polished))
        counts.append(c)
    for u in range(len(polished)):
        if u not in in_graph and u not in p_contained:
            transcripts.append(np.array(polished[u], np.uint8))
            counts.append(read_counts.get(u, 0.0))
    return UniqueOLCResult(
        transcripts=transcripts, counts=counts, n_unique=n_unique, n_unitigs=n_unitigs, n_paths=len(greedy),
    )
