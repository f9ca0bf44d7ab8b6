"""Read-to-unitig mapping and pileup consensus polish.

The port's copy of ``rnabloom_tpu/olc/consensus.py``, the reference's step
3+4 of uniqueOLC: minimap2 read->unitig mapping
(olc/OverlapLayoutConsensus.java:661 mapWithMinimapFiltered) and racon
consensus (:849 consensusWithRacon).  ``polish`` realigns every placed
read to its unitig in a narrow diagonal band and applies majority
substitution and indel edits (host numpy, ``olc/realign.py``, as in the
JAX package); with ``indel_band=0`` it takes a column-majority vote per
batch of reads instead (``ops/consensus_vote.py``: the hand-written kernel
on the card).

Also derives the per-unitig length-normalized read counts used by the
greedy layout's edge filter (PafUtils.getLengthNormalizedReadCounts :352).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.consensus_vote import consensus_vote
from . import realign
from .overlap import Minimizers, OverlapParams, map_to_targets


@dataclass
class Placement:
    """A read placed on a unitig, in unitig-forward coordinates."""

    read: int
    target: int
    orient: int  # 0: read forward, 1: read reverse-complemented
    start: int  # unitig position of the (oriented) read's first base
    q_start: int  # aligned span on the read's forward strand
    q_end: int
    t_start: int  # aligned span on the unitig
    t_end: int


def place_reads(
    read_mins: Minimizers, unitig_mins: Minimizers, read_lengths: np.ndarray, params: OverlapParams
) -> List[Placement]:
    """Best placement of each read onto the unitig set (selection and
    geometry vectorized over the whole overlap set)."""
    ov = map_to_targets(read_mins, unitig_mins, params)
    n = len(ov)
    if n == 0:
        return []
    # best strand per (q, t) by shared count, first (forward) wins ties —
    # _chain emits rows in (q, t, strand) lexicographic order, so groups
    # are contiguous
    newg = np.ones(n, bool)
    newg[1:] = (ov.q[1:] != ov.q[:-1]) | (ov.t[1:] != ov.t[:-1])
    gid = np.cumsum(newg) - 1
    ngroups = int(gid[-1]) + 1
    best = np.zeros(ngroups, np.int64)
    np.maximum.at(best, gid, ov.shared)
    cand = np.flatnonzero(ov.shared == best[gid])
    first = np.ones(len(cand), bool)
    first[1:] = gid[cand][1:] != gid[cand][:-1]
    sel = cand[first]

    rl = np.asarray(read_lengths, np.int64)[ov.q[sel]]
    fwd = ov.strand[sel] == 1
    start = np.where(fwd, ov.t_start[sel] - ov.q_start[sel], ov.t_start[sel] - (rl - ov.q_end[sel]))
    orient = (~fwd).astype(np.int64)
    return [
        Placement(
            read=int(ov.q[sel[i]]), target=int(ov.t[sel[i]]),
            orient=int(orient[i]), start=int(start[i]),
            q_start=int(ov.q_start[sel[i]]), q_end=int(ov.q_end[sel[i]]),
            t_start=int(ov.t_start[sel[i]]), t_end=int(ov.t_end[sel[i]]),
        )
        for i in range(len(sel))
    ]


_RC = np.array([3, 2, 1, 0, 4], np.uint8)


def polish(
    unitigs: Sequence[np.ndarray],
    reads: Sequence[np.ndarray],
    placements: Sequence[Placement],
    min_depth: int = 2,
    batch_reads: int = 2048,
    indel_band: int = 16,
    max_error: float = 0.35,
    *,
    device,
) -> List[np.ndarray]:
    """Consensus over placed reads (racon's role).

    With ``indel_band`` > 0 every placed read realigns to its unitig in a
    narrow diagonal band and the alignments vote on substitutions AND
    indels (host numpy).  ``indel_band`` = 0 takes the column vote on
    ``device`` (gapless placements): ``batch_reads`` reads a batch, each
    batch a fresh vote table over the previous batch's polished codes, so
    votes do not add up across batches and ``min_depth`` applies per
    batch.  ``max_error`` drops alignments with more edits than this
    fraction of the read.
    """
    if not unitigs:
        return []
    U = len(unitigs)
    placed = [p for p in placements if 0 <= p.target < U]
    if not placed:
        return [np.array(u, np.uint8) for u in unitigs]
    if indel_band > 0:
        return _indel_polish(
            [np.asarray(u, np.uint8) for u in unitigs], reads, placed, min_depth, batch_reads, indel_band, max_error,
        )

    L = max(len(u) for u in unitigs)
    ucodes = np.full((U, L), 4, np.uint8)
    for i, u in enumerate(unitigs):
        ucodes[i, : len(u)] = u
    Lr = max(len(reads[p.read]) for p in placed)
    polished = torch.from_numpy(ucodes).to(device)
    for s in range(0, len(placed), batch_reads):
        chunk = placed[s : s + batch_reads]
        rcodes = np.full((len(chunk), Lr), 4, np.uint8)
        tgt = np.zeros(len(chunk), np.int32)
        start = np.zeros(len(chunk), np.int32)
        for i, p in enumerate(chunk):
            r = reads[p.read]
            if p.orient == 1:
                r = _RC[r[::-1]]
            rcodes[i, : len(r)] = r
            tgt[i] = p.target
            start[i] = p.start
        polished, _ = consensus_vote(
            polished, torch.from_numpy(rcodes).to(device), torch.from_numpy(tgt).to(device),
            torch.from_numpy(start).to(device), min_depth,
        )
    out = polished.cpu().numpy()
    return [out[i, : len(unitigs[i])].copy() for i in range(U)]


def _indel_polish(
    unitigs: List[np.ndarray],
    reads: Sequence[np.ndarray],
    placed: Sequence[Placement],
    min_depth: int,
    batch_reads: int,
    w: int,
    max_error: float,
) -> List[np.ndarray]:
    """Banded realignment + majority indel/substitution edits
    (consensusWithRacon's indel repair, OverlapLayoutConsensus.java:849).
    A frameshift in the unitig's backbone read shows up as a majority
    insertion/deletion vote at one column and is excised."""
    U = len(unitigs)
    ulens = np.asarray([len(u) for u in unitigs], np.int64)
    Lmax = int(ulens.max(initial=0))
    base_v = np.zeros((U, Lmax, 4), np.int32)
    del_v = np.zeros((U, Lmax), np.int32)
    ins_v = np.zeros((U, Lmax + 1, 4), np.int32)
    cov = np.zeros((U, Lmax), np.int32)

    Lr = max(len(reads[p.read]) for p in placed)
    for s in range(0, len(placed), batch_reads):
        chunk = placed[s : s + batch_reads]
        R = len(chunk)
        rcodes = np.full((R, Lr), 4, np.uint8)
        rlens = np.zeros(R, np.int32)
        wins = np.full((R, Lr + 2 * w), 4, np.uint8)
        wstart = np.zeros(R, np.int32)
        tgt = np.zeros(R, np.int32)
        for i, p in enumerate(chunk):
            r = reads[p.read]
            if p.orient == 1:
                r = _RC[r[::-1]]
            rcodes[i, : len(r)] = r
            rlens[i] = len(r)
            tgt[i] = p.target
            # window leads the read by w bases (band center)
            s0 = p.start - w
            wstart[i] = s0
            u = unitigs[p.target]
            a, b = max(s0, 0), min(s0 + Lr + 2 * w, len(u))
            if b > a:
                wins[i, a - s0 : b - s0] = u[a:b]
        tb, end_off, dist = realign.banded_align_batch(rcodes, rlens, wins, w)
        bv, dv, iv, cv = realign.alignment_votes(
            tb, end_off, rcodes, rlens, wstart, tgt, ulens, w,
            np.maximum((rlens * max_error).astype(np.int32), 4), dist,
        )
        base_v += bv
        del_v += dv
        ins_v += iv
        cov += cv
    return realign.apply_edits(unitigs, base_v, del_v, ins_v, cov, min_depth)


def normalized_read_counts(placements: Sequence[Placement], unitig_lengths: np.ndarray) -> Dict[int, float]:
    """Per-unitig count: each read adds aligned_span / unitig_length,
    split across targets when it maps to several (multimap split)."""
    by_read: Dict[int, List[Placement]] = {}
    for p in placements:
        by_read.setdefault(p.read, []).append(p)
    counts: Dict[int, float] = {}
    for hits in by_read.values():
        share = 1.0 / len(hits)
        for p in hits:
            tl = float(unitig_lengths[p.target])
            if tl > 0:
                inc = share * (p.t_end - p.t_start) / tl
                counts[p.target] = counts.get(p.target, 0.0) + inc
    return counts


def junction_placements(placements: Sequence[Placement]) -> List[Tuple[int, int, int, int, int]]:
    """(read, target, orient, q_start, q_end) tuples for
    OverlapGraph.add_mapping_support."""
    return [(p.read, p.target, p.orient, p.q_start, p.q_end) for p in placements]
