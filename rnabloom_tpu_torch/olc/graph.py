"""Stranded overlap graph over long reads, unitigs or transcripts.

The port's copy of ``rnabloom_tpu/olc/graph.py`` (what the nr pass's
``layout_unitigs`` and the long-read OLC call), host-side numpy and
dicts: vertices are oriented reads
(read id x strand), edges are dovetail overlaps, and the reverse-complement
mirror of every edge is kept so paths can be extracted from either strand
(olc/Layout.java's JGraphT graph, Layout.java:80-101, addEdges
:2543-2753).

  remove_transitive_edges   <- removeTransitiveEdges (Layout.java:235)
  remove_redundant_nodes    <- removeRedundantNodes/isRedundantNode (:274-:407)
  resolve_junctions         <- resolveJunctions (:409)
  prune_polya               <- pruneGraphWithPolyAInfo (:3529-3672)
  filter_edges_binomial     <- filterEdges (:3673-3724)
  simple_paths              <- extractSimplePaths (:3349)
  greedy_paths              <- extractGreedyPaths/getMaxWeightExtension (:3726-3995)
  add_mapping_support       <- updateCounts edge-weight increments (:4395-4415)

The edge filter takes an empirical CDF of the read lengths and a
log-gamma binomial tail (the reference uses the smile library's
distributions).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .overlap import (
    KIND_DOVETAIL, KIND_Q_CONTAINED, KIND_T_CONTAINED, OverlapParams, OverlapRecord, Overlaps, classify,
    classify_batch, oriented_t_coords,
)


def vid(read: int, orient: int) -> int:
    """Oriented vertex id: orient 0 = forward, 1 = reverse complement."""
    return read * 2 + orient


def vread(v: int) -> int:
    return v >> 1


def vrc(v: int) -> int:
    return v ^ 1


@dataclass
class Edge:
    offset: int  # sink read's start in source-oriented coordinates
    ovl: float  # mean overlap span (bases) across source/sink
    support: int  # shared minimizers from the ava join
    weight: float = 0.0  # reads spanning the junction (mapping evidence)


@dataclass
class OverlapGraph:
    lengths: np.ndarray  # per-read length
    out: Dict[int, Dict[int, Edge]] = field(default_factory=dict)
    inn: Dict[int, Dict[int, Edge]] = field(default_factory=dict)

    def _add_edge(self, u: int, v: int, e: Edge) -> None:
        cur = self.out.setdefault(u, {}).get(v)
        if cur is None or e.support > cur.support:
            self.out.setdefault(u, {})[v] = e
            self.inn.setdefault(v, {})[u] = e

    def _remove_edge(self, u: int, v: int) -> None:
        self.out.get(u, {}).pop(v, None)
        self.inn.get(v, {}).pop(u, None)

    def add_overlap(self, rec: OverlapRecord, params: OverlapParams) -> Optional[str]:
        """Insert a dovetail overlap (and its rc mirror); returns the
        classification so callers can tally containments."""
        q_len = int(self.lengths[rec.q])
        t_len = int(self.lengths[rec.t])
        kind = classify(rec, q_len, t_len, params)
        if kind != "dovetail":
            return kind
        ot_s, ot_e = oriented_t_coords(rec, t_len)
        t_orient = 0 if rec.strand == 1 else 1
        ovl = ((rec.q_end - rec.q_start) + (ot_e - ot_s)) / 2.0
        if rec.q_start > ot_s:
            u, v = vid(rec.q, 0), vid(rec.t, t_orient)
            off = rec.q_start - ot_s
            lu, lv = q_len, t_len
        else:
            u, v = vid(rec.t, t_orient), vid(rec.q, 0)
            off = ot_s - rec.q_start
            lu, lv = t_len, q_len
        if off <= 0 or off + lv <= lu:
            return "internal"  # not a proper extension
        self._add_edge(u, v, Edge(offset=off, ovl=ovl, support=rec.shared))
        # rc mirror: reversing the 2-read layout swaps and flips both
        self._add_edge(vrc(v), vrc(u), Edge(offset=off + lv - lu, ovl=ovl, support=rec.shared))
        return "dovetail"

    def vertices(self) -> List[int]:
        return sorted(set(self.out.keys()) | set(self.inn.keys()))

    def num_edges(self) -> int:
        return sum(len(d) for d in self.out.values())

    def out_of(self, u: int) -> Dict[int, Edge]:
        return self.out.get(u, {})

    def in_of(self, v: int) -> Dict[int, Edge]:
        return self.inn.get(v, {})

    def remove_transitive_edges(self, fuzz: int = 100) -> int:
        """Myers-style reduction: drop u->x when u->w->x explains it."""
        removed = []
        for u in self.vertices():
            outs = self.out_of(u)
            if len(outs) < 2:
                continue
            targets = dict(outs)
            for w, e_uw in sorted(outs.items(), key=lambda kv: kv[1].offset):
                for x, e_wx in self.out_of(w).items():
                    if x == u or x not in targets or x == w:
                        continue
                    implied = e_uw.offset + e_wx.offset
                    if abs(implied - targets[x].offset) <= fuzz:
                        removed.append((u, x))
                        del targets[x]
        for u, x in removed:
            self._remove_edge(u, x)
            self._remove_edge(vrc(x), vrc(u))
        return len(removed)

    def _consistent(self, d: float, d2: float, tol: float = 0.9) -> bool:
        return max(d, d2) * tol <= min(d, d2)

    def is_redundant_node(self, v: int) -> bool:
        """Node bridged by a direct predecessor->successor edge
        (isRedundantNode, Layout.java:287-407)."""
        ins = self.in_of(v)
        outs = self.out_of(v)
        if not ins or not outs:
            return False
        # closest predecessor/successor = largest overlap
        p0 = max(ins, key=lambda p: ins[p].ovl)
        s0 = max(outs, key=lambda s: outs[s].ovl)
        if s0 not in self.out_of(p0):
            return False
        succ_set = set(outs)
        bridged_preds: Set[int] = set()
        bridged_succs: Set[int] = set()
        pending_preds: Set[int] = set()
        for p in ins:
            in_edge = ins[p]
            found = False
            for s, e_ps in self.out_of(p).items():
                if s == v or s not in succ_set:
                    continue
                out_edge = outs[s]
                # stitch distance through v vs the direct bridge must agree
                d = float(e_ps.offset)
                d2 = float(in_edge.offset + out_edge.offset)
                if not self._consistent(d, d2):
                    return False
                found = True
                bridged_succs.add(s)
            if found:
                bridged_preds.add(p)
            else:
                pending_preds.add(p)
        for p in pending_preds:
            if not any(s in bridged_preds for s in self.out_of(p)):
                return False
        for s in succ_set - bridged_succs:
            if not any(p in bridged_succs for p in self.in_of(s)):
                return False
        return True

    def remove_vertex(self, v: int) -> None:
        for w in list(self.out_of(v)):
            self._remove_edge(v, w)
        for u in list(self.in_of(v)):
            self._remove_edge(u, v)
        self.out.pop(v, None)
        self.inn.pop(v, None)

    def remove_redundant_nodes(self) -> List[int]:
        removed = []
        for v in self.vertices():
            if self.is_redundant_node(v):
                self.remove_vertex(v)
                self.remove_vertex(vrc(v))
                removed.append(v)
        return removed

    def resolve_junctions(self) -> int:
        """Greedy best-overlap matching (resolveJunctions, Layout.java:409):
        visit edges largest-overlap first; each kept edge evicts every other
        out-edge of its source and in-edge of its sink (and their mirrors),
        forcing the graph toward simple paths."""
        edges = []
        for u in self.vertices():
            for v, e in self.out_of(u).items():
                edges.append((e.ovl, u, v))
        edges.sort(key=lambda t: -t[0])
        removed = 0
        for _, u, v in edges:
            if v not in self.out_of(u):  # already evicted
                continue
            for w in list(self.out_of(u)):
                if w != v:
                    self._remove_edge(u, w)
                    self._remove_edge(vrc(w), vrc(u))
                    removed += 1
            for p in list(self.in_of(v)):
                if p != u:
                    self._remove_edge(p, v)
                    self._remove_edge(vrc(v), vrc(p))
                    removed += 1
        return removed

    def prune_polya(self, polya_fwd: Sequence[bool]) -> int:
        """A read with a poly-A tail on its forward strand is a transcript
        3' end: nothing may extend it rightward (pruneGraphWithPolyAInfo)."""
        n = 0
        for r, has in enumerate(polya_fwd):
            if not has:
                continue
            u = vid(r, 0)
            for w in list(self.out_of(u)):
                self._remove_edge(u, w)
                self._remove_edge(vrc(w), vrc(u))
                n += 1
        return n

    def add_mapping_support(self, placements: Sequence[Tuple[int, int, int, int, int]]) -> None:
        """placements: (read, target, orient, q_start, q_end) sorted per read.
        Consecutive dovetailing hits on one read support the junction edge."""
        by_read: Dict[int, List[Tuple[int, int, int, int]]] = {}
        for read, tgt, orient, qs, qe in placements:
            by_read.setdefault(read, []).append((qs, qe, tgt, orient))
        for hits in by_read.values():
            hits.sort()
            for i in range(len(hits) - 1):
                ls, le, lt, lo = hits[i]
                for j in range(i + 1, len(hits)):
                    rs, re, rt, ro = hits[j]
                    if rs > le:
                        break
                    if rs > ls and re > le:  # forward dovetail on the read
                        u, v = vid(lt, lo), vid(rt, ro)
                        e = self.out_of(u).get(v)
                        if e is not None:
                            e.weight += 1
                        m = self.out_of(vrc(v)).get(vrc(u))
                        if m is not None:
                            m.weight += 1

    def filter_edges_binomial(self, read_counts: Dict[int, float], sample_lengths: np.ndarray,
                              alpha: float = 0.001) -> int:
        """Remove edges whose junction-spanning read support is binomially
        improbable given the read-length distribution (filterEdges,
        Layout.java:3673-3724)."""
        if sample_lengths.size == 0:
            return 0
        sample = np.sort(np.asarray(sample_lengths))
        max_len = int(sample[-1])
        to_remove = []
        seen = set()
        for u in self.vertices():
            for v, e in self.out_of(u).items():
                if (u, v) in seen:  # mirror of an edge already judged
                    continue
                seen.add((vrc(v), vrc(u)))
                if e.ovl >= max_len:
                    continue
                # P(read shorter than the overlap)
                p_short = float(np.searchsorted(sample, e.ovl, side="right")) / sample.size
                c = math.floor(max(read_counts.get(vread(u), 0.0), read_counts.get(vread(v), 0.0)))
                s = e.weight
                if s >= c or c <= 0:
                    continue
                if _binom_cdf(int(s), int(c), 1.0 - p_short) < alpha:
                    to_remove.append((u, v))
        for u, v in to_remove:
            self._remove_edge(u, v)
            self._remove_edge(vrc(v), vrc(u))
        return len(to_remove)

    def simple_paths(self) -> List[List[Tuple[int, int]]]:
        """Maximal unambiguous chains -> [(oriented vid, stitch offset)].
        Each read appears in exactly one path (its mirror is skipped)."""
        used: Set[int] = set()
        paths: List[List[Tuple[int, int]]] = []
        for v0 in self.vertices():
            r0 = vread(v0)
            if r0 in used:
                continue
            # walk left along unambiguous edges
            cur = v0
            seen_reads = {r0}
            while True:
                ins = self.in_of(cur)
                if len(ins) != 1:
                    break
                (p, _), = ins.items()
                if len(self.out_of(p)) != 1 or vread(p) in seen_reads or vread(p) in used:
                    break
                cur = p
                seen_reads.add(vread(p))
            # walk right collecting the chain
            chain = [cur]
            while True:
                outs = self.out_of(chain[-1])
                if len(outs) != 1:
                    break
                (s, _), = outs.items()
                if len(self.in_of(s)) != 1 or vread(s) in used or vread(s) in {vread(c) for c in chain}:
                    break
                chain.append(s)
            pos = 0
            path = [(chain[0], 0)]
            for a, b in zip(chain, chain[1:]):
                pos += self.out_of(a)[b].offset
                path.append((b, pos))
            for c in chain:
                used.add(vread(c))
            paths.append(path)
        return paths

    def greedy_paths(self, read_counts: Dict[int, float]) -> List[Tuple[List[Tuple[int, int]], float]]:
        """Max-weight greedy extension from high-count seeds
        (getMaxWeightExtension; weights decremented per emitted path)."""
        counts = dict(read_counts)
        visited: Set[int] = set()
        results: List[Tuple[List[Tuple[int, int]], float]] = []
        order = sorted(counts, key=lambda r: -counts[r])
        all_reads = {vread(v) for v in self.vertices()}
        for r in order:
            if r in visited or r not in all_reads:
                continue
            seed = vid(r, 0) if (vid(r, 0) in self.out or vid(r, 0) in self.inn) else vid(r, 1)
            chain = [seed]
            chain_reads = {r}
            for right in (True, False):  # extend right, then left
                while True:
                    nbrs = self.out_of(chain[-1]) if right else self.in_of(chain[0])
                    best, best_w = None, -1.0
                    for s in nbrs:
                        if vread(s) in visited or vread(s) in chain_reads:
                            continue
                        w = counts.get(vread(s), 0.0)
                        if w > best_w:
                            best, best_w = s, w
                    if best is None:
                        break
                    if right:
                        chain.append(best)
                    else:
                        chain.insert(0, best)
                    chain_reads.add(vread(best))
            pos = 0
            path = [(chain[0], 0)]
            for a, b in zip(chain, chain[1:]):
                pos += self.out_of(a)[b].offset
                path.append((b, pos))
            c_min = min((counts.get(x, 0.0) for x in chain_reads), default=0.0)
            for x in chain_reads:
                if x in counts:
                    counts[x] = max(counts[x] - c_min, 0.0)
                visited.add(x)
            results.append((path, c_min))
        return results


def _binom_cdf(s: int, c: int, p: float) -> float:
    """P(X <= s) for X ~ Binomial(c, p), via log-gamma (no scipy)."""
    if p <= 0.0:
        return 1.0
    if p >= 1.0:
        return 0.0 if s < c else 1.0
    lp, lq = math.log(p), math.log(1.0 - p)
    lg_c1 = math.lgamma(c + 1)
    total = 0.0
    for i in range(0, min(s, c) + 1):
        total += math.exp(lg_c1 - math.lgamma(i + 1) - math.lgamma(c - i + 1) + i * lp + (c - i) * lq)
    return min(total, 1.0)


def build_graph(ov: Overlaps, lengths: np.ndarray, params: OverlapParams) -> Tuple[OverlapGraph, Set[int]]:
    """Classify once to collect containments, then insert dovetails between
    non-contained reads, each with its reverse-complement mirror
    (populateGraphFromOverlaps, Layout.java:2869).  Returns the graph and
    the contained read ids."""
    lengths = np.asarray(lengths)
    g = OverlapGraph(lengths=lengths)
    kinds = classify_batch(ov, lengths, params)
    contained = set(np.concatenate([ov.q[kinds == KIND_Q_CONTAINED], ov.t[kinds == KIND_T_CONTAINED]]).tolist())
    if len(contained):
        carr = np.fromiter(contained, np.int64, count=len(contained))
        ok = ~(np.isin(ov.q, carr) | np.isin(ov.t, carr))
    else:
        ok = np.ones(len(ov), bool)
    sel = np.flatnonzero(ok & (kinds == KIND_DOVETAIL))
    if len(sel) == 0:
        return g, contained

    # dovetail edge geometry, vectorised
    q, t = ov.q[sel], ov.t[sel]
    q_len, t_len = lengths[q].astype(np.int64), lengths[t].astype(np.int64)
    strand = ov.strand[sel]
    ot_s = np.where(strand == 1, ov.t_start[sel], t_len - ov.t_end[sel])
    ot_e = np.where(strand == 1, ov.t_end[sel], t_len - ov.t_start[sel])
    t_orient = (strand != 1).astype(np.int64)
    ovl = ((ov.q_end[sel] - ov.q_start[sel]) + (ot_e - ot_s)) / 2.0
    q_first = ov.q_start[sel] > ot_s
    u = np.where(q_first, q * 2, t * 2 + t_orient)
    v = np.where(q_first, t * 2 + t_orient, q * 2)
    off = np.where(q_first, ov.q_start[sel] - ot_s, ot_s - ov.q_start[sel])
    lu = np.where(q_first, q_len, t_len)
    lv = np.where(q_first, t_len, q_len)
    proper = (off > 0) & (off + lv > lu)
    shared = ov.shared[sel]
    m_off = off + lv - lu
    for i in np.flatnonzero(proper):
        e = Edge(offset=int(off[i]), ovl=float(ovl[i]), support=int(shared[i]))
        g._add_edge(int(u[i]), int(v[i]), e)
        # rc mirror: reversing the 2-read layout swaps and flips both
        g._add_edge(
            vrc(int(v[i])), vrc(int(u[i])),
            Edge(offset=int(m_off[i]), ovl=float(ovl[i]), support=int(shared[i])),
        )
    return g, contained
