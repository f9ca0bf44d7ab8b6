"""Stranded overlap graph over transcripts (the nr pass's part).

The port's copy of what ``rnabloom_tpu/olc/graph.py`` gives
``layout_unitigs``, host-side numpy and dicts: vertices are oriented reads
(read id x strand), edges are dovetail overlaps, and the reverse-complement
mirror of every edge is kept so paths can be extracted from either strand
(olc/Layout.java's JGraphT graph, Layout.java:80-101, addEdges
:2543-2753).

  remove_transitive_edges   <- removeTransitiveEdges (Layout.java:235)
  remove_redundant_nodes    <- removeRedundantNodes/isRedundantNode (:274-:407)
  simple_paths              <- extractSimplePaths (:3349)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import numpy as np

from .overlap import KIND_DOVETAIL, KIND_Q_CONTAINED, KIND_T_CONTAINED, OverlapParams, Overlaps, classify_batch


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

    def vertices(self) -> List[int]:
        return sorted(set(self.out.keys()) | set(self.inn.keys()))

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
