"""Unitig layout over a transcript set: the non-redundant (nr) pass.

The port's copy of ``rnabloom_tpu/olc/layout.py::layout_unitigs`` and
``stitch_path``: all-vs-all overlaps by minimizers, an overlap graph of
the dovetails between non-contained transcripts, redundant nodes and
transitive edges removed, then maximal unambiguous chains stitched into
unitigs (overlapWithMinimapAndLayoutSimple, OverlapLayoutConsensus.java:
500; extractSimplePaths, Layout.java:3349).  Stage 3 runs it over the
emitted transcripts (generateNonRedundantTranscripts, RNABloom.java:5676).
The minimizer keys are hashed on the caller's device; the rest is host
numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np

from .graph import build_graph, vid, vread
from .overlap import OverlapParams, extract_minimizers_reads, find_overlaps

_RC = np.array([3, 2, 1, 0, 4], np.uint8)


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
