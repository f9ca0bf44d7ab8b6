"""Stage 3 — transcript extension (the part of it ported so far).

Port of ``rnabloom_tpu/assembly/transcripts.py``: ``TranscriptParams`` and
``extend_fragments_pair``, extendPE's bidirectional pair-guided extension
of whole fragments (a right pair walk seeded with each fragment, then a
left pair walk seeded with the reverse complement of the right-extended
sequence, so the left walk's pair ring holds the whole context).  The
screen, the break checks, dedup, the gap rewalk and the artifact filters
of stage 3 are ROADMAP queue-1 item 10b.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..graph import engine, traverse
from ..graph.dbg import GraphConfig, GraphState
from .fragments import revcomp_rows


@dataclass
class TranscriptParams:
    """The JAX package's stage-3 parameters, field for field.  The
    extension reads ``bound``, ``max_walk_len``, ``pair_ring`` and
    ``lookahead``; the other fields are placeholders that nothing reads
    until the rest of stage 3 is ported (ROADMAP queue-1 item 10b)."""

    min_transcript_length: int = 200
    num_pairs_required: int = 1  # minNumKmerPairs in break checks
    bound: int = 1000  # max extension per direction
    max_walk_len: int = 4096
    pair_ring: int = 1024
    screen_min_frac: float = 0.95
    screen_max_gap: Optional[int] = None  # default k
    max_indel: int = 1
    percent_identity: float = 0.90
    max_edge_clip: int = 0
    screen_max_edge_clip: int = -1
    template_switch_filter: bool = False
    lookahead: int = 3
    tip_probe_depth: int = 8
    keep_chimeras: bool = False
    keep_artifacts: bool = False
    frag_consistency: bool = True


def extend_fragments_pair(
    graph: GraphState,
    cfg: GraphConfig,
    frags: np.ndarray,
    lens: np.ndarray,
    params: TranscriptParams,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Extend fragments in both directions on the graph's device.

    Returns (codes (B, max_walk_len), lengths, orig_start, orig_end), where
    [orig_start, orig_end) is each original fragment's base range inside
    its extended sequence.  Walks are bounded by ``params.bound`` hops a
    direction (the pipeline's stage 3 leaves it at its default, 1000)."""
    B = frags.shape[0]
    dev = graph.cbf.device

    def wcfg(left: bool) -> traverse.WalkConfig:
        return traverse.WalkConfig(
            max_len=params.max_walk_len, pair_ring=params.pair_ring, left=left,
            lookahead=params.lookahead,
        )

    # right walks seeded with whole fragments
    st = traverse.make_walks(cfg, wcfg(False), frags, lens, device=dev)
    st = engine.extend_walks(st, graph, cfg, wcfg(False), 1.0, params.bound, mode="pair")
    # left walks seeded with the reverse complement of the right-extended
    # sequences
    rpos = st.pos
    stl = traverse.revcomp_reseed(cfg, wcfg(True), st.buf, st.pos)
    stl = engine.extend_walks(stl, graph, cfg, wcfg(True), 1.0, params.bound, mode="pair")
    engine._tick("query")
    lbuf, lpos, rpos = stl.buf.cpu().numpy(), stl.pos.cpu().numpy(), rpos.cpu().numpy()

    out_len = np.minimum(lpos, params.max_walk_len).astype(np.int32)
    out = revcomp_rows(lbuf, out_len)[:B]
    left_ext = (lpos - rpos).astype(np.int32)[:B]
    orig_e = np.minimum(left_ext + np.asarray(lens, np.int32), out_len[:B]).astype(np.int32)
    return out, out_len[:B], left_ext, orig_e
