"""Stage 3 — transcript extension, screening, and output.

Port of ``rnabloom_tpu/assembly/transcripts.py``, the equivalent of
TranscriptAssemblyWorker / TranscriptWriter (RNABloom.java:1789-1933,
:1614-1780) over the fragment graph:

  per batch of fragments (largest coverage stratum first, as the reference
  iterates E5..E0 then singletons):
    1. redundancy screen against the screening Bloom filter
       (GraphUtils.represented :711-824; approximated by seen-k-mer
       fraction + max unseen run, with edit-variant repairs and greedy
       gap re-walks),
    2. extendPE: bidirectional walks with pair-scored branch resolution
       (read + fragment paired k-mers; walk mode "pair"),
    3. breakWithFragPairedKmers then breakWithReadPairedKmers — the
       surviving range is the one overlapping the original fragment most
       (RNABloom.java:1846-1906),
    4. re-screen, sequential within-batch dedup, commit k-mers to the
       screening filter, emit with the min-transcript-length split
       (transcripts.fa vs .short.fa).

The screening filter is a bit-lane tensor on the graph's device, updated
in place by the ``set`` insert kernel.  Its lookups, the SNV-variant
lookups and the dedup hashes are plain torch on that device; the gap
re-walks and depth probes are greedy walks (the walk kernel on the card).
Artifact screens: chimera (isChimera :7674), blunt-end (isBluntEndArtifact
:8535, opt-in via max_edge_clip), template-switch (isTemplateSwitch
:8305/:8434, opt-in) and reverse-complement-fold trimming
(trimReverseComplementArtifact :7762).  Poly-A annotation happens in the
pipeline's writer (``pipeline._run_stage3``).  ``reduce_redundancy`` is
the long-read path's redundancy reduction: the same screen and dedup over
the assembled transcripts, longest first.  Each part's wall time goes
to a ``utils/timer`` span: ``extend``, ``screen`` (``screen_rewalk`` is
pass 1b inside it), ``break`` and ``dedup``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..bloom import filters
from ..bloom.filters import BloomConfig, CountingConfig
from ..graph import dbg, engine, traverse
from ..graph.dbg import GraphConfig, GraphState
from ..ops import nthash
from ..utils import align, seq as sequtils
from ..utils.timer import span
from . import artifacts
from .correct import _batch_runs
from .fragments import pair_break_segments, revcomp_rows


@dataclass
class TranscriptParams:
    """The JAX package's stage-3 parameters, field for field."""

    min_transcript_length: int = 200
    num_pairs_required: int = 1  # minNumKmerPairs in break checks
    bound: int = 1000  # max extension per direction
    max_walk_len: int = 4096
    pair_ring: int = 1024
    screen_min_frac: float = 0.95
    screen_max_gap: Optional[int] = None  # default k
    max_indel: int = 1  # -indel: indel-bubble tolerance in the screen
    percent_identity: float = 0.90  # -p: identity floor for gap repairs
    max_edge_clip: int = 0  # >0 enables the blunt-end artifact filter
    # unassembled sequence EDGES up to this many k-mers are forgiven by the
    # redundancy screen when they are graph tips (represented()'s
    # maxEdgeClipLength, GraphUtils.java:744/:813); -1 = auto
    screen_max_edge_clip: int = -1
    template_switch_filter: bool = False  # enable isTemplateSwitch screening
    lookahead: int = 3  # -lookahead: traversal lookahead depth
    tip_probe_depth: int = 8  # the JAX package hands it to the pair walks, which do not read it
    keep_chimeras: bool = False  # -chimera: skip the chimera screen
    keep_artifacts: bool = False  # -artifact: skip blunt-end / rc-fold trims
    frag_consistency: bool = True  # -nofc turns off frag-pair break checks


@dataclass
class Transcript:
    codes: np.ndarray
    length: int


# ---------------------------------------------------------------------------
# Screening filter (sbf) — assembled-k-mer redundancy screen
# ---------------------------------------------------------------------------


def _screen_hashes(screen: torch.Tensor, scfg: BloomConfig, cfg: GraphConfig, codes):
    """(multi-hashes (B, P, num_hash), valid) of a code batch, on the
    screen's device."""
    if isinstance(codes, np.ndarray):
        codes = torch.from_numpy(np.ascontiguousarray(codes))
    _, _, base, valid = dbg.seq_hashes(cfg, codes.to(screen.device))
    return nthash.multi_hash(base, cfg.k, scfg.num_hash), valid


def _screen_lookup(
    screen: torch.Tensor, scfg: BloomConfig, cfg: GraphConfig, codes
) -> Tuple[np.ndarray, np.ndarray]:
    """(seen, valid) per k-mer window as numpy: seen = in the screen and valid."""
    h, valid = _screen_hashes(screen, scfg, cfg, codes)
    seen = filters.bloom_lookup(screen, scfg, h)
    return (seen & valid).cpu().numpy(), valid.cpu().numpy()


def screen_add(screen: torch.Tensor, scfg: BloomConfig, cfg: GraphConfig, codes) -> torch.Tensor:
    """Insert every valid k-mer of a code batch into the screen, in place
    (the ``set`` insert kernel on the card); returns the screen."""
    h, valid = _screen_hashes(screen, scfg, cfg, codes)
    return filters.bloom_add(screen, scfg, h, valid)


def screen_template_switch(
    screen: torch.Tensor,
    scfg: BloomConfig,
    cfg: GraphConfig,
    codes: np.ndarray,
    lengths: np.ndarray,
) -> np.ndarray:
    """Template-switch artifact flags per row (isTemplateSwitch
    GraphUtils.java:8434 / isTemplateSwitch2 :8305): one end previously
    assembled, the other an unassembled tip whose reverse complement is
    itself fully assembled (= contained in the backbone transcript).
    """
    B, L = codes.shape
    out = np.zeros(B, bool)
    engine._tick("query")
    seen_np, valid_np = _screen_lookup(screen, scfg, cfg, codes)
    tips: List[Tuple[int, np.ndarray]] = []
    k = cfg.k
    for b in range(B):
        nk = max(int(lengths[b]) - k + 1, 0)
        if nk < 3:
            continue
        tip = artifacts.template_switch_tip(seen_np[b, :nk], valid_np[b, :nk], k)
        if tip is None:
            continue
        ks, ke = tip  # k-mer range -> base range [ks, ke + k - 1)
        tips.append((b, sequtils.revcomp_codes(codes[b, ks : ke + k - 1])))
    if not tips:
        return out
    TL = 1 << (max(max(len(t) for _, t in tips), k) - 1).bit_length()
    rows_p = 1 << max(4, (len(tips) - 1).bit_length())
    batch = np.full((rows_p, TL), 4, np.uint8)  # the JAX package's padded shape
    for i, (_, t) in enumerate(tips):
        batch[i, : len(t)] = t
    engine._tick("query")
    tseen, tvalid = _screen_lookup(screen, scfg, cfg, batch)
    for i, (b, _) in enumerate(tips):
        v = tvalid[i]
        if v.any() and tseen[i][v].all():
            out[b] = True
    return out


def _max_true_run(mask: np.ndarray) -> int:
    """Length of the longest True run (vectorized)."""
    if not mask.any():
        return 0
    padded = np.concatenate(([False], mask, [False]))
    d = np.diff(padded.astype(np.int8))
    return int((np.flatnonzero(d == -1) - np.flatnonzero(d == 1)).max())


def _gap_rewalk(
    graph: GraphState,
    screen: torch.Tensor,
    scfg: BloomConfig,
    cfg: GraphConfig,
    codes: np.ndarray,
    lengths: np.ndarray,
    seen: np.ndarray,
    valid: np.ndarray,
    params: TranscriptParams,
) -> None:
    """Graph re-walk of unseen k-mer gaps (GraphUtils.represented :711-824).

    For each unseen run anchored by seen k-mers, greedily walk the graph's
    max-coverage path from the anchor for the expected length; the gap is
    accepted — ``seen[b, g0:g1]`` set — when the walked path's k-mers are
    all in the screening filter AND its bases match the gap's bases at
    >= percent_identity within max_indel of the expected length.  Edge
    gaps re-walk outward the same way; failing edge gaps up to
    ``screen_max_edge_clip`` k-mers are forgiven when the sequence end is
    a graph tip (hasDepth check, :744-752/:811-820).  Mutates ``seen``.
    """
    k = cfg.k
    mi = params.max_indel
    bubble_max = (cfg.read_pair_distance if cfg.read_pair_distance > 0 else 0) + k
    edge_clip = params.screen_max_edge_clip
    if edge_clip < 0:
        edge_clip = max(k, cfg.read_pair_distance)
    dev = engine.device_of(graph)

    # vectorized row prefilter: only rows with unseen runs AND a seen anchor
    Bq, Pq = seen.shape
    nk_all = np.maximum(np.asarray(lengths).astype(np.int64) - k + 1, 0)
    inlen_q = np.arange(Pq)[None, :] < nk_all[:, None]
    vm = valid & inlen_q
    bad_all = (~seen) & vm
    rows_q = np.flatnonzero(bad_all.any(axis=1) & (seen & vm).any(axis=1))

    # jobs: (b, g0, g1, seed (k,), target bases, expected_ext, kind)
    jobs: List[tuple] = []
    for b in rows_q:
        nb = int(lengths[b])
        n = int(nk_all[b])
        bad = bad_all[b, :n]
        padded = np.concatenate(([False], bad, [False]))
        d = np.diff(padded.astype(np.int8))
        for g0, g1 in zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)):
            g0, g1 = int(g0), int(g1)
            glen = g1 - g0
            interior = g0 > 0 and g1 < n
            if interior:
                if glen > bubble_max:
                    continue
                # walk right from the anchor k-mer at g0-1, regenerate
                # through the end of the right anchor k-mer at g1
                seed = codes[b, g0 - 1 : g0 - 1 + k]
                target = codes[b, g0 - 1 + k : g1 + k]
                jobs.append((b, g0, g1, seed, target, len(target), "int"))
            elif g1 >= n and g0 > 0:  # right edge
                if glen > max(bubble_max, edge_clip):
                    continue
                seed = codes[b, g0 - 1 : g0 - 1 + k]
                target = codes[b, g0 - 1 + k : nb]
                jobs.append((b, g0, g1, seed, target, len(target), "redge"))
            elif g0 == 0 and g1 < n:  # left edge: walk left = rc right
                if glen > max(bubble_max, edge_clip):
                    continue
                seed = sequtils.revcomp_codes(codes[b, g1 : g1 + k])
                target = sequtils.revcomp_codes(codes[b, :g1])
                jobs.append((b, g0, g1, seed, target, len(target), "ledge"))
    if not jobs:
        return

    # a power-of-two walk length, as in the JAX package: it decides when a
    # walk goes FULL, so it must match
    max_ext = max(j[5] for j in jobs) + mi
    max_ext = 1 << max(6, (max_ext - 1).bit_length())
    wcfg = traverse.WalkConfig(max_len=k + max_ext, lookahead=params.lookahead)
    seeds = np.stack([j[3] for j in jobs])
    W = 1 << max(6, (len(jobs) - 1).bit_length())  # make_walks pads rows
    bounds_p = np.zeros(W, np.int32)
    bounds_p[: len(jobs)] = [j[5] + mi for j in jobs]
    st = traverse.make_walks(cfg, wcfg, seeds, device=dev)
    st = engine.extend_walks(st, graph, cfg, wcfg, 1.0, bounds_p, mode="greedy")
    buf, pos, _ = traverse.harvest(st)

    # one batched screen lookup over every walked path
    engine._tick("query")
    wseen, wvalid = _screen_lookup(screen, scfg, cfg, buf[: len(jobs)])

    # failed EDGE gaps fall back to the tip test: walk outward from the
    # sequence's outermost k-mer; a dead end within the clip allowance
    # means the edge is unassembled junk, not novel sequence
    tip_jobs: List[tuple] = []  # (job index, seed)

    for i, (b, g0, g1, _seed, target, expected, kind) in enumerate(jobs):
        ext = buf[i, k : pos[i]]
        ok = False
        if len(ext) >= max(expected - mi, 1):
            m = min(len(ext), expected + mi)
            nk_w = pos[i] - k + 1  # walked k-mers incl. the seed k-mer
            wv = wvalid[i, :nk_w]
            path_seen = wseen[i, :nk_w][wv].all() if wv.any() else False
            if path_seen:
                a = ext[:m]
                t = np.asarray(target)
                if align.percent_identity(a, t) >= params.percent_identity:
                    ok = True
        if ok:
            seen[b, g0:g1] = True
        elif kind in ("redge", "ledge") and (g1 - g0) <= edge_clip:
            nb = int(lengths[b])
            if kind == "redge":
                tip_seed = codes[b, nb - k : nb]
            else:
                tip_seed = sequtils.revcomp_codes(codes[b, :k])
            tip_jobs.append((i, tip_seed))

    if tip_jobs:
        depth = max(edge_clip, 1)
        twcfg = traverse.WalkConfig(max_len=k + depth, lookahead=params.lookahead)
        tst = traverse.make_walks(cfg, twcfg, np.stack([s for _, s in tip_jobs]), device=dev)
        tst = engine.extend_walks(tst, graph, cfg, twcfg, 1.0, depth, mode="greedy")
        _, tpos, _ = traverse.harvest(tst)
        for j, (i, _s) in enumerate(tip_jobs):
            b, g0, g1 = jobs[i][0], jobs[i][1], jobs[i][2]
            gap = g1 - g0
            if int(tpos[j]) - k < max(edge_clip - gap, 0):
                seen[b, g0:g1] = True  # dead-end tip: forgive the edge


def screen_represented(
    screen: torch.Tensor,
    scfg: BloomConfig,
    cfg: GraphConfig,
    codes: np.ndarray,
    lengths: np.ndarray,
    params: TranscriptParams,
    chimera_out: Optional[np.ndarray] = None,
    graph: Optional[GraphState] = None,
) -> np.ndarray:
    """Per row: already represented by previously assembled sequence?

    GraphUtils.represented (:711-824): a sequence is redundant when its
    k-mers are in the screening filter up to repaired error bubbles.  Short
    unseen gaps are first tested against their direct edit variants
    (pass 1); with ``graph`` given, surviving gaps are re-walked through
    the graph's max-coverage path with percent-identity acceptance and
    edge gaps are forgiven when they are graph tips (pass 1b).  Finally a
    row is represented when >= screen_min_frac of its k-mers are seen and
    no unseen run exceeds screen_max_gap.

    When ``chimera_out`` is given, rows whose seen-profile matches the
    chimera signature (two fully assembled arms joined by a short
    unsupported junction, isChimera :7674) are flagged there.
    """
    engine._tick("query")
    seen, valid = _screen_lookup(screen, scfg, cfg, codes)  # seen is writable
    k = cfg.k
    gap_max = params.screen_max_gap or k
    B, P = seen.shape
    n_kmers = np.maximum(np.asarray(lengths).astype(np.int64) - k + 1, 0)
    inlen = np.arange(P)[None, :] < n_kmers[:, None]
    vmask = valid & inlen
    badmask = (~seen) & vmask
    # rows worth repairing: some unseen k-mer AND some seen anchor
    cand_rows = np.flatnonzero(badmask.any(axis=1) & (seen & vmask).any(axis=1))

    # pass 1: repair error bubbles.  Each short gap is tested directly
    # against the bubble's edit variants: the 3 substitutions at the implied
    # error base, deletions of 1..max_indel bases, and single-base
    # insertions.  A variant whose k-mers are all assembled marks the gap
    # seen; indel variants respect the percent-identity floor.
    wins: List[np.ndarray] = []
    groups: List[Tuple[int, int, int, int, int]] = []  # (b, g0, g1, start, end)
    mi = params.max_indel
    for b in cand_rows:
        n = int(n_kmers[b])
        bad = badmask[b, :n]
        padded = np.concatenate(([False], bad, [False]))
        d = np.diff(padded.astype(np.int8))
        for g0, g1 in zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)):
            if g1 - g0 > k + 2 + mi:
                continue
            nb = int(lengths[b])
            p = g1 - 1 if g0 == 0 else min(g0 + k - 1, nb - 1)
            glen = g1 + k - 1 - g0  # nominal gap segment length (bases)
            # segment with up to max_indel extra tail bases for deletions
            seg = codes[b, g0 : min(g1 + k - 1 + mi, nb)].copy()
            rel = p - g0
            start = len(wins)
            orig = seg[rel] if rel < len(seg) else 4
            alts = [c for c in range(4) if c != orig][:3] if orig < 4 else [0, 1, 2]
            for alt in alts:
                var = seg[:glen].copy()
                if rel < len(var):
                    var[rel] = alt
                wins.append(var)
            interior = g0 > 0 and g1 < n  # anchored both sides
            if interior and mi > 0 and rel < glen:
                for dd in range(1, mi + 1):
                    if (glen - dd) / glen < params.percent_identity:
                        break
                    if len(seg) >= glen + dd:
                        wins.append(
                            np.concatenate([seg[:rel], seg[rel + dd : glen + dd]])
                        )
                if (glen - 1) / glen >= params.percent_identity:
                    for alt in range(4):
                        wins.append(
                            np.concatenate([seg[:rel], [alt], seg[rel : glen - 1]]).astype(np.uint8)
                        )
            groups.append((b, g0, g1, start, len(wins)))
    if wins:
        # both dims padded to powers of two, as in the JAX package
        seg_len = max(max(len(w) for w in wins), k)
        seg_p = 1 << (seg_len - 1).bit_length()
        rows_p = 1 << max(5, (len(wins) - 1).bit_length())
        batch = np.full((rows_p, seg_p), 4, np.uint8)
        for i, w in enumerate(wins):
            batch[i, : len(w)] = w
        engine._tick("query")
        vseen, vvalid = _screen_lookup(screen, scfg, cfg, batch)
        for b, g0, g1, start, end in groups:
            for i in range(start, end):
                nk = max(len(wins[i]) - k + 1, 0)
                vv = vvalid[i, :nk]
                if nk > 0 and vv.any() and vseen[i, :nk][vv].all():
                    seen[b, g0:g1] = True
                    break

    # pass 1b: graph re-walk of the gaps the direct variants couldn't
    # explain (multi-error bubbles, indel clusters, unassembled edges)
    if graph is not None:
        with span("screen_rewalk"):
            _gap_rewalk(graph, screen, scfg, cfg, codes, lengths, seen, valid, params)

    # final decision, vectorized: a row is represented when >= min_frac of
    # its k-mers are seen and no unseen run exceeds gap_max
    badf = (~seen) & vmask  # recompute: passes 1/1b marked gaps seen
    nv = vmask.sum(axis=1)
    nseen = (seen & vmask).sum(axis=1)
    trivial = (n_kmers == 0) | (nv == 0)
    frac_ok = nseen / np.maximum(nv, 1) >= params.screen_min_frac
    maxrun = np.zeros(B, np.int64)
    if badf.any():
        rs, ss, es = _batch_runs(badf)
        np.maximum.at(maxrun, rs, es - ss)
    out = trivial | (frac_ok & (maxrun <= gap_max))

    if chimera_out is not None:
        # chimera signature needs an unsupported junction — only rows with
        # unseen runs can match
        for b in np.flatnonzero(badf.any(axis=1) & (n_kmers > 0)):
            n0 = int(n_kmers[b])
            if artifacts.is_chimera(seen[b, :n0], valid[b, :n0], k):
                chimera_out[b] = True
    return out


def _base_hashes_np(cfg: GraphConfig, codes: np.ndarray, device) -> Tuple[np.ndarray, np.ndarray]:
    """(hashes (B, P) uint64, valid) — canonical k-mer hashes, computed on
    ``device``, on the host (int64 bit patterns viewed as uint64)."""
    _, _, base, valid = dbg.seq_hashes(cfg, torch.from_numpy(np.ascontiguousarray(codes)).to(device))
    return base.cpu().numpy().view(np.uint64), valid.cpu().numpy()


def sequential_dedup(
    cfg: GraphConfig,
    codes: np.ndarray,
    lengths: np.ndarray,
    params: TranscriptParams,
    seen: Optional[set] = None,
    *,
    device,
) -> Tuple[np.ndarray, Optional[set]]:
    """Within-batch sequential redundancy screen.

    The reference's writer serializes every candidate against all previously
    written sequences (TranscriptWriter :1639); batched device screening
    only sees earlier *batches*, so rows of one batch are re-checked here in
    order against the k-mers accepted earlier in the batch.  Vectorized:
    the batch's distinct k-mer hashes are assigned dense ids once
    (np.unique), and the sequential pass is one boolean-array gather/scatter
    per row instead of per-element set probes.  Returns (represented mask,
    the passed-in seen set updated with accepted hashes, or None).  The
    hashes are computed on ``device``.
    """
    h, valid = _base_hashes_np(cfg, codes, device)
    B, P = h.shape
    k = cfg.k
    gap_max = params.screen_max_gap or k
    n_kmers = np.maximum(lengths.astype(np.int64) - k + 1, 0)
    inlen = np.arange(P)[None, :] < n_kmers[:, None]
    sel = inlen & valid
    rep = np.zeros(B, bool)
    if not sel.any():
        rep[:] = True
        return rep, seen
    uniq, inv = np.unique(h[sel], return_inverse=True)
    ids = np.zeros((B, P), np.int64)
    ids[sel] = inv
    seen_mask = np.zeros(len(uniq), bool)
    if seen:
        seen_arr = np.fromiter(seen, dtype=np.uint64, count=len(seen))
        seen_mask = np.isin(uniq, seen_arr)
    for b in range(B):
        n = int(n_kmers[b])
        if n == 0:
            rep[b] = True
            continue
        v = sel[b, :n]
        nv = int(v.sum())
        if nv == 0:
            rep[b] = True
            continue
        row_ids = ids[b, :n]
        hits = seen_mask[row_ids] & v
        frac = hits.sum() / nv
        if frac >= params.screen_min_frac and _max_true_run((~hits) & v) <= gap_max:
            rep[b] = True
        else:
            seen_mask[row_ids[v]] = True
            if seen is not None:
                seen.update(uniq[row_ids[v]].tolist())
    return rep, seen


def reduce_redundancy(
    cfg: GraphConfig, scfg: BloomConfig, seqs: List[np.ndarray], params: TranscriptParams, batch: int = 256, *, device,
) -> List[int]:
    """Length-sorted redundancy reduction (GraphUtils.reduceRedundancy
    :652-699): longest-first re-screen against a fresh screening filter on
    ``device``.  Returns indices of ``seqs`` that survive (the nr set)."""
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    screen = filters.make_bloom(scfg, device=device)
    keep: List[int] = []
    L = max((len(s) for s in seqs), default=0)
    Lp = 1 << max(8, (max(L, cfg.k) - 1).bit_length())
    for s0 in range(0, len(order), batch):
        idx = order[s0 : s0 + batch]
        codes = np.full((len(idx), Lp), 4, np.uint8)
        lens = np.zeros(len(idx), np.int32)
        for j, i in enumerate(idx):
            codes[j, : len(seqs[i])] = seqs[i]
            lens[j] = len(seqs[i])
        rep = screen_represented(screen, scfg, cfg, codes, lens, params)
        # within-batch serialization (cross-batch handled by the screen)
        seq_lens = np.where(rep, 0, lens)
        rep2, _ = sequential_dedup(cfg, codes, seq_lens, params, device=screen.device)
        rep = rep | rep2
        commit = np.where(~rep[:, None], codes, np.uint8(4))
        engine._tick("build")
        screen = screen_add(screen, scfg, cfg, commit)
        keep.extend(i for j, i in enumerate(idx) if not rep[j])
    return sorted(keep)


# ---------------------------------------------------------------------------
# extendPE — bidirectional pair-guided extension
# ---------------------------------------------------------------------------


def extend_fragments_pair(
    graph: GraphState,
    cfg: GraphConfig,
    frags: np.ndarray,
    lens: np.ndarray,
    params: TranscriptParams,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Extend fragments in both directions on the graph's device: a right
    pair walk seeded with each fragment, then a left pair walk seeded with
    the reverse complement of the right-extended sequence, so the left
    walk's pair ring holds the whole context.

    Returns (codes (B, max_walk_len), lengths, orig_start, orig_end), where
    [orig_start, orig_end) is each original fragment's base range inside
    its extended sequence.  Walks are bounded by ``params.bound`` hops a
    direction (the pipeline's stage 3 leaves it at its default, 1000)."""
    B = frags.shape[0]
    dev = engine.device_of(graph)

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


# ---------------------------------------------------------------------------
# break checks
# ---------------------------------------------------------------------------


def _best_range(segments, orig) -> Optional[Tuple[int, int]]:
    if not segments:
        return None
    if len(segments) == 1:
        return segments[0]
    os_, oe = orig

    def overlap(se):
        return max(0, min(se[1], oe) - max(se[0], os_))

    best = max(segments, key=overlap)
    return best if overlap(best) > 0 else None


def break_check(
    graph: GraphState,
    cfg: GraphConfig,
    codes: np.ndarray,
    lengths: np.ndarray,
    orig_s: np.ndarray,
    orig_e: np.ndarray,
    params: TranscriptParams,
) -> List[Optional[Tuple[int, int]]]:
    """Fragment-pair then read-pair supported base range per row."""
    k = cfg.k
    have_frag = (
        graph.fpkbf is not None
        and cfg.fragment_pair_distance > 0
        and params.frag_consistency  # -nofc (RNABloom.java:6237-6240)
    )
    have_read = graph.rpkbf is not None and cfg.read_pair_distance > 0
    sup_f = sup_r = None
    if have_frag or have_read:
        sup_f, sup_r = engine.pair_support_both(
            graph, cfg, codes,
            cfg.fragment_pair_distance if have_frag else 0,
            cfg.read_pair_distance if have_read else 0,
        )

    out: List[Optional[Tuple[int, int]]] = []
    for b in range(codes.shape[0]):
        n_kmers = max(int(lengths[b]) - k + 1, 0)
        rng: Optional[Tuple[int, int]] = (0, n_kmers)
        orig_k = (int(orig_s[b]), max(int(orig_e[b]) - k + 1, 0))
        if have_frag:
            d = cfg.fragment_pair_distance
            if n_kmers >= d:
                segs = pair_break_segments(
                    sup_f[b, : n_kmers - d], d, params.num_pairs_required, n_kmers
                )
                rng = _best_range(segs, orig_k)
            else:
                rng = None
        if rng is not None and have_read:
            d = cfg.read_pair_distance
            s0, e0 = rng
            if e0 - s0 > d:
                segs = pair_break_segments(
                    sup_r[b, s0 : e0 - d], d, params.num_pairs_required, e0 - s0
                )
                segs = [(s + s0, e + s0) for s, e in segs]
                best = _best_range(segs, orig_k)
                if best is not None:
                    rng = best
        if rng is not None:
            s, e = rng
            out.append((s, e + k - 1))  # kmer -> base range
        else:
            out.append(None)
    return out


# ---------------------------------------------------------------------------
# batch assembly
# ---------------------------------------------------------------------------


def _depth_probe(graph: GraphState, cfg: GraphConfig, seeds, bound: int, lookahead: int = 3) -> np.ndarray:
    """Greedy depth reached from each seed k-mer, up to ``bound`` hops —
    the batched stand-in for the reference's exhaustive hasDepth DFS
    (graph/Kmer.java:407-486).  seeds: list of (k,) uint8 code arrays.
    The seed rows pad to a power of two (at least 16) with all-A rows,
    which walk too, as in the JAX package."""
    B = len(seeds)
    Bp = 1 << max(4, (B - 1).bit_length())
    arr = np.full((Bp, cfg.k), 0, np.uint8)
    for i, s in enumerate(seeds):
        arr[i] = s
    max_len = 1 << max(6, (cfg.k + bound).bit_length())
    wcfg = traverse.WalkConfig(max_len=max_len, lookahead=lookahead)
    st = traverse.make_walks(cfg, wcfg, arr, device=engine.device_of(graph))
    st = engine.extend_walks(st, graph, cfg, wcfg, 1.0, bound, mode="greedy")
    _, pos, _ = traverse.harvest(st)
    return np.asarray(pos)[:B] - cfg.k


def _screen_as_graph(screen: torch.Tensor, scfg: BloomConfig, cfg: GraphConfig) -> Tuple[GraphState, GraphConfig]:
    """The screening filter viewed as a graph whose k-mer counts are
    membership (1/0): walking it IS the assembled-k-mer-restricted
    traversal of the reference's hasDepth(assembledKmers) overload.
    Bit lanes are 0/1 uint8, so an mf8-decoded count-min over them is
    exactly the AND-of-lanes Bloom lookup.  The graph's counter table is
    the screen tensor itself, on its device."""
    pcfg = dbg.GraphConfig(
        k=cfg.k, stranded=cfg.stranded, dbgbf=cfg.dbgbf,
        cbf=CountingConfig(scfg.size_log2, scfg.num_hash, dtype="mf8", merge=scfg.merge),
        pkbf=None, read_pair_distance=-1, exact_counts=False,
    )
    return dbg.GraphState(dbgbf=None, cbf=screen, rpkbf=None, fpkbf=None), pcfg


def branch_free_batch(
    graph: GraphState, cfg: GraphConfig, codes: np.ndarray, lens: np.ndarray
) -> np.ndarray:
    """(B,) bool: True when no k-mer of the row has an existing SNV variant."""
    hit, _valid = engine.variant_exists(graph, cfg, codes)
    out = np.zeros(codes.shape[0], bool)
    for b in range(codes.shape[0]):
        n = max(int(lens[b]) - cfg.k + 1, 0)
        out[b] = n > 0 and not hit[b, :n].any()
    return out


def _blunt_end(
    graph: GraphState, cfg: GraphConfig, screen: torch.Tensor, scfg: BloomConfig,
    frags: np.ndarray, lens: np.ndarray, params: TranscriptParams,
) -> np.ndarray:
    """Blunt-end artifact flags per row (isBluntEndArtifact :8535-8585)."""
    B = frags.shape[0]
    blunt = np.zeros(B, bool)
    engine._tick("query")
    seen_np, _ = _screen_lookup(screen, scfg, cfg, frags)
    counts_t, valid_t = engine.count_step(graph, cfg, frags)
    counts_np, valid_np = counts_t.cpu().numpy(), valid_t.cpu().numpy()
    cands = []
    for b in range(B):
        nk = max(int(lens[b]) - cfg.k + 1, 0)
        if nk:
            cand = artifacts.blunt_end_candidate(
                seen_np[b, :nk], valid_np[b, :nk], counts_np[b, :nk],
                cfg.read_pair_distance, params.max_edge_clip,
            )
            if cand is not None:
                cands.append((b, cand))
    if not cands:
        return blunt
    # the reference's depth confirmation (isBluntEndArtifact :8558-8560,
    # :8577-8580): the stub end must be a graph DEAD END within maxDepth
    # while an ASSEMBLED-restricted continuation of >= the stub length
    # exists from the last assembled k-mer — both probed in two batched walks
    k = cfg.k
    seeds_end, seeds_alt, stubs = [], [], []
    for b, (side, endi, alti, stub) in cands:
        row = frags[b]
        if side == "r":
            seeds_end.append(np.asarray(row[endi : endi + k]))
            seeds_alt.append(np.asarray(row[alti : alti + k]))
        else:
            seeds_end.append(sequtils.revcomp_codes(np.asarray(row[endi : endi + k])))
            seeds_alt.append(sequtils.revcomp_codes(np.asarray(row[alti : alti + k])))
        stubs.append(stub)
    dep_end = _depth_probe(graph, cfg, seeds_end, params.max_edge_clip, params.lookahead)
    sgraph, pcfg = _screen_as_graph(screen, scfg, cfg)
    dep_alt = _depth_probe(sgraph, pcfg, seeds_alt, max(stubs), params.lookahead)
    for i, (b, (_side, _e, _a, stub)) in enumerate(cands):
        blunt[b] = bool(dep_end[i] < params.max_edge_clip and dep_alt[i] >= stub)
    return blunt


def assemble_transcripts_batch(
    graph: GraphState,
    cfg: GraphConfig,
    screen: torch.Tensor,
    scfg: BloomConfig,
    frags: np.ndarray,
    lens: np.ndarray,
    params: TranscriptParams,
    require_branch_free: Optional[np.ndarray] = None,
) -> Tuple[List[Transcript], List[Transcript], torch.Tensor]:
    """Returns (transcripts, short_transcripts, the screening filter, which
    was updated in place).

    ``require_branch_free``: per-row flag (the -stratum gate,
    assembleTranscriptsMultiThreaded RNABloom.java:4912-4954) — flagged
    fragments are extended only when branch-free; otherwise the fragment
    itself is the transcript candidate."""
    B, L = frags.shape
    chimera = np.zeros(B, bool)
    with span("screen"):
        rep = screen_represented(
            screen, scfg, cfg, frags, lens, params, chimera_out=chimera, graph=graph
        )
        if params.keep_chimeras:  # -chimera (RNABloom.java:6253-6257)
            chimera[:] = False
        blunt = np.zeros(B, bool)
        if params.max_edge_clip > 0 and cfg.read_pair_distance > 0 and not params.keep_artifacts:
            blunt = _blunt_end(graph, cfg, screen, scfg, frags, lens, params)
        tswitch = np.zeros(B, bool)
        if params.template_switch_filter and not params.keep_artifacts:
            tswitch = screen_template_switch(screen, scfg, cfg, frags, lens)
    keep = np.flatnonzero(~rep & ~chimera & ~blunt & ~tswitch)
    transcripts: List[Transcript] = []
    shorts: List[Transcript] = []
    if len(keep) == 0:
        return transcripts, shorts, screen

    K0 = len(keep)
    Kp = 1 << max(6, (K0 - 1).bit_length())  # power-of-two rows, as in the JAX package
    sel = np.full((Kp, L), 4, np.uint8)
    sel[:K0] = frags[keep]
    sel_lens = np.zeros(Kp, lens.dtype)
    sel_lens[:K0] = lens[keep]
    with span("extend"):
        ext, ext_len, orig_s, orig_e = extend_fragments_pair(graph, cfg, sel, sel_lens, params)
        if require_branch_free is not None and require_branch_free[keep].any():
            gated = np.flatnonzero(require_branch_free[keep])
            bf = branch_free_batch(graph, cfg, sel[gated], sel_lens[gated])
            for j, row in enumerate(gated):
                if not bf[j]:  # not branch-free: the fragment itself, unextended
                    n = int(sel_lens[row])
                    ext[row, :] = 4
                    ext[row, :n] = sel[row, :n]
                    ext_len[row] = n
                    orig_s[row] = 0
                    orig_e[row] = n
    with span("break"):
        ranges = break_check(graph, cfg, ext, ext_len, orig_s, orig_e, params)[:K0]
        final = np.full((Kp, params.max_walk_len), 4, np.uint8)
        final_len = np.zeros(Kp, np.int32)
        for i, r in enumerate(ranges):
            if r is None:
                continue
            s, e = r
            e = min(e, int(ext_len[i]))
            if e - s < cfg.k:
                continue
            seq = ext[i, s:e]
            if not params.keep_artifacts:
                seq = artifacts.trim_rc_artifact(seq, k=cfg.k)
            if len(seq) < cfg.k:
                continue
            final[i, : len(seq)] = seq
            final_len[i] = len(seq)

    # final redundancy re-check (vs earlier batches; same-batch duplicates
    # are serialized below)
    with span("screen"):
        rep2 = screen_represented(screen, scfg, cfg, final, final_len, params, graph=graph)
    with span("dedup"):
        # serialize within the batch: mask rows already dead, then screen
        # each survivor against the k-mers accepted earlier in this batch
        seq_lens = np.where(rep2 | (final_len < cfg.k), 0, final_len)
        rep3, _ = sequential_dedup(cfg, final, seq_lens, params, device=screen.device)
        emitted = np.zeros(Kp, bool)
        for i in range(len(keep)):
            n = int(final_len[i])
            if n < cfg.k or rep2[i] or rep3[i]:
                continue
            emitted[i] = True
            t = Transcript(codes=final[i, :n].copy(), length=n)
            if n >= params.min_transcript_length:
                transcripts.append(t)
            else:
                shorts.append(t)
        if emitted.any():
            commit = np.where(emitted[:, None], final, np.uint8(4))
            engine._tick("build")
            screen_add(screen, scfg, cfg, commit)
    return transcripts, shorts, screen
