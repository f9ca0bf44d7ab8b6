"""Bulk paired-end assembly pipeline.

Port of ``rnabloom_tpu/assembly/pipeline.py``: ``assemble_pe`` runs

  Stage 0  read-length sampling -> read-pair distance, tip length
           (setReadLengthBasedParams, RNABloom.java:1011-1033)
  Stage 1  graph build: cbf counters + read-paired-k-mer keys
           (populateGraph2, RNABloom.java:1290-1346), saved with -savebf
  Stage 2  fragment assembly in batches of read pairs into the stratified
           fragment store; fragment-length quartiles of the first sample
           set the fragment pair distance (Q1 - k - minNumKmerPairs) and
           the walk bound (Q3 + 1.5 IQR) (RNABloom.java:4465-4663)

  Stage 2b fragment-graph rebuild (``rebuild_fragment_graph``,
           populateGraphFromFragments, RNABloom.java:1553-1560), with the
           ``-ref`` reference transcripts
  Stage 3  transcripts in batches of fragments in the store's priority
           order (``_run_stage3``, assembleTranscriptsMultiThreaded
           RNABloom.java:4886-4954) -> {name}.transcripts.fa,
           {name}.transcripts.short.fa and {name}.report.json

           and, unless ``no_reduce``, the non-redundant pass over the
           emitted transcripts -> {name}.transcripts.nr.fa

A rerun into the same directory with a saved graph and the stage-2 stamp
resumes at stage 2b.  ``-rescue`` and unpaired reads (``-sef``/``-ser``)
are not ported yet: asking for them raises before any work is done.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bloom import filters
from ..bloom.filters import BloomConfig
from ..graph import dbg, engine
from ..io import fastx, native
from ..io.seqstore import SeqStore
from ..olc import layout as olc_layout, overlap as olc_overlap
from ..utils import checkpoint as ckpt, polya, seq as sequtils
from ..utils.timer import Timer, span, span_totals
from . import correct, fragments as fragmod, stage1, transcripts as txmod
from .fragstore import FragmentStore


@dataclass
class PipelineParams:
    """The JAX package's pipeline parameters, field for field; the fields
    of stages 0-3 are read."""

    k: int = 25
    stranded: bool = False
    min_qual: int = 3
    min_avg_qual: int = 0
    total_mem_bytes: int = 1 << 30
    num_hash: int = 2
    batch_size: int = 8192
    stage3_batch: int = 2048
    sample_size: int = 1000
    min_num_kmer_pairs: int = 10
    min_overlap: int = 10
    bound: int = 500
    min_transcript_length: int = 200
    max_walk_len: int = 4096
    min_fragment_cov: float = 0.0
    max_edge_clip: int = 0
    template_switch_filter: bool = False
    write_uracil: bool = False
    expected_num_kmers: int = 0  # -nk: exact filter sizing at 1% FPR
    max_fpr: float = 0.01  # -fpr: resize + rebuild filters above this
    name: str = "rnabloom"  # -n: assembly name (output file prefix)
    header_prefix: str = ""
    no_reduce: bool = False
    stop_stage: int = 3  # -stage: terminate after this stage (1..3)
    min_kmer_cov: float = 1.0
    err_corr_iters: int = 2
    max_cov_gradient: float = 0.5
    max_indel: int = 1
    percent_identity: float = 0.90
    lookahead: int = 3
    max_tip_length: int = -1  # -tiplength: -1 = auto (median read len - k)
    extend_fragments: bool = False
    frag_consistency: bool = True
    keep_artifacts: bool = False
    keep_chimeras: bool = False
    branch_free_stratum: str = "e0"
    polya_min_len: int = 0
    revcomp_long: bool = False
    lr_min_depth: int = 0
    lr_overlap_prop: float = 0.0
    minimizer_size: int = 0
    minimizer_window: int = 0
    sketch_overlap_prop: float = 0.0
    sketch_overlap_num: int = 0
    hpc: bool = False
    write_paf: bool = False
    paf_in: str = ""
    sbf_hash: int = 0
    dbgbf_hash: int = 0
    cbf_hash: int = 0
    pkbf_hash: int = 0
    sbf_mem_bytes: int = 0
    dbgbf_mem_bytes: int = 0
    cbf_mem_bytes: int = 0
    pkbf_mem_bytes: int = 0
    sharded: str = "auto"
    counter: str = "mf8"  # -cnt {mf8,u16,int32}: counter cell width
    rescue_unconnected: bool = False
    verbose: bool = False

    def graph_config_overrides(self) -> dict:
        return dict(
            dbgbf_hash=self.dbgbf_hash,
            cbf_hash=self.cbf_hash,
            pkbf_hash=self.pkbf_hash,
            dbgbf_mem_bytes=self.dbgbf_mem_bytes,
            cbf_mem_bytes=self.cbf_mem_bytes,
            pkbf_mem_bytes=self.pkbf_mem_bytes,
            counter=self.counter,
        )

    def correct_params(self) -> correct.CorrectParams:
        return correct.CorrectParams(
            max_cov_gradient=self.max_cov_gradient,
            min_kmer_cov=self.min_kmer_cov,
            rounds=self.err_corr_iters,
            max_indel=self.max_indel,
            percent_identity=self.percent_identity,
        )


@dataclass
class PipelineReport:
    stage1: Optional[stage1.Stage1Stats] = None
    num_pairs: int = 0
    num_fragments: int = 0
    num_rescued: int = 0
    num_transcripts: int = 0
    num_short: int = 0
    num_nr: int = 0
    fragment_pair_distance: int = -1
    elapsed_s: float = 0.0
    stage2_dispatches: dict = field(default_factory=dict)
    stage3_dispatches: dict = field(default_factory=dict)
    stage2_batches: int = 0
    stage2_s: float = 0.0
    stage3_s: float = 0.0
    stage3_spans: dict = field(default_factory=dict)  # seconds per utils/timer span


# coverage strata, lowest first (RNABloom.java:150-158: 01 < e0 < .. < e5)
_STRATA = ("01", "e0", "e1", "e2", "e3", "e4", "e5")


def _stratum_rank(s: str) -> int:
    return _STRATA.index(s)


def _fragment_stratum(min_cov: float) -> str:
    if min_cov <= 1:
        return "01"
    return f"e{min(fragmod.coverage_order_of_magnitude(min_cov), 5)}"


def _stratum_gate(params: "PipelineParams", covs: np.ndarray, lens: np.ndarray) -> Optional[np.ndarray]:
    """-stratum: the rows of a stage-3 batch whose fragments lie in a
    stratum below the threshold, which extend only when branch-free
    (RNABloom.java:4912-4954); None when there are none."""
    thr_rank = _stratum_rank(params.branch_free_stratum)
    gate = np.array([n > 0 and _stratum_rank(_fragment_stratum(c)) < thr_rank for c, n in zip(covs, lens)], bool)
    return gate if gate.any() else None


# ---- stage 2 (fragments) ----


def _avg_qual_ok(qual: Optional[str], min_avg: int) -> bool:
    """Whole-read average base quality gate (-Q/qual-avg,
    FastqFilteredReader's min-avg-qual check)."""
    if qual is None or not qual:
        return True
    q = np.frombuffer(qual.encode("ascii"), np.uint8)
    return float(q.mean()) - 33.0 >= min_avg


def _segments_of(
    seq: str, qual: Optional[str], min_qual: int, k: int, L: int, revcomp: bool
) -> List[np.ndarray]:
    """Quality-split segments of one read, in fragment orientation."""
    codes = sequtils.encode(seq)[:L]
    quals = (
        np.frombuffer(qual.encode("ascii"), np.uint8)[: len(codes)]
        if qual
        else None
    )
    segs = sequtils.segment_read(codes, quals, min_qual, k)
    if revcomp:
        segs = [sequtils.revcomp_codes(s) for s in reversed(segs)]
    return segs


def _best_segments(
    codes: np.ndarray, lens: np.ndarray, k: int, rc: bool
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Per-row longest quality segment from MASKED rows (bad bases = 4).

    Vectorized over the batch: segments are the runs of codes < 4; the
    longest (>= k) lands left-aligned in the output buffer, and rows with
    several segments report them all for connect(segments) re-joining.
    With ``rc`` the whole row is reverse-complemented first — segments
    flip into fragment orientation and reverse order in one shot."""
    B, L = codes.shape
    if rc:
        codes = fragmod.revcomp_rows(codes, np.asarray(lens, np.int64))
    inlen = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    good = (codes < 4) & inlen
    out = np.full((B, L), 4, np.uint8)
    outlen = np.zeros(B, np.int32)
    multi: dict = {}
    if not good.any():
        return out, outlen, multi
    rs, ss, es = correct._batch_runs(good)
    rl = es - ss
    keep = rl >= k
    rs, ss, es, rl = rs[keep], ss[keep], es[keep], rl[keep]
    if len(rs) == 0:
        return out, outlen, multi
    best_len = np.zeros(B, np.int64)
    np.maximum.at(best_len, rs, rl)
    cand = np.flatnonzero(rl == best_len[rs])
    first = np.ones(len(cand), bool)
    first[1:] = rs[cand][1:] != rs[cand][:-1]  # runs are emitted row-major
    sel = cand[first]
    rows, s0, ln = rs[sel], ss[sel], rl[sel]
    idx = np.minimum(s0[:, None] + np.arange(L)[None, :], L - 1)
    gathered = np.take_along_axis(codes[rows], idx, axis=1)
    m = np.arange(L)[None, :] < ln[:, None]
    out[rows] = np.where(m, gathered, np.uint8(4))
    outlen[rows] = ln
    cnt = np.bincount(rs, minlength=B)
    for b in np.flatnonzero(cnt > 1):
        sel_b = rs == b
        multi[int(b)] = [
            codes[b, a:z] for a, z in zip(ss[sel_b], es[sel_b])
        ]
    return out, outlen, multi


def _iter_pair_batches_native(
    left_path: str,
    right_path: str,
    params: PipelineParams,
    k: int,
    revcomp_left: bool,
    revcomp_right: bool,
    L: int,
):
    """Native-reader stage-2 feeder: the C++ parser masks low-quality
    bases to 4 and the segment selection is vectorized — no per-read
    Python on the critical path (the stage the JVM throws its threads at,
    RNABloom.java:4465-4663)."""
    B = params.batch_size
    gl = native.read_masked_batches(left_path, B, L, params.min_qual)
    gr = native.read_masked_batches(right_path, B, L, params.min_qual)
    for (lb0, ll0, lq), (rb0, rl0, rq) in zip(gl, gr):
        n = min(lb0.shape[0], rb0.shape[0])
        lb0, ll0, rb0, rl0 = lb0[:n], ll0[:n].copy(), rb0[:n], rl0[:n].copy()
        if params.min_avg_qual > 0:
            bad = (lq[:n] < params.min_avg_qual) | (rq[:n] < params.min_avg_qual)
            ll0[bad] = 0
            rl0[bad] = 0
        lbuf, llen, lmulti = _best_segments(lb0, ll0, k, revcomp_left)
        rbuf, rlen, rmulti = _best_segments(rb0, rl0, k, revcomp_right)
        # a pair needs a usable segment on BOTH sides
        none = (llen == 0) | (rlen == 0)
        llen[none] = 0
        rlen[none] = 0
        multi = {("l", b): segs for b, segs in lmulti.items() if not none[b]}
        multi.update(
            (("r", b), segs) for b, segs in rmulti.items() if not none[b]
        )
        if n < B:  # keep the (B, L) shape, as the JAX package does
            pad = B - n
            lbuf = np.concatenate([lbuf, np.full((pad, L), 4, np.uint8)])
            rbuf = np.concatenate([rbuf, np.full((pad, L), 4, np.uint8)])
            llen = np.concatenate([llen, np.zeros(pad, np.int32)])
            rlen = np.concatenate([rlen, np.zeros(pad, np.int32)])
        yield lbuf, llen, rbuf, rlen, multi


def _prefetch(gen, depth: int = 2):
    """Run a generator on a background thread with a bounded queue —
    host parsing/segmenting of batch i+1 overlaps device compute of batch
    i (the reference gets this overlap from its reader/worker threads,
    RNABloom.java:1203-1238)."""
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    END = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
            q.put(END)
        except BaseException as e:  # surfaced on the consumer side
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _iter_pair_batches(
    left_path: str,
    right_path: str,
    params: PipelineParams,
    k: int,
    revcomp_left: bool,
    revcomp_right: bool,
    L: int,
):
    """Yield (left_codes, left_len, right_codes, right_len, multi) batches.

    The right mate is flipped into fragment orientation (the reference's
    FR convention: fragment = left .. rc(right) unless flags say otherwise).
    Reads are quality-segmented exactly as in stage 1 (the reference's
    FastqFilteredReader feeds PairedReadSegments to stage 2); a read with
    one segment contributes that segment, and a multi-segment read's
    longest segment goes in the buffer while ``multi`` records
    (side, row) -> all segments for connect(segments) re-joining.
    """
    if native.available():
        yield from _prefetch(
            _iter_pair_batches_native(
                left_path, right_path, params, k, revcomp_left, revcomp_right, L,
            )
        )
        return
    B = params.batch_size
    lbuf = np.full((B, L), 4, np.uint8)
    rbuf = np.full((B, L), 4, np.uint8)
    llen = np.zeros(B, np.int32)
    rlen = np.zeros(B, np.int32)
    multi: dict = {}
    n = 0
    for (ln, ls, lq), (rn, rs, rq) in fastx.read_paired(left_path, right_path):
        if params.min_avg_qual > 0 and not (
            _avg_qual_ok(lq, params.min_avg_qual) and _avg_qual_ok(rq, params.min_avg_qual)
        ):
            continue
        lsegs = _segments_of(ls, lq, params.min_qual, k, L, revcomp_left)
        rsegs = _segments_of(rs, rq, params.min_qual, k, L, revcomp_right)
        if not lsegs or not rsegs:
            continue
        lbest = max(lsegs, key=len)
        rbest = max(rsegs, key=len)
        lbuf[n, : len(lbest)] = lbest
        llen[n] = len(lbest)
        rbuf[n, : len(rbest)] = rbest
        rlen[n] = len(rbest)
        if len(lsegs) > 1:
            multi[("l", n)] = lsegs
        if len(rsegs) > 1:
            multi[("r", n)] = rsegs
        n += 1
        if n == B:
            yield lbuf, llen, rbuf, rlen, multi
            lbuf = np.full((B, L), 4, np.uint8)
            rbuf = np.full((B, L), 4, np.uint8)
            llen = np.zeros(B, np.int32)
            rlen = np.zeros(B, np.int32)
            multi = {}
            n = 0
    if n:
        # keep the full (B, L) shape, as the JAX package does
        yield lbuf, llen, rbuf, rlen, multi


def _connect_multi_segments(
    state: dbg.GraphState,
    cfg: dbg.GraphConfig,
    lbuf: np.ndarray,
    llen: np.ndarray,
    rbuf: np.ndarray,
    rlen: np.ndarray,
    multi: dict,
    fparams: "fragmod.FragmentParams",
) -> None:
    """Re-join quality-split mates through the graph before pairing
    (connect(segments), GraphUtils.java:4836-4897).  Buffers are updated
    in place when the joined sequence beats the longest-segment fallback."""
    if not multi:
        return
    keys = sorted(multi.keys())
    joined = fragmod.connect_segments_batch(
        state, cfg, [multi[key] for key in keys], fparams
    )
    L = lbuf.shape[1]
    for key, seq in zip(keys, joined):
        side, row = key
        n = min(len(seq), L)
        buf, lens = (lbuf, llen) if side == "l" else (rbuf, rlen)
        if n > lens[row]:
            buf[row, :n] = seq[:n]
            buf[row, n:] = 4
            lens[row] = n


def _new_fragment_store(outdir: str, params: PipelineParams) -> FragmentStore:
    return FragmentStore(
        outdir,
        long_threshold=params.min_transcript_length,
        polya_priority=params.polya_min_len > 0,
    )


def _store_fragment(store: FragmentStore, f: "fragmod.Fragment", params: PipelineParams) -> None:
    pa = params.polya_min_len > 0 and polya.find_polya_tail(f.codes) is not None
    store.add(f.codes, f.min_cov, f.connected, polya=pa)


def _stage2_pair_loop(
    state,
    cfg: dbg.GraphConfig,
    left_path: str,
    right_path: str,
    params: PipelineParams,
    revcomp_left: bool,
    revcomp_right: bool,
    read_L: int,
    fparams: "fragmod.FragmentParams",
    store: FragmentStore,
    report: "PipelineReport",
    frag_lengths: List[int],
) -> int:
    """The stage-2 fragment loop over the pair stream.

    Returns the learned fragment pair distance (-1 when the sample never
    filled: the caller derives it from all lengths)."""
    k = cfg.k
    learned = False
    d_frag = -1
    _d0 = engine.dispatch_counts()
    for lb, ll, rb, rl, multi in _iter_pair_batches(
        left_path, right_path, params, k, revcomp_left, revcomp_right, read_L,
    ):
        report.num_pairs += int((ll > 0).sum())
        _connect_multi_segments(state, cfg, lb, ll, rb, rl, multi, fparams)
        outs = fragmod.assemble_fragments_batch(state, cfg, lb, ll, rb, rl, fparams)
        for f in outs:
            if f is not None and f.min_cov >= params.min_fragment_cov:
                _store_fragment(store, f, params)
                frag_lengths.append(f.length)
        report.stage2_batches += 1
        if not learned and len(frag_lengths) >= params.sample_size:
            # the fragment pair distance (sample Q1 - k - minNumKmerPairs)
            # and the walk bound come from the first sampleSize fragments'
            # quartiles; later batches walk with the new bound
            # (RNABloom.java:4534-4568)
            learned = True
            q1, _, q3 = sequtils.quartiles(np.asarray(frag_lengths))
            fparams.bound = int(q3 + (q3 - q1) * 3 // 2)
            d_frag = max(1, int(q1) - k - params.min_num_kmer_pairs)
    _d1 = engine.dispatch_counts()
    report.stage2_dispatches = {k2: _d1[k2] - _d0[k2] for k2 in _d1}
    return d_frag


def rebuild_fragment_graph(
    state: dbg.GraphState, cfg: dbg.GraphConfig, store: FragmentStore, params: PipelineParams,
    ref_paths: Sequence[str] = (),
) -> dbg.GraphState:
    """Stage 2b: the fragment graph on ``state``'s device.  Zeroed counters
    and a fresh fpkbf, the read-pair keys kept (shared with ``state``); the
    stored fragments go in, in batches of 1024 in the store's priority
    order, each batch's counter (0, 1, ...) salting the mf8 rounding.  The
    fragment-pair keys go in when a fragment row holds more k-mers than the
    fragment pair distance.  Then the reference transcripts of
    ``ref_paths`` (``-ref``, populateGraphFromFragments' refFastas branch),
    one row of ``max_walk_len`` bases a step, salts counting on."""
    k = cfg.k
    frag_L = int(min(max(store.max_len, 2 * k), params.max_walk_len))
    add_pairs = frag_L - k + 1 > cfg.fragment_pair_distance
    state = engine.fresh_rebuild_state(state, cfg)
    nbatch = 0
    for codes, _lens, _covs, _conn in store.iter_batches(1024, width=frag_L):
        state = engine.rebuild_step(state, cfg, codes, add_frag_pairs=add_pairs, salt=nbatch)
        nbatch += 1

    W = params.max_walk_len
    for rp in ref_paths:
        for _, rseq in fastx.read_fasta(rp):
            codes_r = sequtils.encode(rseq.upper())
            if len(codes_r) < k:
                continue
            for s0 in range(0, len(codes_r), W - k + 1):
                chunk = np.full((1, W), 4, np.uint8)
                piece = codes_r[s0 : s0 + W]
                chunk[0, : len(piece)] = piece
                state = engine.rebuild_step(
                    state, cfg, chunk, add_frag_pairs=W - k + 1 > cfg.fragment_pair_distance, salt=nbatch
                )
                nbatch += 1
    return state


def _transcript_params(cfg: dbg.GraphConfig, params: PipelineParams) -> "txmod.TranscriptParams":
    return txmod.TranscriptParams(
        min_transcript_length=params.min_transcript_length,
        max_walk_len=params.max_walk_len,
        # -a > 0 disables the blunt-end clip screen (RNABloom.java:1820)
        max_edge_clip=0 if params.polya_min_len > 0 else params.max_edge_clip,
        template_switch_filter=params.template_switch_filter,
        max_indel=params.max_indel,
        percent_identity=params.percent_identity,
        lookahead=params.lookahead,
        tip_probe_depth=min(params.max_tip_length, cfg.k - 1) if params.max_tip_length >= 0 else 8,
        # -tiplength also bounds the screen's forgivable edge clip
        # (represented()'s maxEdgeClipLength = maxTipLength); -1 = auto
        screen_max_edge_clip=params.max_tip_length,
        keep_chimeras=params.keep_chimeras,
        keep_artifacts=params.keep_artifacts,
        frag_consistency=params.frag_consistency,
    )


def _write_transcript(w: "fastx.FastaWriter", name: str, t: "txmod.Transcript", params: PipelineParams) -> None:
    """One transcripts.fa record: a poly-T-headed transcript flipped into
    poly-A-tail orientation under -a (TranscriptWriter RNABloom.java:
    1652-1676), then the PAS positions in the header and the tail
    lowercase-masked (:1752-1766)."""
    if params.polya_min_len > 0 and not params.stranded:
        if polya.find_polya_tail(t.codes) is None and polya.find_polyt_head(t.codes) is not None:
            t.codes = sequtils.revcomp_codes(t.codes)
    seq = sequtils.decode(t.codes)
    comment = f"l={t.length}"
    tail = polya.find_polya_tail(t.codes)
    if tail is not None:
        pas = polya.find_pas_positions(seq, tail[0])
        if pas:
            comment += " pas=" + ",".join(map(str, pas))
        seq = seq[: tail[0]] + seq[tail[0] :].lower()
    w.write(name, seq, comment)


def _run_stage3(
    state: dbg.GraphState,
    cfg: dbg.GraphConfig,
    store: FragmentStore,
    outdir: str,
    params: PipelineParams,
    report: PipelineReport,
) -> None:
    """Stratified transcript assembly, then (unless ``no_reduce``) the
    non-redundant pass.  Fragments stream from the stratified store in the
    reference's priority order in fixed-size batches; the screening filter
    lives on the graph's device (assembleTranscriptsMultiThreaded,
    RNABloom.java:4886-4954).  Fills the report's stage-3 counts,
    dispatches and spans."""
    sbf_log2 = (
        filters.pow2_size(params.sbf_mem_bytes).bit_length() - 1
        if params.sbf_mem_bytes > 0
        else cfg.pkbf.size_log2
    )
    scfg = BloomConfig(sbf_log2, params.sbf_hash or cfg.pkbf.num_hash)
    screen = filters.make_bloom(scfg, device=state.cbf.device)
    tparams = _transcript_params(cfg, params)
    _d0, _s0 = engine.dispatch_counts(), span_totals()
    frag_L = int(min(max(store.max_len, cfg.k), params.max_walk_len))
    tx_path = os.path.join(outdir, f"{params.name}.transcripts.fa")
    short_path = os.path.join(outdir, f"{params.name}.transcripts.short.fa")
    # emitted transcripts (after the -a flip) spool to a disk-backed 2-bit
    # store for the nr pass (the streamed analog of generateNonRedundant
    # Transcripts re-reading transcripts.fa, RNABloom.java:5676)
    emitted = SeqStore(os.path.join(outdir, f".{params.name}.nr_input.2bit"))
    with fastx.FastaWriter(tx_path, uracil=params.write_uracil) as wtx, fastx.FastaWriter(
        short_path, uracil=params.write_uracil
    ) as wsh:
        for sel, sel_len, covs, _conn in store.iter_batches(params.stage3_batch, width=frag_L):
            txs, shorts, screen = txmod.assemble_transcripts_batch(
                state, cfg, screen, scfg, sel, sel_len, tparams,
                require_branch_free=_stratum_gate(params, covs, sel_len),
            )
            with span("write"):
                for t in txs:
                    _write_transcript(wtx, f"{params.header_prefix}{params.name}.{report.num_transcripts}", t, params)
                    emitted.append(t.codes)
                    report.num_transcripts += 1
                for t in shorts:
                    wsh.write(f"{params.header_prefix}{params.name}.s{report.num_short}", sequtils.decode(t.codes))
                    report.num_short += 1

    # the nr pass: contained transcripts are dropped and unambiguously
    # dovetailing ones merge into unitigs (the reference's minimap2 ava and
    # Layout.extractSimplePaths, OverlapLayoutConsensus.overlapLayout :878)
    if len(emitted) and not params.no_reduce:
        with span("nr"):
            op = olc_overlap.OverlapParams(min_overlap=max(params.min_transcript_length // 2, 100))
            nr_seqs, _, _ = olc_layout.layout_unitigs(emitted, cfg.k, op, device=state.cbf.device)
            nr_path = os.path.join(outdir, f"{params.name}.transcripts.nr.fa")
            with fastx.FastaWriter(nr_path, uracil=params.write_uracil) as wnr:
                for j, s in enumerate(nr_seqs):
                    wnr.write(f"{params.header_prefix}{params.name}.nr.{j}", sequtils.decode(s), f"l={len(s)}")
            report.num_nr = len(nr_seqs)
    emitted.close(delete=True)
    _d1, _s1 = engine.dispatch_counts(), span_totals()
    report.stage3_dispatches = {k: _d1[k] - _d0[k] for k in _d1}
    report.stage3_spans = {k: v - _s0.get(k, 0.0) for k, v in _s1.items()}


def _finish_pe_stage3(
    state: dbg.GraphState,
    cfg: dbg.GraphConfig,
    store: FragmentStore,
    outdir: str,
    params: PipelineParams,
    report: PipelineReport,
    ref_paths: Sequence[str] = (),
) -> None:
    """Stage 2b (the fragment-graph rebuild, ``-ref`` transcripts added)
    then stage 3, both streaming the store's batches; stamps the stage-3
    steps done."""
    state = rebuild_fragment_graph(state, cfg, store, params, ref_paths)
    _run_stage3(state, cfg, store, outdir, params, report)
    ckpt.touch_stamp(outdir, ckpt.STAMP_TRANSCRIPTS_DONE)
    ckpt.touch_stamp(outdir, ckpt.STAMP_TRANSCRIPTS_NR_DONE)


def _refuse_unported(params: PipelineParams, sef_paths, ser_paths) -> None:
    if params.rescue_unconnected:
        raise NotImplementedError("-rescue (the stage-2b rescue pass) is ROADMAP queue-1 item 12")
    if sef_paths or ser_paths:
        raise NotImplementedError("unpaired reads (-sef/-ser) are ROADMAP queue-1 item 12")


def assemble_pe(
    left_path: str,
    right_path: str,
    outdir: str,
    params: PipelineParams,
    revcomp_left: bool = False,
    revcomp_right: bool = True,
    save_graph: bool = False,
    force: bool = False,
    device="cuda",
    sef_paths: Sequence[str] = (),
    ser_paths: Sequence[str] = (),
    ref_paths: Sequence[str] = (),
) -> PipelineReport:
    """Bulk paired-end assembly through ``params.stop_stage`` on ``device``
    (the card unless the caller asks for the CPU; raises when there is no
    card).  With ``save_graph`` the graph is checkpointed under
    {outdir}/{name}.graph after stage 1 or 2; stage 2 writes the fragment
    store under {outdir}/fragments; stage 3 writes
    {outdir}/{name}.transcripts.fa, .transcripts.short.fa, (unless
    ``no_reduce``) .transcripts.nr.fa, and .report.json.  ``ref_paths``:
    reference transcript FASTAs added to the fragment graph (-ref).  A stage-3 run into a directory that holds the
    stage-2 stamp and a saved graph (and without ``force``) resumes at stage
    2b and writes no report.json, as the JAX package does."""
    _refuse_unported(params, sef_paths, ser_paths)
    device = engine.require_device(device)
    t0 = time.time()
    os.makedirs(outdir, exist_ok=True)
    if force:
        ckpt.clear_stamps(outdir)
    ckpt.touch_stamp(outdir, ckpt.STAMP_STARTED)
    graph_prefix = os.path.join(outdir, f"{params.name}.graph")
    report = PipelineReport()
    timer = Timer(quiet=not params.verbose)
    k = params.k

    # resume: stages 1 and 2 complete with a saved graph -> jump to stage 2b
    # (the JAX package takes this jump whatever -stage says; the port, as
    # the reference, only when stage 3 was asked for)
    if (
        params.stop_stage >= 3
        and not force
        and ckpt.has_stamp(outdir, ckpt.STAMP_FRAGMENTS_DONE)
        and os.path.exists(graph_prefix + ".graph.json")
    ):
        store = FragmentStore.open(outdir)
        if store is not None and store.count > 0:
            state, cfg = ckpt.load_graph(graph_prefix, device=device)
            report.num_fragments = store.count
            report.fragment_pair_distance = cfg.fragment_pair_distance
            _finish_pe_stage3(state, cfg, store, outdir, params, report)
            report.elapsed_s = time.time() - t0
            return report

    # ---- stage 0: read length params (quartiles persisted to .readstats so
    # reruns skip the sampling pass, RNABloom.java:2669-2714)
    readstats_path = os.path.join(outdir, f"{params.name}.readstats")
    lengths = None
    nk_hint = 0
    if not force and os.path.exists(readstats_path):
        try:
            with open(readstats_path) as fh:
                rs = json.load(fh)
            lengths = np.asarray(rs["lengths"], np.int64)
            nk_hint = int(rs.get("distinct_kmers", 0))
        except (json.JSONDecodeError, KeyError):
            lengths = None
    if lengths is None:
        lengths = stage1.sample_read_lengths([left_path, right_path], params.sample_size)
        with open(readstats_path, "w") as fh:
            q = sequtils.quartiles(lengths) if len(lengths) else (0, 0, 0)
            json.dump({"lengths": [int(x) for x in lengths], "quartiles": list(map(int, q))}, fh)
    d_read, max_tip = stage1.read_length_params(lengths, k, params.min_num_kmer_pairs)
    if params.max_tip_length >= 0:
        max_tip = params.max_tip_length
    read_L = int(max(lengths.max(initial=150), k + d_read + 1))

    # a rerun sizes filters from the previous run's distinct-k-mer estimate
    cfg = stage1.default_graph_config(
        k, params.stranded, params.total_mem_bytes, params.num_hash, d_read,
        expected_num_kmers=params.expected_num_kmers or nk_hint,
        **params.graph_config_overrides(),
    )
    if params.verbose:
        cbf_mb = (cfg.cbf.size * cfg.cbf.cell_bytes) >> 20
        pk_mb = cfg.pkbf.size >> 20 if cfg.pkbf else 0
        print(
            f"Mem plan: cbf {cbf_mb} MB (2^{cfg.cbf.size_log2} x "
            f"{cfg.cbf.cell_bytes} B {cfg.cbf.dtype}), rpkbf {pk_mb} MB; "
            f"k={k} d_read={d_read} hash={cfg.cbf.num_hash} device={device}",
            flush=True,
        )

    # ---- stage 1: graph build (right mates revcomp'd onto forward strand)
    timer.start("stage 1: de Bruijn graph construction")
    s1p = stage1.Stage1Params(
        k=k, stranded=params.stranded, min_qual=params.min_qual, max_seq_len=max(read_L, 2 * k),
    )
    state, s1_stats, cfg = stage1.build_graph_autosized(
        [left_path, right_path], cfg, s1p, max_fpr=params.max_fpr, device=device,
        revcomp_flags=[revcomp_left, revcomp_right], add_read_pairs=True,
    )
    s1_stats.read_pair_distance = d_read
    s1_stats.max_tip_length = max_tip
    report.stage1 = s1_stats
    if s1_stats.distinct_kmers_est > 0:
        try:  # persist for rerun filter sizing
            with open(readstats_path) as fh:
                rs = json.load(fh)
            rs["distinct_kmers"] = s1_stats.distinct_kmers_est
            with open(readstats_path, "w") as fh:
                json.dump(rs, fh)
        except (json.JSONDecodeError, OSError):
            pass
    timer.done("graph built", f"{s1_stats.num_segments} segments, FPRs {s1_stats.fprs}")
    ckpt.touch_stamp(outdir, ckpt.STAMP_DBG_DONE)
    if params.stop_stage <= 1:  # -stage 1: graph only (RNABloom.java:6447-6500)
        if save_graph:
            ckpt.save_graph(graph_prefix, engine.to_host_state(state, cfg), cfg)
        report.elapsed_s = time.time() - t0
        return report

    # ---- stage 2: fragments
    timer.start("stage 2: fragment assembly")
    t_s2 = time.time()
    fparams = fragmod.FragmentParams(
        min_overlap=params.min_overlap, bound=params.bound,
        lookahead=params.lookahead, extend_fragments=params.extend_fragments,
        ec_params=params.correct_params(),
    )
    store = _new_fragment_store(outdir, params)
    frag_lengths: List[int] = []
    d_frag = _stage2_pair_loop(
        state, cfg, left_path, right_path, params, revcomp_left,
        revcomp_right, read_L, fparams, store, report, frag_lengths,
    )
    report.num_fragments = store.count
    if store.count == 0:
        store.close()
        report.elapsed_s = time.time() - t0
        return report

    if d_frag < 0:  # input smaller than the sample: use all lengths
        q1, _, q3 = sequtils.quartiles(np.asarray(frag_lengths))
        d_frag = max(1, int(q1) - k - params.min_num_kmer_pairs)
    report.fragment_pair_distance = d_frag
    cfg = dbg.GraphConfig(
        k=cfg.k, stranded=cfg.stranded, dbgbf=cfg.dbgbf, cbf=cfg.cbf,
        pkbf=cfg.pkbf, read_pair_distance=cfg.read_pair_distance,
        fragment_pair_distance=d_frag, exact_counts=cfg.exact_counts,
    )
    store.close()
    if state.cbf.is_cuda:
        torch.cuda.synchronize(state.cbf.device)
    report.stage2_s = time.time() - t_s2
    timer.done("fragments assembled", f"{store.count}/{report.num_pairs} pairs connected")
    if save_graph:
        ckpt.save_graph(graph_prefix, engine.to_host_state(state, cfg), cfg)
        ckpt.update_fragment_distance(graph_prefix, d_frag)
    ckpt.touch_stamp(outdir, ckpt.STAMP_FRAGMENTS_DONE)
    if params.stop_stage <= 2:  # -stage 2: stop after fragment assembly
        report.elapsed_s = time.time() - t0
        return report

    timer.start("stage 3: transcript assembly")
    t_s3 = time.time()
    _finish_pe_stage3(state, cfg, store, outdir, params, report, ref_paths=ref_paths)
    if state.cbf.is_cuda:
        torch.cuda.synchronize(state.cbf.device)
    report.stage3_s = time.time() - t_s3
    timer.done("transcripts assembled", f"{report.num_transcripts} transcripts, {report.num_nr} nr")
    report.elapsed_s = time.time() - t0
    with open(os.path.join(outdir, f"{params.name}.report.json"), "w") as f:
        json.dump(
            {
                "num_pairs": report.num_pairs,
                "num_fragments": report.num_fragments,
                "num_transcripts": report.num_transcripts,
                "num_short": report.num_short,
                "fragment_pair_distance": report.fragment_pair_distance,
                "elapsed_s": report.elapsed_s,
            },
            f,
        )
    return report
