"""Assembly pipelines: bulk paired-end, single-end, mixed, pooled and
long-read.

Port of ``rnabloom_tpu/assembly/pipeline.py``: ``assemble_pe`` runs

  Stage 0  read-length sampling -> read-pair distance, tip length
           (setReadLengthBasedParams, RNABloom.java:1011-1033)
  Stage 1  graph build: cbf counters + read-paired-k-mer keys
           (populateGraph2, RNABloom.java:1290-1346), saved with -savebf
  Stage 2  fragment assembly in batches of read pairs into the stratified
           fragment store; fragment-length quartiles of the first sample
           set the fragment pair distance (Q1 - k - minNumKmerPairs) and
           the walk bound (Q3 + 1.5 IQR) (RNABloom.java:4465-4663); then
           the unpaired reads of a mixed run (``-sef``/``-ser``) as
           unconnected fragments, and with ``-rescue`` a second attempt
           at the unconnected pairs against a fragment graph

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
resumes at stage 2b.  ``assemble_se`` runs the same stages over unpaired
reads (``-sef``/``-ser``), and ``assemble_pool`` over a pooled READSLIST
(``-pool``) with one shared stage-1 graph and stages 2-3 per sample;
``merge_pool`` (``-mergepool``) lays the samples' transcripts out into one
merged set.  ``assemble_long`` (``-long``) builds the graph over long
reads, corrects them, optionally subsamples them (``-lrsub``) and lays
them out with the internal uniqueOLC, then reduces redundancy.
``assemble_pe_multihost`` and ``assemble_long_multihost`` run the PE and
long-read paths across the processes of a group
(``parallel/multihost.py``): stage 1 by local builds and one merge, stage
2 over record-modulo slices, the last stage on process 0.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..bloom import filters
from ..bloom.filters import BloomConfig
from ..graph import dbg, engine
from ..io import fastx, native, paf as pafmod
from ..io.seqstore import SeqStore
from ..olc import layout as olc_layout, overlap as olc_overlap
from ..parallel import multihost
from ..utils import checkpoint as ckpt, polya, seq as sequtils
from ..utils.timer import Timer, span, span_totals
from . import artifacts, correct, fragments as fragmod, longreads as lrmod, stage1, transcripts as txmod
from .fragstore import FragmentStore, merge_stores


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


def _mesh_for(params: PipelineParams, device):
    """The mesh of this run (``params.sharded``): one shard a visible card
    when more than one is visible ("auto"), required ("on": raises where
    fewer than two are visible or ``device`` is the CPU), or none ("off")."""
    if params.sharded == "off":
        return None
    mesh = engine.make_mesh_if_multi(device)
    if mesh is None and params.sharded == "on":
        raise RuntimeError("-sharded on requires >1 CUDA device")
    return mesh


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
    stride=None,
):
    """Native-reader stage-2 feeder: the C++ parser masks low-quality
    bases to 4 and the segment selection is vectorized — no per-read
    Python on the critical path (the stage the JVM throws its threads at,
    RNABloom.java:4465-4663)."""
    B = params.batch_size
    gl = native.read_masked_batches(left_path, B, L, params.min_qual, stride=stride)
    gr = native.read_masked_batches(right_path, B, L, params.min_qual, stride=stride)
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
    stride=None,
):
    """Yield (left_codes, left_len, right_codes, right_len, multi) batches.

    The right mate is flipped into fragment orientation (the reference's
    FR convention: fragment = left .. rc(right) unless flags say otherwise).
    Reads are quality-segmented exactly as in stage 1 (the reference's
    FastqFilteredReader feeds PairedReadSegments to stage 2); a read with
    one segment contributes that segment, and a multi-segment read's
    longest segment goes in the buffer while ``multi`` records
    (side, row) -> all segments for connect(segments) re-joining.
    ``stride`` (process_id, num_processes) keeps pairs p, p+n, ... (a
    multi-host process's slice).
    """
    if native.available():
        yield from _prefetch(
            _iter_pair_batches_native(
                left_path, right_path, params, k, revcomp_left, revcomp_right, L, stride=stride,
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
    for rec_i, ((ln, ls, lq), (rn, rs, rq)) in enumerate(fastx.read_paired(left_path, right_path)):
        if stride is not None and rec_i % stride[1] != stride[0]:
            continue
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


def _ingest_se_fragments(
    state: dbg.GraphState,
    cfg: dbg.GraphConfig,
    sef_paths: Sequence[str],
    ser_paths: Sequence[str],
    read_L: int,
    params: PipelineParams,
    store: FragmentStore,
    frag_lengths: List[int],
    report: PipelineReport,
) -> None:
    """Unpaired reads (-sef/-ser) become error-corrected unconnected
    fragments (SingleEndReadExtractor, RNABloom.java:1935-2036): the -Q
    average-quality gate, per-base quality segments with the graph re-join
    of split reads (connect(segments), GraphUtils.java:4836-4897), the
    low-complexity gate (RNABloom.java:1983), correction, and the real
    minimum k-mer coverage as the fragment's stratum.

    As in the JAX package (its pipeline.py:457-461, with every caller's
    ``fparams=None``), the re-join walks with a fresh ``FragmentParams``
    without ``-extend`` and the run's own bound, and no fragment is held to
    ``min_fragment_cov``."""
    k = cfg.k
    ecp = params.correct_params()
    fparams = fragmod.FragmentParams(
        min_overlap=params.min_overlap, bound=params.bound, lookahead=params.lookahead, ec_params=ecp,
    )
    for path, rc in [(p, False) for p in sef_paths] + [(p, True) for p in ser_paths]:
        buf = np.full((params.batch_size, read_L), 4, np.uint8)
        lens = np.zeros(params.batch_size, np.int32)
        multi: dict = {}
        n = 0

        def flush_se(n):
            if n == 0:
                return
            # re-join quality-split segments through the graph before EC
            if multi:
                keys = sorted(multi.keys())
                joined = fragmod.connect_segments_batch(state, cfg, [multi[key] for key in keys], fparams)
                for key, seqj in zip(keys, joined):
                    m = min(len(seqj), read_L)
                    if m > lens[key]:
                        buf[key, :m] = seqj[:m]
                        buf[key, m:] = 4
                        lens[key] = m
                multi.clear()
            fixed, flens, _ = correct.correct_batch(state, cfg, buf[:n], lens[:n], ecp)
            counts, valid = engine.count_step(state, cfg, fixed)
            counts, valid = counts.cpu().numpy(), valid.cpu().numpy()
            for i in range(n):
                nk = int(flens[i]) - k + 1
                v = valid[i, :nk]
                if nk <= 0 or not v.any():
                    continue
                mc = float(counts[i, :nk][v].min())
                _store_fragment(
                    store,
                    fragmod.Fragment(codes=fixed[i, : flens[i]].copy(), min_cov=mc, length=int(flens[i]),
                                     connected=False),
                    params,
                )
                frag_lengths.append(int(flens[i]))

        for _, rs, rq in fastx.read_seqs(path):
            if params.min_avg_qual > 0 and not _avg_qual_ok(rq, params.min_avg_qual):
                continue
            segs = _segments_of(rs, rq, params.min_qual, k, read_L, rc)
            segs = [s for s in segs if len(s) >= k]
            if not segs:
                continue
            best = max(segs, key=len)
            if artifacts.is_low_complexity_short(best):
                continue
            buf[n, : len(best)] = best
            buf[n, len(best) :] = 4
            lens[n] = len(best)
            if len(segs) > 1:
                multi[n] = segs
            n += 1
            report.num_pairs += 1
            if n == params.batch_size:
                flush_se(n)
                n = 0
        flush_se(n)


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
    stride=None,
    rescue_spill: Optional[list] = None,
) -> int:
    """The stage-2 fragment loop over the pair stream, or over the
    record-modulo slice ``stride`` (process_id, num_processes) of it in a
    multi-host stage 2 (the fragment-length sample then learns from the
    slice).  With a ``rescue_spill`` list (``-rescue``), unconnected pairs
    whose mates both hold a k-mer are kept there, up to
    ``_RESCUE_SPILL_CAP``.

    Returns the learned fragment pair distance (-1 when the sample never
    filled: the caller derives it from all lengths)."""
    k = cfg.k
    learned = False
    d_frag = -1
    _d0 = engine.dispatch_counts()
    for lb, ll, rb, rl, multi in _iter_pair_batches(
        left_path, right_path, params, k, revcomp_left, revcomp_right, read_L, stride=stride,
    ):
        report.num_pairs += int((ll > 0).sum())
        _connect_multi_segments(state, cfg, lb, ll, rb, rl, multi, fparams)
        outs = fragmod.assemble_fragments_batch(state, cfg, lb, ll, rb, rl, fparams)
        for i, f in enumerate(outs):
            if f is not None and f.min_cov >= params.min_fragment_cov:
                _store_fragment(store, f, params)
                frag_lengths.append(f.length)
            elif (
                rescue_spill is not None
                and f is None
                and ll[i] >= k
                and rl[i] >= k
                and len(rescue_spill) < _RESCUE_SPILL_CAP
            ):
                rescue_spill.append((lb[i, : ll[i]].copy(), rb[i, : rl[i]].copy()))
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


# -rescue holds unconnected pairs in host memory for the second attempt;
# the cap bounds it (about 2 * read_L bytes a pair).  Pairs beyond it stay
# dropped (the JAX package's pipeline.py:1576-1579).
_RESCUE_SPILL_CAP = 200_000


def _rescue_unconnected_pass(
    state: dbg.GraphState,
    cfg: dbg.GraphConfig,
    spill: list,
    read_L: int,
    params: PipelineParams,
    fparams: "fragmod.FragmentParams",
    store: FragmentStore,
    frag_lengths: List[int],
    report: PipelineReport,
) -> None:
    """Second connection attempt for unconnected read pairs (-rescue,
    rescueUnconnectedMultiThreaded, RNABloom.java:2392-2668): a fragment
    graph over the stored fragments (fresh counters and fpkbf, the read
    graph's read-pair keys read in place), the spilled pairs corrected once against the
    *read* graph with shared pair thresholds, then overlap, bridge and pair
    validation against the fragment graph.  Rescued fragments that reach
    ``min_fragment_cov`` join the store (and so the final stage-2b
    rebuild)."""
    if not spill or store.count == 0:
        return
    store.flush()
    # the JAX package copies the read-pair keys here (its pipeline.py:1607)
    # against buffer donation; the rebuild never writes them
    rescue_graph = rebuild_fragment_graph(state, cfg, store, params)

    B = max(64, min(params.batch_size, 1 << (len(spill) - 1).bit_length()))
    for s0 in range(0, len(spill), B):
        chunk = spill[s0 : s0 + B]
        lb = np.full((B, read_L), 4, np.uint8)
        rb = np.full((B, read_L), 4, np.uint8)
        ll = np.zeros(B, np.int32)
        rl = np.zeros(B, np.int32)
        for i, (lc, rc_) in enumerate(chunk):
            ll[i] = min(len(lc), read_L)
            rl[i] = min(len(rc_), read_L)
            lb[i, : ll[i]] = lc[: ll[i]]
            rb[i, : rl[i]] = rc_[: rl[i]]
        both, both_len, _ = correct.correct_batch(
            state, cfg, np.concatenate([lb, rb]), np.concatenate([ll, rl]), fparams.ec_params,
            np.concatenate([np.arange(B), np.arange(B)]),
        )
        outs = fragmod.rescue_unconnected(rescue_graph, cfg, both[:B], both_len[:B], both[B:], both_len[B:], fparams)
        for i, f in enumerate(outs):
            if i < len(chunk) and f is not None and f.min_cov >= params.min_fragment_cov:
                _store_fragment(store, f, params)
                frag_lengths.append(f.length)
                report.num_rescued += 1
    del rescue_graph


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
    screen = filters.make_bloom(scfg, device=engine.device_of(state))
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
            nr_seqs, _, _ = olc_layout.layout_unitigs(emitted, cfg.k, op, device=engine.device_of(state))
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


def _read_config(lengths: np.ndarray, params: PipelineParams, nk_hint: int = 0):
    """(cfg, stage-1 params, read_L, d_read, max_tip) of a short-read run
    from its sampled read lengths: they set the read-pair distance, the
    tip length (unless -tiplength) and the read batch width; the filters
    are sized from -nk, else ``nk_hint``."""
    k = params.k
    d_read, max_tip = stage1.read_length_params(lengths, k, params.min_num_kmer_pairs)
    if params.max_tip_length >= 0:
        max_tip = params.max_tip_length
    read_L = int(max(lengths.max(initial=150), k + d_read + 1))
    cfg = stage1.default_graph_config(
        k, params.stranded, params.total_mem_bytes, params.num_hash, d_read,
        expected_num_kmers=params.expected_num_kmers or nk_hint,
        **params.graph_config_overrides(),
    )
    s1p = stage1.Stage1Params(k=k, stranded=params.stranded, min_qual=params.min_qual, max_seq_len=max(read_L, 2 * k))
    return cfg, s1p, read_L, d_read, max_tip


def _write_report(outdir: str, params: PipelineParams, report: PipelineReport) -> None:
    """{outdir}/{name}.report.json, the JAX package's fields."""
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


def _stage1_graph(paths: Sequence[str], flags: Sequence[bool], params: PipelineParams, device, mesh=None,
                  lengths: Optional[np.ndarray] = None, nk_hint: int = 0, show_plan: bool = False):
    """(graph, stage-1 stats, cfg, read_L, d_read, max_tip): the stage-1
    graph over ``paths`` (each read revcomp'd where its path's flag is
    set), its read-pair keys included.  The read lengths are sampled from
    ``paths`` unless ``lengths`` is given; they set the read-pair distance,
    the tip length (unless -tiplength) and the read batch width.  The
    filters are sized from -nk, else ``nk_hint``, and sharded over
    ``mesh`` when it is not None (``_mesh_for``)."""
    k = params.k
    if lengths is None:
        lengths = stage1.sample_read_lengths(paths, params.sample_size)
    cfg, s1p, read_L, d_read, max_tip = _read_config(lengths, params, nk_hint)
    if show_plan:
        cbf_mb = (cfg.cbf.size * cfg.cbf.cell_bytes) >> 20
        pk_mb = cfg.pkbf.size >> 20 if cfg.pkbf else 0
        print(
            f"Mem plan: cbf {cbf_mb} MB (2^{cfg.cbf.size_log2} x "
            f"{cfg.cbf.cell_bytes} B {cfg.cbf.dtype}), rpkbf {pk_mb} MB; "
            f"k={k} d_read={d_read} hash={cfg.cbf.num_hash} device={device}",
            flush=True,
        )
    state, s1_stats, cfg = stage1.build_graph_autosized(
        list(paths), cfg, s1p, max_fpr=params.max_fpr, device=device, mesh=mesh, revcomp_flags=list(flags),
        add_read_pairs=True,
    )
    return state, s1_stats, cfg, read_L, d_read, max_tip


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
    reference transcript FASTAs added to the fragment graph (-ref).
    ``sef_paths``/``ser_paths`` mix unpaired reads in: they join the
    stage-1 graph and become unconnected fragments after the pairs
    (-sef/-ser beside -left/-right).  ``params.rescue_unconnected``
    (-rescue) retries the unconnected pairs against a fragment graph.  A
    stage-3 run into a directory that holds the stage-2 stamp and a saved
    graph (and without ``force``) resumes at stage 2b and writes no
    report.json, as the JAX package does.  ``params.sharded`` picks the
    engine (``_mesh_for``)."""
    device = engine.require_device(device)
    mesh = _mesh_for(params, device)
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
            state, cfg = ckpt.load_graph(graph_prefix, device="cpu" if mesh is not None else device)
            state = engine.from_host_state(state, cfg, mesh) if mesh is not None else state
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
    # ---- stage 1: graph build (right mates revcomp'd onto forward strand);
    # a rerun sizes filters from the previous run's distinct-k-mer estimate
    timer.start("stage 1: de Bruijn graph construction")
    state, s1_stats, cfg, read_L, d_read, max_tip = _stage1_graph(
        [left_path, right_path] + list(sef_paths) + list(ser_paths),
        [revcomp_left, revcomp_right] + [False] * len(sef_paths) + [True] * len(ser_paths),
        params, device, mesh, lengths=lengths, nk_hint=nk_hint, show_plan=params.verbose,
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
    rescue_spill: Optional[list] = [] if params.rescue_unconnected else None
    d_frag = _stage2_pair_loop(
        state, cfg, left_path, right_path, params, revcomp_left,
        revcomp_right, read_L, fparams, store, report, frag_lengths, rescue_spill=rescue_spill,
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
    # mixed input: unpaired reads become error-corrected unconnected fragments
    if sef_paths or ser_paths:
        _ingest_se_fragments(state, cfg, sef_paths, ser_paths, read_L, params, store, frag_lengths, report)
        report.num_fragments = store.count
    if rescue_spill:
        _rescue_unconnected_pass(state, cfg, rescue_spill, read_L, params, fparams, store, frag_lengths, report)
        report.num_fragments = store.count
    store.close()
    engine.synchronize(state)
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
    engine.synchronize(state)
    report.stage3_s = time.time() - t_s3
    timer.done("transcripts assembled", f"{report.num_transcripts} transcripts, {report.num_nr} nr")
    report.elapsed_s = time.time() - t0
    _write_report(outdir, params, report)
    return report



def _mh_pe_stage2(state, cfg: dbg.GraphConfig, left_path: str, right_path: str, outdir: str, params: PipelineParams,
                  revcomp_left: bool, revcomp_right: bool, read_L: int, report: PipelineReport, pid: int,
                  n: int) -> None:
    """Multi-host stage 2 of process ``pid`` of ``n``: the fragment loop
    over its record-modulo pair slice against the merged graph, into its
    own store under {outdir}/mh_p{pid}."""
    fparams = fragmod.FragmentParams(
        min_overlap=params.min_overlap, bound=params.bound,
        lookahead=params.lookahead, extend_fragments=params.extend_fragments,
        ec_params=params.correct_params(),
    )
    store = _new_fragment_store(os.path.join(outdir, f"mh_p{pid}"), params)
    _stage2_pair_loop(state, cfg, left_path, right_path, params, revcomp_left, revcomp_right, read_L, fparams,
                      store, report, [], stride=(pid, n))
    store.close()


def _mh_pe_stage3(state, cfg: dbg.GraphConfig, outdir: str, params: PipelineParams, report: PipelineReport,
                  n: int) -> bool:
    """Process 0's part after the stage-2 barrier: the ``n`` stores merged
    into {outdir}/fragments, then (``stop_stage`` 3) stage 2b and stage 3
    with the fragment pair distance from the pooled lengths.  False when
    no fragment was assembled."""
    merged = merge_stores(outdir, [os.path.join(outdir, f"mh_p{i}") for i in range(n)])
    if merged is None or merged.count == 0:
        return False
    report.num_fragments = merged.count
    ckpt.touch_stamp(outdir, ckpt.STAMP_FRAGMENTS_DONE)
    if params.stop_stage <= 2:
        return True
    q1, _, _ = sequtils.quartiles(np.fromiter(merged.iter_lengths(), np.int64))
    d_frag = max(1, int(q1) - cfg.k - params.min_num_kmer_pairs)
    report.fragment_pair_distance = d_frag
    cfg = dbg.GraphConfig(
        k=cfg.k, stranded=cfg.stranded, dbgbf=cfg.dbgbf, cbf=cfg.cbf,
        pkbf=cfg.pkbf, read_pair_distance=cfg.read_pair_distance,
        fragment_pair_distance=d_frag, exact_counts=cfg.exact_counts,
    )
    _finish_pe_stage3(state, cfg, merged, outdir, params, report)
    return True


def assemble_pe_multihost(
    left_path: str,
    right_path: str,
    outdir: str,
    params: PipelineParams,
    revcomp_left: bool = False,
    revcomp_right: bool = True,
    device="cuda",
) -> PipelineReport:
    """Multi-host paired-end assembly, one call a process of an initialized
    group (``parallel.multihost.initialize``; CLI ``-coordinator -nprocs
    -procid`` with ``-left``/``-right``), on this process's ``device``.

    The JAX package's layout (its ``assemble_pe_multihost``): stage 1
    builds with the local merge (every process ends holding the merged
    filters); stage 2 runs in each process over its record-modulo pair
    slice into its own store (its fragment-length sample learns from its
    slice); after a barrier, process 0 merges the stores, derives the
    stage-3 pair distance from the pooled lengths, runs stages 2b and 3
    and writes report.json.  The other processes return after the
    barrier; ``params.sharded`` is not read."""
    device = engine.require_device(device)
    t0 = time.time()
    report = PipelineReport()
    pid, n = multihost.process_index(), multihost.process_count()
    os.makedirs(outdir, exist_ok=True)
    lengths = stage1.sample_read_lengths([left_path, right_path], params.sample_size)
    cfg, s1p, read_L, _, _ = _read_config(lengths, params)
    state, report.stage1 = multihost.build_graph_local_merge(
        [left_path, right_path], cfg, s1p, device=device, revcomp_flags=[revcomp_left, revcomp_right],
        add_read_pairs=True,
    )
    if pid == 0:
        ckpt.touch_stamp(outdir, ckpt.STAMP_DBG_DONE)
    if params.stop_stage <= 1:
        report.elapsed_s = time.time() - t0
        return report

    t_s2 = time.time()
    _mh_pe_stage2(state, cfg, left_path, right_path, outdir, params, revcomp_left, revcomp_right, read_L, report,
                  pid, n)
    engine.synchronize(state)
    report.stage2_s = time.time() - t_s2
    multihost.barrier()  # every store closed before process 0 merges them
    if pid == 0:
        t_s3 = time.time()
        if _mh_pe_stage3(state, cfg, outdir, params, report, n) and params.stop_stage >= 3:
            engine.synchronize(state)
            report.stage3_s = time.time() - t_s3
            report.elapsed_s = time.time() - t0
            _write_report(outdir, params, report)
            return report
    report.elapsed_s = time.time() - t0
    return report

def assemble_se(
    se_paths: Sequence[str],
    outdir: str,
    params: PipelineParams,
    revcomp_flags: Optional[Sequence[bool]] = None,
    device="cuda",
) -> PipelineReport:
    """Single-end assembly (-sef/-ser) on ``device`` (the card unless the
    caller asks for the CPU; raises when there is no card): corrected reads
    become unconnected fragments, and transcripts extend with read-pair
    support only (SingleEndReadExtractor :1935-2036, extendSE :6454).
    ``revcomp_flags``: one per path, True for -ser reads.  As in the JAX
    package, no stamps, read statistics or report.json are written, and
    there is no resume."""
    device = engine.require_device(device)
    mesh = _mesh_for(params, device)
    t0 = time.time()
    os.makedirs(outdir, exist_ok=True)
    report = PipelineReport()
    if revcomp_flags is None:
        revcomp_flags = [False] * len(se_paths)

    # the JAX function also works out max_tip here, with the -tiplength
    # override, and uses neither (its pipeline.py:678-680): stage 3 reads
    # -tiplength from params
    state, s1_stats, cfg, read_L, _, _ = _stage1_graph(se_paths, revcomp_flags, params, device, mesh)
    report.stage1 = s1_stats
    if params.stop_stage <= 1:
        report.elapsed_s = time.time() - t0
        return report

    store = _new_fragment_store(outdir, params)
    frag_lengths: List[int] = []
    _ingest_se_fragments(
        state, cfg,
        [p for p, rc in zip(se_paths, revcomp_flags) if not rc],
        [p for p, rc in zip(se_paths, revcomp_flags) if rc],
        read_L, params, store, frag_lengths, report,
    )
    store.close()
    report.num_fragments = store.count
    if store.count == 0:
        report.elapsed_s = time.time() - t0
        return report

    # stage 2b: counters from the corrected reads, read-pair keys kept and
    # no fpkbf (stage 3's walks and break checks see read pairs only)
    state = engine.fresh_rebuild_state(state, cfg, with_fpkbf=False)
    for bi, (codes, _l, _c, _conn) in enumerate(store.iter_batches(1024, width=read_L)):
        state = engine.build_step(state, cfg, codes, salt=bi)

    _run_stage3(state, cfg, store, outdir, params, report)
    report.elapsed_s = time.time() - t0
    return report


def parse_pool_list(path: str) -> List[Tuple[str, str, str, Tuple[str, ...], Tuple[str, ...]]]:
    """Parse a -pool READSLIST (getPooledReadPaths, RNABloom.java:5066-5224).

    Lines are '<name> <left> <right> [sef] [ser]'; a header line starting
    with '#' may name the columns (any order of left/right/sef/ser after
    name).  sef/ser cells may hold comma-separated lists or '-' for none.
    Returns (name, left, right, sef_paths, ser_paths) tuples."""
    out = []
    columns = ["name", "left", "right", "sef", "ser"]
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                # an optional header row names the columns (RNABloom.java:5092)
                hdr = line.lstrip("#").split()
                if hdr and all(h in ("name", "left", "right", "sef", "ser") for h in hdr):
                    columns = hdr
                continue
            parts = line.split()
            if len(parts) < 3:
                raise ValueError(f"pool list line needs '<name> <left> <right>': {line!r}")
            row = dict(zip(columns, parts))
            if not {"name", "left", "right"} <= row.keys():
                raise ValueError(f"pool list line missing name/left/right: {line!r}")

            def paths(cell: Optional[str]) -> Tuple[str, ...]:
                if not cell or cell == "-":
                    return ()
                return tuple(p for p in cell.split(",") if p)

            out.append((row["name"], row["left"], row["right"], paths(row.get("sef")), paths(row.get("ser"))))
    return out


def _pool_shared_graph(samples: Sequence[tuple], params: PipelineParams, revcomp_left: bool, revcomp_right: bool,
                       device, mesh=None):
    """(shared graph, stage-1 stats, cfg, read_L): one stage-1 graph over
    every sample's left, right, sef and ser reads, in sample order, on
    ``device`` or sharded over ``mesh``."""
    paths, flags = [], []
    for _, left, right, sef, ser in samples:
        paths += [left, right] + list(sef) + list(ser)
        flags += [revcomp_left, revcomp_right] + [False] * len(sef) + [True] * len(ser)
    shared, s1_stats, cfg, read_L, _, _ = _stage1_graph(paths, flags, params, device, mesh)
    return shared, s1_stats, cfg, read_L


def _pool_sample(
    shared: dbg.GraphState, cfg: dbg.GraphConfig, sample: tuple, outdir: str, params: PipelineParams,
    revcomp_left: bool, revcomp_right: bool, read_L: int,
) -> PipelineReport:
    """One pooled sample's stages 2-3 into {outdir}/{name}/ on the shared
    graph, which it never writes: stage 2 over its pairs then its unpaired
    reads, its own fragment pair distance, and its fragment graph beside
    the shared read-pair keys, which it only reads."""
    name, left, right, sef, ser = sample
    k = params.k
    sample_dir = os.path.join(outdir, name)
    os.makedirs(sample_dir, exist_ok=True)
    report = PipelineReport()
    fparams = fragmod.FragmentParams(
        min_overlap=params.min_overlap, bound=params.bound, lookahead=params.lookahead,
        extend_fragments=params.extend_fragments, ec_params=params.correct_params(),
    )
    store = _new_fragment_store(sample_dir, params)
    frag_lengths: List[int] = []
    # the JAX package's pool loop (its pipeline.py:1139-1148), quirks kept:
    # num_pairs counts every row of a batch, the padded rows of the last
    # one included; no fragment is held to min_fragment_cov, and the walk
    # bound is never learned from the fragment sample
    for lb, ll, rb, rl, multi in _iter_pair_batches(left, right, params, k, revcomp_left, revcomp_right, read_L):
        report.num_pairs += lb.shape[0]
        _connect_multi_segments(shared, cfg, lb, ll, rb, rl, multi, fparams)
        for f in fragmod.assemble_fragments_batch(shared, cfg, lb, ll, rb, rl, fparams):
            if f is not None:
                _store_fragment(store, f, params)
                frag_lengths.append(f.length)
    if sef or ser:
        _ingest_se_fragments(shared, cfg, sef, ser, read_L, params, store, frag_lengths, report)
    store.close()
    report.num_fragments = store.count
    if store.count == 0 or params.stop_stage <= 2:
        return report

    q1, _, _ = sequtils.quartiles(np.asarray(frag_lengths))
    d_frag = max(1, int(q1) - k - params.min_num_kmer_pairs)
    report.fragment_pair_distance = d_frag
    sample_cfg = dbg.GraphConfig(
        k=cfg.k, stranded=cfg.stranded, dbgbf=cfg.dbgbf, cbf=cfg.cbf,
        pkbf=cfg.pkbf, read_pair_distance=cfg.read_pair_distance,
        fragment_pair_distance=d_frag, exact_counts=cfg.exact_counts,
    )
    # the JAX package copies the shared read-pair keys (its pipeline.py:1174-1175)
    # against buffer donation; the rebuild never writes them, so here the
    # sample's fragment graph reads the shared lanes in place
    sample_state = rebuild_fragment_graph(shared, sample_cfg, store, params)
    _run_stage3(sample_state, sample_cfg, store, sample_dir, params, report)
    return report


def assemble_pool(
    readslist_path: str,
    outdir: str,
    params: PipelineParams,
    revcomp_left: bool = False,
    revcomp_right: bool = True,
    device="cuda",
) -> dict:
    """Pooled multi-sample assembly (-pool) on ``device`` (the card unless
    the caller asks for the CPU; raises when there is no card): ONE shared
    graph built from all samples' reads, then each sample's stages 2-3
    into {outdir}/{sample}/ (RNABloom.main :7203-7322), in sorted name
    order, as the reference does.  Returns {sample name: PipelineReport},
    empty at ``-stage 1``; writes no stamps and no report.json."""
    device = engine.require_device(device)
    mesh = _mesh_for(params, device)
    t0 = time.time()
    os.makedirs(outdir, exist_ok=True)
    samples = sorted(parse_pool_list(readslist_path))
    shared, s1_stats, cfg, read_L = _pool_shared_graph(samples, params, revcomp_left, revcomp_right, device, mesh)
    reports = {}
    if params.stop_stage <= 1:
        return reports
    for sample in samples:
        report = _pool_sample(shared, cfg, sample, outdir, params, revcomp_left, revcomp_right, read_L)
        report.stage1 = s1_stats
        report.elapsed_s = time.time() - t0
        reports[sample[0]] = report
    return reports


def merge_pool(outdir: str, sample_names: Sequence[str], params: PipelineParams, device="cuda") -> int:
    """-mergepool: each sample's nr transcripts (its transcripts.fa when
    it has none) laid out into one non-redundant set,
    {outdir}/{name}.transcripts.merged.fa (mergePooledAssemblies,
    RNABloom.java:5473); the minimizer keys are hashed on ``device``.
    Returns the number of merged sequences."""
    device = engine.require_device(device)
    seqs = SeqStore(os.path.join(outdir, f".{params.name}.merge_input.2bit"))
    for name in sample_names:
        for fname in (f"{params.name}.transcripts.nr.fa", f"{params.name}.transcripts.fa"):
            path = os.path.join(outdir, name, fname)
            if os.path.exists(path):
                for _, s in fastx.read_fasta(path):
                    seqs.append(sequtils.encode(s.upper()))
                break
    if not len(seqs):
        seqs.close(delete=True)
        return 0
    op = olc_overlap.OverlapParams(min_overlap=max(params.min_transcript_length // 2, 100))
    merged_seqs, _, _ = olc_layout.layout_unitigs(seqs, params.k, op, device=device)
    seqs.close(delete=True)
    merged = os.path.join(outdir, f"{params.name}.transcripts.merged.fa")
    with fastx.FastaWriter(merged, uracil=params.write_uracil) as w:
        for j, s in enumerate(merged_seqs):
            w.write(f"{params.header_prefix}{params.name}.merged.{j}", sequtils.decode(s), f"l={len(s)}")
    return len(merged_seqs)


def _subsample(cfg: dbg.GraphConfig, corrected: SeqStore, spec: str, device) -> Optional[List[int]]:
    """The -lrsub seed reads (RNABloom.java:6335-6339): "depth,s,size,window"
    selects strobemer-novelty subsampling, "depth,k,size" k-mer novelty.
    None: no subsampling."""
    if not spec:
        return None
    parts = [int(x) for x in spec.split(",")]
    if len(parts) == 4:
        depth, s, _size, window = parts
        return lrmod.subsample_strobemer_based(
            cfg, corrected, max_multiplicity=depth, w_min=s, w_max=window, device=device
        )
    if len(parts) == 3:
        return lrmod.subsample_kmer_based(cfg, corrected, parts[0], device=device)
    raise ValueError(f"bad -lrsub spec: {spec!r}")


def assemble_long(
    long_paths: Sequence[str],
    outdir: str,
    params: PipelineParams,
    subsample_spec: str = "",
    force: bool = False,
    device="cuda",
) -> PipelineReport:
    """Long-read (ONT/PacBio cDNA) assembly (-long) on ``device`` (the card
    unless the caller asks for the CPU; raises when there is no card).

    Stages mirror RNABloom.main :7323-7470: graph build over the long reads
    (segments of at most 512 bases), windowed correction
    (LongReadCorrectionWorker) in chunks of 4096 reads into
    {name}.longreads.corrected.{long,short,repeats}.fa, .polya.txt and
    .long.lengths.txt, optional subsampling (``subsample_spec``, -lrsub),
    then the internal uniqueOLC (olc/OverlapLayoutConsensus.java:1129-1228)
    and redundancy reduction into {name}.transcripts.fa and
    {name}.transcripts.short.fa.  As in the JAX package, no report.json is
    written.

    Resume protocol (RNABloom.java:5818-5825, :6451-6500): a rerun with the
    LONGREADS.CORRECTED stamp present reloads the corrected reads and jumps
    straight to the OLC stage; LONGREADS.ASSEMBLED marks completion.
    """
    device = engine.require_device(device)
    mesh = _mesh_for(params, device)
    t0 = time.time()
    os.makedirs(outdir, exist_ok=True)
    if force:
        ckpt.clear_stamps(outdir)
    report = PipelineReport()
    k = params.k
    lr_min_cov = 2.0  # solid k-mer coverage of the correction, and the OLC depth floor
    # corrected-read file layout mirrors the reference (RNABloom.java:
    # 7324-7329): .long feeds the OLC stage; .short/.repeats are preserved
    # outputs; polyA read names and sampled long-read lengths ride along
    corrected_prefix = os.path.join(outdir, f"{params.name}.longreads.corrected")
    corrected_path = corrected_prefix + ".long.fa"
    short_path_lr = corrected_prefix + ".short.fa"
    repeats_path = corrected_prefix + ".repeats.fa"
    polya_names_path = corrected_prefix + ".polya.txt"
    sample_lengths_path = corrected_prefix + ".long.lengths.txt"

    # disk-backed corrected-read store: host RAM stays bounded however many
    # reads are corrected (the reference streams through a writer worker,
    # RNABloom.java:3490-3635)
    corrected = SeqStore(corrected_prefix + ".2bit")
    polya_flags: List[bool] = []
    resumed = (
        not force
        and ckpt.has_stamp(outdir, ckpt.STAMP_LONGREADS_CORRECTED)
        and os.path.exists(corrected_path)
    )
    cfg = stage1.default_graph_config(
        k, params.stranded, params.total_mem_bytes, params.num_hash, -1,
        with_pkbf=True, expected_num_kmers=params.expected_num_kmers,
        **params.graph_config_overrides(),
    )
    if resumed:
        # crash after correction: skip graph build + correction entirely;
        # the FASTA streams straight into the disk-backed store
        for header, seq in fastx.read_fasta(corrected_path, full_header=True):
            corrected.append(sequtils.encode(seq.upper()))
            polya_flags.append("polya" in header)
        report.num_fragments = len(corrected)
        if not corrected or params.stop_stage <= 2:
            report.elapsed_s = time.time() - t0
            return report
    else:
        s1p = stage1.Stage1Params(k=k, stranded=params.stranded, min_qual=params.min_qual, max_seq_len=512)
        state, s1_stats, cfg = stage1.build_graph_autosized(
            list(long_paths), cfg, s1p, max_fpr=params.max_fpr, device=device, mesh=mesh
        )
        report.stage1 = s1_stats
        ckpt.touch_stamp(outdir, ckpt.STAMP_DBG_DONE)
        if params.stop_stage <= 1:
            report.elapsed_s = time.time() - t0
            return report

        # stage 2: correction — raw reads stream from disk in bounded chunks
        # and corrected reads stream straight to the stratified output
        # FASTAs (the reference's reader -> workers -> writer queue,
        # RNABloom.java:3948-4046, CorrectedLongReadsWriterWorker2); length
        # threshold = min(minOverlap, minTranscriptLength) (RNABloom.java:7344)
        t_s2 = time.time()
        lrp = lrmod.LongReadParams(min_kmer_cov=lr_min_cov, min_seq_len=min(200, params.min_transcript_length))
        chunk: List[np.ndarray] = []
        n_short = n_rep = 0
        with fastx.FastaWriter(corrected_path) as w, fastx.FastaWriter(short_path_lr) as wsh, \
                fastx.FastaWriter(repeats_path) as wrep, open(polya_names_path, "w") as wpa:

            def flush_chunk():
                nonlocal n_short, n_rep
                res = lrmod.correct_long_reads(state, cfg, chunk, lrp)
                for c, fl in zip(res.long, res.polya):
                    name = f"lr.{len(corrected)}"
                    w.write(name, sequtils.decode(c), f"l={len(c)}{' polya' if fl else ''}")
                    if fl:
                        wpa.write(name + "\n")
                    corrected.append(c)
                    polya_flags.append(fl)
                for c, fl in zip(res.short, res.short_polya):
                    name = f"lr.s{n_short}"
                    wsh.write(name, sequtils.decode(c), f"l={len(c)}")
                    if fl:
                        wpa.write(name + "\n")
                    n_short += 1
                for c in res.repeats:
                    wrep.write(f"lr.r{n_rep}", sequtils.decode(c), f"l={len(c)}")
                    n_rep += 1
                chunk.clear()

            for path in long_paths:
                for _, s, _ in fastx.read_seqs(path):
                    codes = sequtils.encode(s)
                    if params.revcomp_long:  # -rc (RNABloom.java optRevCompLong)
                        codes = sequtils.revcomp_codes(codes)
                    if len(codes) >= k:
                        chunk.append(codes)
                        report.num_pairs += 1
                    if len(chunk) >= 4096:
                        flush_chunk()
            if chunk:
                flush_chunk()
        report.num_fragments = len(corrected)
        with open(sample_lengths_path, "w") as f:
            f.write("\n".join(str(n) for n in corrected.lengths))
        ckpt.touch_stamp(outdir, ckpt.STAMP_LONGREADS_CORRECTED)
        report.stage2_s = time.time() - t_s2
        if not len(corrected) or params.stop_stage <= 2:
            report.elapsed_s = time.time() - t0
            return report

    t_s3 = time.time()
    _s0 = span_totals()
    with span("olc_subsample"):
        seed_indices = _subsample(cfg, corrected, subsample_spec, device)

    # stage 3: internal uniqueOLC (unique reads -> unitigs -> pileup
    # polish -> binomial-filtered greedy layout)
    op = olc_overlap.OverlapParams(min_match_prop=params.lr_overlap_prop, min_shared_frac=params.sketch_overlap_prop)
    if params.minimizer_window > 0:
        op.w = params.minimizer_window
    if params.sketch_overlap_num > 0:
        op.min_shared = params.sketch_overlap_num
    mk = params.minimizer_size or k  # -m: OLC minimizer size
    if params.write_paf and corrected:
        # -paf: the reference's OLC stage leaves `*.ava.paf.gz` behind
        # (olc/OverlapLayoutConsensus.java:78-106); emit the internal
        # engine's all-vs-all overlaps in the same format for interop
        with span("olc_paf"):
            mins = olc_overlap.extract_minimizers_reads(corrected, mk, op.w, device=device)
            ov = olc_overlap.find_overlaps(mins, op)
            pafmod.write_paf(os.path.join(outdir, f"{params.name}.ava.paf"), pafmod.overlaps_to_paf(ov, mins.lengths, mk))

    ext_ov = None
    if params.paf_in:
        # -pafin: an external all-vs-all PAF over the corrected reads (named
        # lr.<i>, the names this pipeline writes) replaces the internal
        # minimizer engine for unique extraction, with the same span and
        # support screens
        ext_ov = pafmod.paf_to_overlaps(
            params.paf_in, {f"lr.{i}": i for i in range(len(corrected))}, mk,
            min_identity=params.lr_overlap_prop, params=op,
        )
    res = olc_layout.unique_olc(
        corrected, mk, op,
        polya_flags=polya_flags,
        sample_lengths=corrected.lengths.astype(np.int64),
        min_seq_depth=params.lr_min_depth or max(int(lr_min_cov), 1),
        polya_finder=lambda codes: polya.find_polya_tail(codes) is not None,
        seed_indices=seed_indices,
        external_overlaps=ext_ov,
        device=device,
    )
    assembled = res.transcripts

    # redundancy reduction + length split
    scfg = BloomConfig(cfg.pkbf.size_log2, cfg.pkbf.num_hash)
    with span("reduce_redundancy"):
        keep = txmod.reduce_redundancy(
            cfg, scfg, assembled, txmod.TranscriptParams(min_transcript_length=params.min_transcript_length),
            device=device,
        )
    tx_path = os.path.join(outdir, f"{params.name}.transcripts.fa")
    short_path = os.path.join(outdir, f"{params.name}.transcripts.short.fa")
    with fastx.FastaWriter(tx_path, uracil=params.write_uracil) as wtx, \
            fastx.FastaWriter(short_path, uracil=params.write_uracil) as wsh:
        for i in keep:
            seq = sequtils.decode(assembled[i])
            if len(seq) >= params.min_transcript_length:
                wtx.write(f"{params.header_prefix}{params.name}.{report.num_transcripts}", seq,
                          f"l={len(seq)} c={res.counts[i]:.2f}")
                report.num_transcripts += 1
            else:
                wsh.write(f"{params.header_prefix}{params.name}.s{report.num_short}", seq)
                report.num_short += 1

    ckpt.touch_stamp(outdir, ckpt.STAMP_LONGREADS_ASSEMBLED)
    corrected.close(delete=True)  # 2-bit cache of the corrected FASTA
    report.stage3_s = time.time() - t_s3
    report.stage3_spans = {key: v - _s0.get(key, 0.0) for key, v in span_totals().items()
                           if v != _s0.get(key, 0.0)}
    report.elapsed_s = time.time() - t0
    return report


def _mh_long_correct(state, cfg: dbg.GraphConfig, long_paths: Sequence[str], outdir: str, params: PipelineParams,
                     report: PipelineReport, pid: int, n: int, lr_min_cov: float = 2.0) -> None:
    """Multi-host long-read stage 2 of process ``pid`` of ``n``: the
    windowed correction of its record-modulo read slice, in chunks of 4096
    reads, into the part FASTAs {outdir}/.mh_lr_p{pid}.{long,short,repeats}.fa
    (local names, poly-A in the comment; process 0 renumbers)."""
    k = params.k
    lrp = lrmod.LongReadParams(min_kmer_cov=lr_min_cov, min_seq_len=min(200, params.min_transcript_length))
    part = os.path.join(outdir, f".mh_lr_p{pid}")
    chunk: List[np.ndarray] = []
    n_long = 0
    with fastx.FastaWriter(part + ".long.fa") as w, fastx.FastaWriter(part + ".short.fa") as wsh, \
            fastx.FastaWriter(part + ".repeats.fa") as wrep:

        def flush_chunk():
            nonlocal n_long
            res = lrmod.correct_long_reads(state, cfg, chunk, lrp)
            for c, fl in zip(res.long, res.polya):
                w.write(f"p{pid}.{n_long}", sequtils.decode(c), f"l={len(c)}{' polya' if fl else ''}")
                n_long += 1
            for c, fl in zip(res.short, res.short_polya):
                wsh.write(f"p{pid}.s", sequtils.decode(c), f"l={len(c)}{' polya' if fl else ''}")
            for c in res.repeats:
                wrep.write(f"p{pid}.r", sequtils.decode(c), f"l={len(c)}")
            chunk.clear()

        for path in long_paths:
            for _, s, _ in multihost.partition_records(fastx.read_seqs(path), pid, n):
                codes = sequtils.encode(s)
                if params.revcomp_long:
                    codes = sequtils.revcomp_codes(codes)
                if len(codes) >= k:
                    chunk.append(codes)
                    report.num_pairs += 1
                if len(chunk) >= 4096:
                    flush_chunk()
        if chunk:
            flush_chunk()


def _mh_long_merge_parts(outdir: str, params: PipelineParams, n: int) -> None:
    """Process 0's part after the correction barrier: the ``n`` processes'
    part FASTAs renumbered in process order into the corrected-read files
    that ``assemble_long`` resumes from (names ``lr.<i>``, ``lr.s<i>``,
    ``lr.r<i>``, .polya.txt, .long.lengths.txt), the parts removed, and the
    DBG and LONGREADS.CORRECTED stamps."""
    prefix = os.path.join(outdir, f"{params.name}.longreads.corrected")
    lengths: List[int] = []
    n_long = n_short = n_rep = 0
    with fastx.FastaWriter(prefix + ".long.fa") as w, fastx.FastaWriter(prefix + ".short.fa") as wsh, \
            fastx.FastaWriter(prefix + ".repeats.fa") as wrep, open(prefix + ".polya.txt", "w") as wpa:
        for p_i in range(n):
            pfx = os.path.join(outdir, f".mh_lr_p{p_i}")
            for header, seq in fastx.read_fasta(pfx + ".long.fa", full_header=True):
                tag = " polya" if "polya" in header else ""
                name = f"lr.{n_long}"
                w.write(name, seq, f"l={len(seq)}{tag}")
                if tag:
                    wpa.write(name + "\n")
                lengths.append(len(seq))
                n_long += 1
            for header, seq in fastx.read_fasta(pfx + ".short.fa", full_header=True):
                name = f"lr.s{n_short}"
                wsh.write(name, seq, f"l={len(seq)}")
                if "polya" in header:
                    wpa.write(name + "\n")
                n_short += 1
            for _, seq in fastx.read_fasta(pfx + ".repeats.fa"):
                wrep.write(f"lr.r{n_rep}", seq, f"l={len(seq)}")
                n_rep += 1
            for suffix in (".long.fa", ".short.fa", ".repeats.fa"):
                os.remove(pfx + suffix)
    with open(prefix + ".long.lengths.txt", "w") as f:
        f.write("\n".join(str(x) for x in lengths))
    ckpt.touch_stamp(outdir, ckpt.STAMP_DBG_DONE)
    ckpt.touch_stamp(outdir, ckpt.STAMP_LONGREADS_CORRECTED)


def assemble_long_multihost(
    long_paths: Sequence[str],
    outdir: str,
    params: PipelineParams,
    subsample_spec: str = "",
    device="cuda",
) -> PipelineReport:
    """Multi-host long-read assembly, one call a process of an initialized
    group (CLI ``-coordinator -nprocs -procid`` with ``-long``), on this
    process's ``device``.

    The JAX package's layout (its ``assemble_long_multihost``): stage 1
    builds with the local merge; the windowed correction runs in each
    process over its record-modulo read slice into part FASTAs; after a
    barrier, process 0 renumbers the parts into the corrected-read files
    and runs the OLC stage through ``assemble_long``'s resume path (the
    LONGREADS.CORRECTED stamp).  The other processes return after the
    barrier; ``params.sharded`` is not read."""
    device = engine.require_device(device)
    t0 = time.time()
    report = PipelineReport()
    pid, n = multihost.process_index(), multihost.process_count()
    os.makedirs(outdir, exist_ok=True)
    cfg = stage1.default_graph_config(
        params.k, params.stranded, params.total_mem_bytes, params.num_hash, -1,
        with_pkbf=True, expected_num_kmers=params.expected_num_kmers,
        **params.graph_config_overrides(),
    )
    s1p = stage1.Stage1Params(k=params.k, stranded=params.stranded, min_qual=params.min_qual, max_seq_len=512)
    state, report.stage1 = multihost.build_graph_local_merge(list(long_paths), cfg, s1p, device=device)
    if params.stop_stage <= 1:
        if pid == 0:
            ckpt.touch_stamp(outdir, ckpt.STAMP_DBG_DONE)
        report.elapsed_s = time.time() - t0
        return report

    t_s2 = time.time()
    _mh_long_correct(state, cfg, long_paths, outdir, params, report, pid, n)
    engine.synchronize(state)
    report.stage2_s = time.time() - t_s2
    multihost.barrier()  # every part written
    if pid != 0:
        report.elapsed_s = time.time() - t0
        return report
    del state
    _mh_long_merge_parts(outdir, params, n)
    rep = assemble_long(long_paths, outdir, replace(params, sharded="off"), subsample_spec=subsample_spec,
                        device=device)
    rep.stage1 = report.stage1
    rep.stage2_s = report.stage2_s
    rep.num_pairs = report.num_pairs
    rep.elapsed_s = time.time() - t0
    return rep
