"""Bulk paired-end assembly pipeline, through stage 1.

Port of ``rnabloom_tpu/assembly/pipeline.py``: ``assemble_pe`` runs

  Stage 0  read-length sampling -> read-pair distance, tip length
           (setReadLengthBasedParams, RNABloom.java:1011-1033)
  Stage 1  graph build: cbf counters + read-paired-k-mer keys
           (populateGraph2, RNABloom.java:1290-1346), saved with -savebf

Stages 2-3 (fragments, transcripts) are not ported yet: ``stop_stage >= 2``
raises before any work is done.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from rnabloom_tpu.utils import seq as sequtils
from rnabloom_tpu.utils.timer import Timer

from ..graph import engine
from ..utils import checkpoint as ckpt
from . import stage1


@dataclass
class PipelineParams:
    """The JAX package's pipeline parameters, field for field; only the
    stage-0/1 fields are read so far."""

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


def assemble_pe(
    left_path: str,
    right_path: str,
    outdir: str,
    params: PipelineParams,
    revcomp_left: bool = False,
    revcomp_right: bool = True,
    save_graph: bool = False,
    force: bool = False,
    device="cpu",
) -> PipelineReport:
    """Bulk paired-end assembly through stage 1 on ``device``; with
    ``save_graph`` the graph is checkpointed under {outdir}/{name}.graph."""
    if params.stop_stage >= 2:
        raise NotImplementedError(
            f"-stage {params.stop_stage}: the port runs stage 1 only; fragments and "
            "transcripts are ROADMAP queue-1 items 7-10"
        )
    t0 = time.time()
    os.makedirs(outdir, exist_ok=True)
    if force:
        ckpt.clear_stamps(outdir)
    ckpt.touch_stamp(outdir, ckpt.STAMP_STARTED)
    graph_prefix = os.path.join(outdir, f"{params.name}.graph")
    report = PipelineReport()
    timer = Timer(quiet=not params.verbose)
    k = params.k

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
    if save_graph:
        ckpt.save_graph(graph_prefix, engine.to_host_state(state, cfg), cfg)
    report.elapsed_s = time.time() - t0
    return report
