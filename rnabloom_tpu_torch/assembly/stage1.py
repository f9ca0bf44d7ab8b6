"""Stage 1 — de Bruijn graph construction from read files.

Port of ``rnabloom_tpu/assembly/stage1.py``.  The host streams
quality-segmented 2-bit read batches to the device, where one build step
(hash -> multi-hash -> insert kernels) updates the filters.  Batches, their
order and their salts (the batch counter, which keys the mf8 rounding) are
the JAX package's: the same batch size and the same native or pure-Python
reader path (the port's copies of the JAX package's reader modules).

Read-length-based parameters follow setReadLengthBasedParams
(RNABloom.java:1011-1033): read-pair distance = Q1 - k - minNumKmerPairs.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..bloom.filters import BloomConfig, CountingConfig, pow2_size
from ..graph import dbg, engine
from ..io import fastx, native
from ..utils import seq as sequtils

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


@dataclass
class Stage1Params:
    k: int = 25
    stranded: bool = False
    min_qual: int = 3
    batch_size: int = 4096
    max_seq_len: int = 256
    min_num_kmer_pairs: int = 10
    sample_size: int = 1000  # reads sampled for length quartiles


@dataclass
class Stage1Stats:
    num_reads: int = 0
    num_segments: int = 0
    num_bases: int = 0
    num_batches: int = 0
    elapsed_s: float = 0.0
    read_pair_distance: int = -1
    max_tip_length: int = -1
    fprs: dict = field(default_factory=dict)
    # distinct-k-mer estimate from the counting filter's fill
    distinct_kmers_est: int = 0
    # multi-host (parallel/multihost.py): the merge collective's seconds
    # and the bytes this process received from its peers
    merge_s: float = 0.0
    merge_bytes: int = 0


def sample_read_lengths(paths: Sequence[str], sample_size: int) -> np.ndarray:
    lengths = []
    for path in paths:
        for _, seq, _ in fastx.read_seqs(path):
            lengths.append(len(seq))
            if len(lengths) >= sample_size:
                return np.asarray(lengths)
    return np.asarray(lengths)


def read_length_params(lengths: np.ndarray, k: int, min_num_kmer_pairs: int) -> Tuple[int, int]:
    """(read_pair_distance, max_tip_length) from length quartiles."""
    if len(lengths) == 0:
        return -1, -1
    q1, med, _ = sequtils.quartiles(lengths)
    d = int(q1) - k - min_num_kmer_pairs
    return max(d, 0), max(int(med) - k, 0)


def _segments_from_file(path: str, params: Stage1Params, reverse_complement: bool = False):
    """Yield (is_new_read, segment) code arrays for one file (pure-Python
    reader path)."""
    k = params.k
    for _, seq, qual in fastx.read_seqs(path):
        codes = sequtils.encode(seq)
        quals = np.frombuffer(qual.encode("ascii"), dtype=np.uint8) if qual is not None else None
        first = True
        for seg in sequtils.segment_read(codes, quals, params.min_qual, k):
            if reverse_complement:
                seg = sequtils.revcomp_codes(seg)
            yield first, seg
            first = False
        if first:
            yield True, None  # read produced no segment; still counted


def revcomp_rows(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Reverse-complement the first lens[i] codes of every row, padding the
    rest with 4 (the JAX package's per-row loop, vectorised)."""
    src = lens[:, None].astype(np.int64) - 1 - np.arange(codes.shape[1])[None, :]
    rows = np.arange(codes.shape[0])[:, None]
    out = _COMP[codes[rows, np.maximum(src, 0)]]
    out[src < 0] = 4
    return out


def build_graph(
    paths: Sequence[str],
    cfg: dbg.GraphConfig,
    state: dbg.GraphState,
    params: Stage1Params,
    revcomp_flags: Optional[Sequence[bool]] = None,
    add_read_pairs: bool = False,
) -> Tuple[dbg.GraphState, Stage1Stats]:
    """Populate the graph filters from read files.  Returns (state, stats).
    ``state`` may be a single-device GraphState or an ``engine.MeshGraph``:
    the build step dispatches accordingly."""
    t0 = time.time()
    stats = Stage1Stats()
    k = params.k
    B, L = params.batch_size, params.max_seq_len
    pending: List[np.ndarray] = []

    def flush(state):
        batch, _ = sequtils.pack_batch(pending, B, L)
        state = engine.build_step(state, cfg, batch, add_read_pairs=add_read_pairs, salt=stats.num_batches)
        stats.num_batches += 1
        pending.clear()
        return state

    if revcomp_flags is None:
        revcomp_flags = [False] * len(paths)

    use_native = native.available()
    for path, rc in zip(paths, revcomp_flags):
        if use_native:
            # native parse + segment + encode; batches come pre-chunked
            parsed = 0
            for codes, lens, parsed in native.read_code_batches(path, B, L, params.min_qual, k):
                if rc:
                    codes = revcomp_rows(codes, lens)
                stats.num_segments += codes.shape[0]
                stats.num_bases += int(lens.sum())
                if codes.shape[0] < B:
                    codes = np.concatenate([codes, np.full((B - codes.shape[0], L), 4, np.uint8)])
                state = engine.build_step(
                    state, cfg, codes, add_read_pairs=add_read_pairs, salt=stats.num_batches
                )
                stats.num_batches += 1
            stats.num_reads += parsed
            continue
        for is_new_read, seg in _segments_from_file(path, params, rc):
            stats.num_reads += is_new_read
            if seg is None:
                continue
            stats.num_segments += 1
            stats.num_bases += len(seg)
            for chunk in sequtils.chunk_segments([seg], L, k - 1):
                pending.append(chunk)
                if len(pending) == B:
                    state = flush(state)
    if pending:
        state = flush(state)

    engine.synchronize(state)
    stats.elapsed_s = time.time() - t0
    stats.fprs = engine.fprs(state, cfg)
    # fill -> inserted-key estimate: n = -m/h * ln(1 - fill)
    fill = min(stats.fprs["cbf"] ** (1.0 / cfg.cbf.num_hash), 0.999999)
    if fill > 0:
        stats.distinct_kmers_est = int(-cfg.cbf.size / cfg.cbf.num_hash * math.log1p(-fill))
    return state, stats


def build_graph_autosized(
    paths: Sequence[str],
    cfg: dbg.GraphConfig,
    params: Stage1Params,
    max_fpr: float = 0.01,
    max_retries: int = 2,
    device="cuda",
    mesh=None,
    **kwargs,
) -> Tuple[dbg.GraphState, Stage1Stats, dbg.GraphConfig]:
    """Stage-1 build with the FPR check / resize / repopulate loop
    (RNABloom.java:7142-7180): a filter breaching ``max_fpr`` is resized to
    the size its measured fill calls for and the graph rebuilt.  Runs on
    ``device``: the card unless the caller asks for the CPU; raises when
    there is no card.  With a ``mesh`` (``parallel.sharded.make_mesh``) the
    filters are sharded over it and the graph is an ``engine.MeshGraph``,
    its FPRs computed as the JAX package's mesh computes them.

    With fill ``p = fpr**(1/h)``, the inserted-key estimate is
    ``n = -m/h ln(1-p)`` and the size needed is ``m' = -h n / ln(1-p_t)``."""

    def _grow_log2(fpr: float, h: int) -> int:
        """Extra powers of two needed to bring ``fpr`` under ``max_fpr``."""
        if fpr <= max_fpr:
            return 0
        fill = min(fpr ** (1.0 / h), 0.999)
        fill_t = max_fpr ** (1.0 / h)
        factor = math.log1p(-fill) / math.log1p(-fill_t)  # m'/m
        return max(1, math.ceil(math.log2(factor)))

    device = engine.require_device(device)
    for attempt in range(max_retries + 1):
        state = engine.make_graph(cfg, with_rpkbf=kwargs.get("add_read_pairs", False), device=device, mesh=mesh)
        state, stats = build_graph(paths, cfg, state, params, **kwargs)
        worst = max(stats.fprs.values()) if stats.fprs else 0.0
        if worst <= max_fpr or attempt == max_retries:
            return state, stats, cfg
        del state
        dbg_g = _grow_log2(stats.fprs.get("dbgbf", 0.0), cfg.dbgbf.num_hash)
        cbf_g = _grow_log2(stats.fprs.get("cbf", 0.0), cfg.cbf.num_hash)
        pk_fpr = max(stats.fprs.get("rpkbf", 0.0), stats.fprs.get("fpkbf", 0.0))
        pk_g = _grow_log2(pk_fpr, cfg.pkbf.num_hash) if cfg.pkbf else 0
        cfg = replace(
            cfg,
            dbgbf=BloomConfig(cfg.dbgbf.size_log2 + dbg_g, cfg.dbgbf.num_hash),
            cbf=replace(cfg.cbf, size_log2=cfg.cbf.size_log2 + cbf_g),
            pkbf=BloomConfig(cfg.pkbf.size_log2 + pk_g, cfg.pkbf.num_hash) if cfg.pkbf else None,
        )
    return state, stats, cfg


def default_graph_config(
    k: int,
    stranded: bool,
    total_mem_bytes: int,
    num_hash: int = 2,
    read_pair_distance: int = -1,
    with_pkbf: bool = True,
    expected_num_kmers: int = 0,
    dbgbf_hash: int = 0,
    cbf_hash: int = 0,
    pkbf_hash: int = 0,
    dbgbf_mem_bytes: int = 0,
    cbf_mem_bytes: int = 0,
    pkbf_mem_bytes: int = 0,
    counter: str = "mf8",
) -> dbg.GraphConfig:
    """Memory plan mirroring the reference's split: dbgbf 1/8, cbf 1/2,
    pkbf 1/8 of the budget in cells (RNABloom.java:6822-6830).  Scatter
    layout (``merge=False``); ``-cnt int32`` takes the blocked counter
    layout, as the JAX package does off the TPU.

    ``expected_num_kmers`` > 0 sizes every filter for that many keys at 1%
    FPR (-nk); ``*_hash`` / ``*_mem_bytes`` are the per-filter overrides
    (-dh/-ch/-ph, -dm/-cm/-pm), 0 = default."""
    cell_bytes = {"int32": 4, "u16": 2, "mf8": 1}[counter]

    if expected_num_kmers > 0:
        sized = BloomConfig.for_expected(expected_num_kmers, 0.01, num_hash)
        dbg_bits = cbf_cells = pk_bits = 1 << sized.size_log2
    else:
        dbg_bits = pow2_size(total_mem_bytes // 8)
        cbf_cells = pow2_size(total_mem_bytes // 2 // cell_bytes)
        pk_bits = pow2_size(total_mem_bytes // 8)
    if dbgbf_mem_bytes > 0:
        dbg_bits = pow2_size(dbgbf_mem_bytes)
    if cbf_mem_bytes > 0:
        cbf_cells = pow2_size(cbf_mem_bytes // cell_bytes)
    if pkbf_mem_bytes > 0:
        pk_bits = pow2_size(pkbf_mem_bytes)
    return dbg.GraphConfig(
        k=k,
        stranded=stranded,
        dbgbf=BloomConfig(dbg_bits.bit_length() - 1, dbgbf_hash or num_hash),
        cbf=CountingConfig(
            cbf_cells.bit_length() - 1, cbf_hash or num_hash,
            blocked=counter == "int32", dtype=counter,
        ),
        pkbf=BloomConfig(pk_bits.bit_length() - 1, pkbf_hash or num_hash) if with_pkbf else None,
        read_pair_distance=read_pair_distance,
    )
