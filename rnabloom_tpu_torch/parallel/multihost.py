"""Multi-host (multi-process) assembly in the local-merge layout.

The port of ``rnabloom_tpu/parallel/multihost.py``'s local-merge layout
(the JAX CLI's ``-mhlayout auto``/``local``): every process of a
``torch.distributed`` group builds a full single-device graph over its
slice of the input (record-aligned byte ranges of plain files, every n-th
record of gzip streams), then one merge collective combines the graphs:
count-min counters sum (insertion is commutative addition), bit lanes OR.
Every process ends holding the merged filters.  The pipelines
(``assembly/pipeline.py``: ``assemble_pe_multihost``,
``assemble_long_multihost``) then run stage 2 over record-modulo slices
and the last stage on process 0, with ``barrier`` between.

The group runs on gloo: the merge gathers host copies (as the JAX package
does, ``np.asarray`` of each table), and NCCL runs no two ranks on one
card.  The gathered tables are reduced on the process's own device, in
rank order.  A peer that never arrives, or dies, fails the collective
after the group's timeout (``RNABLOOM_MH_TIMEOUT`` seconds, default 1800)
instead of waiting forever.

Run one command a process:

    python -m rnabloom_tpu_torch.cli ... -coordinator HOST0:9876 -nprocs 2 -procid $ID

The lockstep hash-range layout (``-mhlayout sharded``,
``build_graph_multihost``) is not ported.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..assembly import stage1 as s1
from ..graph import dbg
from ..io import fastx, native
from ..ops import minifloat
from ..utils import seq as sequtils

TIMEOUT_ENV = "RNABLOOM_MH_TIMEOUT"
DEFAULT_TIMEOUT_S = 1800.0

# the reducer of each table: bit lanes (uint8 0/1) OR as a maximum
TABLE_KINDS = {"dbgbf": "max", "rpkbf": "max", "fpkbf": "max"}
COUNTER_KINDS = {"int32": "sum", "u16": "sum_u16", "mf8": "sum_mf8"}


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S)))


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the process group: gloo over TCP, process 0 listening at
    ``coordinator`` (HOST:PORT)."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id, timeout=_timeout(),
    )


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    """Block until every process of the group reaches this point (between
    process-local phases, e.g. before process 0 merges the per-process
    stage-2 stores); raises, naming the ranks, after the group's timeout."""
    import torch.distributed as dist

    if process_count() > 1:
        dist.monitored_barrier(timeout=_timeout(), wait_all_ranks=True)


def partition_records(records: Iterator, process_id: int, num_processes: int) -> Iterator:
    """Record-modulo partition of any record iterator: process p keeps
    records p, p+n, p+2n, ...  The same rule on the left and right files
    keeps mates on the same process."""
    for i, rec in enumerate(records):
        if i % num_processes == process_id:
            yield rec


def byte_ranges(path: str, num_parts: int) -> Optional[List[Tuple[int, int]]]:
    """[start, end) byte ranges splitting a PLAIN FASTQ/FASTA at record
    boundaries, or None when the file is gzip (a stream cannot seek:
    callers partition it record-modulo).

    A FASTQ record starts at a line beginning with '@' whose second
    successor line begins with '+' (a bare '@' test would take quality
    lines); a FASTA record at a line beginning with '>'."""
    with open(path, "rb") as f:
        head = f.read(2)
        if head[:2] == b"\x1f\x8b":  # gzip magic
            return None
        is_fastq = head[:1] == b"@"
        f.seek(0, 2)
        size = f.tell()
        cuts = [0]
        for p in range(1, num_parts):
            f.seek(size * p // num_parts)
            f.readline()  # skip the partial line
            cut = None
            lines = []
            positions = [f.tell()]
            while len(lines) < 8:
                line = f.readline()
                if not line:
                    break
                lines.append(line)
                positions.append(f.tell())
            for j, line in enumerate(lines):
                if is_fastq:
                    if line[:1] == b"@" and j + 2 < len(lines) and lines[j + 2][:1] == b"+":
                        cut = positions[j]
                        break
                elif line[:1] == b">":
                    cut = positions[j]
                    break
            cuts.append(cut if cut is not None else size)
        cuts.append(size)
        return [(cuts[i], cuts[i + 1]) for i in range(num_parts)]


def build_local(
    paths: Sequence[str],
    cfg: dbg.GraphConfig,
    params: s1.Stage1Params,
    *,
    pid: int,
    n: int,
    device,
    revcomp_flags: Optional[Sequence[bool]] = None,
    add_read_pairs: bool = False,
) -> Tuple[dbg.GraphState, s1.Stage1Stats]:
    """Process ``pid`` of ``n``'s single-device graph over its slice of
    ``paths`` on ``device``: the native reader's byte range of each plain
    file (every n-th record of a gzip stream, and of every file on the
    pure-Python reader).  Segments (each revcomp'd where its path's flag is
    set) pack into batches of ``params.batch_size`` rows that carry over
    from one file to the next; batch b's salt is ``b * n + pid``.  No
    collective; no FPR resize, as in the JAX package."""
    t0 = time.time()
    stats = s1.Stage1Stats()
    k, L, B = params.k, params.max_seq_len, params.batch_size
    if revcomp_flags is None:
        revcomp_flags = [False] * len(paths)
    state = dbg.make_graph(cfg, with_rpkbf=add_read_pairs, device=device)
    pending: List[np.ndarray] = []

    def flush():
        if not pending:
            return
        batch, _ = sequtils.pack_batch(pending, B, L)
        pending.clear()
        dbg.build_step(state, cfg, torch.from_numpy(batch).to(device), add_read_pairs=add_read_pairs,
                       salt=stats.num_batches * n + pid)
        stats.num_batches += 1

    def add(seg):
        pending.append(seg)
        if len(pending) >= B:
            flush()

    use_native = native.available()
    for path, rc in zip(paths, revcomp_flags):
        if use_native:
            rng = None
            if n > 1:
                ranges = byte_ranges(path, n)
                rng = ranges[pid] if ranges else None
            stride = (pid, n) if (n > 1 and rng is None) else None
            last_parsed = 0
            for codes, lens, parsed in native.read_code_batches(path, B, L, params.min_qual, k,
                                                                byte_range=rng, stride=stride):
                stats.num_reads += parsed - last_parsed
                last_parsed = parsed
                stats.num_segments += codes.shape[0]
                stats.num_bases += int(lens.sum())
                for i in range(codes.shape[0]):
                    seg = codes[i, : lens[i]]
                    add(sequtils.revcomp_codes(seg) if rc else seg)
            continue
        for _, seq, qual in partition_records(fastx.read_seqs(path), pid, n):
            stats.num_reads += 1
            codes = sequtils.encode(seq)
            quals = np.frombuffer(qual.encode("ascii"), dtype=np.uint8) if qual is not None else None
            for seg in sequtils.segment_read(codes, quals, params.min_qual, k):
                if rc:
                    seg = sequtils.revcomp_codes(seg)
                stats.num_segments += 1
                stats.num_bases += len(seg)
                for chunk in sequtils.chunk_segments([seg], L, k - 1):
                    add(chunk)
    flush()
    if state.cbf.is_cuda:
        torch.cuda.synchronize(state.cbf.device)
    stats.elapsed_s = time.time() - t0
    return state, stats


_CHUNK = 1 << 24  # cells reduced at a time: bounds the float32 temporaries of an mf8 merge


def _reduce(parts: Sequence[torch.Tensor], kind: str) -> torch.Tensor:
    first, rest = parts[0], parts[1:]
    if kind == "max":
        out = first.clone()
        for p in rest:
            torch.maximum(out, p, out=out)
        return out
    if kind == "sum":
        out = first.clone()
        for p in rest:
            out += p
        return out
    if kind == "sum_u16":
        acc = first.to(torch.int32) & 0xFFFF
        for p in rest:
            acc += p.to(torch.int32) & 0xFFFF
        acc.clamp_(max=65535)
        return torch.where(acc >= 32768, acc - 65536, acc).to(torch.int16)
    if kind == "sum_mf8":
        acc = minifloat.decode(first)
        for p in rest:
            acc += minifloat.decode(p)
        return minifloat.encode(acc)
    raise ValueError(f"unknown reducer {kind!r}")


def reduce_tables(parts: Sequence[torch.Tensor], kind: str, device) -> torch.Tensor:
    """The merged table of the processes' tables ``parts`` (host copies in
    rank order), on ``device``: ``max`` (bit lanes), ``sum`` (int32
    counters, wrapping), ``sum_u16`` (int16 bit patterns of u16 counters:
    the int32 sum, saturated at 65535) or ``sum_mf8`` (the float32 sum of
    the decoded counts, in rank order, encoded).  Elementwise, a slice of
    ``_CHUNK`` cells at a time."""
    size = parts[0].numel()
    out = torch.empty(size, dtype=parts[0].dtype, device=device)
    for start in range(0, size, _CHUNK):
        end = min(start + _CHUNK, size)
        out[start:end] = _reduce([p[start:end].to(device) for p in parts], kind)
    return out


def _gather(host: torch.Tensor) -> List[torch.Tensor]:
    """Every process's copy of ``host``, in rank order.  The tables travel
    as their bytes (gloo has no 16-bit integers), so each copy holds the
    sender's bits in the table's dtype."""
    import torch.distributed as dist

    raw = host.contiguous().view(torch.uint8)
    out = [torch.empty_like(raw) for _ in range(process_count())]
    dist.all_gather(out, raw)
    return [o.view(host.dtype) for o in out]


def merge_graph(state: dbg.GraphState, cfg: dbg.GraphConfig) -> Tuple[dbg.GraphState, int]:
    """The one merge collective: every table's host copy gathered from
    every process (without a group, this process's alone), then reduced on
    the table's device.  Returns (merged graph, bytes received from the
    peers)."""
    received = 0
    merged = {}
    for name in dbg.GraphState._fields:
        arr = getattr(state, name)
        if arr is None:
            merged[name] = None
            continue
        host = arr.cpu()
        parts = _gather(host) if process_count() > 1 else [host]
        received += (len(parts) - 1) * host.numel() * host.element_size()
        kind = COUNTER_KINDS[cfg.cbf.dtype] if name == "cbf" else TABLE_KINDS[name]
        merged[name] = reduce_tables(parts, kind, arr.device)
    return dbg.GraphState(**merged), received


def build_graph_local_merge(
    paths: Sequence[str],
    cfg: dbg.GraphConfig,
    params: s1.Stage1Params,
    *,
    device,
    revcomp_flags: Optional[Sequence[bool]] = None,
    add_read_pairs: bool = False,
) -> Tuple[dbg.GraphState, s1.Stage1Stats]:
    """Stage 1 across the group: this process's ``build_local``, then
    ``merge_graph``.  Returns (the merged graph on ``device``, this
    process's Stage1Stats: its local counts, the whole stage's seconds,
    the merge's seconds and bytes, the merged graph's FPRs).

    With exact counters (int32, u16) the merged filters equal a
    one-process build's outside the trash cells; mf8 cells decode, sum and
    encode, within one quantization step of it."""
    t0 = time.time()
    state, stats = build_local(paths, cfg, params, pid=process_index(), n=process_count(), device=device,
                               revcomp_flags=revcomp_flags, add_read_pairs=add_read_pairs)
    tm = time.time()
    state, stats.merge_bytes = merge_graph(state, cfg)
    if state.cbf.is_cuda:
        torch.cuda.synchronize(state.cbf.device)
    stats.merge_s = time.time() - tm
    stats.elapsed_s = time.time() - t0
    stats.fprs = dbg.fprs(state, cfg)
    return state, stats


def rank_line(report, device) -> dict:
    """This process's numbers of a multi-host run: seconds by stage, the
    merge's seconds and bytes, peak device memory (the card's) and
    launches by kernel."""
    from ..ops import cell_insert, consensus_vote, lr_keys, strobemer, walk

    launches = {}
    for module in (cell_insert, walk, lr_keys, strobemer, consensus_vote):
        launches.update({op: c for op, c in module.launch_counts().items() if c})
    s1_stats = report.stage1
    device = torch.device(device)
    return {
        "mh_rank": process_index(), "nprocs": process_count(), "device": str(device),
        "stage1_s": s1_stats.elapsed_s if s1_stats else 0.0,
        "merge_s": s1_stats.merge_s if s1_stats else 0.0,
        "merge_bytes": s1_stats.merge_bytes if s1_stats else 0,
        "stage2_s": report.stage2_s, "stage3_s": report.stage3_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "launches": launches,
    }
