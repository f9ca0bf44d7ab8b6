"""PAF (pairwise mapping format) reader/writer.

The port's copy of ``rnabloom_tpu/io/paf.py``.  Maps io/PafReader.java / PafRecord.java / ExtendedPafRecord.java: minimal
12-column records plus the cg:Z cigar tag used for indel checks.  The
internal OLC engine emits OverlapRecords; this module provides interop with
external mappers when present and round-trips the layout's own overlaps.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class PafRecord:
    qname: str
    qlen: int
    qstart: int
    qend: int
    strand: str  # '+' or '-'
    tname: str
    tlen: int
    tstart: int
    tend: int
    num_match: int
    block_len: int
    mapq: int
    tags: dict = field(default_factory=dict)

    @property
    def cigar(self) -> Optional[str]:
        return self.tags.get("cg")

    def max_indel(self) -> int:
        """Largest I/D run in the cigar (PafUtils.hasGoodAlignment :79-104)."""
        cg = self.cigar
        if not cg:
            return 0
        return max(
            (int(n) for n, op in _CIGAR_RE.findall(cg) if op in "ID"), default=0
        )


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_paf(path: str) -> Iterator[PafRecord]:
    with _open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            yield parse_paf_line(line)


def parse_paf_line(line: str) -> PafRecord:
    parts = line.split("\t")
    tags = {}
    for tag in parts[12:]:
        try:
            key, typ, val = tag.split(":", 2)
            tags[key] = val
        except ValueError:
            continue
    return PafRecord(
        qname=parts[0], qlen=int(parts[1]), qstart=int(parts[2]), qend=int(parts[3]),
        strand=parts[4], tname=parts[5], tlen=int(parts[6]), tstart=int(parts[7]),
        tend=int(parts[8]), num_match=int(parts[9]), block_len=int(parts[10]),
        mapq=int(parts[11]), tags=tags,
    )


def write_paf(path: str, records) -> None:
    with open(path, "w") as f:
        for r in records:
            fields = [
                r.qname, r.qlen, r.qstart, r.qend, r.strand, r.tname, r.tlen,
                r.tstart, r.tend, r.num_match, r.block_len, r.mapq,
            ]
            line = "\t".join(str(x) for x in fields)
            for k, v in r.tags.items():
                typ = "Z" if not str(v).isdigit() else "i"
                line += f"\t{k}:{typ}:{v}"
            f.write(line + "\n")


def overlaps_to_paf(ov, lengths, k: int, name_fmt: str = "lr.{}") -> Iterator[PafRecord]:
    """PAF records from an internal ``olc.overlap.Overlaps`` set — the
    interop bridge from the internal ava engine to the reference's PAF
    intermediates (olc/OverlapLayoutConsensus.java writes `ava.paf.gz`;
    `-paf` requests the same artifact here).  ``num_match`` approximates
    matched bases as shared_minimizers * k; ``mapq`` is left at 255."""
    for i in range(len(ov)):
        q, t = int(ov.q[i]), int(ov.t[i])
        span = int(
            max(ov.q_end[i] - ov.q_start[i], ov.t_end[i] - ov.t_start[i])
        )
        yield PafRecord(
            qname=name_fmt.format(q), qlen=int(lengths[q]),
            qstart=int(ov.q_start[i]), qend=int(ov.q_end[i]),
            strand="+" if int(ov.strand[i]) == 1 else "-",
            tname=name_fmt.format(t), tlen=int(lengths[t]),
            tstart=int(ov.t_start[i]), tend=int(ov.t_end[i]),
            num_match=min(int(ov.shared[i]) * k, span),
            block_len=span, mapq=255,
        )


def has_good_overlap(r: PafRecord, min_identity: float) -> bool:
    """PafUtils.hasGoodOverlap: alignment identity over the block."""
    return r.block_len > 0 and r.num_match / r.block_len >= min_identity


def has_good_alignment(r: PafRecord, max_indel: int, min_identity: float) -> bool:
    return has_good_overlap(r, min_identity) and r.max_indel() <= max_indel


def paf_to_overlaps(
    path: str,
    names: "Sequence[str] | dict",
    k: int,
    min_identity: float = 0.0,
    params=None,
):
    """The inverse interop bridge: an external all-vs-all PAF (e.g. from
    minimap2, the reference's overlap source — olc/OverlapLayoutConsensus
    .java:78-106) becomes an internal ``olc.overlap.Overlaps`` SoA set
    feeding ``unique_olc``.

    ``names``: read-name -> index mapping (a dict, or a sequence whose
    positions define indices).  Records naming unknown reads, self-hits,
    and records under ``min_identity`` (PafUtils.hasGoodOverlap) are
    dropped.  ``shared`` is reconstructed as ceil(num_match / k) — the
    internal engine's shared-minimizer count at equivalent match mass.

    ``params`` (an ``olc.overlap.OverlapParams``) applies the same screens
    the internal engine applies to its own candidates (overlap.py:329-334):
    span >= min_overlap on either read and reconstructed shared >=
    min_shared — minimap2 ava output routinely contains records both the
    internal engine and the reference's PAF filtering would reject, and
    they must not flow into unique extraction unscreened.  Symmetric
    duplicates (A->B and B->A describe one overlap; the internal engine
    emits each pair once) are deduplicated on the unordered pair key,
    keeping the record with the most matched bases, so interior depth in
    ``extract_unique`` is not double-counted.
    """
    import numpy as np
    from ..olc.overlap import Overlaps

    if not isinstance(names, dict):
        names = {n: i for i, n in enumerate(names)}
    best = {}  # unordered (i, j) -> (num_match, record fields)
    for r in read_paf(path):
        if min_identity > 0.0 and not has_good_overlap(r, min_identity):
            continue
        qi, ti = names.get(r.qname), names.get(r.tname)
        if qi is None or ti is None or qi == ti:
            continue
        shared = max(1, -(-r.num_match // k))
        if params is not None:
            q_span = r.qend - r.qstart
            t_span = r.tend - r.tstart
            if max(q_span, t_span) < params.min_overlap:
                continue
            if shared < params.min_shared:
                continue
        key = (qi, ti) if qi < ti else (ti, qi)
        row = (
            qi, ti, 1 if r.strand == "+" else -1,
            r.qstart, r.qend, r.tstart, r.tend, shared,
        )
        prev = best.get(key)
        if prev is None or r.num_match > prev[0]:
            best[key] = (r.num_match, row)
    rows = [v[1] for v in best.values()]
    cols = list(zip(*rows)) if rows else [[] for _ in range(8)]
    mk = lambda a: np.asarray(a, np.int64)
    return Overlaps(
        q=mk(cols[0]), t=mk(cols[1]), strand=mk(cols[2]),
        q_start=mk(cols[3]), q_end=mk(cols[4]),
        t_start=mk(cols[5]), t_end=mk(cols[6]), shared=mk(cols[7]),
    )
