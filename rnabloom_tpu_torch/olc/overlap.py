"""Minimizer-based overlap detection: all-vs-all and read-to-unitig.

The port's copy of ``rnabloom_tpu/olc/overlap.py``, for the nr pass's
``layout_unitigs`` and the long-read OLC: window minimizers over the
canonical ntHash stream (hash/MinimizerHashIterator.java), an
inverted-index hash join, and diagonal-binned chaining that estimates
overlap coordinates, returning PAF-like records.  The reference shells out to minimap2 for this
(olc/OverlapLayoutConsensus.java:78-106).

Strand-aware: a minimizer key is canonical (the signed min of the forward
and reverse-complement hashes), each occurrence carries a strand flag, and
the join recovers each overlap's relative strand.  ``_minimizer_keys`` runs
on the caller's device as plain torch on the port's int64 ntHash (the JAX
package jits it); winnowing and the join are the JAX package's numpy.

Keys are int64 bit patterns on the device.  On the host they are viewed as
uint64 before anything orders them: the invalid-window sentinel
0xFFFF_FFFF_FFFF_FFFF is -1 as int64 and would sort first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import nthash

_SIGN = -(1 << 63)  # int64 with only the sign bit: flips signed to unsigned order


@dataclass
class OverlapParams:
    w: int = 10  # minimizer window
    min_shared: int = 4  # minimizers supporting an overlap (-son analog)
    diag_band: int = 100  # diagonal tolerance (bases)
    min_overlap: int = 150  # bases
    max_overhang: int = 100  # dovetail tolerance (maxEdgeClip)
    max_occ: int = 512  # drop minimizer keys seen more often (repeat filter)
    # -lrop: per-base identity proxy (minimizer density at identity
    # min_match_prop, PafUtils.hasGoodOverlap recast).  0 = off.
    min_match_prop: float = 0.0
    # -sop: min fraction of the expected perfect-identity minimizer count
    # shared.  0 = off.
    min_shared_frac: float = 0.0


@dataclass
class OverlapRecord:
    """PAF-like overlap.

    ``strand``: +1 same strand, -1 the query matches the target's reverse
    complement.  Coordinates are on each read's forward strand (PAF
    convention); spans are k-mer-start based, end-exclusive of the last
    k-mer start + k."""

    q: int
    t: int
    strand: int
    q_start: int
    q_end: int
    t_start: int
    t_end: int
    shared: int


@dataclass
class Overlaps:
    """Structure-of-arrays overlap set (one entry per record); iteration
    yields ``OverlapRecord`` views."""

    q: np.ndarray
    t: np.ndarray
    strand: np.ndarray  # +1 / -1
    q_start: np.ndarray
    q_end: np.ndarray
    t_start: np.ndarray
    t_end: np.ndarray
    shared: np.ndarray

    def __len__(self) -> int:
        return len(self.q)

    def __getitem__(self, i: int) -> OverlapRecord:
        return OverlapRecord(
            q=int(self.q[i]), t=int(self.t[i]), strand=int(self.strand[i]),
            q_start=int(self.q_start[i]), q_end=int(self.q_end[i]),
            t_start=int(self.t_start[i]), t_end=int(self.t_end[i]),
            shared=int(self.shared[i]),
        )

    def __iter__(self):
        for i in range(len(self.q)):
            yield self[i]

    @classmethod
    def empty(cls) -> "Overlaps":
        z = np.zeros(0, np.int64)
        return cls(z, z, z, z, z, z, z, z)


@dataclass
class Minimizers:
    """Flat winnowed-minimizer arrays over a read batch."""

    key: np.ndarray  # uint64 canonical hash
    pos: np.ndarray  # int32 k-mer start on the read's forward strand
    strand: np.ndarray  # bool: canonical hash came from the forward strand
    read: np.ndarray  # int32 read id
    lengths: np.ndarray  # int32 per-read length
    k: int


def _minimizer_keys(codes: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical hash keys (int64 bit patterns; invalid windows all ones)
    and the forward-strand flag per k-mer position of a (B, L) code batch.

    ``fwd`` is the UNSIGNED compare fh <= rh, while the key is the SIGNED
    min: when the two hashes differ in sign the flag names the strand of
    the other hash than the key's, as in the JAX package."""
    fh, rh, valid = nthash.rolling_hash(codes, k, stranded=False)
    fwd = (fh ^ _SIGN) <= (rh ^ _SIGN)
    key = torch.where(valid, nthash.canonical(fh, rh), torch.full_like(fh, -1))
    return key, fwd


def _winnow(row: np.ndarray, w: int) -> np.ndarray:
    """Positions of window minimizers (first-min tie rule, deduplicated)."""
    n = row.shape[0]
    if n == 0:
        return np.empty(0, np.int64)
    if n <= w:
        return np.array([int(np.argmin(row))], np.int64)
    win = np.lib.stride_tricks.sliding_window_view(row, w)
    picks = np.argmin(win, axis=1) + np.arange(win.shape[0])
    keep = np.empty(picks.shape[0], bool)
    keep[0] = True
    np.not_equal(picks[1:], picks[:-1], out=keep[1:])
    return np.unique(picks[keep])


def _empty_minimizers(lengths: np.ndarray, k: int) -> Minimizers:
    e = np.empty(0)
    return Minimizers(e.astype(np.uint64), e.astype(np.int32), e.astype(bool), e.astype(np.int32),
                      np.asarray(lengths, np.int32), k)


def extract_minimizers(codes: np.ndarray, lengths: np.ndarray, k: int, w: int, *, device) -> Minimizers:
    """Winnowed canonical minimizers for a padded (B, L) read batch; the
    keys are hashed on ``device``."""
    key, fwd = _minimizer_keys(torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(device), k)
    keys = key.cpu().numpy().view(np.uint64)
    fwd = fwd.cpu().numpy()

    out_key: List[np.ndarray] = []
    out_pos: List[np.ndarray] = []
    out_strand: List[np.ndarray] = []
    out_read: List[np.ndarray] = []
    sentinel = np.uint64(0xFFFFFFFFFFFFFFFF)
    for b in range(codes.shape[0]):
        n = max(int(lengths[b]) - k + 1, 0)
        if n == 0:
            continue
        row = keys[b, :n]
        picks = _winnow(row, w)
        picks = picks[row[picks] != sentinel]
        out_key.append(row[picks])
        out_pos.append(picks.astype(np.int32))
        out_strand.append(fwd[b, picks])
        out_read.append(np.full(picks.shape[0], b, np.int32))

    if not out_key:
        return _empty_minimizers(lengths, k)
    return Minimizers(
        key=np.concatenate(out_key),
        pos=np.concatenate(out_pos),
        strand=np.concatenate(out_strand),
        read=np.concatenate(out_read),
        lengths=np.asarray(lengths, np.int32),
        k=k,
    )


def extract_minimizers_reads(
    reads: Sequence[np.ndarray], k: int, w: int, chunk: int = 1024, *, device
) -> Minimizers:
    """Winnowed minimizers over a read list, in chunks of ``chunk`` reads
    padded to the chunk's own power-of-two length (at least 64), so host
    memory is bounded by the chunk size and the flat minimizer arrays."""
    # disk-backed stores (io.seqstore.SeqStore) give lengths without decoding
    if hasattr(reads, "lengths"):
        lengths = np.asarray(reads.lengths, np.int32)
    else:
        lengths = np.fromiter((len(r) for r in reads), np.int32, count=len(reads))
    parts: List[Minimizers] = []
    for s in range(0, len(reads), chunk):
        sub = reads[s : s + chunk]
        L = max((len(r) for r in sub), default=1)
        Lp = 1 << max(6, (max(L, k) - 1).bit_length())
        codes = np.full((len(sub), Lp), 4, np.uint8)
        lens = np.zeros(len(sub), np.int32)
        for i, r in enumerate(sub):
            codes[i, : len(r)] = r
            lens[i] = len(r)
        m = extract_minimizers(codes, lens, k, w, device=device)
        if m.key.size:
            parts.append(Minimizers(m.key, m.pos, m.strand, m.read + np.int32(s), lengths, k))
    if not parts:
        return _empty_minimizers(lengths, k)
    return Minimizers(
        key=np.concatenate([p.key for p in parts]),
        pos=np.concatenate([p.pos for p in parts]),
        strand=np.concatenate([p.strand for p in parts]),
        read=np.concatenate([p.read for p in parts]),
        lengths=lengths,
        k=k,
    )


def _drop_frequent(m: Minimizers, max_occ: int) -> Minimizers:
    order = np.argsort(m.key, kind="stable")
    key = m.key[order]
    boundary = np.flatnonzero(np.concatenate(([True], key[1:] != key[:-1])))
    counts = np.diff(np.concatenate((boundary, [key.shape[0]])))
    keep = np.repeat(counts <= max_occ, counts)
    sel = order[keep]
    return Minimizers(m.key[sel], m.pos[sel], m.strand[sel], m.read[sel], m.lengths, m.k)


def _match_pairs(mq: Minimizers, mt: Minimizers, ava: bool, max_occ: int) -> Tuple[np.ndarray, ...]:
    """All minimizer matches (q_read, t_read, q_pos, t_pos, rel_strand).

    ``ava``: mq is mt; emit each unordered read pair once (q < t).
    Otherwise mq (queries) and mt (targets) are separate namespaces."""
    mq = _drop_frequent(mq, max_occ)
    mt = mq if ava else _drop_frequent(mt, max_occ)
    if mq.key.size == 0 or mt.key.size == 0:
        z = np.empty(0, np.int64)
        return z, z, z, z, z

    t_order = np.argsort(mt.key, kind="stable")
    t_key = mt.key[t_order]
    lo = np.searchsorted(t_key, mq.key, side="left")
    hi = np.searchsorted(t_key, mq.key, side="right")
    n_hits = hi - lo
    q_idx = np.repeat(np.arange(mq.key.shape[0]), n_hits)
    # flat indices into t_order for each hit
    starts = np.repeat(lo, n_hits)
    offs = np.arange(q_idx.shape[0]) - np.repeat(np.concatenate(([0], np.cumsum(n_hits)[:-1])), n_hits)
    t_idx = t_order[starts + offs]

    qr = mq.read[q_idx].astype(np.int64)
    tr = mt.read[t_idx].astype(np.int64)
    sel = qr < tr if ava else np.ones(qr.shape[0], bool)
    qr, tr = qr[sel], tr[sel]
    qp = mq.pos[q_idx[sel]].astype(np.int64)
    tp = mt.pos[t_idx[sel]].astype(np.int64)
    rel = (mq.strand[q_idx[sel]] == mt.strand[t_idx[sel]]).astype(np.int64)
    return qr, tr, qp, tp, rel


def _chain(qr, tr, qp, tp, rel, k: int, params: OverlapParams) -> Overlaps:
    """Diagonal-binned chaining: per (q, t, strand) keep the best bin."""
    if qr.shape[0] == 0:
        return Overlaps.empty()
    diag = np.where(rel == 1, qp - tp, qp + tp)
    dbin = diag // params.diag_band
    # pack a group key; reads < 2^31, bins offset into non-negative range
    packed = np.stack([qr, tr, rel, dbin - dbin.min()], axis=1)
    uniq, inv = np.unique(packed, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    n_groups = uniq.shape[0]
    counts = np.bincount(inv, minlength=n_groups)
    qs = np.full(n_groups, np.iinfo(np.int64).max)
    qe = np.full(n_groups, -1)
    ts = np.full(n_groups, np.iinfo(np.int64).max)
    te = np.full(n_groups, -1)
    np.minimum.at(qs, inv, qp)
    np.maximum.at(qe, inv, qp)
    np.minimum.at(ts, inv, tp)
    np.maximum.at(te, inv, tp)

    # best bin per (q, t, strand): groups sort by (q, t, strand, bin), so a
    # pair's groups are contiguous and the first matching its pair's max
    # count wins (the reference's first-candidate tie rule)
    pair = np.stack([uniq[:, 0], uniq[:, 1], uniq[:, 2]], axis=1)
    puniq, pinv = np.unique(pair, axis=0, return_inverse=True)
    pinv = pinv.reshape(-1)
    best_count = np.zeros(puniq.shape[0], np.int64)
    np.maximum.at(best_count, pinv, counts)
    cand = np.flatnonzero(counts == best_count[pinv])
    first = np.ones(len(cand), bool)
    first[1:] = pinv[cand][1:] != pinv[cand][:-1]
    g = cand[first]  # one best group per pair, in pair order

    q_span = qe[g] - qs[g] + k
    t_span = te[g] - ts[g] + k
    span = np.minimum(q_span, t_span)
    keep = (counts[g] >= params.min_shared) & ((q_span >= params.min_overlap) | (t_span >= params.min_overlap))
    exp_density = 2.0 / (params.w + 1)  # minimizers per base at identity 1
    if params.min_shared_frac > 0:
        keep &= counts[g] >= params.min_shared_frac * exp_density * span
    if params.min_match_prop > 0:
        keep &= counts[g] >= (params.min_match_prop**k) * exp_density * span
    g = g[keep]
    p = np.flatnonzero(keep)
    return Overlaps(
        q=puniq[p, 0].astype(np.int64),
        t=puniq[p, 1].astype(np.int64),
        strand=np.where(puniq[p, 2] == 1, 1, -1).astype(np.int64),
        q_start=qs[g],
        q_end=qe[g] + k,
        t_start=ts[g],
        t_end=te[g] + k,
        shared=counts[g].astype(np.int64),
    )


def find_overlaps(mins: Minimizers, params: OverlapParams) -> Overlaps:
    """All-vs-all overlap candidates via minimizer hash join + diagonal bins."""
    qr, tr, qp, tp, rel = _match_pairs(mins, mins, ava=True, max_occ=params.max_occ)
    return _chain(qr, tr, qp, tp, rel, mins.k, params)


def map_to_targets(query_mins: Minimizers, target_mins: Minimizers, params: OverlapParams) -> Overlaps:
    """Map queries (reads) onto targets (unitigs); q/t in separate id spaces."""
    qr, tr, qp, tp, rel = _match_pairs(query_mins, target_mins, ava=False, max_occ=params.max_occ)
    return _chain(qr, tr, qp, tp, rel, query_mins.k, params)


def oriented_t_coords(rec: OverlapRecord, t_len: int) -> Tuple[int, int]:
    """Target overlap span in target-oriented coords (flip if strand == -1)."""
    if rec.strand == 1:
        return rec.t_start, rec.t_end
    return t_len - rec.t_end, t_len - rec.t_start


KIND_Q_CONTAINED, KIND_T_CONTAINED, KIND_DOVETAIL, KIND_INTERNAL = 0, 1, 2, 3


def classify_batch(ov: Overlaps, lengths: np.ndarray, params: OverlapParams) -> np.ndarray:
    """PAF classification of a whole overlap set as int8 KIND_* codes
    (PafUtils containment/dovetail predicates :117-218), strand-aware."""
    q_len = lengths[ov.q].astype(np.int64)
    t_len = lengths[ov.t].astype(np.int64)
    h = params.max_overhang
    q_l = ov.q_start
    q_r = q_len - ov.q_end
    # target coords oriented to the target's own strand
    ot_s = np.where(ov.strand == 1, ov.t_start, t_len - ov.t_end)
    ot_e = np.where(ov.strand == 1, ov.t_end, t_len - ov.t_start)
    t_l = ot_s
    t_r = t_len - ot_e
    out = np.full(len(ov), KIND_INTERNAL, np.int8)
    dove = ((q_l <= h) & (t_r <= h)) | ((t_l <= h) & (q_r <= h))
    out[dove] = KIND_DOVETAIL
    t_cont = (t_l <= h) & (t_r <= h)
    out[t_cont] = KIND_T_CONTAINED
    q_cont = (q_l <= h) & (q_r <= h)
    out[q_cont] = KIND_Q_CONTAINED
    return out


_KIND_NAMES = ("q_contained", "t_contained", "dovetail", "internal")


def classify(rec: OverlapRecord, q_len: int, t_len: int, params: OverlapParams) -> str:
    """'q_contained' | 't_contained' | 'dovetail' | 'internal' of one record:
    ``classify_batch`` on a one-record set."""
    one = Overlaps(*(np.array([v], np.int64) for v in (
        0, 1, rec.strand, rec.q_start, rec.q_end, rec.t_start, rec.t_end, rec.shared)))
    return _KIND_NAMES[int(classify_batch(one, np.array([q_len, t_len], np.int64), params)[0])]
