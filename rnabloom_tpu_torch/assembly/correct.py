"""Batched short-read error correction (substitutions + small indels).

Port of ``rnabloom_tpu/assembly/correct.py`` (the reference's
correctErrorsPE :4051-4182, correctMismatches :3914-3997 and
correctErrorHelper :3711-3913):

  * per read, k-mer coverages are sorted; the threshold walks down from the
    top (minus covFPR false positives allowed) until consecutive sorted
    values drop by ``max_cov_gradient``, as an adjacent-gap scan over the
    sorted axis (``coverage_thresholds``, on the graph's device);
  * low-coverage runs give candidate error sites (``find_candidates``),
    whose edits (3 substitutions, deletions of 1..max_indel bases, single
    insertions; 3x3 substitutions for two sites within k) are scored by
    re-counting a fixed-width window per edit in one device batch
    (``_window_scores``);
  * the best edit is applied when its min coverage passes ``min_kmer_cov``
    and its median beats the current window's; ``rounds`` rounds.

The device queries are plain torch; the host loops are the JAX package's,
line for line.  Float32 throughout, as the JAX package computes: the
false-positive allowance ``round(nvalid * cov_fpr)`` is a float32 product
rounded half to even, and medians are float32 means of two sorted values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..graph import dbg, engine
from ..graph.dbg import GraphConfig, GraphState


@dataclass
class CorrectParams:
    max_cov_gradient: float = 0.5
    cov_fpr: float = 0.01  # fraction of k-mers allowed as false positives
    min_cov_threshold: float = 2.0
    min_kmer_cov: float = 1.0
    rounds: int = 2
    max_indel: int = 1  # -indel: max indel bases repaired per site
    percent_identity: float = 0.90  # -p: min identity of indel-edited windows


def coverage_thresholds(
    counts: torch.Tensor, valid: torch.Tensor, fp_allowed: torch.Tensor, grad: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-read dropoff threshold over sorted coverages.

    counts: (B, P) float32 (0 where invalid); valid: (B, P) bool;
    fp_allowed: (B,) int32.  Returns (threshold (B,) float32, found (B,)):
    from sorted index n-1-fp_allowed down, the threshold follows the sorted
    values until covs[i] <= covs[i+1] * grad."""
    B, P = counts.shape
    n = valid.sum(dim=1)
    # invalid entries sort first as -inf, so the tail is the real data
    s = torch.sort(torch.where(valid, counts, float("-inf")), dim=1).values
    idx = torch.arange(P, device=counts.device)
    start = P - 1 - torch.minimum(fp_allowed.long(), torch.clamp(n - 1, min=0))
    nxt = torch.cat([s[:, 1:], s[:, -1:]], dim=1)
    in_range = (idx[None, :] < start[:, None]) & (idx[None, :] >= (P - n)[:, None])
    gap = in_range & (s <= nxt * torch.tensor(grad, dtype=torch.float32)) & (nxt > 0)
    found = gap.any(dim=1)
    # highest gap index -> threshold = s[i + 1]
    jstar = torch.argmax(torch.where(gap, idx[None, :], -1), dim=1)
    thr_at_gap = nxt.gather(1, jstar[:, None])[:, 0]
    thr_start = s.gather(1, torch.clamp(start, min=0)[:, None])[:, 0]
    return torch.where(found, thr_at_gap, thr_start), found


def _runs(mask: np.ndarray):
    """(start, end) pairs of True runs in a 1-D bool array."""
    padded = np.concatenate(([False], mask, [False]))
    d = np.diff(padded.astype(np.int8))
    return np.flatnonzero(d == 1), np.flatnonzero(d == -1)


def _batch_runs(mask: np.ndarray):
    """(rows, starts, ends) of True runs per row of a 2-D bool array."""
    B, P = mask.shape
    padded = np.zeros((B, P + 2), np.int8)
    padded[:, 1:-1] = mask
    d = np.diff(padded, axis=1)
    rs, ss = np.nonzero(d == 1)
    re, es = np.nonzero(d == -1)
    # starts and ends pair up in order within each row
    return rs, ss, es


def find_candidates(
    counts: np.ndarray, valid: np.ndarray, thr: np.ndarray, found: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Candidate (read, pos1, pos2, interior) error sites from low-coverage
    runs.  pos2 == -1 for single-site runs (length <= k); runs of (k, 2k]
    are two sites corrected jointly; ``interior`` marks sites anchored on
    both sides, the only ones where indel edits are tried."""
    B, P = counts.shape
    low = (counts < thr[:, None]) & valid & found[:, None]
    rows_any = low.any(axis=1) & ~(low | ~valid).all(axis=1)
    low &= rows_any[:, None]
    if not low.any():
        z = np.zeros(0, np.int32)
        return z, z, z.copy(), np.zeros(0, bool)
    rs, ss, es = _batch_runs(low)
    # first/last valid k-mer index per row (for edge-touch tests)
    vidx = np.where(valid, np.arange(P)[None, :], P)
    first_v = vidx.min(axis=1)
    vidx = np.where(valid, np.arange(P)[None, :], -1)
    last_v = vidx.max(axis=1)
    run = es - ss
    touches_left = ss <= first_v[rs]
    touches_right = es > last_v[rs]
    # left-edge runs have no length cap (the error is the last low base);
    # interior/right runs longer than 2k are dense error regions, skipped
    keep = ~(touches_left & touches_right) & (touches_left | (run <= 2 * k))
    rs, ss, es = rs[keep], ss[keep], es[keep]
    run, touches_left, touches_right = run[keep], touches_left[keep], touches_right[keep]
    p = np.where(touches_left, es - 1, ss + k - 1)
    q = np.where(~touches_left & (run > k), es - 1, -1)
    inter = ~touches_left & (run <= k) & ~touches_right
    return rs.astype(np.int32), p.astype(np.int32), q.astype(np.int32), inter


def _scores_from_counts(counts: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, median) over each row's valid entries, float32 (0 for a row
    with none)."""
    big = torch.where(valid, counts, float("inf"))
    mn = big.amin(dim=1)
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    # median over valid entries via sort with +inf padding
    s = torch.sort(big, dim=1).values
    nv = valid.sum(dim=1)
    half = torch.clamp(nv // 2, min=0)
    lo_i = torch.clamp(torch.where(nv % 2 == 0, half - 1, half), min=0)
    med = (s.gather(1, lo_i[:, None])[:, 0] + s.gather(1, half[:, None])[:, 0]) / 2.0
    return mn, torch.where(nv > 0, med, 0.0)


def _window_scores(graph, cfg: GraphConfig, windows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(min_cov, median_cov) over each window row's valid k-mers; a mesh
    graph counts through the engine (one more query dispatch, as in the
    JAX package)."""
    if engine.is_sharded(graph):
        counts, valid = engine.count_step(graph, cfg, windows)
    else:
        counts, valid = dbg.count_step(graph, cfg, engine._on_device(windows, graph))
    mn, med = _scores_from_counts(counts, valid)
    return mn.cpu().numpy(), med.cpu().numpy()


def _ec_stats(graph, cfg: GraphConfig, codes: np.ndarray, grad: float, cov_fpr: float):
    """(counts, valid, threshold, found) as numpy, from one counting pass.

    On a mesh the JAX package takes the false-positive allowance on the
    host, ``np.round(nvalid * cov_fpr)`` in float64, where one device
    computes it in float32; the port copies each."""
    if engine.is_sharded(graph):
        counts, valid = engine.count_step(graph, cfg, codes)
        nvalid = valid.cpu().numpy().sum(axis=1).astype(np.int32)
        fp_allowed = torch.from_numpy(np.round(nvalid * cov_fpr).astype(np.int32)).to(counts.device)
    else:
        counts, valid = dbg.count_step(graph, cfg, engine._on_device(codes, graph))
        nvalid = valid.sum(dim=1).to(torch.float32)
        fp_allowed = torch.round(nvalid * torch.tensor(cov_fpr, dtype=torch.float32)).to(torch.int32)
    thr, found = coverage_thresholds(counts, valid, fp_allowed, grad)
    return counts.cpu().numpy(), valid.cpu().numpy(), thr.cpu().numpy(), found.cpu().numpy()


def correct_batch(
    graph: GraphState,
    cfg: GraphConfig,
    codes: np.ndarray,
    lengths: np.ndarray,
    params: CorrectParams,
    pair_ids: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Correct substitution and small-indel errors in a batch of reads.

    codes: (B, L) uint8 (4 = pad/N); lengths: (B,) bases per row.
    pair_ids: optional (B,) grouping; rows with the same id share the
    minimum threshold (correctErrorsPE's min(left, right) rule).

    Returns (corrected codes, new lengths, changed (B,) bool); indel edits
    change row lengths."""
    k = cfg.k
    B, L = codes.shape
    codes = codes.copy()
    lengths = np.asarray(lengths).astype(np.int64).copy()
    changed = np.zeros(B, dtype=bool)

    for _ in range(params.rounds):
        engine._tick("query")
        counts, valid, thr, found = _ec_stats(graph, cfg, codes, params.max_cov_gradient, params.cov_fpr)
        thr = np.array(thr)  # writable copies (pair sharing mutates)
        found = np.array(found)

        if pair_ids is not None:
            # share the min threshold within a pair; found only if sane
            uniq, inv = np.unique(pair_ids, return_inverse=True)
            npid = len(uniq)
            all_found = np.ones(npid, bool)
            np.logical_and.at(all_found, inv, found)
            any_found = np.zeros(npid, bool)
            np.logical_or.at(any_found, inv, found)
            tmin = np.full(npid, np.inf, thr.dtype)
            np.minimum.at(tmin, inv, thr)
            tfound = np.full(npid, np.inf, thr.dtype)
            np.minimum.at(tfound, inv, np.where(found, thr, np.inf))
            tnot = np.full(npid, np.inf, thr.dtype)
            np.minimum.at(tnot, inv, np.where(found, np.inf, thr))
            t_shared = np.where(
                all_found, tmin, np.where(any_found & (tfound <= tnot), tfound, -1.0)
            ).astype(thr.dtype)
            thr = t_shared[inv]
            found = thr >= params.min_cov_threshold
        else:
            found = found & (thr >= params.min_cov_threshold)

        reads, pos1, pos2, interior = find_candidates(counts, valid, thr, found, k)
        if len(reads) == 0:
            break

        # variant windows: single sites try the 3 other bases at p, deletions
        # of 1..max_indel bases at p and single-base insertions before p
        # (interior sites only); dual sites try the 3x3 substitutions at
        # (p, q).  One window width (3k-1) keeps the batch shape fixed.
        win_len = 3 * k - 1
        wins, meta, groups = [], [], []
        for b, p, q, inter in zip(reads, pos1, pos2, interior):
            n = int(lengths[b])
            right = q if q >= 0 else p
            w0 = max(p - k + 1, 0)
            w1 = min(right + k, n)
            wlen = w1 - w0
            base_win = np.full(win_len, 4, np.uint8)
            base_win[:wlen] = codes[b, w0:w1]
            rel_p, rel_q = p - w0, (q - w0 if q >= 0 else -1)
            start = len(wins)
            wins.append(base_win.copy())  # current window (comparison row)
            meta.append(("cur", 0, 0))
            cur_p = codes[b, p]
            if q < 0:
                for v in range(4):
                    if v == cur_p:
                        continue
                    wv = base_win.copy()
                    wv[rel_p] = v
                    wins.append(wv)
                    meta.append(("sub", v, 0))
                if inter and params.max_indel > 0:
                    # identity of a d-base indel edit over this window
                    for d in range(1, params.max_indel + 1):
                        if (wlen - d) / wlen < params.percent_identity:
                            break
                        if p + d > n:
                            break
                        wv = np.full(win_len, 4, np.uint8)
                        tail = codes[b, p + d : min(w1 + d, n)]
                        wv[:rel_p] = base_win[:rel_p]
                        wv[rel_p : rel_p + len(tail)] = tail
                        wins.append(wv)
                        meta.append(("del", d, 0))
                    if (wlen - 1) / wlen >= params.percent_identity:
                        for v in range(4):
                            wv = base_win.copy()
                            wv[rel_p] = v
                            wv[rel_p + 1 : wlen] = base_win[rel_p : wlen - 1]
                            wins.append(wv)
                            meta.append(("ins", v, 0))
            else:
                cur_q = codes[b, q]
                for v in range(4):
                    if v == cur_p:
                        continue
                    for u in range(4):
                        if u == cur_q:
                            continue
                        wv = base_win.copy()
                        wv[rel_p] = v
                        wv[rel_q] = u
                        wins.append(wv)
                        meta.append(("sub", v, u))
            groups.append((b, p, q, start, len(wins)))

        # the row count pads to a power of two, as in the JAX package
        M = len(wins)
        Mp = 1 << max(6, (M - 1).bit_length())
        wins_np = np.full((Mp, win_len), 4, np.uint8)
        wins_np[:M] = np.stack(wins)
        engine._tick("query")
        mn, med = _window_scores(graph, cfg, wins_np)
        mn = mn[:M]
        med = med[:M]

        applied = False
        indel_rows = set()  # one indel per read per round: later sites shift
        for b, p, q, start, end in groups:
            if b in indel_rows:
                continue
            cur_med = med[start]
            best_j, best_med = -1, cur_med
            for j in range(start + 1, end):
                if mn[j] >= params.min_kmer_cov and med[j] > best_med:
                    best_j, best_med = j, med[j]
            if best_j < 0:
                continue
            kind, v, u = meta[best_j]
            n = int(lengths[b])
            if kind == "sub":
                codes[b, p] = v
                if q >= 0:
                    codes[b, q] = u
            elif kind == "del":
                codes[b, p : n - v] = codes[b, p + v : n]
                codes[b, n - v :] = 4
                lengths[b] = n - v
                indel_rows.add(b)
            else:  # ins
                stop = min(n + 1, L)
                codes[b, p + 1 : stop] = codes[b, p : stop - 1]
                codes[b, p] = v
                lengths[b] = stop
                indel_rows.add(b)
            changed[b] = True
            applied = True
        if not applied:
            break

    return codes, lengths, changed
