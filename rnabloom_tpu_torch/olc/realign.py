"""Batched banded read-to-unitig realignment for indel-aware polish.

The port's copy of ``rnabloom_tpu/olc/realign.py`` (host numpy, as there).
Plays racon's role in the reference's uniqueOLC step 4
(olc/OverlapLayoutConsensus.java:849 consensusWithRacon): after the cheap
column-majority vote fixes substitutions, placed reads are realigned to the
polished unitig inside a narrow diagonal band and their alignments vote on
per-position substitutions, deletions (unitig base unsupported by reads),
and insertions (reads carry a base the unitig lacks).  Majority edits are
applied, which repairs frameshifts contributed by the unitig's backbone
read — the failure mode a pure column vote cannot fix.

The DP is numpy-vectorized over all placements at once (band offsets are
the inner axis, read positions the sequential axis); only the per-read
traceback walks in Python, bounded by total aligned bases.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_INF = np.int32(1 << 20)


def banded_align_batch(
    reads: np.ndarray,  # (R, N) uint8 oriented read codes, 4 = pad
    read_lens: np.ndarray,  # (R,)
    windows: np.ndarray,  # (R, N + 2*w) uint8 unitig windows, 4 = pad
    w: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Semiglobal banded alignment of each read into its window.

    Window position j is banded to i + w + off with off in [-w, w]
    (the window leads the read by w bases).  The window prefix/suffix are
    free; interior gaps cost 1.

    Returns (tb (R, N+1, 2w+1) int8 traceback, end_off (R,), dist (R,)).
    tb codes: 0 diagonal (consume read+window), 1 window gap (consume
    window only), 2 read gap (consume read only).
    """
    R, N = reads.shape
    B = 2 * w + 1
    Wn = windows.shape[1]
    assert Wn >= N + 2 * w

    D = np.zeros((R, B), np.int32)  # D[., off] at current i; free window prefix
    tb = np.zeros((R, N + 1, B), np.int8)
    offs = np.arange(-w, w + 1)
    rows = np.arange(R)

    for i in range(1, N + 1):
        j = i + w + offs[None, :]  # (1, B) window column per off
        # diagonal: D[i-1][off] + mismatch(read[i-1], window[j-1])
        rbase = reads[:, i - 1 : i]  # (R, 1)
        wbase = windows[rows[:, None], j - 1]  # (R, B)
        diag = D + ((rbase != wbase) | (rbase >= 4) | (wbase >= 4)).astype(np.int32)
        # read gap (consume read only): D[i-1][off+1] + 1
        up = np.concatenate([D[:, 1:], np.full((R, 1), _INF)], axis=1) + 1
        best = np.minimum(diag, up)
        choice = np.where(up < diag, np.int8(2), np.int8(0))
        # window gap (consume window only): D_new[off-1] + 1 — prefix scan
        # along the off axis (left-to-right dependency within row i)
        for b in range(B):
            if b > 0:
                left = best[:, b - 1] + 1
                take = left < best[:, b]
                best[take, b] = left[take]
                choice[take, b] = 1
        # rows already past their read length keep their final values
        done = read_lens < i
        best[done] = D[done]
        choice[done] = 0
        D = best
        tb[:, i, :] = choice

    # tie-break toward the centered diagonal: an overhanging read can end
    # with equal cost via trailing mismatches (off 0) or trailing read gaps
    # (off < 0); the mismatch path keeps overhang bases off the vote table
    penal = D.astype(np.int64) * (2 * w + 2) + np.abs(offs)[None, :]
    end_off = np.argmin(penal, axis=1)
    dist = D[rows, end_off]
    return tb, end_off.astype(np.int32) - w, dist


def alignment_votes(
    tb: np.ndarray,
    end_off: np.ndarray,
    reads: np.ndarray,
    read_lens: np.ndarray,
    win_starts: np.ndarray,  # (R,) unitig position of window column 0
    tgt: np.ndarray,  # (R,) unitig index
    unitig_lens: np.ndarray,
    w: int,
    max_dist: np.ndarray,  # (R,) max edits accepted per read
    dist: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Traceback every accepted alignment and accumulate votes.

    Returns (base_votes (U, Lmax, 4), del_votes (U, Lmax),
    ins_votes (U, Lmax+1, 4), cov (U, Lmax)).
    """
    U = len(unitig_lens)
    Lmax = int(unitig_lens.max(initial=0))
    base_votes = np.zeros((U, Lmax, 4), np.int32)
    del_votes = np.zeros((U, Lmax), np.int32)
    ins_votes = np.zeros((U, Lmax + 1, 4), np.int32)
    cov = np.zeros((U, Lmax), np.int32)

    R = reads.shape[0]
    for r in range(R):
        if dist[r] > max_dist[r]:
            continue
        u = int(tgt[r])
        lu = int(unitig_lens[u])
        i = int(read_lens[r])
        off = int(end_off[r])
        base0 = int(win_starts[r])
        while i > 0:
            c = tb[r, i, off + w]
            j = i + w + off  # window column (1-based end)
            upos = base0 + j - 1
            if c == 0:  # diagonal
                b = reads[r, i - 1]
                if 0 <= upos < lu and b < 4:
                    base_votes[u, upos, b] += 1
                    cov[u, upos] += 1
                i -= 1
            elif c == 1:  # window gap: unitig base unsupported
                if 0 <= upos < lu:
                    del_votes[u, upos] += 1
                    cov[u, upos] += 1
                off -= 1
            else:  # read gap: read base missing from unitig
                b = reads[r, i - 1]
                # interior only: boundary "insertions" are read overhang,
                # not evidence (racon also polishes within the aligned span)
                if 0 < upos + 1 < lu and b < 4:
                    ins_votes[u, upos + 1, b] += 1
                i -= 1
                off += 1
    return base_votes, del_votes, ins_votes, cov


def apply_edits(
    unitigs: Sequence[np.ndarray],
    base_votes: np.ndarray,
    del_votes: np.ndarray,
    ins_votes: np.ndarray,
    cov: np.ndarray,
    min_depth: int,
) -> List[np.ndarray]:
    """Apply majority edits per unitig position (vectorized per unitig)."""
    out: List[np.ndarray] = []
    for u, codes in enumerate(unitigs):
        lu = len(codes)
        c = cov[u, :lu]
        half = np.maximum(c // 2 + 1, min_depth)
        # substitutions: winning base with majority support
        win = np.argmax(base_votes[u, :lu], axis=1).astype(np.uint8)
        win_n = base_votes[u, :lu][np.arange(lu), win]
        sub = (win_n >= half) & (c >= min_depth)
        edited = np.where(sub, win, codes[:lu])
        # deletions: majority of covering reads skip this base
        dele = (del_votes[u, :lu] >= half) & (c >= min_depth)
        # insertions before pos: majority of local coverage
        ins_n = ins_votes[u, : lu + 1]
        ins_win = np.argmax(ins_n, axis=1).astype(np.uint8)
        ins_cnt = ins_n[np.arange(lu + 1), ins_win]
        locc = np.zeros(lu + 1, np.int32)
        locc[:lu] = c
        locc[1:] = np.maximum(locc[1:], c)
        ins = (ins_cnt >= np.maximum(locc // 2 + 1, min_depth)) & (locc >= min_depth)

        if not dele.any() and not ins.any():
            out.append(edited)
            continue
        pieces: List[np.ndarray] = []
        keep = ~dele
        # interleave insertions and kept bases
        last = 0
        for pos in np.flatnonzero(ins):
            pieces.append(edited[last:pos][keep[last:pos]])
            pieces.append(np.asarray([ins_win[pos]], np.uint8))
            last = pos
        pieces.append(edited[last:][keep[last:]])
        out.append(np.concatenate(pieces).astype(np.uint8))
    return out
