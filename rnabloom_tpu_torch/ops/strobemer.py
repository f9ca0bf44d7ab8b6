"""Randstrobe hashing: the plain version and the kernel's front end.

Port of ``rnabloom_tpu/ops/strobemer.py`` (hash/StrobeHashIterator.java and
its Strobe3 / canonical variants): for each anchor k-mer, each of the n-1
strobes is chosen from the window [anchor + s*w_max + w_min, anchor +
s*w_max + w_max) minimising combine(current, candidate) under UNSIGNED
comparison, ties taking the later position (Long.compareUnsigned >= 0).
The long-read strobemer subsampler (``-lrsub depth,s,size,window``) keys
reads by these hashes.

``strobemer_hashes_plain`` is the JAX function op for op on a padded
(B, L) batch, on any device, with int64 bit patterns (the unsigned <= is a
signed <= after flipping the sign bits).  ``randstrobe_hashes`` launches
the hand-written CUDA kernel (``csrc/lr_kernels.cu``) on ragged reads, on
the k-mer hashes of ``lr_keys.kmer_hashes``; ``LAUNCHES`` counts its
launches and ``launch_timer.recording()`` times them.  ``lr_keys`` holds
the per-read key arrays that the subsampler takes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import launch_timer, nthash

_SIGN = -(1 << 63)  # int64 with only the sign bit: flips signed to unsigned order

LAUNCHES: Dict[str, int] = {"lr_randstrobe_keys": 0}


def reset_launch_counts() -> None:
    LAUNCHES["lr_randstrobe_keys"] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def num_anchors(L, k: int, n: int, w_min: int, w_max: int):
    """Anchors of a sequence of length L (an int or an array of them):
    M = (L-k+1) - w_max*(n-2) - w_min."""
    return (L - k + 1) - w_max * (n - 2) - w_min


def strobemer_hashes_plain(
    codes: torch.Tensor, k: int, n: int, w_min: int, w_max: int, stranded: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strobemer hash per anchor position of a (B, L) uint8 code batch:
    (hashes (B, M) int64, valid (B, M)), M = num_anchors(L, ...), the
    reference's anchor range.  A candidate past the end of the batch's
    k-mers is invalid (value 0, as the JAX package's padding)."""
    assert n >= 2
    P = codes.shape[-1] - k + 1
    M = num_anchors(codes.shape[-1], k, n, w_min, w_max)
    assert M >= 1, "sequence too short for strobemer parameters"
    fh, rh, valid = nthash.rolling_hash(codes, k, stranded=stranded)
    base = nthash.canonical(fh, rh)

    cur, ok = base[..., :M], valid[..., :M]
    for s in range(n - 1):
        best = best_ok = None
        for off in range(s * w_max + w_min, s * w_max + w_max):
            avail = min(M, P - off)
            if avail <= 0:
                continue
            cand = torch.zeros_like(cur)
            cand[..., :avail] = base[..., off : off + avail]
            cand_ok = torch.zeros_like(ok)
            cand_ok[..., :avail] = valid[..., off : off + avail]
            h = nthash.combine(cur, cand)
            if best is None:
                best, best_ok = h, cand_ok
            else:
                # unsigned compare, ties -> later offset wins (le on old)
                take_new = (((h ^ _SIGN) <= (best ^ _SIGN)) & cand_ok) | ~best_ok
                best = torch.where(take_new, h, best)
                best_ok = best_ok | cand_ok
        cur, ok = best, ok & best_ok
    return cur, ok


def randstrobe_hashes(
    hash_: torch.Tensor, valid: torch.Tensor, offsets: torch.Tensor, aoff: torch.Tensor,
    k: int, n: int, w_min: int, w_max: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strobemer hash per anchor of ragged reads on the card: (hashes int64,
    valid uint8), anchor a of read i at index aoff[i] + a.

    ``hash_``/``valid``: the k-mer hashes (int64) and validity (uint8) at
    every base position of the reads (``lr_keys.kmer_hashes``); ``offsets``
    (int64, R + 1) the reads' base offsets; ``aoff`` (int64, R + 1) their
    anchor offsets.  offsets[0] = aoff[0] = 0, offsets[-1] = the number of
    positions, and read i has at most max(len_i - k + 1, 0) anchors (checked
    here, with the host's one read of the anchor count).  Launches the kernel
    on the current stream, or raises."""
    dev = hash_.device
    if dev.type != "cuda":
        raise ValueError(f"randstrobe_hashes: the kernel runs on a CUDA device, not {dev}")
    if n < 2 or not 0 < w_min < w_max:
        raise ValueError(f"randstrobe parameters n={n} w_min={w_min} w_max={w_max}")
    for t, dt in ((hash_, torch.int64), (valid, torch.uint8), (offsets, torch.int64), (aoff, torch.int64)):
        if t.device != dev or t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"randstrobe_hashes: want a contiguous 1-D {dt} tensor on {dev}")
    if valid.numel() != hash_.numel() or aoff.numel() != offsets.numel():
        raise ValueError("randstrobe_hashes: hash/valid or offsets/aoff differ in length")
    from ._build import lr_kernels

    lib = lr_kernels()
    n_reads = offsets.numel() - 1
    lens, m = offsets.diff(), aoff.diff()
    bad = ((lens < 0) | (m < 0) | (m > (lens - k + 1).clamp(min=0))).any()
    n_anchors, first, a_first, last, n_bad = torch.stack(
        [aoff[-1], offsets[0], aoff[0], offsets[-1], bad.long()]).tolist()
    if first != 0 or a_first != 0 or last != hash_.numel() or n_bad:
        raise ValueError("randstrobe_hashes: offsets and aoff must start at 0, offsets end at the positions, and a "
                         "read have at most len - k + 1 anchors")
    out = torch.empty(n_anchors, dtype=torch.int64, device=dev)
    ok = torch.empty(n_anchors, dtype=torch.uint8, device=dev)
    start = launch_timer.begin(dev)
    err = lib.lr_randstrobe_keys(
        hash_.data_ptr(), valid.data_ptr(), offsets.data_ptr(), aoff.data_ptr(), n_reads, n_anchors,
        k, n, w_min, w_max, out.data_ptr(), ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    launch_timer.end(start, dev, "lr_randstrobe_keys", n_anchors)
    if err != 0:
        raise RuntimeError(f"lr_randstrobe_keys launch failed: cudaError_t {err}")
    LAUNCHES["lr_randstrobe_keys"] += 1
    return out, ok
