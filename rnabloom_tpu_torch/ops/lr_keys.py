"""Per-read k-mer and strobemer keys of the long-read subsamplers.

The counterpart of the JAX package's ``_device_hash_buckets`` with
``_base_key_fn`` (k-mer keys) or its strobemer ``fn``
(``rnabloom_tpu/assembly/longreads.py:307-349``, ``:431-437``): for each
read, the key of every valid k-mer (or strobemer anchor), in position
order, as a uint64 array.

Two quirks of the JAX package are kept, value for value:

1. The keys are 32 bits.  The JAX package never enables 64-bit mode, so
   its ``uint64`` key is uint32 and ``hi << 32`` is 0: the key is the low
   word of the canonical hash.  Here every hash is full 64-bit and the key
   is ``hash & 0xFFFFFFFF``.
2. The JAX package takes a read's strobemer anchors below M = (L-k+1) -
   w_max*(n-2) - w_min with L the read's power-of-two bucket length
   1 << max(6, (len-1).bit_length()).  That has no effect on the keys: an
   anchor is valid only when its last window, which starts w_max*(n-2) +
   w_min past it, holds a valid k-mer, so every anchor at or past the M of
   the read's own length is invalid.  The plain versions pad into the
   buckets as the JAX package does; the ragged path lays the anchors out by
   the read's own length.

``kmer_keys`` and ``strobemer_keys`` run the plain versions
(``kmer_keys_plain``, ``strobemer_keys_plain``: the reads padded into the
JAX package's (64, 2^j) buckets through the plain torch hashers) on the
CPU, and on a CUDA device pack the reads ragged (codes concatenated, int64
offsets) and launch the hand-written kernels of ``csrc/lr_kernels.cu``:
``kmer_hashes`` (this module; ``LAUNCHES`` counts it) and
``strobemer.randstrobe_hashes``.  Reads shorter than k (than k + w_max*(n-2)
+ w_min + 1 for strobemers) get no keys.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import launch_timer, nthash, strobemer

KEY_MASK = 0xFFFFFFFF
ROWS = 64  # reads per padded batch of the plain versions, as the JAX package

LAUNCHES: Dict[str, int] = {"lr_kmer_keys": 0}


def reset_launch_counts() -> None:
    LAUNCHES["lr_kmer_keys"] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def strobemer_min_len(k: int, n: int, w_min: int, w_max: int) -> int:
    return k + w_max * (n - 2) + w_min + 1


def _bucketed(reads: Sequence[np.ndarray], fn: Callable, min_len: int, device) -> List[np.ndarray]:
    """``_device_hash_buckets``: reads grouped by padded length, ROWS at a
    time; ``fn(codes (ROWS, L) on device) -> (hashes, valid)``."""
    out = [np.empty(0, np.uint64)] * len(reads)
    buckets: Dict[int, List[int]] = {}
    for i, r in enumerate(reads):
        if len(r) >= min_len:
            buckets.setdefault(1 << max(6, (len(r) - 1).bit_length()), []).append(i)
    for L, idxs in sorted(buckets.items()):
        for s in range(0, len(idxs), ROWS):
            chunk = idxs[s : s + ROWS]
            codes = np.full((ROWS, L), 4, np.uint8)
            for j, i in enumerate(chunk):
                codes[j, : len(reads[i])] = reads[i]
            h, valid = fn(torch.from_numpy(codes).to(device))
            keys = (h & KEY_MASK).cpu().numpy().view(np.uint64)
            valid = valid.cpu().numpy()
            for j, i in enumerate(chunk):
                out[i] = keys[j][valid[j]]
    return out


def kmer_keys_plain(reads: Sequence[np.ndarray], k: int, stranded: bool, *, device) -> List[np.ndarray]:
    def fn(codes):
        fh, rh, valid = nthash.rolling_hash(codes, k, stranded)
        return nthash.canonical(fh, rh), valid

    return _bucketed(reads, fn, k, device)


def strobemer_keys_plain(
    reads: Sequence[np.ndarray], k: int, n: int, w_min: int, w_max: int, stranded: bool, *, device
) -> List[np.ndarray]:
    return _bucketed(
        reads, lambda codes: strobemer.strobemer_hashes_plain(codes, k, n, w_min, w_max, stranded),
        strobemer_min_len(k, n, w_min, w_max), device,
    )


def pack(reads: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """(codes uint8, offsets int64 (R + 1), lengths) of the reads, ragged, on ``device``."""
    lens = np.fromiter((len(r) for r in reads), np.int64, count=len(reads))
    offsets = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = np.concatenate([np.asarray(r, np.uint8) for r in reads]) if len(reads) else np.empty(0, np.uint8)
    return (torch.from_numpy(codes).to(device), torch.from_numpy(offsets).to(device), lens)


def kmer_hashes(codes: torch.Tensor, offsets: torch.Tensor, k: int, stranded: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k-mer hash (canonical: the signed min of both strands; forward
    when stranded) and validity (uint8) at every base position of ragged
    reads on the card; a k-mer that runs past its read's end or holds a
    code > 3 is invalid (hash 0).  Launches the kernel on the current
    stream, or raises."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"kmer_hashes: the kernel runs on a CUDA device, not {dev}")
    if codes.dtype != torch.uint8 or codes.dim() != 1 or not codes.is_contiguous():
        raise ValueError("kmer_hashes: codes must be a contiguous 1-D uint8 tensor")
    if offsets.device != dev or offsets.dtype != torch.int64 or offsets.dim() != 1 or not offsets.is_contiguous():
        raise ValueError(f"kmer_hashes: offsets must be a contiguous 1-D int64 tensor on {dev}")
    if not 1 <= k <= 64:
        raise ValueError(f"kmer_hashes: k={k} outside [1, 64]")
    from ._build import lr_kernels

    lib = lr_kernels()
    total = codes.numel()
    h = torch.empty(total, dtype=torch.int64, device=dev)
    valid = torch.empty(total, dtype=torch.uint8, device=dev)
    start = launch_timer.begin(dev)
    err = lib.lr_kmer_keys(codes.data_ptr(), offsets.data_ptr(), offsets.numel() - 1, total, k, int(stranded),
                           h.data_ptr(), valid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    launch_timer.end(start, dev, "lr_kmer_keys", total)
    if err != 0:
        raise RuntimeError(f"lr_kmer_keys launch failed: cudaError_t {err}")
    LAUNCHES["lr_kmer_keys"] += 1
    return h, valid


def _split(h: torch.Tensor, valid: torch.Tensor, seg: np.ndarray) -> List[np.ndarray]:
    """Per segment [seg[i], seg[i+1]) of (h, valid): the valid keys (low
    32 bits) as uint64, selected on the device."""
    if len(seg) == 1:
        return []
    ok = valid.bool()
    counts = torch.nn.functional.pad(torch.cumsum(ok, 0), (1, 0))[torch.from_numpy(seg).to(ok.device)]
    keys = torch.masked_select(h & KEY_MASK, ok).cpu().numpy().view(np.uint64)
    return np.split(keys, counts[1:-1].cpu().numpy())


def kmer_keys(reads: Sequence[np.ndarray], k: int, stranded: bool, *, device) -> List[np.ndarray]:
    """Per read, the 32-bit keys of its valid k-mers in position order."""
    device = torch.device(device)
    if device.type == "cpu":
        return kmer_keys_plain(reads, k, stranded, device=device)
    return kmer_keys_ragged(reads, k, stranded, device=device)


def kmer_keys_ragged(reads: Sequence[np.ndarray], k: int, stranded: bool, *, device) -> List[np.ndarray]:
    """``kmer_keys`` through the kernel, on the reads packed ragged."""
    codes, offsets, _ = pack(reads, device)
    h, valid = kmer_hashes(codes, offsets, k, stranded)
    return _split(h, valid, offsets.cpu().numpy())


def strobemer_keys(
    reads: Sequence[np.ndarray], k: int, n: int, w_min: int, w_max: int, stranded: bool, *, device
) -> List[np.ndarray]:
    """Per read, the 32-bit keys of its valid strobemer anchors in anchor
    order."""
    device = torch.device(device)
    if device.type == "cpu":
        return strobemer_keys_plain(reads, k, n, w_min, w_max, stranded, device=device)
    return strobemer_keys_ragged(reads, k, n, w_min, w_max, stranded, device=device)


def strobemer_keys_ragged(
    reads: Sequence[np.ndarray], k: int, n: int, w_min: int, w_max: int, stranded: bool, *, device
) -> List[np.ndarray]:
    """``strobemer_keys`` through the kernels, on the reads packed ragged."""
    codes, offsets, lens = pack(reads, device)
    m = np.where(lens >= strobemer_min_len(k, n, w_min, w_max), strobemer.num_anchors(lens, k, n, w_min, w_max), 0)
    aoff = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(m, out=aoff[1:])
    h, valid = kmer_hashes(codes, offsets, k, stranded)
    sh, ok = strobemer.randstrobe_hashes(h, valid, offsets, torch.from_numpy(aoff).to(device), k, n, w_min, w_max)
    return _split(sh, ok, aoff)
