"""Helpers shared by the long-read kernels' tests (no JAX, so the card
tests can use them where JAX is not installed): the kernel source's tile
constants, the plain versions' values in the key kernels' ragged layout,
and the consensus vote's edge cases."""

import re
from pathlib import Path

import numpy as np
import torch

from rnabloom_tpu_torch.ops import lr_keys, nthash, strobemer

SOURCE = Path(__file__).resolve().parents[1] / "rnabloom_tpu_torch" / "csrc" / "lr_kernels.cu"


def kernel_constants() -> dict:
    """The ``constexpr int`` constants of the kernel source, evaluated."""
    out = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", SOURCE.read_text(), re.M):
        out[name] = eval(expr.replace("/", "//"), {}, dict(out))
    return out


def ragged_plain(reads, k, stranded, dev, strobes=None):
    """The plain versions' full 64-bit values in the kernels' ragged layout:
    per position the k-mer hash and flag (hash 0 where invalid), or with
    ``strobes = (n, w_min, w_max)`` per anchor the randstrobe hash and flag
    (hash 0 where invalid; reads padded into the JAX package's buckets, as
    the plain key path)."""
    if strobes is None:
        codes, offsets, _ = lr_keys.pack(reads, dev)
        h = torch.zeros(codes.numel(), dtype=torch.int64, device=dev)
        v = torch.zeros(codes.numel(), dtype=torch.uint8, device=dev)
        offs = offsets.tolist()
        for a, b in zip(offs, offs[1:]):
            if b - a >= k:
                fh, rh, ok = nthash.rolling_hash(codes[a:b], k, stranded)
                h[a : b - k + 1] = torch.where(ok, nthash.canonical(fh, rh), 0)
                v[a : b - k + 1] = ok.to(torch.uint8)
        return h, v
    n, w_min, w_max = strobes
    min_len = lr_keys.strobemer_min_len(k, n, w_min, w_max)
    per, buckets = {}, {}
    for i, r in enumerate(reads):
        if len(r) >= min_len:
            buckets.setdefault(1 << max(6, (len(r) - 1).bit_length()), []).append(i)
    for L, idxs in buckets.items():
        for s in range(0, len(idxs), lr_keys.ROWS):
            chunk = idxs[s : s + lr_keys.ROWS]
            codes = np.full((len(chunk), L), 4, np.uint8)
            for j, i in enumerate(chunk):
                codes[j, : len(reads[i])] = reads[i]
            h, ok = strobemer.strobemer_hashes_plain(torch.from_numpy(codes).to(dev), k, n, w_min, w_max, stranded)
            for j, i in enumerate(chunk):
                m = strobemer.num_anchors(len(reads[i]), k, n, w_min, w_max)
                per[i] = (torch.where(ok[j, :m], h[j, :m], 0), ok[j, :m].to(torch.uint8))
    empty = (torch.empty(0, dtype=torch.int64, device=dev), torch.empty(0, dtype=torch.uint8, device=dev))
    parts = [per.get(i, empty) for i in range(len(reads))]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


VOTE_CASES = ("overhang", "untouched", "ties", "one_unitig", "pads")


def vote_case(case: str, U: int = 6, L: int = 300, R: int = 80, Lr: int = 120, seed: int = 0):
    """Inputs of one batch of the consensus vote (numpy: unitigs (U, L)
    uint8, reads (R, Lr) uint8, tgt and start (R,) int32) where a kernel is
    likely to go wrong.  Every case: a unitig of pad 4 past two thirds of
    its length, reads padded with 4 past their own length, starts from
    below -Lr - 10 up to L + 10 (reads over both ends, wholly outside, and
    below -Lr/2).  "untouched": no read on unitig 2; "ties": on unitig 0,
    which no other read targets, every column of its first Lr a four-way
    tie (one read of each base from 0) and those from Lr/2 on a two-way tie
    of G and T (two reads more from Lr/2); "one_unitig": every read on
    unitig U - 1; "pads": a tenth of the read bases 4, 5, 77 or 255."""
    rng = np.random.default_rng(seed)
    unitigs = rng.integers(0, 4, (U, L), dtype=np.uint8)
    unitigs[min(1, U - 1), 2 * L // 3:] = 4
    reads = rng.integers(0, 4, (R, Lr), dtype=np.uint8)
    lens = rng.integers(Lr // 4, Lr + 1, R)
    reads[np.arange(Lr)[None, :] >= lens[:, None]] = 4
    tgt = rng.integers(0, U, R).astype(np.int32)
    start = rng.integers(-Lr - 10, L + 10, R).astype(np.int32)
    if case == "untouched":
        assert U > 3
        tgt[tgt == 2] = 3
    elif case == "ties":
        assert R >= 6 and U > 1
        tgt[tgt == 0] = 1
        tgt[:6] = 0
        start[:6] = [0, 0, 0, 0, Lr // 2, Lr // 2]
        reads[:6] = np.array([0, 1, 2, 3, 2, 3], np.uint8)[:, None]
    elif case == "one_unitig":
        tgt[:] = U - 1
    elif case == "pads":
        bad = rng.random((R, Lr)) < 0.1
        reads[bad] = rng.choice(np.array([4, 5, 77, 255], np.uint8), int(bad.sum()))
    else:
        assert case == "overhang", case
    return unitigs, reads, tgt, start
