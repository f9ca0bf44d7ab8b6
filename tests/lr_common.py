"""Helpers shared by the long-read key kernels' tests (no JAX, so the card
tests can use them where JAX is not installed): the kernel source's tile
constants and the plain versions' values in the kernels' ragged layout."""

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
