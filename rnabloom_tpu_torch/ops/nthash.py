"""Batched ntHash on int64 tensors.

Port of ``rnabloom_tpu/ops/nthash.py`` (rolling hash, canonical, multi-hash,
pair combine, successor and SNV-variant hashes).  Hash values are carried
as int64 two's-complement bit patterns of the reference's u64 values:
multiply and add wrap, a logical right shift is
``(x >> s) & ((1 << (64 - s)) - 1)`` and the signed-min canonical hash is
``torch.minimum``.

The rolling hash uses the direct form

    fh(i) = XOR_{j<k} rotl(seed[s[i+j]], k-1-j)
    rh(i) = XOR_{j<k} rotl(seed[comp(s[i+j])], j)

as k table gathers over shifted views of the code batch, with the rotations
folded into per-offset seed tables.  The JAX package's prefix-XOR form was a
TPU vector device; the hash values are equal.

Bases are 2-bit codes A=0 C=1 G=2 T=3, with 4 = N/invalid/padding.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

M64 = (1 << 64) - 1

# Published ntHash 64-bit base seeds (same constants as
# rnabloom_tpu/ops/nthash_ref.py; a CPU test asserts they agree).
SEEDS = [
    0x3C8BFBB395C60474,  # A
    0x3193C18562A02B4C,  # C
    0x20323ED082572324,  # G
    0x295549F54BE24456,  # T
    0x0000000000000000,  # N / invalid
]
MULTI_SEED = 0x90B45D39FB6DA1FA
MULTI_SHIFT = 27
PAIR_CONST = 0x9E3779B9


def to_s64(v: int) -> int:
    """u64 Python int -> the int64 value with the same bit pattern."""
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def rotl64(v: int, s: int) -> int:
    s %= 64
    v &= M64
    return ((v << s) | (v >> (64 - s))) & M64


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


@functools.lru_cache(maxsize=None)
def _seed_tables(k: int, device: str) -> torch.Tensor:
    """(2, k, 5) int64: [0, j] = rotl(seed[c], k-1-j) (forward strand),
    [1, j] = rotl(seed[comp c], j) (reverse strand); code 4 -> 0."""
    fwd = [[to_s64(rotl64(SEEDS[c], k - 1 - j)) if c < 4 else 0 for c in range(5)] for j in range(k)]
    rev = [[to_s64(rotl64(SEEDS[3 - c], j)) if c < 4 else 0 for c in range(5)] for j in range(k)]
    return torch.tensor([fwd, rev], dtype=torch.int64, device=device)


def rolling_hash(
    codes: torch.Tensor, k: int, stranded: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """All k-mer hashes of a code batch.

    Args:
      codes: (..., L) uint8 2-bit codes, 4 = invalid/pad.  L >= k.
      k: k-mer length.
      stranded: if False also compute reverse-strand hashes.

    Returns:
      (fh, rh, valid): int64 tensors of shape (..., L-k+1); rh is None when
      stranded.  valid[i] is True iff the window [i, i+k) holds no invalid
      base.
    """
    L = codes.shape[-1]
    n = L - k + 1
    assert n >= 1, f"sequence length {L} < k={k}"
    c = torch.clamp(codes.long(), max=4)
    tables = _seed_tables(k, str(codes.device))
    fh = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64, device=codes.device)
    rh = None if stranded else torch.zeros_like(fh)
    for j in range(k):
        w = c[..., j : j + n]
        fh ^= tables[0, j][w]
        if rh is not None:
            rh ^= tables[1, j][w]

    invalid = torch.nn.functional.pad((codes >= 4).to(torch.int32).cumsum(-1), (1, 0))
    valid = (invalid[..., k:] - invalid[..., :n]) == 0
    return fh, rh, valid


def canonical(fh: torch.Tensor, rh: Optional[torch.Tensor]) -> torch.Tensor:
    """Base hash value: signed min(fh, rh) in non-stranded mode, else fh."""
    if rh is None:
        return fh
    return torch.minimum(fh, rh)


def multi_hash(base: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """NTM64: m hash values from the base value (trailing axis m).

    h_0 = base;  h_i = g(base * (i ^ k*MULTI_SEED)),  g(x) = x ^ (x >>> 27).
    """
    outs = [base]
    for i in range(1, m):
        t = base * to_s64(i ^ (k * MULTI_SEED))
        outs.append(t ^ shr(t, MULTI_SHIFT))
    return torch.stack(outs, dim=-1)


def comp_codes(codes: torch.Tensor) -> torch.Tensor:
    """Complement of 2-bit codes; invalid (>= 4) stays invalid."""
    return torch.where(codes < 4, 3 - codes, codes).to(codes.dtype)


def rotl1(x: torch.Tensor) -> torch.Tensor:
    return (x << 1) | shr(x, 63)


def rotr1(x: torch.Tensor) -> torch.Tensor:
    return shr(x, 1) | (x << 63)


@functools.lru_cache(maxsize=None)
def _step_tables(k: int, device: str) -> torch.Tensor:
    """(4, 5) int64 seed tables of a one-base slide, code 4 -> 0: rows
    seed, rotl(seed, k), rotl(seed, k-1), rotr(seed, 1)."""
    rows = [lambda s: s, lambda s: rotl64(s, k), lambda s: rotl64(s, k - 1), lambda s: rotl64(s, 63)]
    return torch.tensor(
        [[to_s64(f(SEEDS[c])) if c < 4 else 0 for c in range(5)] for f in rows],
        dtype=torch.int64, device=device,
    )


def successor_hashes(
    fh: torch.Tensor, out_codes: torch.Tensor, k: int, rh: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Hashes of the 4 right-neighbours of each k-mer, shape (..., 4), one
    per appended base A/C/G/T.  ``out_codes`` holds each k-mer's FIRST
    base (the one leaving the window).

      fh' = rotl(fh,1) ^ rotl(seed[out], k) ^ seed[in]
      rh' = rotr(rh,1) ^ rotr(seed[comp out], 1) ^ rotl(seed[comp in], k-1)
    """
    ident, rot_k, rot_km1, rotr_1 = _step_tables(k, str(fh.device))
    out = torch.clamp(out_codes.long(), max=4)
    fh4 = (rotl1(fh) ^ rot_k[out])[..., None] ^ ident[:4]
    rh4 = None
    if rh is not None:
        tr = rotr1(rh) ^ rotr_1[comp_codes(out)]
        rh4 = tr[..., None] ^ rot_km1[:4].flip(0)  # comp(in) = 3 - in
    return fh4, rh4


def combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pair-hash combiner: a ^ (b + 0x9e3779b9 + (a << 6) + (b >>> 2))."""
    return a ^ (b + PAIR_CONST + (a << 6) + shr(b, 2))


def combine_canonical(
    fh_l: torch.Tensor, rh_l: torch.Tensor, fh_r: torch.Tensor, rh_r: torch.Tensor
) -> torch.Tensor:
    """Canonical pair hash: signed min(combine(fl, fr), combine(rr, rl));
    the reverse complement of the pair (L, R) is (rc(R), rc(L))."""
    return torch.minimum(combine(fh_l, fh_r), combine(rh_r, rh_l))


def _variants(h: torch.Tensor, codes: torch.Tensor, table: torch.Tensor, comp: bool) -> torch.Tensor:
    """h ^ table[c] ^ table[b] for each new base b = A/C/G/T, shape
    (..., 4); with ``comp`` the complements of the code c and of b."""
    c = torch.clamp(codes.long(), max=4)
    if comp:
        return (h ^ table[comp_codes(c)])[..., None] ^ table[:4].flip(0)  # comp(b) = 3 - b
    return (h ^ table[c])[..., None] ^ table[:4]


def variant_hashes_right(
    fh: torch.Tensor, last_codes: torch.Tensor, k: int, rh: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Hashes of the k-mers with the LAST base substituted by each of
    A/C/G/T, shape (..., 4): the last base has rotation 0 in the forward
    sum and its complement rotation k-1 on the reverse strand
    (RightVariantsNTHashIterator)."""
    ident, _, rot_km1, _ = _step_tables(k, str(fh.device))
    rh4 = None if rh is None else _variants(rh, last_codes, rot_km1, True)
    return _variants(fh, last_codes, ident, False), rh4


def variant_hashes_left(
    fh: torch.Tensor, first_codes: torch.Tensor, k: int, rh: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Hashes of the k-mers with the FIRST base substituted (rotation k-1
    forward, rotation 0 of the complement on the reverse strand)."""
    ident, _, rot_km1, _ = _step_tables(k, str(fh.device))
    rh4 = None if rh is None else _variants(rh, first_codes, ident, True)
    return _variants(fh, first_codes, rot_km1, False), rh4
