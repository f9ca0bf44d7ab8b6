"""MiniFloat 8-bit log-scale counter codec (3-bit mantissa, 5-bit exponent).

Port of ``rnabloom_tpu/ops/minifloat.py``, bit for bit: the same float32
exponent tricks, the same rounding, the same salted per-(cell, batch)
stochastic rounding.  u32 wraparound in ``mix_u01`` is done in int64 with a
32-bit mask after each multiply (torch has no uint32 right shift on the
CPU).  The CUDA kernel in ``csrc/cell_insert.cu`` carries a C++ copy of
``increment_codes`` and ``mix_u01``; the tests hold both to this module.

Encoding: b <= 7 -> value b; else value = ((b & 7) | 8) * 2**((b >> 3) - 1).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e as float32 from an int32 exponent via the float's bits."""
    return ((torch.clamp(e, -126, 127) + 127).to(torch.int32) << 23).view(torch.float32)


def _floor_log2(c: torch.Tensor) -> torch.Tensor:
    """floor(log2(c)) for positive float32 c: the float's exponent bits."""
    return (c.to(torch.float32).view(torch.int32) >> 23) - 127


def decode(b: torch.Tensor) -> torch.Tensor:
    """MiniFloat byte -> float32 count."""
    b = b.to(torch.int32)
    mant = (b & 7) | 8
    exp = (b >> 3) - 1
    big = mant.to(torch.float32) * _exp2i(exp)
    return torch.where(b <= 7, b.to(torch.float32), big)


def encode(count: torch.Tensor) -> torch.Tensor:
    """float/int count -> nearest representable MiniFloat byte (uint8)."""
    c = torch.clamp(count.to(torch.float32), min=0.0)
    small = torch.clamp(torch.round(c), 0, 7).to(torch.int32)
    e = torch.clamp(_floor_log2(torch.clamp(c, min=8.0)) - 2, min=1)
    mant = torch.round(c * _exp2i(1 - e)).to(torch.int32)
    bump = mant >= 16
    e = torch.where(bump, e + 1, e)
    mant = torch.clamp(torch.where(bump, 8, mant), 8, 15)
    big = (e << 3) | (mant & 7)
    out = torch.where(c <= 7.5, small, torch.clamp(big, max=127))
    return out.to(torch.uint8)


def encode_floor(count: torch.Tensor) -> torch.Tensor:
    """float/int count -> largest representable MiniFloat byte <= count."""
    c = torch.clamp(count.to(torch.float32), min=0.0)
    small = torch.clamp(torch.floor(c), 0, 7).to(torch.int32)
    e = torch.clamp(_floor_log2(torch.clamp(c, min=8.0)) - 2, min=1)
    mant = torch.clamp(torch.floor(c * _exp2i(1 - e)).to(torch.int32), 8, 15)
    big = (e << 3) | (mant & 7)
    out = torch.where(c < 8, small, torch.clamp(big, max=127))
    return out.to(torch.uint8)


def encode_stochastic(count: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """Round up to the next representable value with probability equal to
    the residual fraction (u01: uniform [0, 1) per element)."""
    c = torch.clamp(count.to(torch.float32), min=0.0)
    c0 = encode_floor(c).to(torch.int32)
    c1 = torch.clamp(c0 + 1, max=127)
    v0 = decode(c0.to(torch.uint8))
    v1 = decode(c1.to(torch.uint8))
    frac = torch.where(v1 > v0, (c - v0) / torch.clamp(v1 - v0, min=1e-9), 0.0)
    return torch.where(u01 < frac, c1, c0).to(torch.uint8)


def increment_codes(codes: torch.Tensor, delta: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """Fused ``encode_stochastic(decode(codes) + delta, u01)`` for integer
    deltas >= 0, in integer arithmetic (one float compare for the bump)."""
    c = torch.clamp(codes.to(torch.int32), max=127)
    d = torch.clamp(delta.to(torch.int32), min=0)
    e_old = torch.clamp((c >> 3) - 1, min=0)
    v = torch.where(c <= 7, c, ((c & 7) | 8) << e_old)
    n = v + d
    # exponent from the float32 representation, as the reference does: for
    # n > 2^24 the conversion rounds, and the codes must round the same way
    b = _floor_log2(torch.clamp(n, min=8).to(torch.float32))
    e = b - 2
    m = n >> (e - 1)
    v0 = m << (e - 1)
    raw = (e << 3) | (m & 7)
    sat = raw >= 127
    q = (1 << torch.clamp(e - 1, min=0)).to(torch.float32)
    bump = torch.logical_and(~sat, u01 * q < (n - v0).to(torch.float32))
    big = torch.clamp(raw + bump.to(torch.int32), max=127)
    return torch.where(n <= 7, n, big).to(torch.uint8)


def mix_u01(idx: torch.Tensor, salt: int) -> torch.Tensor:
    """Deterministic per-(index, salt) uniform [0, 1) (xxhash-style mix)."""
    x = ((idx.to(torch.int64) & M32) * 0x9E3779B1) & M32
    x = x ^ (((int(salt) & M32) * 0x85EBCA6B) & M32)
    x = x ^ (x >> 16)
    x = (x * 0x27D4EB2F) & M32
    x = x ^ (x >> 15)
    return (x >> 8).to(torch.int32).to(torch.float32) / float(1 << 24)
