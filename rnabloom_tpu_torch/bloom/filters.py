"""Bloom bit-lane filters and counters (count-min, and the conservative
update of exact counts) on torch tensors.

Port of ``rnabloom_tpu/bloom/filters.py`` with its scatter semantics
(``merge=False``, the layout the JAX package uses off the TPU): every
filter array carries trailing trash cell(s) at index ``size``, inside the
array, that masked-out lanes are written to.  Hash values are int64 bit
patterns (see ``ops/nthash.py``); cell indices are int64.

Inserts go through ``ops.cell_insert`` (the CUDA kernel on the card) and
update the arrays in place; the functions return the array for symmetry
with the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops import minifloat
from ..ops.cell_insert import cell_insert
from ..ops.nthash import shr


def pow2_size(requested: int) -> int:
    """Round a requested cell count up to a power of two (min 1024)."""
    return 1 << max(10, math.ceil(math.log2(max(requested, 2))))


def _no_merge(merge: bool) -> None:
    if merge:
        raise NotImplementedError(
            "merge=True is the TPU sort-merge layout; the port computes the scatter layout"
        )


@dataclass(frozen=True)
class BloomConfig:
    """Shape/hash parameters of a bit-lane filter.  ``merge`` is kept so
    checkpoint descriptors interchange with the JAX package; it is always
    False here."""

    size_log2: int
    num_hash: int
    merge: bool = False

    def __post_init__(self):
        _no_merge(self.merge)

    @property
    def size(self) -> int:
        return 1 << self.size_log2

    @property
    def trash(self) -> int:
        return 1

    @classmethod
    def for_expected(cls, num_elements: int, fpr: float, num_hash: int) -> "BloomConfig":
        """Sizing from expected elements + target FPR (getExpectedSize),
        rounded up to a power of two."""
        r = -num_hash / math.log(1.0 - math.exp(math.log(fpr) / num_hash))
        return cls(pow2_size(int(math.ceil(num_elements * r))).bit_length() - 1, num_hash)


def _bcast_valid(valid: Optional[torch.Tensor], hashes: torch.Tensor) -> Optional[torch.Tensor]:
    """Broadcast a (...)-shaped mask to the (..., num_hash) hash shape."""
    if valid is None or valid.shape == hashes.shape:
        return valid
    return valid[..., None].expand(hashes.shape)


def bloom_indices(
    hashes: torch.Tensor, size_log2: int, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(hash >>> 1) & (size - 1) as int64 indices; invalid lanes go to the
    trash cell at index ``size``."""
    assert size_log2 <= 32
    idx = shr(hashes, 1) & ((1 << size_log2) - 1)
    if valid is not None:
        idx = torch.where(valid, idx, 1 << size_log2)
    return idx


def make_bloom(cfg: BloomConfig, *, device) -> torch.Tensor:
    """Fresh bit-lane array (uint8, size + trash cell) on ``device``."""
    return torch.zeros(cfg.size + cfg.trash, dtype=torch.uint8, device=device)


def bloom_add(
    bits: torch.Tensor, cfg: BloomConfig, hashes: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Insert a batch in place.  hashes: int64 (..., num_hash)."""
    idx = bloom_indices(hashes, cfg.size_log2, _bcast_valid(valid, hashes))
    return cell_insert(bits, idx.reshape(-1), "set")


def bloom_lookup(bits: torch.Tensor, cfg: BloomConfig, hashes: torch.Tensor) -> torch.Tensor:
    """Membership per element.  hashes: int64 (..., num_hash) -> bool (...)."""
    idx = bloom_indices(hashes, cfg.size_log2)
    return torch.all(bits[idx] != 0, dim=-1)


def bloom_lookup_then_add(
    bits: torch.Tensor, cfg: BloomConfig, hashes: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched lookupThenAdd in place: (bits, was_present), with
    ``was_present`` read from the pre-batch snapshot (the JAX package's
    semantics; the caller's multiplicity logic accounts for repeats within
    the batch)."""
    found = bloom_lookup(bits, cfg, hashes)
    return bloom_add(bits, cfg, hashes, valid), found


def _integer_pow(x, y: int):
    """x ** y by the same multiplications as JAX's integer_pow lowering
    (binary exponentiation), so float32 results agree bit for bit."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _count_nonzero(cells: torch.Tensor) -> int:
    """Nonzero cells, counted in slices: on CUDA ``torch.count_nonzero``
    makes an int64 copy of its input, 8 B per cell (4 GiB for a 2^29-cell
    cbf), which would be the stage-1 run's peak."""
    return sum(int(torch.count_nonzero(part)) for part in cells.split(1 << 24))


def _fpr(nonzero: int, size: int, num_hash: int) -> float:
    """(popcount / size) ** num_hash in float32, as the JAX package
    computes it (its popcount is a float32 sum: exact below 2^24)."""
    frac = torch.tensor(float(nonzero), dtype=torch.float32) / size
    return float(_integer_pow(frac, num_hash))


def bloom_fpr(bits: torch.Tensor, cfg: BloomConfig) -> float:
    """(popcount / size) ** num_hash (BloomFilter.java:184-194)."""
    return _fpr(_count_nonzero(bits[: cfg.size]), cfg.size, cfg.num_hash)


# ---------------------------------------------------------------------------
# Counting filter
# ---------------------------------------------------------------------------

SCRATCH_LOG2_DEFAULT = 22

_TORCH_DTYPES = {"int32": torch.int32, "u16": torch.int16, "mf8": torch.uint8}


@dataclass(frozen=True)
class CountingConfig:
    """Count-min counter array.  ``dtype``: "mf8" (1 B MiniFloat), "u16"
    (2 B saturating, held as int16 bit patterns) or "int32".  ``blocked``
    puts all of a key's cells in one 128-lane row (int32 only).  Fields
    match the JAX package's so checkpoint descriptors interchange."""

    size_log2: int
    num_hash: int
    scratch_log2: int = SCRATCH_LOG2_DEFAULT
    blocked: bool = False
    merge: bool = False
    dtype: str = "int32"

    def __post_init__(self):
        _no_merge(self.merge)

    @property
    def size(self) -> int:
        return 1 << self.size_log2

    @property
    def trash(self) -> int:
        return 128 if self.blocked else 1

    @property
    def cell_bytes(self) -> int:
        return {"int32": 4, "u16": 2, "mf8": 1}[self.dtype]

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]


def make_counting(cfg: CountingConfig, *, device) -> torch.Tensor:
    """Fresh counter array (size + trash cells) on ``device``."""
    assert cfg.dtype == "int32" or not cfg.blocked, "narrow counters are unblocked"
    return torch.zeros(cfg.size + cfg.trash, dtype=cfg.torch_dtype, device=device)


def decode_counts(cells: torch.Tensor, dtype: str) -> torch.Tensor:
    """Raw counter cells -> count values (monotonic in the cell code)."""
    if dtype == "mf8":
        return minifloat.decode(cells)
    if dtype == "u16":
        return cells.to(torch.int32) & 0xFFFF
    return cells.to(torch.int32)


def encode_counts(values: torch.Tensor, dtype: str, u01: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count values -> counter cells (monotonic, saturating); mf8 rounds
    stochastically with ``u01``, else to the nearest code.  u16 cells come
    out as int16 bit patterns."""
    if dtype == "mf8":
        return minifloat.encode(values) if u01 is None else minifloat.encode_stochastic(values, u01)
    if dtype == "u16":
        v = torch.clamp(values.to(torch.int32), 0, 65535)
        return torch.where(v >= 32768, v - 65536, v).to(torch.int16)
    return values.to(torch.int32)


def apply_cell_increments(
    cells: torch.Tensor, inc: torch.Tensor, dtype: str, salt: int = 0,
    cell_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """cells + inc elementwise in the cell encoding (saturating); returns a
    new tensor.  ``cell_index`` is each cell's absolute index (default
    0..n-1), which keys the mf8 stochastic rounding."""
    if dtype == "int32":
        return cells + inc
    if dtype == "u16":
        v = torch.clamp((cells.to(torch.int32) & 0xFFFF) + inc, max=65535)
        return torch.where(v >= 32768, v - 65536, v).to(torch.int16)
    if cell_index is None:
        cell_index = torch.arange(cells.shape[0], device=cells.device)
    new = minifloat.increment_codes(cells, inc, minifloat.mix_u01(cell_index, salt))
    return torch.where(inc > 0, new, cells)


def blocked_cells(
    cfg: CountingConfig, hashes: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, lanes) of a key's cells in the blocked layout.

    Row from hash 0; lane i from hash i, forced distinct from lane 0 for
    i >= 1.  Invalid keys go to the trash row ``size / 128``."""
    assert cfg.size_log2 >= 7
    rows_log2 = cfg.size_log2 - 7
    h0 = hashes[..., 0]
    row = shr(h0, 1) & ((1 << min(rows_log2, 32)) - 1)
    lane0 = (h0 >> 40) & 127
    lanes = [lane0]
    for i in range(1, cfg.num_hash):
        step = (hashes[..., i] & 0xFFFFFFFF) % 127 + 1
        lanes.append((lane0 + step * i) & 127)
    if valid is not None:
        v = valid if valid.dim() == row.dim() else valid[..., 0]
        row = torch.where(v, row, 1 << rows_log2)
    return row, torch.stack(lanes, dim=-1)


def counting_count(counts: torch.Tensor, cfg: CountingConfig, hashes: torch.Tensor) -> torch.Tensor:
    """Estimated count per element: min over the h cells, decoded."""
    if cfg.blocked:
        row, lanes = blocked_cells(cfg, hashes)
        return torch.amin(counts[row[..., None] * 128 + lanes], dim=-1)
    # decoding is monotonic in the cell code, so min-then-decode (the JAX
    # package's order) equals decode-then-min; decoding first reads u16
    # cells as unsigned
    cells = counts[bloom_indices(hashes, cfg.size_log2)]
    return torch.amin(decode_counts(cells, cfg.dtype), dim=-1)


def counting_increment(
    counts: torch.Tensor, cfg: CountingConfig, hashes: torch.Tensor,
    valid: Optional[torch.Tensor] = None, dec_first: Optional[torch.Tensor] = None,
    salt: int = 0,
) -> torch.Tensor:
    """Conservative-update increment of a batch with multiplicity, in place
    (the exact-count path; flat layout only).

    Every occurrence sees the pre-batch cells.  The multiplicity m of a key
    within the batch is the min over its cells of a fresh int32 scratch
    sketch of ``2^scratch_log2 + 1`` cells (the ``add`` insert of the
    batch); ``dec_first`` takes 1 off it (the first insert of a key new to
    the graph goes to the dbgbf only).  All h cells are then raised to
    max(cell, min_cell + max(m, 0)) by the ``max`` insert of the encoded
    values; mf8 rounds stochastically keyed by hash 0's low 32 bits and
    ``salt``."""
    assert not cfg.blocked, "the conservative path keeps the reference layout"
    valid = _bcast_valid(valid, hashes)
    idx = bloom_indices(hashes, cfg.size_log2, valid)
    sidx = bloom_indices(hashes, cfg.scratch_log2, valid)
    scratch = torch.zeros((1 << cfg.scratch_log2) + 1, dtype=torch.int32, device=counts.device)
    cell_insert(scratch, sidx.reshape(-1), "add")
    mult = torch.amin(scratch[sidx], dim=-1)
    if dec_first is not None:
        mult = mult - dec_first.to(torch.int32)
    # decoding is monotonic in the cell code: min-then-decode (the JAX
    # package's order) equals decode-then-min, which reads u16 unsigned
    cur_min = torch.amin(decode_counts(counts[idx], cfg.dtype), dim=-1)
    new_val = cur_min + torch.clamp(mult, min=0).to(cur_min.dtype)
    if valid is not None:
        new_val = torch.where(valid[..., 0], new_val, torch.zeros_like(new_val))
    u01 = minifloat.mix_u01(hashes[..., 0], salt) if cfg.dtype == "mf8" else None
    upd = encode_counts(new_val, cfg.dtype, u01)[..., None].expand(idx.shape)
    return cell_insert(counts, idx.reshape(-1), "max", values=upd.reshape(-1))


def counting_increment_cm(
    counts: torch.Tensor, cfg: CountingConfig, hashes: torch.Tensor,
    valid: Optional[torch.Tensor] = None, salt: int = 0,
) -> torch.Tensor:
    """Count-min increment in place: +1 at all h cells of each occurrence,
    applied per cell as one batch total (``salt`` keys the mf8 rounding)."""
    if cfg.blocked:
        row, lanes = blocked_cells(cfg, hashes, valid)
        idx = row[..., None] * 128 + lanes
        return cell_insert(counts, idx.reshape(-1), "add")
    idx = bloom_indices(hashes, cfg.size_log2, _bcast_valid(valid, hashes))
    op = {"int32": "add", "u16": "add_u16", "mf8": "add_mf8"}[cfg.dtype]
    return cell_insert(counts, idx.reshape(-1), op, salt)


def counting_fpr(counts: torch.Tensor, cfg: CountingConfig) -> float:
    return _fpr(_count_nonzero(counts[: cfg.size]), cfg.size, cfg.num_hash)
