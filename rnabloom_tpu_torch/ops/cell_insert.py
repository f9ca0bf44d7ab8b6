"""Filter-table inserts: a batch of cell indices applied to a table.

Port of ``rnabloom_tpu/ops/histmerge.py`` (the Pallas ``_sweep_kernel``,
launched by ``_sweep2`` and wrapped by ``hist_update``), computing the
SCATTER semantics of ``filters.bloom_add`` / ``counting_increment_cm``:

  set      uint8 lanes        table[i] = 1
  add      int32 counters     table[i] += occurrences of i
  add_u16  int16 tables holding uint16 bit patterns
                              table[i] = min(table[i] + n_i, 65535)
  add_mf8  uint8 MiniFloat    table[i] = increment_codes(table[i], n_i,
                                            mix_u01(base + i, salt))   (n_i > 0)
  max      int32, int16 (uint16 bit patterns, compared unsigned) or
           uint8 (MiniFloat codes) tables, with a value per index
                              table[i] = max(table[i], values of i)

where n_i is the number of occurrences of cell i in the batch, and
``base`` (uint32, 0 for a whole table) is the table's first cell in the
whole filter when the table is one shard of a filter sharded by index
range: the rounding is then keyed as on the whole filter.  ``max`` is
the scatter-max of the conservative update
(``filters.counting_increment``; XLA's ``.at[].max`` in the JAX package).  Indices
>= numel are dropped; every other index, the trash cell included, is
applied.  Tables are updated in place.

``conservative_update`` is the rest of the conservative update after its
scratch sketch (the batch's ``add``): per key of h hashes, the min of its
scratch cells less ``dec_first`` (clamped at 0) added to the min of its
cells, decoded, then encoded and raised into its h cells by ``max``, every
key reading the pre-batch cells; ``conservative_update_plain`` is that
composition in plain PyTorch.  On the card it is two launches:
``conservative_words`` (a key's value and the lanes below it, from the
pre-batch cells) and ``conservative_raise`` (the ``max`` kernel over those
lanes).

``cell_insert`` and ``conservative_update`` launch the hand-written CUDA
kernels (``csrc/cell_insert.cu``, which states their design) for a CUDA
table, and run the plain versions for a CPU table.  ``LAUNCHES`` counts
kernel launches per op (``conservative`` and ``conservative_raise`` the
update's two launches), ``INDICES`` the indices (for the update's launches
the key lanes) those launches were given; ``launch_timer.recording()``
times the launches on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import launch_timer

OPS = {"set": torch.uint8, "add": torch.int32, "add_u16": torch.int16, "add_mf8": torch.uint8, "max": None}
MAX_DTYPES = (torch.int32, torch.int16, torch.uint8)  # the max op's tables

CELL_DTYPES = {torch.int32: "int32", torch.int16: "u16", torch.uint8: "mf8"}  # the counters' names by cell dtype

CONSERVATIVE_OPS = ("conservative", "conservative_raise")  # the conservative update's launches
LAUNCHES: Dict[str, int] = {op: 0 for op in (*OPS, *CONSERVATIVE_OPS)}
INDICES: Dict[str, int] = {op: 0 for op in (*OPS, *CONSERVATIVE_OPS)}

# add_mf8's batch table, one per device: int64 slots, each a uint32 cell key
# (high word) and that cell's int32 batch total (low word), FREE_SLOT when
# free.  A launch uses the first batch_slots(n) slots and leaves them free.
_batch_tables: Dict[torch.device, torch.Tensor] = {}
FREE_SLOT = -(1 << 32)  # 0xFFFFFFFF_00000000 as int64: key 0xFFFFFFFF, count 0


def reset_launch_counts() -> None:
    for op in LAUNCHES:
        LAUNCHES[op] = 0
        INDICES[op] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def index_counts() -> Dict[str, int]:
    return dict(INDICES)


def _check(table: torch.Tensor, idx: torch.Tensor, op: str, values: Optional[torch.Tensor] = None) -> None:
    if op not in OPS:
        raise ValueError(f"unknown insert op {op!r}; expected one of {sorted(OPS)}")
    if op == "max":
        if table.dtype not in MAX_DTYPES:
            raise TypeError(f"max needs an int32, int16 or uint8 table, got {table.dtype}")
        if values is None or values.dtype != table.dtype or values.shape != idx.shape:
            raise TypeError(f"max needs {table.dtype} values shaped as idx {tuple(idx.shape)}")
        if values.device != table.device:
            raise ValueError(f"values on {values.device}, table on {table.device}")
    elif values is not None:
        raise TypeError(f"{op} takes no values")
    elif table.dtype != OPS[op]:
        raise TypeError(f"{op} needs a {OPS[op]} table, got {table.dtype}")
    if table.dim() != 1 or not table.is_contiguous():
        raise ValueError("table must be a contiguous 1-D tensor")
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise TypeError(f"idx must be a 1-D int64 tensor, got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")


def _check_words(table: torch.Tensor, what: str) -> None:
    """uint16 and uint8 cells are raised by a CAS on their aligned 32-bit
    word, which for the last cells reaches up to 3 bytes past the tensor:
    inside its storage's block, which the caching allocator rounds to 512 B."""
    if table.dtype != torch.int32 and table.storage_offset() != 0:
        raise ValueError(f"{what} on a {table.dtype} table: the table must start its storage")


def cell_insert_plain(
    table: torch.Tensor, idx: torch.Tensor, op: str, salt: int = 0, values: Optional[torch.Tensor] = None,
    base: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the insert kernel (any device)."""
    _check(table, idx, op, values)
    keep = (idx >= 0) & (idx < table.numel())
    sel = idx[keep]
    if op == "max":
        vals = values[keep]
        if table.dtype == torch.int16:  # uint16 bit patterns: compare unsigned
            cells, inv = torch.unique(sel, return_inverse=True)
            cur = table[cells].to(torch.int32) & 0xFFFF
            cur.scatter_reduce_(0, inv, vals.to(torch.int32) & 0xFFFF, "amax")
            table[cells] = torch.where(cur >= 32768, cur - 65536, cur).to(torch.int16)
        else:
            table.scatter_reduce_(0, sel, vals, "amax")
    elif op == "set":
        table[sel] = 1
    elif op == "add":
        table.index_add_(0, sel, torch.ones_like(sel, dtype=torch.int32))
    else:
        # the batch total per touched cell, applied once in the encoding
        from ..bloom.filters import apply_cell_increments

        cells, n = torch.unique(sel, return_counts=True)
        table[cells] = apply_cell_increments(
            table[cells], n.to(torch.int32), "u16" if op == "add_u16" else "mf8",
            salt=salt, cell_index=cells + base,
        )
    return table


def batch_slots(n: int) -> int:
    """Slots of add_mf8's batch table for a batch of ``n`` indices: the
    least power of two >= 2n, so that at most half hold a cell."""
    return 1 << max(2 * n - 1, 1).bit_length()


def batch_table_bytes() -> int:
    """Bytes held by add_mf8's batch tables, all devices."""
    return sum(t.numel() * t.element_size() for t in _batch_tables.values())


def _batch_table_for(device: torch.device, n: int) -> torch.Tensor:
    t = _batch_tables.get(device)
    if t is not None and t.numel() >= batch_slots(n):
        return t
    # drop both references to a smaller table before allocating, so the
    # two are never held at once
    del t
    _batch_tables.pop(device, None)
    t = _batch_tables[device] = torch.empty(batch_slots(n), dtype=torch.int64, device=device)
    t.fill_(FREE_SLOT)
    return t


def cell_insert(
    table: torch.Tensor, idx: torch.Tensor, op: str, salt: int = 0, values: Optional[torch.Tensor] = None,
    base: int = 0,
) -> torch.Tensor:
    """Apply ``idx`` (and, for ``max``, ``values``) to ``table`` in place
    (see the module docstring).

    A CPU table takes the plain version; a CUDA table launches the kernel
    on the table's device's current stream, or raises."""
    if not 0 <= base < 1 << 32:
        raise ValueError(f"base {base} is not a uint32")
    if table.device.type == "cpu":
        return cell_insert_plain(table, idx, op, salt, values, base)
    if table.device.type != "cuda":
        raise ValueError(f"cell_insert: unsupported device {table.device}")
    _check(table, idx, op, values)
    idx = idx.contiguous()
    from ._build import kernels

    lib = kernels()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    numel, n = table.numel(), idx.numel()
    if op in ("add_u16", "add_mf8", "max") and numel >= 1 << 32:
        raise ValueError(f"{op} keys cells as uint32; a table of {numel} cells is too long")
    if op == "add_mf8":
        if n >= 1 << 31:
            raise ValueError(f"add_mf8 totals a cell in int32; a batch of {n} indices is too long")
        batch = _batch_table_for(table.device, n)
    if op == "max":
        _check_words(table, "max")
        values = values.contiguous()
        entry = {torch.int32: lib.cell_max_i32, torch.int16: lib.cell_max_u16, torch.uint8: lib.cell_max_u8}
    # the launch goes to the table's device, whichever device is current
    with torch.cuda.device(table.device):
        start = launch_timer.begin(table.device)
        if op == "max":
            err = entry[table.dtype](table.data_ptr(), numel, idx.data_ptr(), values.data_ptr(), n, stream)
        elif op == "set":
            err = lib.cell_set_u8(table.data_ptr(), numel, idx.data_ptr(), n, stream)
        elif op == "add":
            err = lib.cell_add_i32(table.data_ptr(), numel, idx.data_ptr(), n, stream)
        elif op == "add_u16":
            err = lib.cell_add_u16(table.data_ptr(), numel, idx.data_ptr(), n, stream)
        else:
            err = lib.cell_add_mf8_batch(
                table.data_ptr(), batch.data_ptr(), batch_slots(n), numel, idx.data_ptr(), n,
                int(salt) & 0xFFFFFFFF, base, stream,
            )
        launch_timer.end(start, table.device, op, n)
    if err != 0:
        raise RuntimeError(f"cell_insert[{op}] launch failed: cudaError_t {err}")
    LAUNCHES[op] += 1
    INDICES[op] += n
    return table


def _check_keys(counts, hashes, size_log2, valid, dec_first) -> None:
    if counts.dtype not in CELL_DTYPES:
        raise TypeError(f"the conservative update needs an int32, int16 or uint8 table, got {counts.dtype}")
    if not 0 <= size_log2 <= 32:
        raise ValueError("cell indices are 32-bit")
    if counts.dim() != 1 or not counts.is_contiguous() or counts.numel() <= 1 << size_log2:
        raise ValueError(f"counts must be a contiguous 1-D table of more than 2^{size_log2} cells")
    if hashes.dtype != torch.int64 or hashes.dim() < 1 or not 1 <= hashes.shape[-1] <= 32:
        raise TypeError(f"hashes must be int64 (..., h) with 1 <= h <= 32, got {hashes.dtype} {tuple(hashes.shape)}")
    keys = hashes.shape[:-1]
    if valid is not None and (valid.dtype != torch.bool or valid.shape not in (hashes.shape, keys)):
        raise TypeError(f"valid must be bool shaped {tuple(keys)} or {tuple(hashes.shape)}")
    if dec_first is not None and (dec_first.dtype != torch.bool or dec_first.shape != keys):
        raise TypeError(f"dec_first must be bool shaped {tuple(keys)}")
    for t in (hashes, valid, dec_first):
        if t is not None and t.device != counts.device:
            raise ValueError(f"an argument on {t.device}, counts on {counts.device}")


def _check_conservative(counts, scratch, hashes, size_log2, scratch_log2, valid, dec_first) -> None:
    _check_keys(counts, hashes, size_log2, valid, dec_first)
    if not 0 <= scratch_log2 <= 32:
        raise ValueError("cell indices are 32-bit")
    if scratch.dtype != torch.int32 or scratch.dim() != 1 or not scratch.is_contiguous() \
            or scratch.numel() <= 1 << scratch_log2:
        raise ValueError(f"scratch must be a contiguous 1-D int32 table of more than 2^{scratch_log2} cells")
    if scratch.device != counts.device:
        raise ValueError(f"scratch on {scratch.device}, counts on {counts.device}")


def conservative_values(
    counts: torch.Tensor, scratch: torch.Tensor, hashes: torch.Tensor, size_log2: int, scratch_log2: int,
    valid: Optional[torch.Tensor] = None, dec_first: Optional[torch.Tensor] = None, salt: int = 0,
):
    """The conservative update's (cell indices, encoded values), flat, as
    its ``max`` insert takes them: plain PyTorch on the tables' device."""
    from ..bloom.filters import _bcast_valid, bloom_indices, decode_counts, encode_counts
    from . import minifloat

    dtype = CELL_DTYPES[counts.dtype]
    valid = _bcast_valid(valid, hashes)
    idx = bloom_indices(hashes, size_log2, valid)
    mult = torch.amin(scratch[bloom_indices(hashes, scratch_log2, valid)], dim=-1)
    if dec_first is not None:
        mult = mult - dec_first.to(torch.int32)
    # decoding is monotonic in the cell code: min-then-decode (the JAX
    # package's order) equals decode-then-min, which reads u16 unsigned
    cur_min = torch.amin(decode_counts(counts[idx], dtype), dim=-1)
    new_val = cur_min + torch.clamp(mult, min=0).to(cur_min.dtype)
    if valid is not None:
        new_val = torch.where(valid[..., 0], new_val, torch.zeros_like(new_val))
    u01 = minifloat.mix_u01(hashes[..., 0], salt) if dtype == "mf8" else None
    upd = encode_counts(new_val, dtype, u01)[..., None].expand(idx.shape)
    return idx.reshape(-1), upd.reshape(-1)


def conservative_update_plain(
    counts: torch.Tensor, scratch: torch.Tensor, hashes: torch.Tensor, size_log2: int, scratch_log2: int,
    valid: Optional[torch.Tensor] = None, dec_first: Optional[torch.Tensor] = None, salt: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the conservative-update kernel (any device)."""
    _check_conservative(counts, scratch, hashes, size_log2, scratch_log2, valid, dec_first)
    idx, upd = conservative_values(counts, scratch, hashes, size_log2, scratch_log2, valid, dec_first, salt)
    return cell_insert_plain(counts, idx, "max", values=upd)


def _card_keys(counts, hashes, valid, dec_first):
    """The keys of the update's launches on the card, after the argument
    checks: (n, h, valid lanes a key, hashes (n, h), valid and dec_first
    flat or None)."""
    if counts.device.type != "cuda":
        raise ValueError(f"the conservative update's kernels need a CUDA table, got {counts.device}")
    _check_words(counts, "the conservative update")
    if counts.numel() >= 1 << 32:
        raise ValueError(f"the conservative update keys cells as uint32; a table of {counts.numel()} cells is too long")
    h = hashes.shape[-1]
    n = hashes.numel() // h
    if n * h >= 1 << 32:
        raise ValueError(f"a batch of {n} keys of {h} hashes is too long")
    lanes = h if valid is not None and valid.shape == hashes.shape else 1  # valid a lane, or a key
    return (n, h, lanes, hashes.reshape(n, h).contiguous(), None if valid is None else valid.reshape(-1).contiguous(),
            None if dec_first is None else dec_first.reshape(-1).contiguous())


def _launch(op: str, device: torch.device, count: int, call) -> None:
    """Run ``call(stream)`` (a C entry point) on ``device``'s current
    stream; count the launch and its ``count`` indices, or raise."""
    with torch.cuda.device(device):
        start = launch_timer.begin(device)
        err = call(torch.cuda.current_stream(device).cuda_stream)
        launch_timer.end(start, device, op, count)
    if err != 0:
        raise RuntimeError(f"cell_insert[{op}] launch failed: cudaError_t {err}")
    LAUNCHES[op] += 1
    INDICES[op] += count


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def conservative_words(
    counts: torch.Tensor, scratch: torch.Tensor, hashes: torch.Tensor, size_log2: int, scratch_log2: int,
    valid: Optional[torch.Tensor] = None, dec_first: Optional[torch.Tensor] = None, salt: int = 0,
) -> torch.Tensor:
    """The update's first launch on the card (arguments as
    ``conservative_update``'s; ``counts`` is only read): int64, a word a
    key, its encoded value (low 32 bits) and the lanes whose cell is below
    it (bit 32 + j)."""
    _check_conservative(counts, scratch, hashes, size_log2, scratch_log2, valid, dec_first)
    n, h, lanes, hashes, valid, dec_first = _card_keys(counts, hashes, valid, dec_first)
    words = torch.empty(n, dtype=torch.int64, device=counts.device)
    from ._build import kernels

    lib = kernels()
    entry = {torch.int32: lib.cell_conservative_values_i32, torch.int16: lib.cell_conservative_values_u16,
             torch.uint8: lib.cell_conservative_values_u8}[counts.dtype]
    _launch("conservative", counts.device, n * h, lambda stream: entry(
        counts.data_ptr(), size_log2, scratch.data_ptr(), scratch_log2, hashes.data_ptr(), n, h, _ptr(valid), lanes,
        _ptr(dec_first), int(salt) & 0xFFFFFFFF, words.data_ptr(), stream))
    return words


def conservative_raise(
    counts: torch.Tensor, words: torch.Tensor, hashes: torch.Tensor, size_log2: int,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The update's second launch on the card: each lane of ``words``'
    masks raised to its key's value (the ``max`` kernel), in place."""
    _check_keys(counts, hashes, size_log2, valid, None)
    n, h, lanes, hashes, valid, _ = _card_keys(counts, hashes, valid, None)
    if words.dtype != torch.int64 or words.shape != (n,) or not words.is_contiguous() or words.device != counts.device:
        raise TypeError(f"words must be int64 ({n},) on {counts.device}")
    from ._build import kernels

    lib = kernels()
    entry = {torch.int32: lib.cell_conservative_raise_i32, torch.int16: lib.cell_conservative_raise_u16,
             torch.uint8: lib.cell_conservative_raise_u8}[counts.dtype]
    _launch("conservative_raise", counts.device, n * h, lambda stream: entry(
        counts.data_ptr(), counts.numel(), size_log2, hashes.data_ptr(), n, h, _ptr(valid), lanes,
        words.data_ptr(), stream))
    return counts


def conservative_update(
    counts: torch.Tensor, scratch: torch.Tensor, hashes: torch.Tensor, size_log2: int, scratch_log2: int,
    valid: Optional[torch.Tensor] = None, dec_first: Optional[torch.Tensor] = None, salt: int = 0,
) -> torch.Tensor:
    """Raise ``counts`` (2^size_log2 cells and a trash cell; int32, int16
    holding uint16, or uint8 MiniFloat) in place by the conservative update
    of the keys ``hashes`` (int64, (..., h)) after their ``add`` into
    ``scratch`` (int32, 2^scratch_log2 + 1 cells).  ``valid`` (bool, keys'
    or hashes' shape) sends invalid lanes to the trash cells and gives an
    invalid key the value 0; ``dec_first`` (bool, keys' shape) takes 1 off
    a key's multiplicity; mf8 rounds stochastically keyed by hash 0's low
    32 bits and ``salt``.

    A CPU table takes the plain version; a CUDA table launches the two
    kernels on the table's device's current stream, or raises."""
    if counts.device.type == "cpu":
        return conservative_update_plain(counts, scratch, hashes, size_log2, scratch_log2, valid, dec_first, salt)
    if counts.device.type != "cuda":
        raise ValueError(f"conservative_update: unsupported device {counts.device}")
    words = conservative_words(counts, scratch, hashes, size_log2, scratch_log2, valid, dec_first, salt)
    return conservative_raise(counts, words, hashes, size_log2, valid)
