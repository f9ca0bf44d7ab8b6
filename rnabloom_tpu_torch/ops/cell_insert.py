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

``cell_insert`` launches the hand-written CUDA kernel
(``csrc/cell_insert.cu``, which states its design) for a CUDA table, and
runs ``cell_insert_plain`` for a CPU table.  ``LAUNCHES`` counts kernel
launches per op, ``INDICES`` the indices those launches were given;
``launch_timer.recording()`` times the launches on the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import launch_timer

OPS = {"set": torch.uint8, "add": torch.int32, "add_u16": torch.int16, "add_mf8": torch.uint8, "max": None}
MAX_DTYPES = (torch.int32, torch.int16, torch.uint8)  # the max op's tables

LAUNCHES: Dict[str, int] = {op: 0 for op in OPS}
INDICES: Dict[str, int] = {op: 0 for op in OPS}

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
    if op in ("add_u16", "add_mf8") and numel >= 1 << 32:
        raise ValueError(f"{op} keys cells as uint32; a table of {numel} cells is too long")
    if op == "add_mf8":
        if n >= 1 << 31:
            raise ValueError(f"add_mf8 totals a cell in int32; a batch of {n} indices is too long")
        batch = _batch_table_for(table.device, n)
    if op == "max":
        # a uint8 cell is raised by a CAS on its aligned 32-bit word, which
        # for the last cells reaches up to 3 bytes past the tensor: inside
        # its storage's block, which the caching allocator rounds to 512 B
        if table.dtype == torch.uint8 and table.storage_offset() != 0:
            raise ValueError("max on a uint8 table: the table must start its storage")
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
