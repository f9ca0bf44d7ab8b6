"""Port's filter inserts (rnabloom_tpu_torch/bloom/filters.py over
ops/cell_insert.py, plain version on the CPU) vs the JAX package.

The reference is the JAX package's scatter path (merge=False), which the
port computes bit for bit, trash cell included.  A second case holds the
insert op itself against the Pallas kernel (histmerge.hist_update, in
interpret mode off the TPU) on the real cells.  The CUDA kernel is held
against the same plain version on the card in tests/test_torch_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.ops import histmerge
from rnabloom_tpu.ops.u64 import U64
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.ops import cell_insert as ci, minifloat

torch.set_num_threads(2)

SIZE_LOG2 = 18


def _hash_batch(rng, n=20_000, h=2):
    """(n, h) u64 hashes with heavy duplicates, and a validity mask."""
    vals = rng.integers(0, 2**64, size=(n, h), dtype=np.uint64)
    vals[:3000] = vals[0]  # one poly-A-like key, 3000 times
    vals[3000:3600] = vals[3000:3060].repeat(10, axis=0)
    rng.shuffle(vals)
    valid = rng.random(n) < 0.9
    return vals, valid


def _jax(vals, valid):
    lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
    return U64(lo, hi), jnp.asarray(valid)


def _torch(vals, valid):
    return torch.from_numpy(vals.view(np.int64)), torch.from_numpy(valid)


def _np(t: torch.Tensor, like: np.ndarray) -> np.ndarray:
    return t.numpy().view(like.dtype)


def test_bloom_add_matches_jax_scatter():
    rng = np.random.default_rng(0)
    cfg_j, cfg_t = jf.BloomConfig(SIZE_LOG2, 2), tf.BloomConfig(SIZE_LOG2, 2)
    bits_j, bits_t = jf.make_bloom(cfg_j), tf.make_bloom(cfg_t, device="cpu")
    for _ in range(3):
        vals, valid = _hash_batch(rng)
        bits_j = jf.bloom_add(bits_j, cfg_j, *_jax(vals, valid))
        tf.bloom_add(bits_t, cfg_t, *_torch(vals, valid))
        want = np.asarray(bits_j)
        np.testing.assert_array_equal(_np(bits_t, want), want)
    assert want[cfg_j.size] == 1  # invalid lanes wrote the trash cell
    q, _ = _hash_batch(rng, 4000)
    np.testing.assert_array_equal(
        tf.bloom_lookup(bits_t, cfg_t, torch.from_numpy(q.view(np.int64))).numpy(),
        np.asarray(jf.bloom_lookup(bits_j, cfg_j, _jax(q, q[:, 0] > 0)[0])),
    )


@pytest.mark.parametrize(
    "dtype,blocked", [("mf8", False), ("u16", False), ("int32", False), ("int32", True)]
)
def test_counting_increment_cm_matches_jax_scatter(dtype, blocked):
    rng = np.random.default_rng(1)
    cfg_j = jf.CountingConfig(SIZE_LOG2, 2, blocked=blocked, dtype=dtype)
    cfg_t = tf.CountingConfig(SIZE_LOG2, 2, blocked=blocked, dtype=dtype)
    cnt_j, cnt_t = jf.make_counting(cfg_j), tf.make_counting(cfg_t, device="cpu")
    for salt in (0, 1, 2):  # three successive salted batches
        vals, valid = _hash_batch(rng)
        hj, vj = _jax(vals, valid)
        cnt_j = jf.counting_increment_cm(cnt_j, cfg_j, hj, valid=vj, salt=salt)
        tf.counting_increment_cm(cnt_t, cfg_t, *_torch(vals, valid), salt=salt)
        want = np.asarray(cnt_j)
        np.testing.assert_array_equal(_np(cnt_t, want), want)
    assert want[cfg_j.size:].any()  # the trash cell(s) were written
    q, _ = _hash_batch(rng, 4000)
    np.testing.assert_array_equal(
        tf.counting_count(cnt_t, cfg_t, torch.from_numpy(q.view(np.int64))).numpy(),
        np.asarray(jf.counting_count(cnt_j, cfg_j, _jax(q, q[:, 0] > 0)[0])),
    )


def test_u16_saturates_like_jax():
    cfg_j, cfg_t = jf.CountingConfig(12, 1, dtype="u16"), tf.CountingConfig(12, 1, dtype="u16")
    vals = np.full((70_000, 1), 12345 << 1, np.uint64)  # one cell, 70k times
    valid = np.ones(70_000, bool)
    cnt_j = jf.counting_increment_cm(jf.make_counting(cfg_j), cfg_j, *_jax(vals, valid))
    cnt_t = tf.counting_increment_cm(tf.make_counting(cfg_t, device="cpu"), cfg_t, *_torch(vals, valid))
    want = np.asarray(cnt_j)
    assert want.max() == 65535
    np.testing.assert_array_equal(_np(cnt_t, want), want)


# mf8 is left out here: the Pallas merge path applies a second stochastic
# increment to heavy-duplicate rows and differs from the scatter semantics
# by one code on some cells (ROADMAP, "Faults", fault 1); the port follows
# the scatter semantics, tested above
@pytest.mark.parametrize("op", ["set", "add", "add_u16"])
def test_insert_op_matches_pallas_hist_update(op):
    rng = np.random.default_rng(2)
    size = 1 << SIZE_LOG2
    idx = np.concatenate([
        rng.integers(0, size, 30_000),
        np.full(5_000, 777),  # heavy cell: uniform rows in the sweep
        np.full(500, size),  # trash index: dropped by the sweep
    ]).astype(np.uint32)
    rng.shuffle(idx)
    jdtype = {"set": jnp.uint8, "add": jnp.int32, "add_u16": jnp.uint16}[op]
    pad = histmerge.table_pad(SIZE_LOG2)
    want = np.asarray(
        histmerge.hist_update(jnp.zeros(size + pad, jdtype), SIZE_LOG2, jnp.asarray(idx), op)
    )[:size]
    table = torch.zeros(size + 1, dtype=ci.OPS[op])
    ci.cell_insert(table, torch.from_numpy(idx.astype(np.int64)), op)
    np.testing.assert_array_equal(_np(table, want)[:size], want)


def test_cpu_wrapper_takes_plain_path_and_checks_arguments():
    table = torch.zeros(1025, dtype=torch.uint8)
    idx = torch.tensor([0, 5, 5, 1024, 4000])
    before = ci.launch_counts()
    ci.cell_insert(table, idx, "add_mf8", salt=3)
    assert ci.launch_counts() == before  # no kernel on the CPU
    assert table[[0, 5, 1024]].tolist() == [1, 2, 1] and int(table.sum()) == 4
    with pytest.raises(TypeError):
        ci.cell_insert(table, idx, "add")  # int32 op on a uint8 table
    with pytest.raises(ValueError):
        ci.cell_insert(table, idx, "min")  # no such op
    with pytest.raises(TypeError):
        ci.cell_insert(table, idx, "max")  # max takes a value per index
    with pytest.raises(TypeError):
        ci.cell_insert(table, idx.to(torch.int32), "set")


# --- add_u16 in tiles: the invariant the one-pass CUDA kernel stands on ------
#
# The kernel totals each tile of T indices per cell and applies the tile
# totals with a saturating add, tiles in any order.  For increments >= 0,
# min(min(v + a, 65535) + b, 65535) == min(v + a + b, 65535), so that must
# give the table of one saturating add of the whole batch's histogram.

U16_SIZE_LOG2 = 12
U16_NUMEL = (1 << U16_SIZE_LOG2) + 1  # odd, as every table: 2^s cells + trash
U16_N = 10_007  # a multiple of no tile size below except 1


def _u16_case(case, tile, rng):
    """(table uint16 (U16_NUMEL,), idx int64) for one case."""
    table = rng.integers(0, 65536, U16_NUMEL).astype(np.uint16)
    idx = rng.integers(0, U16_NUMEL, U16_N)
    if case == "prefilled_near_cap":
        table[:60] = 65530 + np.arange(60) % 6  # 65530 .. 65535
        idx[: 60 * 8] = np.arange(60).repeat(8)
    elif case == "one_cell_every_tile":
        table[777] = 65_530
        idx[::tile] = 777  # the cell in every tile (all of them at T = 1)
    elif case == "adjacent_hot":
        table[200:202] = 63_000
        idx[:6000] = np.tile([200, 201], 3000)  # cells 2j and 2j+1
    elif case == "trash_cell":
        table[-1] = 65_000
        idx[:2000] = U16_NUMEL - 1
    elif case == "dropped_and_negative":
        junk = np.array([U16_NUMEL, U16_NUMEL + 1, 1 << 20, 1 << 40, -1, -5, -(1 << 40)])
        idx[:3500] = junk.repeat(500)
    elif case == "empty":
        idx = idx[:0]
    rng.shuffle(idx)
    return table, idx


def _u16_in_tiles(table, idx, tile, rng):
    """Numpy emulation of the kernel's schedule: tile totals, applied with
    the saturating add in a shuffled tile order."""
    out = table.astype(np.int64)
    starts = np.arange(0, len(idx), tile)
    for s in rng.permutation(starts):
        part = idx[s : s + tile]
        cells, n = np.unique(part[(part >= 0) & (part < len(table))], return_counts=True)
        out[cells] = np.minimum(out[cells] + n, 65535)
    return out.astype(np.uint16)


@pytest.mark.parametrize("tile", [1, 1000, 4096])
@pytest.mark.parametrize(
    "case",
    ["prefilled_near_cap", "one_cell_every_tile", "adjacent_hot", "trash_cell",
     "dropped_and_negative", "empty"],
)
def test_u16_tile_totals_match_jax_and_plain(case, tile):
    rng = np.random.default_rng(3)
    table, idx = _u16_case(case, tile, rng)
    got = _u16_in_tiles(table, idx, tile, rng)

    kept = idx[(idx >= 0) & (idx < U16_NUMEL)]
    hist = np.bincount(kept, minlength=U16_NUMEL).astype(np.int32)
    want = np.asarray(jf.apply_cell_increments(jnp.asarray(table), jnp.asarray(hist), "u16"))
    np.testing.assert_array_equal(got, want)

    plain = ci.cell_insert_plain(torch.from_numpy(table.view(np.int16).copy()), torch.from_numpy(idx), "add_u16")
    np.testing.assert_array_equal(_np(plain, want), want)
    assert (want != table).any() == (case != "empty")


# --- add in tiles: the schedule of the CUDA kernel ----
#
# The int32 add totals each warp's 32 indices per cell (__match_any_sync)
# and adds the totals, warps in any order; any other split of the batch
# (T = 1000, 4096) must give the same table.  That must be JAX's scatter add.


def _add_case(case, tile, rng):
    """(table int32 (U16_NUMEL,), idx int64) for one case."""
    table = rng.integers(-(1 << 20), 1 << 20, U16_NUMEL).astype(np.int32)
    idx = rng.integers(0, U16_NUMEL, U16_N)
    if case == "one_cell_every_tile":
        idx[::tile] = 777  # the cell in every tile (all of them at T = 1)
    elif case == "hot_cell":
        idx[:5000] = 4242  # half the batch on one cell
    elif case == "trash_cell":
        idx[:2000] = U16_NUMEL - 1
    elif case == "dropped_and_negative":
        junk = np.array([U16_NUMEL, U16_NUMEL + 1, 1 << 20, 1 << 40, -1, -5, -(1 << 40)])
        idx[:3500] = junk.repeat(500)
    elif case == "empty":
        idx = idx[:0]
    elif case == "one_index":
        idx = idx[:1]
    rng.shuffle(idx)
    return table, idx


def _add_in_tiles(table, idx, tile, rng):
    """Numpy emulation of the kernel's schedule: tile totals, added in a
    shuffled tile order."""
    out = table.astype(np.int64)
    for start in rng.permutation(np.arange(0, len(idx), tile)):
        part = idx[start : start + tile]
        cells, n = np.unique(part[(part >= 0) & (part < len(table))], return_counts=True)
        out[cells] += n
    return out.astype(np.int32)


@pytest.mark.parametrize("tile", [32, 1000, 4096])
@pytest.mark.parametrize(
    "case", ["one_cell_every_tile", "hot_cell", "trash_cell", "dropped_and_negative", "empty", "one_index"]
)
def test_add_tile_totals_match_jax_and_plain(case, tile):
    rng = np.random.default_rng(9)
    table, idx = _add_case(case, tile, rng)
    got = _add_in_tiles(table, idx, tile, rng)

    kept = idx[(idx >= 0) & (idx < U16_NUMEL)]
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(kept)].add(1, mode="drop"))
    np.testing.assert_array_equal(got, want)
    hist = np.bincount(kept, minlength=U16_NUMEL).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jf.apply_cell_increments(jnp.asarray(table), jnp.asarray(hist), "int32")),
                                  want)
    plain = ci.cell_insert_plain(torch.from_numpy(table.copy()), torch.from_numpy(idx), "add")
    np.testing.assert_array_equal(plain.numpy(), want)
    assert (want != table).any() == (case != "empty")


# --- add_mf8 in tiles and a batch table: the schedule of the CUDA kernel ----
#
# Pass 1 totals each tile of T indices per cell and adds the tile totals,
# tiles in any order, into a linear-probing batch table of batch_slots(n)
# slots.  Pass 2 applies one increment_codes per occupied slot, with the
# slot's whole total, and frees the slot.  That must give the table of one
# increment per cell of the batch histogram, and leave the batch table free.

MF8_SALTS = [0, 1, 977, (1 << 31) + 7]
M32 = 0xFFFFFFFF


def _batch_slot(key, mask):
    """The kernel's first slot of a key (murmur3's 32-bit finaliser)."""
    x = int(key)
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return x & mask


def _mf8_case(case, tile, rng):
    """(table uint8 (U16_NUMEL,), idx int64) for one case."""
    table = rng.integers(0, 128, U16_NUMEL).astype(np.uint8)
    idx = rng.integers(0, U16_NUMEL, U16_N)
    if case == "near_saturation":
        table[:48] = 120 + np.arange(48) % 8  # codes 120 .. 127
        idx[: 48 * 40] = np.arange(48).repeat(40)
    elif case == "one_cell_every_tile":
        table[777] = 0
        idx[::tile] = 777  # the cell in every tile (all of them at T = 1)
    elif case == "trash_cell":
        table[-1] = 90
        idx[:2000] = U16_NUMEL - 1
    elif case == "dropped_and_negative":
        junk = np.array([U16_NUMEL, U16_NUMEL + 1, 1 << 20, 1 << 40, -1, -5, -(1 << 40)])
        idx[:3500] = junk.repeat(500)
    elif case == "empty":
        idx = idx[:0]
    elif case == "one_index":
        idx = idx[:1]
    rng.shuffle(idx)
    return table, idx


def _mf8_in_tiles(table, idx, tile, salt, rng):
    """Numpy emulation of the kernel's schedule: tile totals into the batch
    table in a shuffled tile order, then one increment per occupied slot."""
    slots = ci.batch_slots(len(idx))
    keys, counts = np.full(slots, -1, np.int64), np.zeros(slots, np.int64)
    for start in rng.permutation(np.arange(0, len(idx), tile)):
        part = idx[start : start + tile]
        for cell, n in zip(*np.unique(part[(part >= 0) & (part < len(table))], return_counts=True)):
            s = _batch_slot(cell, slots - 1)
            while keys[s] not in (-1, cell):  # another cell's slot: probe on
                s = (s + 1) & (slots - 1)
            keys[s] = cell
            counts[s] += n
    full = np.flatnonzero(keys != -1)
    assert len(full) <= slots // 2
    out = table.copy()
    cells = torch.from_numpy(keys[full])
    out[keys[full]] = minifloat.increment_codes(
        torch.from_numpy(table[keys[full]]), torch.from_numpy(counts[full]), minifloat.mix_u01(cells, salt)
    ).numpy()
    keys[full], counts[full] = -1, 0  # pass 2 frees every slot it applied
    assert (keys == -1).all() and not counts.any()
    return out


@pytest.mark.parametrize("salt", MF8_SALTS)
@pytest.mark.parametrize("tile", [1, 1000, 4096])
@pytest.mark.parametrize(
    "case",
    ["near_saturation", "one_cell_every_tile", "trash_cell", "dropped_and_negative", "empty", "one_index"],
)
def test_mf8_batch_table_matches_jax_and_plain(case, tile, salt):
    rng = np.random.default_rng(5)
    table, idx = _mf8_case(case, tile, rng)
    got = _mf8_in_tiles(table, idx, tile, salt, rng)

    kept = idx[(idx >= 0) & (idx < U16_NUMEL)]
    hist = np.bincount(kept, minlength=U16_NUMEL).astype(np.int32)
    want = np.asarray(jf.apply_cell_increments(jnp.asarray(table), jnp.asarray(hist), "mf8", salt=salt))
    np.testing.assert_array_equal(got, want)

    plain = ci.cell_insert_plain(torch.from_numpy(table.copy()), torch.from_numpy(idx), "add_mf8", salt)
    np.testing.assert_array_equal(plain.numpy(), want)
    if case not in ("empty", "one_index"):
        assert (want != table).any()
    if case == "near_saturation":
        assert (want[:48][table[:48] == 127] == 127).all()


@pytest.mark.parametrize("n,slots", [(1, 2), (2, 4), (3, 8), (1 << 20, 1 << 21), (1_032_192, 1 << 21),
                                     ((1 << 20) + 1, 1 << 22)])
def test_batch_slots_are_the_least_power_of_two_of_twice_the_batch(n, slots):
    assert ci.batch_slots(n) == slots


def test_scratch_is_freed_before_a_larger_one_is_allocated(monkeypatch):
    """add_mf8's batch table grows with the batch length, not the table;
    the smaller one must be gone before the larger is allocated, or a
    growth holds both at once; a smaller batch reuses the larger."""
    import weakref

    cpu = torch.device("cpu")
    ci._batch_tables.pop(cpu, None)
    old = weakref.ref(ci._batch_table_for(cpu, 10))
    assert old().numel() == 32 and bool((old() == ci.FREE_SLOT).all())
    empty = torch.empty

    def empty_checked(*args, **kwargs):
        assert old() is None, "the smaller batch table is still alive"
        return empty(*args, **kwargs)

    monkeypatch.setattr(ci.torch, "empty", empty_checked)
    try:
        big = ci._batch_table_for(cpu, 100)
        assert big.numel() == 256 and ci._batch_tables[cpu] is big and bool((big == ci.FREE_SLOT).all())
        assert ci._batch_table_for(cpu, 10) is big  # a smaller batch reuses it
        assert ci.batch_table_bytes() == 256 * 8
    finally:
        ci._batch_tables.pop(cpu, None)


def test_fpr_popcount_in_slices_counts_every_cell():
    cells = torch.zeros((1 << 24) + 7, dtype=torch.uint8)  # two slices
    cells[[0, (1 << 24) - 1, 1 << 24, -1]] = 1
    assert tf._count_nonzero(cells) == 4 == int(torch.count_nonzero(cells))
