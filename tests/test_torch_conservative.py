"""The conservative update of exact counts and the ``max`` insert's
schedule, on the CPU.

1. The conservative update's plain version
   (``ops.cell_insert.conservative_update_plain``, which
   ``filters.counting_increment`` runs on a CPU table after the batch's
   scratch sketch) against the JAX package's ``filters.counting_increment``
   (merge=False) for int32, u16 and mf8 counters: prefilled tables (u16
   cells above 32,767, mf8 codes up to 127), ``valid``, ``dec_first``,
   several salts, and a 2^10-cell table where keys collide heavily.
2. A numpy model of the CUDA ``max``'s schedule
   (``csrc/cell_insert.cu``, ``max_kernel``: warps of 32 consecutive pairs
   in any order, pairs keyed by their 32-bit word, a warp's peers reduced
   per cell of the word, one read and at most one raise a word, the uint16
   and uint8 words written whole) against the plain max:
   a hot cell, the trash cell, dropped indices, the four byte cells of one
   word, the last cells of a table (whose word reaches past it).
3. A numpy model of the conservative kernel's two launches (a key's value
   and the mask of its lanes below it, from the pre-batch cells, in the
   float32 arithmetic of the mf8 encoding; then the masked lanes' raise
   through the model of 2) against the plain version.

The card holds the kernels to the same plain versions in
``tests/test_torch_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.ops.u64 import U64
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.ops import cell_insert as ci
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

DTYPES = ["int32", "u16", "mf8"]
NP_DTYPES = {"int32": np.int32, "u16": np.uint16, "mf8": np.uint8}
LANES = {"int32": 1, "u16": 2, "mf8": 4}  # cells a 32-bit word holds
SALTS = (0, 977, 2**31 + 7)


def _torch(a: np.ndarray) -> torch.Tensor:
    """A copy as a torch tensor (uint16 cells as int16 bit patterns)."""
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a.copy()).clone()


def _jax_hashes(vals: np.ndarray) -> U64:
    return U64(jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
               jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)))


def _prefilled(dtype: str, numel: int, rng) -> np.ndarray:
    hi = {"int32": 1 << 20, "u16": 1 << 16, "mf8": 128}[dtype]
    table = rng.integers(0, hi, numel).astype(NP_DTYPES[dtype])
    table[rng.random(numel) < 0.5] = 0
    return table


def _keys(rng, n: int, h: int):
    """(n, h) uint64 hashes with heavy duplicates (a key 2,000 times, 60
    keys 10 times), a validity mask and a dec_first mask."""
    vals = rng.integers(0, 2**64, size=(n, h), dtype=np.uint64)
    vals[:2000] = vals[0]
    vals[2000:2600] = vals[2000:2060].repeat(10, axis=0)
    rng.shuffle(vals)
    return vals, rng.random(n) < 0.9, rng.random(n) < 0.3


# case -> (cells log2, scratch log2, hashes a key, masks given)
CASES = {"spread": (16, 12, 2, True), "collide": (10, 10, 3, True), "no_masks": (14, 11, 2, False)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_conservative_plain_equals_jax(dtype, case):
    """Three salted batches of 6,000 keys into a prefilled table: every
    cell, the trash cell included, equals the JAX package's."""
    size_log2, scratch_log2, h, masks = CASES[case]
    rng = np.random.default_rng(size_log2 * 7 + h)
    cfg_j = jf.CountingConfig(size_log2, h, scratch_log2=scratch_log2, dtype=dtype)
    cfg_t = tf.CountingConfig(size_log2, h, scratch_log2=scratch_log2, dtype=dtype)
    table = _prefilled(dtype, cfg_t.size + 1, rng)
    cnt_j, cnt_t = jnp.asarray(table), _torch(table)
    for salt in SALTS:
        vals, valid, dec = _keys(rng, 6000, h)
        kw_j = dict(valid=jnp.asarray(valid), dec_first=jnp.asarray(dec & valid)) if masks else {}
        kw_t = dict(valid=torch.from_numpy(valid), dec_first=torch.from_numpy(dec & valid)) if masks else {}
        cnt_j = jf.counting_increment(cnt_j, cfg_j, _jax_hashes(vals), salt=salt, **kw_j)
        tf.counting_increment(cnt_t, cfg_t, torch.from_numpy(vals.view(np.int64)), salt=salt, **kw_t)
        want = np.asarray(cnt_j)
        np.testing.assert_array_equal(cnt_t.numpy().view(want.dtype), want, err_msg=f"salt {salt}")
    assert (want != table).any()


# ---- the max insert's schedule ----


def _model_max(table: np.ndarray, idx: np.ndarray, vals: np.ndarray, lanes: int, rng) -> np.ndarray:
    """The CUDA max's schedule on a copy of ``table`` (int32, uint16 or
    uint8 cells; ``lanes`` of them a word), its storage padded to whole
    words as the caching allocator's block is; the padding must come out
    unchanged."""
    numel, bits = table.size, 32 // lanes
    store = np.zeros(-(-table.nbytes // 4) * 4 + 4, np.uint8)
    store[: table.nbytes] = table.view(np.uint8)
    pad = store[table.nbytes :].copy()
    words = store.view(np.uint32)
    cell = idx.astype(np.int64).view(np.uint64)  # negative: huge, dropped
    n = idx.size
    for w0 in rng.permutation(np.arange(0, n, 32)):  # warps run in no order
        t = np.arange(w0, min(w0 + 32, n))
        keep = cell[t] < numel
        t, c = t[keep], cell[t][keep].astype(np.int64)
        key, pos = c // lanes, c % lanes
        v = vals[t].astype(np.int64) & ((1 << bits) - 1) if lanes > 1 else vals[t].astype(np.int64)
        # a warp's peers of one word: the max of each cell position (0
        # where none holds it: a cell's value is never below 0 unsigned)
        for k in rng.permutation(np.unique(key)):
            peers = key == k
            want = [v[peers & (pos == p)].max(initial=0 if lanes > 1 else -(1 << 31)) for p in range(lanes)]
            # one read of the word, then atomicMax (int32) or one CAS of
            # the lane-wise maxima: the whole word is written
            if lanes == 1:
                if int(words[k].view(np.int32)) < want[0]:
                    words[k] = np.array(want[0], np.int32).view(np.uint32)
                continue
            old, new = int(words[k]), 0
            for p in range(lanes):
                new |= max((old >> (p * bits)) & ((1 << bits) - 1), want[p]) << (p * bits)
            words[k] = new
    assert (store[table.nbytes :] == pad).all(), "a word's CAS changed bytes past the table"
    return store[: table.nbytes].view(table.dtype).copy()


def _max_case(case: str, dtype: str, rng):
    size = 1 << 12
    numel = size + (3 if case == "last_cells" else 1)
    table = _prefilled(dtype, numel, rng)
    hi = {"int32": 1 << 20, "u16": 1 << 16, "mf8": 128}[dtype]
    n = 12_288 + 17  # a ragged last warp
    idx = rng.integers(0, size, n)
    vals = rng.integers(0, hi, n)
    if dtype == "int32":
        vals[::5] = -vals[::5]  # negative values: int32 cells compare signed
    if case == "hot_cell":
        idx[rng.random(n) < 0.3] = 1234
    elif case == "trash_and_dropped":
        idx[:500] = size  # the trash cell
        idx[500:900] = numel + rng.integers(0, 50, 400)  # past the table
        idx[900:1000] = -rng.integers(1, 9, 100)  # negative
    elif case == "one_word":  # the four byte cells of one word (two u16, one int32)
        idx[: n // 2] = 400 + rng.integers(0, 4, n // 2)
    elif case == "last_cells":  # the table's last cells, whose word reaches past it
        idx[: n // 3] = numel - 1 - rng.integers(0, 4, n // 3)
    rng.shuffle(idx[: n - 17])
    return table, idx.astype(np.int64), vals.astype(NP_DTYPES[dtype])


@pytest.mark.parametrize("case", ["hot_cell", "trash_and_dropped", "one_word", "last_cells"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_max_warp_schedule_equals_plain(dtype, case):
    rng = np.random.default_rng(len(case) * 3 + len(dtype))
    table, idx, vals = _max_case(case, dtype, rng)
    got = _model_max(table, idx, vals, LANES[dtype], rng)
    plain = _torch(table)
    ci.cell_insert_plain(plain, torch.from_numpy(idx), "max", values=_torch(vals))
    np.testing.assert_array_equal(got, plain.numpy().view(table.dtype))
    assert (got != table).any()


# ---- the conservative kernel's two launches ----


def _mf8_decode(code: np.ndarray) -> np.ndarray:
    b = code.astype(np.int64)
    big = ((b & 7) | 8).astype(np.float32) * np.exp2((b >> 3) - 1).astype(np.float32)
    return np.where(b <= 7, b.astype(np.float32), big).astype(np.float32)


def _mf8_encode_stochastic(count: np.ndarray, u01: np.ndarray) -> np.ndarray:
    """The kernel's float32 steps: encode_floor, then round up with the
    residual fraction."""
    c = np.maximum(count, np.float32(0))
    e = np.maximum(np.frexp(np.maximum(c, np.float32(8)))[1].astype(np.int64) - 3, 1)  # floor(log2) - 2
    mant = np.clip(np.floor(c * np.exp2(1 - e).astype(np.float32)).astype(np.int64), 8, 15)
    c0 = np.where(c < 8, np.floor(c).astype(np.int64), np.minimum((e << 3) | (mant & 7), 127))
    c1 = np.minimum(c0 + 1, 127)
    v0, v1 = _mf8_decode(c0), _mf8_decode(c1)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(v1 > v0, (c - v0) / np.maximum(v1 - v0, np.float32(1e-9)), np.float32(0))
    return np.where(u01 < frac, c1, c0)


def _mix_u01(x: np.ndarray, salt: int) -> np.ndarray:
    m = np.uint64(0xFFFFFFFF)
    x = (x.astype(np.uint64) & m) * np.uint64(0x9E3779B1) & m
    x ^= (np.uint64(salt & 0xFFFFFFFF) * np.uint64(0x85EBCA6B)) & m
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x27D4EB2F)) & m
    x ^= x >> np.uint64(15)
    return (x >> np.uint64(8)).astype(np.float32) / np.float32(1 << 24)


def _model_values(table, scratch, hashes, size_log2, scratch_log2, valid, dec, salt, dtype):
    """Launch 1 a key, from the pre-batch cells: the lanes' cells, the
    key's encoded value and the lanes whose cell is below it."""
    n, h = hashes.shape
    shr = hashes.view(np.uint64) >> np.uint64(1)
    idx = np.where(valid[:, None], (shr & np.uint64((1 << size_log2) - 1)).astype(np.int64), 1 << size_log2)
    sidx = np.where(valid[:, None], (shr & np.uint64((1 << scratch_log2) - 1)).astype(np.int64), 1 << scratch_log2)
    mult = np.maximum(scratch[sidx].min(axis=1) - dec.astype(np.int64), 0)
    cells = table[idx].astype(np.int64)  # signed int32, unsigned u16 and uint8
    cur = cells.min(axis=1)
    if dtype == "int32":
        value = np.where(valid, (cur + mult).astype(np.int64), 0)
        value = ((value + (1 << 31)) % (1 << 32)) - (1 << 31)
    elif dtype == "u16":
        value = np.where(valid, np.clip(cur + mult, 0, 65535), 0)
    else:
        v = np.where(valid, _mf8_decode(cur) + mult.astype(np.float32), np.float32(0)).astype(np.float32)
        value = _mf8_encode_stochastic(v, _mix_u01(hashes[:, 0].view(np.uint64), salt))
    return idx, value, cells < value[:, None]


def _model_conservative(table, scratch, hashes, size_log2, scratch_log2, valid, dec, salt, dtype, rng):
    """Launch 1, then launch 2: the masked lanes through the max model."""
    idx, value, below = _model_values(table, scratch, hashes, size_log2, scratch_log2, valid, dec, salt, dtype)
    assert below.sum() < below.size  # lanes that raise nothing are dropped
    lane_vals = np.broadcast_to(value[:, None], idx.shape)[below].astype(table.dtype)
    return _model_max(table, idx[below], lane_vals, LANES[dtype], rng)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conservative_kernel_model_equals_plain(dtype):
    """Keys that collide on their cells in a 2^10-cell table, in salted
    batches: the model of the two launches gives the plain version's
    table (a key raised by another key of the batch still reads the
    pre-batch cells)."""
    rng = np.random.default_rng(31 + len(dtype))
    size_log2, scratch_log2, h = 10, 9, 3
    table = _prefilled(dtype, (1 << size_log2) + 1, rng)
    for salt in SALTS:
        hashes, valid, dec, scratch = _batch_with_scratch(rng, 6000, h, size_log2, scratch_log2)
        got = _model_conservative(table, scratch, hashes, size_log2, scratch_log2, valid, dec, salt, dtype, rng)
        plain = _torch(table)
        ci.conservative_update_plain(
            plain, torch.from_numpy(scratch.astype(np.int32)), torch.from_numpy(hashes), size_log2, scratch_log2,
            torch.from_numpy(valid), torch.from_numpy(dec), salt,
        )
        np.testing.assert_array_equal(got, plain.numpy().view(table.dtype), err_msg=f"salt {salt}")
        assert (got != table).any()
        table = got


def _batch_with_scratch(rng, n, h, size_log2, scratch_log2):
    vals, valid, dec = _keys(rng, n, h)
    dec &= valid
    shr = vals >> np.uint64(1)
    sidx = np.where(valid[:, None], (shr & np.uint64((1 << scratch_log2) - 1)).astype(np.int64), 1 << scratch_log2)
    scratch = np.zeros((1 << scratch_log2) + 1, np.int64)
    np.add.at(scratch, sidx.ravel(), 1)
    return vals.view(np.int64), valid, dec, scratch


@pytest.mark.parametrize("h", [2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_smoke_words_plain_equals_model(dtype, h):
    """``chip_smoke.words_plain``, which the smoke holds the first
    launch's words to on the card, equals the model of launch 1: the
    value's bits as the kernel writes them (int32 two's complement, u16
    and mf8 unsigned) and bit 32 + j where lane j's cell is below it."""
    import chip_smoke

    rng = np.random.default_rng(43 + h + len(dtype))
    size_log2, scratch_log2 = 10, 9
    table = _prefilled(dtype, (1 << size_log2) + 1, rng)
    hashes, valid, dec, scratch = _batch_with_scratch(rng, 5000, h, size_log2, scratch_log2)
    _, value, below = _model_values(table, scratch, hashes, size_log2, scratch_log2, valid, dec, 977, dtype)
    bits = {"int32": 0xFFFFFFFF, "u16": 0xFFFF, "mf8": 0xFF}[dtype]
    want = (value.astype(np.int64) & bits) | (below.astype(np.int64) << (32 + np.arange(h))).sum(axis=1)
    # keys shaped (rows, positions), as a build batch's are
    args = (torch.from_numpy(scratch.astype(np.int32)), torch.from_numpy(hashes).reshape(50, 100, h), size_log2,
            scratch_log2, torch.from_numpy(valid).reshape(50, 100), torch.from_numpy(dec).reshape(50, 100), 977)
    got = chip_smoke.words_plain(_torch(table), args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert below.any() and not below.all()


def test_conservative_launches_need_a_card_table():
    """The two launches take CUDA tables only; on a CPU table
    ``conservative_update`` runs the plain version instead."""
    counts = torch.zeros((1 << 10) + 1, dtype=torch.int32)
    scratch = torch.zeros((1 << 8) + 1, dtype=torch.int32)
    hashes = torch.zeros((5, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        ci.conservative_words(counts, scratch, hashes, 10, 8)
    with pytest.raises(ValueError):
        ci.conservative_raise(counts, torch.zeros(5, dtype=torch.int64), hashes, 10)


def test_conservative_update_refuses_bad_arguments():
    counts = torch.zeros((1 << 10) + 1, dtype=torch.int32)
    scratch = torch.zeros((1 << 8) + 1, dtype=torch.int32)
    hashes = torch.zeros((5, 2), dtype=torch.int64)
    with pytest.raises(TypeError):
        ci.conservative_update(counts.float(), scratch, hashes, 10, 8)
    with pytest.raises(ValueError):
        ci.conservative_update(counts[:100], scratch, hashes, 10, 8)  # shorter than 2^10 + 1 cells
    with pytest.raises(TypeError):
        ci.conservative_update(counts, scratch, hashes, 10, 8, valid=torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError):
        ci.conservative_update(counts, scratch, torch.zeros((5, 33), dtype=torch.int64), 10, 8)
