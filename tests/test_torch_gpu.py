"""CUDA kernels (insert, the max op of exact counts among them; greedy,
pair and naive walks, also over exact-count graphs, with terminators and
over a mesh's shards read in place, on one card and across cards;
the long-read k-mer keys, randstrobes and consensus vote, these also where
their tiles bite) vs their plain PyTorch versions, on the card, the pair
walks also on a single-end and a pooled sample's stage-3 graph, -long on
the card against the CPU, and the decision oracle on the card against its
golden dict.

Imports no JAX (the machine with the card has none), so it runs there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX).  Without a CUDA
device every test skips.
"""

import numpy as np
import pytest
import torch

from rnabloom_tpu_torch.graph import dbg
from rnabloom_tpu_torch.bloom.filters import BloomConfig, CountingConfig
from rnabloom_tpu_torch.ops import cell_insert as ci
import lr_common

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(op, numel, rng):
    if op == "add":
        vals = rng.integers(0, 1000, numel, dtype=np.int32)
    elif op == "add_u16":
        vals = rng.integers(0, 65536, numel).astype(np.uint16).view(np.int16)
    elif op == "add_mf8":
        vals = rng.integers(0, 128, numel, dtype=np.uint8)
    else:
        vals = (rng.random(numel) < 0.3).astype(np.uint8)
    return torch.from_numpy(vals)


@pytest.mark.parametrize("op", sorted(op for op in ci.OPS if op != "max"))
def test_kernel_matches_plain_over_batches(cuda, op):
    """Three salted batches with a heavy cell, the trash cell and dropped
    indices; equal tables after each (for add_mf8 this also proves that
    pass 2 frees every slot of the batch table)."""
    rng = np.random.default_rng(0)
    size = 1 << 20
    base = _table(op, size + 1, rng)
    if op == "add_u16":  # cells near the 65535 cap
        base[:100] = -2
    kern, plain = base.to(cuda), base.to(cuda)
    for salt in (0, 1, 2**31 + 7):
        idx = np.concatenate([
            rng.integers(0, size, 200_000),
            np.full(100_000, 12345),  # poly-A-like heavy cell
            np.full(1000, size),  # trash cell
            np.full(1000, size + 5),  # out of range: dropped
            np.arange(100).repeat(3),  # saturating cells
        ])
        rng.shuffle(idx)
        idx = torch.from_numpy(idx).to(cuda)
        before = ci.launch_counts()[op]
        ci.cell_insert(kern, idx, op, salt)
        ci.cell_insert_plain(plain, idx, op, salt)
        torch.cuda.synchronize()
        assert ci.launch_counts()[op] == before + 1
        assert torch.equal(kern, plain)


TILE = 4096  # indices per block of the add_u16 kernel


def _u16_batch(case, numel, rng):
    """(prefilled u16 table as int16, idx) for one add_u16 edge case."""
    table = rng.integers(0, 65536, numel).astype(np.uint16)
    if case == "one_cell_to_the_cap":
        table[:] = 0
        idx = np.full(1 << 20, 4242)  # 2^20 hits: one CAS per tile, saturates
    elif case == "adjacent_hot":
        table[200:202] = 1000
        idx = np.concatenate([rng.integers(0, numel, 50_000), np.tile([200, 201], 40_000)])
    elif case == "last_cell_odd_table":
        table[-1] = 30_000
        idx = np.concatenate([rng.integers(0, numel, 50_000), np.full(50_000, numel - 1)])
    elif case == "empty":
        idx = np.zeros(0, np.int64)
    elif case == "one_index":
        idx = np.array([numel - 1])
    else:  # "ragged": no multiple of the tile, dropped and negative indices
        idx = np.concatenate([
            rng.integers(0, numel, 3 * TILE + 17), np.full(300, numel), np.full(300, -3),
            np.full(300, 1 << 40),
        ])
    rng.shuffle(idx)
    return torch.from_numpy(table.view(np.int16)), torch.from_numpy(idx.astype(np.int64))


@pytest.mark.parametrize(
    "case", ["one_cell_to_the_cap", "adjacent_hot", "last_cell_odd_table", "empty", "one_index", "ragged"]
)
def test_add_u16_edge_cases_match_plain(cuda, case):
    rng = np.random.default_rng(4)
    table, idx = _u16_batch(case, (1 << 20) + 1, rng)
    kern, plain, idx = table.to(cuda), table.to(cuda), idx.to(cuda)
    ci.cell_insert(kern, idx, "add_u16")
    ci.cell_insert_plain(plain, idx, "add_u16")
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)
    if case == "one_cell_to_the_cap":
        assert int(kern[4242]) == -1  # 65535 as int16


def _mf8_batch(case, numel, rng):
    """(prefilled mf8 table, idx) for one add_mf8 edge case."""
    table = rng.integers(0, 128, numel).astype(np.uint8)
    if case == "hot_cell_every_tile":
        table[4242] = 0
        idx = np.concatenate([rng.integers(0, numel, 200_000), np.full(100_000, 4242)])
    elif case == "near_saturation":
        table[:800] = 120 + np.arange(800) % 8  # codes 120 .. 127
        idx = np.concatenate([rng.integers(0, numel, 50_000), np.arange(800).repeat(50)])
    elif case == "trash_cell":
        table[-1] = 90
        idx = np.concatenate([rng.integers(0, numel, 50_000), np.full(5_000, numel - 1)])
    elif case == "empty":
        idx = np.zeros(0, np.int64)
    elif case == "one_index":
        idx = np.array([numel - 1])
    else:  # "ragged": no multiple of the tile, dropped and negative indices
        idx = np.concatenate([
            rng.integers(0, numel, 3 * TILE + 17), np.full(300, numel), np.full(300, -3),
            np.full(300, 1 << 40),
        ])
    rng.shuffle(idx)
    return torch.from_numpy(table), torch.from_numpy(idx.astype(np.int64))


@pytest.mark.parametrize("salt", [0, 1, 977, 2**31 + 7])
@pytest.mark.parametrize(
    "case", ["hot_cell_every_tile", "near_saturation", "trash_cell", "empty", "one_index", "ragged"]
)
def test_add_mf8_edge_cases_match_plain(cuda, case, salt):
    """Equal to plain, and the batch table is all free after the launch."""
    rng = np.random.default_rng(5)
    table, idx = _mf8_batch(case, (1 << 20) + 1, rng)
    kern, plain, idx = table.to(cuda), table.to(cuda), idx.to(cuda)
    ci.cell_insert(kern, idx, "add_mf8", salt)
    ci.cell_insert_plain(plain, idx, "add_mf8", salt)
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)
    batch = ci._batch_tables[kern.device]
    assert bool((batch == ci.FREE_SLOT).all())


def _set_batch(case, numel, rng):
    """(prefilled lane table, idx) for one set edge case."""
    table = (rng.random(numel) < 0.3).astype(np.uint8)
    if case == "lanes_already_set":  # every warp reads first
        idx = np.flatnonzero(table)[:200_000]
    elif case == "fresh_table":  # every warp stores plainly
        table[:] = 0
        idx = rng.integers(0, numel, 200_000)
    elif case == "hot_cell":
        table[4242] = 0
        idx = np.concatenate([rng.integers(0, numel, 200_000), np.full(100_000, 4242)])
    elif case == "empty":
        idx = np.zeros(0, np.int64)
    elif case == "one_index":
        table[-1] = 0
        idx = np.array([numel - 1])
    else:  # "ragged": no multiple of a block's indices, dropped and negative ones
        idx = np.concatenate([
            rng.integers(0, numel, 3 * 1024 + 17), np.full(300, numel), np.full(300, -3),
            np.full(300, 1 << 40),
        ])
    rng.shuffle(idx)
    return torch.from_numpy(table), torch.from_numpy(idx.astype(np.int64))


@pytest.mark.parametrize("case", ["lanes_already_set", "fresh_table", "hot_cell", "empty", "one_index", "ragged"])
def test_set_edge_cases_match_plain(cuda, case):
    rng = np.random.default_rng(6)
    table, idx = _set_batch(case, (1 << 22) + 1, rng)
    kern, plain, idx = table.to(cuda), table.to(cuda), idx.to(cuda)
    ci.cell_insert(kern, idx, "set")
    ci.cell_insert_plain(plain, idx, "set")
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)
    if case in ("hot_cell", "one_index"):
        assert int(kern[4242 if case == "hot_cell" else -1]) == 1


def _add_batch(case, numel, rng):
    """(prefilled int32 table, idx) for one add edge case."""
    table = rng.integers(0, 1 << 20, numel).astype(np.int32)
    if case == "one_cell_every_tile":
        idx = np.full(1 << 20, 4242)  # 2^20 hits: one RED per tile
    elif case == "adjacent_hot":
        idx = np.concatenate([rng.integers(0, numel, 50_000), np.tile([200, 201], 40_000)])
    elif case == "blocked_row_hot":  # all 128 lanes of one blocked row, many times
        idx = np.concatenate([rng.integers(0, numel, 50_000), np.tile(np.arange(128 * 7, 128 * 8), 500)])
    elif case == "trash_row":
        idx = np.concatenate([rng.integers(0, numel, 50_000), np.tile(np.arange(numel - 128, numel), 100)])
    elif case == "empty":
        idx = np.zeros(0, np.int64)
    elif case == "one_index":
        idx = np.array([numel - 1])
    else:  # "ragged": no multiple of the tile, dropped and negative indices
        idx = np.concatenate([
            rng.integers(0, numel, 3 * TILE + 17), np.full(300, numel), np.full(300, -3),
            np.full(300, 1 << 40),
        ])
    rng.shuffle(idx)
    return torch.from_numpy(table), torch.from_numpy(idx.astype(np.int64))


@pytest.mark.parametrize(
    "case", ["one_cell_every_tile", "adjacent_hot", "blocked_row_hot", "trash_row", "empty", "one_index", "ragged"]
)
def test_add_edge_cases_match_plain(cuda, case):
    """The int32 add on a blocked cbf's shape (2^20 cells and a 128-cell
    trash row), against plain and index_add_."""
    rng = np.random.default_rng(8)
    table, idx = _add_batch(case, (1 << 20) + 128, rng)
    kern, plain, idx = table.to(cuda), table.to(cuda), idx.to(cuda)
    lib = table.to(cuda)
    ci.cell_insert(kern, idx, "add")
    ci.cell_insert_plain(plain, idx, "add")
    sel = idx[(idx >= 0) & (idx < lib.numel())]
    lib.index_add_(0, sel, torch.ones_like(sel, dtype=torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(kern, plain) and torch.equal(kern, lib)
    if case == "one_cell_every_tile":
        assert int(kern[4242]) == int(table[4242]) + (1 << 20)


def test_add_u16_uses_no_scratch(cuda):
    """Neither add_u16 nor set allocates an insert buffer; add_mf8's batch
    table is at most 16 B an index of a 2^20-index batch; mf8 and u16
    tables of 2^32 cells are refused (uint32 keys)."""
    ci._batch_tables.clear()
    n = 1 << 20
    for op, dtype in (("add_u16", torch.int16), ("set", torch.uint8)):
        table = torch.zeros((1 << 22) + 1, dtype=dtype, device=cuda)
        for _ in range(3):
            ci.cell_insert(table, torch.randint(0, table.numel(), (n,), device=cuda), op)
    torch.cuda.synchronize()
    assert ci.batch_table_bytes() == 0
    table = torch.zeros((1 << 22) + 1, dtype=torch.uint8, device=cuda)
    ci.cell_insert(table, torch.randint(0, table.numel(), (n,), device=cuda), "add_mf8")
    torch.cuda.synchronize()
    assert 0 < ci.batch_table_bytes() <= 16 * n
    for dtype, op in ((torch.int16, "add_u16"), (torch.uint8, "add_mf8")):  # add takes any length
        too_long = torch.empty(1 << 32, dtype=dtype, device=cuda)  # uint32 keys: < 2^32 cells
        with pytest.raises(ValueError):
            ci.cell_insert(too_long, torch.zeros(1, dtype=torch.int64, device=cuda), op)
        del too_long


def test_build_step_card_equals_cpu(cuda):
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 5, size=(512, 100), dtype=np.uint8))
    for counter in ("mf8", "u16", "int32"):
        cfg = dbg.GraphConfig(
            k=25, stranded=False, dbgbf=BloomConfig(16, 2),
            cbf=CountingConfig(17, 2, blocked=counter == "int32", dtype=counter),
            pkbf=BloomConfig(16, 2), read_pair_distance=40,
        )
        states = []
        for dev in ("cpu", cuda):
            s = dbg.make_graph(cfg, with_rpkbf=True, device=dev)
            for salt in range(3):
                s = dbg.build_step(s, cfg, codes.to(dev), add_read_pairs=True, salt=salt)
            states.append(s)
        assert torch.equal(states[0].cbf, states[1].cbf.cpu())
        assert torch.equal(states[0].rpkbf, states[1].rpkbf.cpu())
        c0, _ = dbg.count_step(states[0], cfg, codes)
        c1, _ = dbg.count_step(states[1], cfg, codes.to(cuda))
        assert torch.equal(c0, c1.cpu())


# ---- greedy walk kernel (csrc/walk_greedy.cu) vs its plain version ----

WALK_GRAPHS = [("mf8", False), ("u16", False), ("int32", True), ("int32", False)]
WALK_FIELDS = ("buf", "pos", "status", "hops", "path_min", "fh", "rh", "hist")
_walk_graphs = {}


def _walk_graph(dtype, blocked, stranded, dev, num_hash=2):
    """A graph of 24 random transcripts read at uneven depth, with planted
    substitutions (branches and tips), built on ``dev``; cached."""
    key = (dtype, blocked, stranded, num_hash, str(dev))
    if key not in _walk_graphs:
        rng = np.random.default_rng(7)
        cfg = dbg.GraphConfig(
            k=25, stranded=stranded, dbgbf=BloomConfig(18, 2),
            cbf=CountingConfig(18, num_hash, blocked=blocked, dtype=dtype), pkbf=BloomConfig(18, 2),
        )
        tx = rng.integers(0, 4, size=(24, 600), dtype=np.uint8)
        tx[1, :200] = tx[0, :200]  # two transcripts sharing a prefix: a branch
        reads = []
        for t, depth in zip(tx, rng.integers(1, 9, size=24)):
            for _ in range(depth):
                for s in range(0, 500, 20):
                    r = t[s : s + 100].copy()
                    if rng.random() < 0.3:
                        r[rng.integers(100)] = rng.integers(4)
                    reads.append(r)
        state = dbg.make_graph(cfg, device=dev)
        state = dbg.build_step(state, cfg, torch.from_numpy(np.stack(reads)).to(dev))
        seeds = np.concatenate([tx[:, :25], tx[:, 300:325], tx[:, -25:][:, ::-1].copy() ^ 3])
        _walk_graphs[key] = (cfg, state, seeds)
    return _walk_graphs[key]


def _walks(cuda, dtype="mf8", blocked=False, stranded=False, left=False, lookahead=3, num_hash=2):
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, seeds = _walk_graph(dtype, blocked, stranded, cuda, num_hash)
    wcfg = traverse.WalkConfig(max_len=25 + 700, lookahead=lookahead, left=left)
    st = traverse.make_walks(cfg, wcfg, seeds, device=cuda)
    rng = np.random.default_rng(3)
    min_cov, bound = traverse.lane_args(
        st, rng.choice([1.0, 2.0, 3.5], size=st.pos.shape[0]).astype(np.float32),
        rng.integers(100, 700, size=st.pos.shape[0]).astype(np.int32),
    )
    return cfg, graph, wcfg, st, min_cov, bound


def _kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound, **kw):
    from rnabloom_tpu_torch.ops import walk

    n0 = walk.LAUNCHES["walk_greedy"]
    kern = walk.walk_greedy(st, graph, cfg, wcfg, min_cov, bound, **kw)
    plain = walk.walk_greedy_plain(st, graph, cfg, wcfg, min_cov, bound, **kw)
    torch.cuda.synchronize()
    assert walk.LAUNCHES["walk_greedy"] == n0 + 1
    for name in WALK_FIELDS:
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    return kern


@pytest.mark.parametrize("dtype,blocked", WALK_GRAPHS)
@pytest.mark.parametrize("stranded,left", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize(
    "lookahead,num_hash", [(1, 2), (2, 2), (3, 2), (4, 2), (5, 2), (3, 1), (5, 1), (2, 3), (3, 3), (3, 4)]
)
def test_walk_kernel_matches_plain(cuda, dtype, blocked, stranded, left, lookahead, num_hash):
    """Every layout, strand mode and walk side, lookahead 1-5 (past 3: the
    descents), num_hash 1-3 (the specialised kernels) and 4 (the generic
    one)."""
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, wcfg, st, min_cov, bound = _walks(cuda, dtype, blocked, stranded, left, lookahead, num_hash)
    kern = _kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound)
    assert int((kern.status == traverse.BRANCH).sum()) == 0


@pytest.mark.parametrize("lookahead", [3, 5])
def test_walk_kernel_superstep_cap(cuda, lookahead):
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, wcfg, st, _, _ = _walks(cuda, lookahead=lookahead)
    min_cov, bound = traverse.lane_args(st, 1.0, 700)
    kern = _kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound, superstep_hops=5, max_supersteps=7)
    assert int((kern.status == traverse.ACTIVE).sum()) > 0  # the cap cut live lanes


@pytest.mark.parametrize("W", [1, 45])
@pytest.mark.parametrize("lookahead", [3, 5])
def test_walk_kernel_odd_lane_counts(cuda, W, lookahead):
    """A single lane alone, and a lane count that is no multiple of the
    lanes of a block (the last block's spare tiles leave at once)."""
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, wcfg, st, min_cov, bound = _walks(cuda, lookahead=lookahead)
    st = traverse.take_lanes(st, slice(0, W))
    min_cov, bound = min_cov[:W].contiguous(), bound[:W].contiguous()
    kern = _kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound)
    assert kern.pos.shape[0] == W and int(kern.hops.sum()) > 0


def test_walk_kernel_long_cycle_ring(cuda):
    """A 2048-slot cycle ring: the rings of a block's lanes pass 48 KB of
    shared memory, so the launch takes fewer lanes a block."""
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, seeds = _walk_graph("mf8", False, False, cuda)
    wcfg = traverse.WalkConfig(max_len=25 + 700, cycle_window=2048)
    st = traverse.make_walks(cfg, wcfg, seeds, device=cuda)
    min_cov, bound = traverse.lane_args(st, 1.0, 700)
    _kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound)


def test_stage2_card_equals_cpu(cuda, tmp_path):
    import filecmp
    import os

    from rnabloom_tpu_torch import cli
    from rnabloom_tpu_torch.ops import walk
    from rnabloom_tpu_torch.utils import pesim

    left, right = str(tmp_path / "r_1.fq"), str(tmp_path / "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=11, num_transcripts=20, tx_len=(500, 1500), num_pairs=1500)
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = str(tmp_path / dev)
        n0 = walk.LAUNCHES["walk_greedy"]
        cli.run(["-left", left, "-right", right, "-revcomp-right", "-o", outs[dev], "-stage", "2",
                 "-savebf", "-mem", "0.00390625", "-batch", "1024", "-sample", "300", "--device", dev])
        if dev == "cuda":
            assert walk.LAUNCHES["walk_greedy"] > n0
    for root, _, files in os.walk(outs["cpu"]):
        for f in files:
            a = os.path.join(root, f)
            assert filecmp.cmp(a, a.replace(outs["cpu"], outs["cuda"], 1), shallow=False), a


# ---- the walk kernel in pair mode vs its plain version ----

PAIR_FIELDS = WALK_FIELDS + ("ring_fh", "ring_rh")
_pair_graphs = {}


def _pair_graph(dtype, blocked, stranded, dev, num_hash=2, pk_hash=2, frag=True, read=True):
    """The walk graph's reads, with the read-pair keys (distance 40) and the
    fragment-pair keys of the same reads (distance 60) as stage 2b inserts
    them; fragment seeds (100-base read rows, some cut short, one empty),
    reverse-complemented for left walks by the caller; cached."""
    key = (dtype, blocked, stranded, num_hash, pk_hash, frag, read, str(dev))
    if key not in _pair_graphs:
        rng = np.random.default_rng(7)
        cfg = dbg.GraphConfig(
            k=25, stranded=stranded, dbgbf=BloomConfig(18, 2),
            cbf=CountingConfig(18, num_hash, blocked=blocked, dtype=dtype), pkbf=BloomConfig(18, pk_hash),
            read_pair_distance=40 if read else -1, fragment_pair_distance=60 if frag else -1,
        )
        tx = rng.integers(0, 4, size=(24, 600), dtype=np.uint8)
        tx[1, :200] = tx[0, :200]
        reads = []
        for t, depth in zip(tx, rng.integers(1, 9, size=24)):
            for _ in range(depth):
                for s in range(0, 500, 20):
                    r = t[s : s + 100].copy()
                    if rng.random() < 0.3:
                        r[rng.integers(100)] = rng.integers(4)
                    reads.append(r)
        reads = torch.from_numpy(np.stack(reads)).to(dev)
        state = dbg.make_graph(cfg, with_rpkbf=read, with_fpkbf=frag, device=dev)
        state = dbg.build_step(state, cfg, reads, add_read_pairs=read)
        if frag:
            state = dbg.rebuild_step(state, cfg, reads, salt=1)
        frags = reads.cpu().numpy()[::29][:90].copy()
        lens = np.full(len(frags), 100)
        lens[3], lens[4], lens[5] = 60, 0, 24
        _pair_graphs[key] = (cfg, state, frags, lens)
    return _pair_graphs[key]


def _pair_walks(cuda, dtype="mf8", blocked=False, stranded=False, left=False, num_hash=2, pk_hash=2, ring=64,
                depth=24, lane_args=True, lanes=None, max_len=25 + 500, bounds=(100, 500), graph=None, **kw):
    """Pair walks of the fragment seeds (``lanes``: that many lanes, the
    seeds repeated; ``graph``: another (cfg, state, seeds, lens)), with
    per-lane coverage floors and hop bounds drawn from ``bounds``."""
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, frags, lens = graph or _pair_graph(dtype, blocked, stranded, cuda, num_hash, pk_hash, **kw)
    if lanes is not None:
        rows = np.arange(lanes) % len(frags)
        frags, lens = frags[rows], lens[rows]
    wcfg = traverse.WalkConfig(max_len=max_len, left=left, pair_ring=ring, pair_probe_depth=depth)
    seeds = 3 - frags[:, ::-1] if left else frags
    st = traverse.make_walks(cfg, wcfg, np.ascontiguousarray(seeds), lens, device=cuda)
    if lanes is not None:
        st = traverse.take_lanes(st, slice(0, lanes))
    rng = np.random.default_rng(5)
    W = st.pos.shape[0]
    if lane_args:
        min_cov, bound = traverse.lane_args(st, rng.choice([1.0, 2.0, 3.5], size=W).astype(np.float32),
                                            rng.integers(*bounds, size=W).astype(np.int32))
    else:
        min_cov, bound = traverse.lane_args(st, 1.0, 400)
    return cfg, graph, wcfg, st, min_cov, bound


def _pair_kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound, **kw):
    from rnabloom_tpu_torch.graph import traverse
    from rnabloom_tpu_torch.ops import walk

    n0 = walk.LAUNCHES["walk_pair"]
    kern = walk.walk_pair(st, graph, cfg, wcfg, min_cov, bound, **kw)
    plain = walk.walk_pair_plain(st, graph, cfg, wcfg, min_cov, bound, **kw)
    torch.cuda.synchronize()
    assert walk.LAUNCHES["walk_pair"] == n0 + 1
    for name in PAIR_FIELDS:
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    assert int((kern.status == traverse.BRANCH).sum()) == 0 or kw
    return kern


@pytest.mark.parametrize("dtype,blocked", WALK_GRAPHS)
@pytest.mark.parametrize("stranded,left", [(False, False), (False, True), (True, False), (True, True)])
def test_pair_kernel_matches_plain(cuda, dtype, blocked, stranded, left):
    """Every layout, strand mode and walk side; fragment seeds longer than
    the ring."""
    from rnabloom_tpu_torch.graph import traverse

    kern = _pair_kernel_and_plain(*_pair_args(_pair_walks(cuda, dtype, blocked, stranded, left)))
    assert int(kern.hops.sum()) > 0
    if not stranded:
        assert int((kern.status == traverse.STOPPED_BRANCH).sum()) > 0


def _pair_args(walks):
    cfg, graph, wcfg, st, min_cov, bound = walks
    return graph, cfg, wcfg, st, min_cov, bound


@pytest.mark.parametrize(
    "kw",
    [{"num_hash": 1}, {"num_hash": 3}, {"num_hash": 4}, {"pk_hash": 1}, {"pk_hash": 3}, {"pk_hash": 5},
     {"ring": 48}, {"ring": 40}, {"ring": 1024}, {"ring": 20}, {"ring": 16, "depth": 23},
     {"depth": 1}, {"depth": 2}, {"depth": 3}, {"depth": 8}, {"depth": 23},
     {"frag": False}, {"read": False}, {"frag": False, "read": False}, {"lane_args": False}],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_pair_kernel_options_match_plain(cuda, kw):
    """num_hash 1-3 (the specialised kernels) and 4 (the generic one), pkbf
    hashes, rings shorter than a fragment, exactly the read pair distance
    and shorter than the probe, probe depths (odd and even rounds of two
    steps: 1, 2, 3, 8, 23 and the default 24), a missing pair class or
    both."""
    _pair_kernel_and_plain(*_pair_args(_pair_walks(cuda, **kw)))


@pytest.mark.parametrize("W", [1, 45, 64, 70, 2048, 3000])
def test_pair_kernel_odd_lane_counts(cuda, W):
    """One lane to several blocks an SM (the launch spreads the lanes over
    every SM first)."""
    _pair_kernel_and_plain(*_pair_args(_pair_walks(cuda, lanes=W)))


@pytest.mark.parametrize(
    "max_len,bounds,parities",
    [(107, (100, 500), {0}), (108, (100, 500), {1}), (525, (1, 13), {0, 1})],
    ids=["max_len_even_hops", "max_len_odd_hops", "small_bounds"],
)
def test_pair_kernel_full_on_either_hop_of_a_round(cuda, max_len, bounds, parities):
    """FULL at max_len - 1 (after an even or an odd number of hops from the
    100-base seeds) and at hop bounds of 1-12 (both), so on the first or
    the second hop of a round's two."""
    from rnabloom_tpu_torch.graph import traverse

    kern = _pair_kernel_and_plain(*_pair_args(_pair_walks(cuda, max_len=max_len, bounds=bounds)))
    full = kern.status == traverse.FULL
    assert {int(h) % 2 for h in kern.hops[full].tolist()} == parities


_cycle_graphs = {}


def _cycle_graph(period, dev):
    """Reads of a sequence that repeats every ``period`` bases (so a walk
    comes back to a k-mer after ``period`` hops, within the cycle window),
    with read- and fragment-pair keys; seeds are reads."""
    key = (period, str(dev))
    if key not in _cycle_graphs:
        rng = np.random.default_rng(period)
        cfg = dbg.GraphConfig(
            k=25, stranded=False, dbgbf=BloomConfig(18, 2), cbf=CountingConfig(18, 2, dtype="mf8"),
            pkbf=BloomConfig(18, 2), read_pair_distance=40, fragment_pair_distance=60,
        )
        tx = np.tile(rng.integers(0, 4, size=period, dtype=np.uint8), 600 // period + 1)[:600]
        reads = np.stack([tx[s : s + 100] for _ in range(3) for s in range(0, 500, 10)])
        t = torch.from_numpy(reads).to(dev)
        state = dbg.build_step(dbg.make_graph(cfg, with_rpkbf=True, with_fpkbf=True, device=dev), cfg, t,
                                 add_read_pairs=True)
        state = dbg.rebuild_step(state, cfg, t, salt=1)
        frags = reads[::7][:40].copy()
        lens = 100 - (np.arange(len(frags)) % 3)
        _cycle_graphs[key] = (cfg, state, frags, lens)
    return _cycle_graphs[key]


@pytest.mark.parametrize("period", [37, 38])
def test_pair_kernel_cycle_on_either_hop_of_a_round(cuda, period):
    """CYCLE after an odd or an even number of hops."""
    from rnabloom_tpu_torch.graph import traverse

    kern = _pair_kernel_and_plain(*_pair_args(_pair_walks(cuda, graph=_cycle_graph(period, cuda))))
    assert int((kern.status == traverse.CYCLE).sum()) > 0


def test_pair_kernel_superstep_cap(cuda):
    graph, cfg, wcfg, st, min_cov, bound = _pair_args(_pair_walks(cuda, lane_args=False))
    _pair_kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound, superstep_hops=5, max_supersteps=7)


@pytest.mark.parametrize("stranded", [False, True])
def test_extend_fragments_pair_card_equals_cpu(cuda, stranded):
    """The stage-3 extension (right walks, the reverse-complement hand-off,
    left walks) on the card and on the CPU, at stage 3's sizes."""
    from rnabloom_tpu_torch.assembly import transcripts
    from rnabloom_tpu_torch.ops import walk

    cfg, graph, frags, lens = _pair_graph("mf8", False, stranded, cuda)
    cpu = dbg.GraphState(*(None if t is None else t.cpu() for t in graph))
    n0 = walk.LAUNCHES["walk_pair"]
    got = transcripts.extend_fragments_pair(graph, cfg, frags, lens, transcripts.TranscriptParams())
    assert walk.LAUNCHES["walk_pair"] == n0 + 2
    want = transcripts.extend_fragments_pair(cpu, cfg, frags, lens, transcripts.TranscriptParams())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pair_walk_refuses_a_greedy_ring(cuda):
    from rnabloom_tpu_torch.ops import walk

    graph, cfg, wcfg, st, min_cov, bound = _pair_args(_pair_walks(cuda))
    with pytest.raises(ValueError, match="pair ring"):
        walk.walk_greedy(st, graph, cfg, wcfg, min_cov, bound)


def _stage3_graphs(monkeypatch, run) -> list:
    """(graph, cfg, store, params) of every stage-3 run of ``run()``:
    ``pipeline._run_stage3`` is replaced by a recorder, so no transcripts
    are written."""
    from rnabloom_tpu_torch.assembly import pipeline

    seen = []
    monkeypatch.setattr(pipeline, "_run_stage3",
                        lambda state, cfg, store, outdir, params, report: seen.append((state, cfg, store, params)))
    run()
    return seen


def _first_full_batch_pair_walks(graph, cfg, store, params, dev):
    """The right pair walks of stage 3's first full batch of fragments
    (stage 3's own order, seeds and lane arguments)."""
    from rnabloom_tpu_torch.assembly import pipeline
    from rnabloom_tpu_torch.graph import traverse

    tparams = pipeline._transcript_params(cfg, params)
    width = int(min(max(store.max_len, cfg.k), params.max_walk_len))
    frags, lens = next((c, n) for c, n, _, _ in store.iter_batches(params.stage3_batch, width=width) if (n > 0).all())
    wcfg = traverse.WalkConfig(max_len=tparams.max_walk_len, pair_ring=tparams.pair_ring, left=False,
                               lookahead=tparams.lookahead)
    st = traverse.make_walks(cfg, wcfg, frags, lens, device=dev)
    return (graph, cfg, wcfg, st, *traverse.lane_args(st, 1.0, tparams.bound))


def test_pair_kernel_on_a_single_end_stage3_batch(cuda, tmp_path, monkeypatch):
    """The single-end stage 3: a graph with read-pair keys and no fpkbf
    (the kernel's null fragment-pair table), on stage 3's first full batch
    of unpaired-read fragments."""
    from rnabloom_tpu_torch.assembly import pipeline
    from stage3_common import write_se_reads

    fwd, rev = str(tmp_path / "f.fq"), str(tmp_path / "r.fq")
    write_se_reads(fwd, rev, seed=3, num_reads=1500)
    params = pipeline.PipelineParams(total_mem_bytes=1 << 22, bound=200, batch_size=1024, sample_size=300,
                                     stage3_batch=256)
    [(graph, cfg, store, params)] = _stage3_graphs(monkeypatch, lambda: pipeline.assemble_se(
        [fwd, rev], str(tmp_path / "se"), params, revcomp_flags=[False, True], device=cuda))
    assert graph.fpkbf is None and graph.rpkbf is not None and cfg.read_pair_distance > 0
    kern = _pair_kernel_and_plain(*_first_full_batch_pair_walks(graph, cfg, store, params, cuda))
    assert int(kern.hops.sum()) > 0


def test_pair_kernel_on_a_pool_sample_rebuilt_graph(cuda, tmp_path, monkeypatch):
    """A pooled sample's fragment graph: fresh counters and fpkbf beside
    the shared read-pair keys, read in place, on stage 3's first full batch
    of the second sample, after the first sample's rebuild."""
    from rnabloom_tpu_torch.assembly import pipeline
    from rnabloom_tpu_torch.utils import pesim

    lines = []
    for i, name in enumerate(("sA", "sB")):
        left, right = str(tmp_path / f"{name}_1.fq"), str(tmp_path / f"{name}_2.fq")
        pesim.write_pe_fastq(left, right, seed=21 + i, num_transcripts=8, tx_len=(500, 1000), num_pairs=1500)
        lines.append(f"{name} {left} {right}\n")
    (tmp_path / "pool.txt").write_text("".join(lines))
    params = pipeline.PipelineParams(total_mem_bytes=1 << 22, bound=200, batch_size=1024, sample_size=300,
                                     stage3_batch=256)
    graphs = _stage3_graphs(monkeypatch, lambda: pipeline.assemble_pool(
        str(tmp_path / "pool.txt"), str(tmp_path / "pool"), params, device=cuda))
    assert len(graphs) == 2
    graph, cfg, store, params = graphs[1]
    assert graph.fpkbf is not None and graph.fpkbf is not graphs[0][0].fpkbf
    assert graph.rpkbf is graphs[0][0].rpkbf
    kern = _pair_kernel_and_plain(*_first_full_batch_pair_walks(graph, cfg, store, params, cuda))
    assert int(kern.hops.sum()) > 0


# ---- stage 3's greedy walks: gap re-walks, depth probes, the screen as a graph ----


_naive_graphs = {}


def _naive_walks(cuda, case):
    """The walks of a naive case of the CPU tests (``stage3_common.
    NAIVE_CASES``: the same graphs, seeds and lane arguments) on the card."""
    from rnabloom_tpu_torch.graph import traverse
    from stage3_common import NAIVE_CASES, WALK_DATA, naive_lane_args, naive_walk_rows

    data, dtype, blocked, stranded, nh, left, back, tpd, max_len = NAIVE_CASES[case][:9]
    key = (data, dtype, blocked, stranded, nh)
    if key not in _naive_graphs:
        reads, seeds = WALK_DATA[data]()
        cfg = dbg.GraphConfig(k=25, stranded=stranded, dbgbf=BloomConfig(18, 2),
                              cbf=CountingConfig(18, nh, blocked=blocked, dtype=dtype), pkbf=BloomConfig(18, 2),
                              read_pair_distance=40)
        graph = dbg.build_step(dbg.make_graph(cfg, device=cuda), cfg, torch.from_numpy(reads).to(cuda))
        _naive_graphs[key] = (cfg, graph, naive_walk_rows(data, reads, seeds, stranded, left))
    cfg, graph, rows = _naive_graphs[key]
    wcfg = traverse.WalkConfig(max_len=max_len, left=left, check_back_branches=back, tip_probe_depth=tpd)
    st = traverse.make_walks(cfg, wcfg, rows, device=cuda)
    min_cov, bound = traverse.lane_args(st, *naive_lane_args(case, st.pos.shape[0]))
    return cfg, graph, wcfg, st, min_cov, bound


def _naive_kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound, **kw):
    from rnabloom_tpu_torch.ops import walk

    n0 = walk.LAUNCHES["walk_naive"]
    kern = walk.walk_naive(st, graph, cfg, wcfg, min_cov, bound, **kw)
    plain = walk.walk_naive_plain(st, graph, cfg, wcfg, min_cov, bound, **kw)
    torch.cuda.synchronize()
    assert walk.LAUNCHES["walk_naive"] == n0 + 1
    for name in WALK_FIELDS:
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    return kern


def _naive_case_ids():
    from stage3_common import NAIVE_CASES

    return list(NAIVE_CASES)


@pytest.mark.parametrize("case", _naive_case_ids())
def test_naive_kernel_matches_plain(cuda, case):
    """The naive cases of tests/test_torch_traverse.py (every field there
    equals the JAX package's): back-branch stops, resolves with none,
    one and several deep candidates, FULL and CYCLE."""
    cfg, graph, wcfg, st, min_cov, bound = _naive_walks(cuda, case)
    kern = _naive_kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound)
    assert int(kern.hops.sum()) > 0


NAIVE_OPTIONS = (
    # every layout, strand mode and walk side with back-branch checks
    [(d, b, s, l, True, 8, 2) for d, b in WALK_GRAPHS for s, l in [(False, False), (True, False), (True, True)]]
    # every layout without them
    + [(d, b, False, False, False, 8, 2) for d, b in WALK_GRAPHS]
    # probe depths 0 (every probe is deep), 1 (no probe step) to 20, num_hash 1-3 and 4 (the generic kernel)
    + [("mf8", False, False, False, back, tpd, nh) for back in (True, False)
       for tpd, nh in [(3, 1), (1, 2), (0, 2), (20, 3), (8, 4)]]
    # every layout with num_hash 1, 3 and 4
    + [(d, b, False, False, True, 8, nh) for d, b in WALK_GRAPHS for nh in (1, 3, 4)]
)


@pytest.mark.parametrize("dtype,blocked,stranded,left,back,tip_probe_depth,num_hash", NAIVE_OPTIONS)
def test_naive_kernel_options_match_plain(cuda, dtype, blocked, stranded, left, back, tip_probe_depth, num_hash):
    """Naive walks from the greedy tests' seeds on their graph, with the
    options of ``NAIVE_OPTIONS``."""
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, seeds = _walk_graph(dtype, blocked, stranded, cuda, num_hash)
    wcfg = traverse.WalkConfig(max_len=25 + 700, left=left, check_back_branches=back, tip_probe_depth=tip_probe_depth)
    st = traverse.make_walks(cfg, wcfg, seeds, device=cuda)
    rng = np.random.default_rng(4)
    min_cov, bound = traverse.lane_args(
        st, rng.choice([1.0, 2.0, 3.5], size=st.pos.shape[0]).astype(np.float32),
        rng.integers(100, 700, size=st.pos.shape[0]).astype(np.int32),
    )
    _naive_kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound)


@pytest.mark.parametrize("W", [1, 45])
def test_naive_kernel_odd_lane_counts_and_cap(cuda, W):
    """A single lane, a lane count that is no multiple of a block's lanes,
    and the superstep cap cutting live lanes."""
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, wcfg, st, min_cov, bound = _naive_walks(cuda, "mf8_right")
    st = traverse.take_lanes(st, slice(0, W))
    _naive_kernel_and_plain(graph, cfg, wcfg, st, min_cov[:W].contiguous(), bound[:W].contiguous())
    cfg, graph, wcfg, st, min_cov, bound = _naive_walks(cuda, "mf8_right")
    _naive_kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound, superstep_hops=5, max_supersteps=7)


_tail_graphs = {}


def _tail_graph(dev):
    """A 160-base line read without errors (3 copies of each 60-base window
    at a stride of 5), and reads with the first base of a k-mer
    substituted: left variants of the k-mers starting 20-48 bases before
    the line's end, so that their probes' common descent dies 0-23 steps
    on (or never, at the depths probed).  Seeds: those k-mers, and k-mers
    along the line (walks that meet the variants on later hops, read or
    handed off)."""
    key = str(dev)
    if key not in _tail_graphs:
        rng = np.random.default_rng(11)
        k, L = 25, 160
        line = rng.integers(0, 4, L, dtype=np.uint8)
        reads = [line[i : i + 60] for i in range(0, L - 59, 5) for _ in range(3)] + [line[-60:]] * 3
        starts = list(range(L - k - 23, L - k + 1)) + [60, 75]
        for p in starts:
            r = np.full(60, 4, np.uint8)
            seg = line[p : p + 60].copy()
            seg[0] = (seg[0] + 1 + p % 3) % 4
            r[: len(seg)] = seg
            reads.append(r)
        cfg = dbg.GraphConfig(k=k, stranded=False, dbgbf=BloomConfig(18, 2), cbf=CountingConfig(18, 2, dtype="mf8"),
                              pkbf=BloomConfig(18, 2))
        state = dbg.build_step(dbg.make_graph(cfg, device=dev), cfg, torch.from_numpy(np.stack(reads)).to(dev))
        seeds = np.stack([line[p : p + k] for p in starts + list(range(0, 90, 3))])
        _tail_graphs[key] = (cfg, state, seeds)
    return _tail_graphs[key]


def _naive_probe_walks(dev, graph_kind, tip_probe_depth, back, max_len=25 + 700, bounds=(100, 700)):
    """Naive walks on the sim graph of the naive cases (its seeds and
    reads' k-mers) or on ``_tail_graph``, per-lane floors and bounds."""
    from rnabloom_tpu_torch.graph import traverse

    if graph_kind == "tail":
        cfg, graph, rows = _tail_graph(dev)
    else:
        cfg, graph, _, _, _, _ = _naive_walks(dev, "mf8_right")
        rows = _naive_graphs[("sim", "mf8", False, False, 2)][2]
    wcfg = traverse.WalkConfig(max_len=max_len, check_back_branches=back, tip_probe_depth=tip_probe_depth)
    st = traverse.make_walks(cfg, wcfg, rows, device=dev)
    rng = np.random.default_rng(tip_probe_depth)
    min_cov, bound = traverse.lane_args(
        st, rng.choice([1.0, 1.0, 2.0, 0.5], size=st.pos.shape[0]).astype(np.float32),
        rng.integers(*bounds, size=st.pos.shape[0]).astype(np.int32),
    )
    return graph, cfg, wcfg, st, min_cov, bound


@pytest.mark.parametrize("graph_kind", ["sim", "tail"])
@pytest.mark.parametrize("back", [True, False])
@pytest.mark.parametrize("tip_probe_depth", [1, 2, 3, 4, 5, 8, 24])
def test_naive_kernel_probe_depths_match_plain(cuda, graph_kind, back, tip_probe_depth):
    """Probe depths 1-5, 8 and k - 1: an odd or even number of steps, so a
    probe's last round takes one step or two; on the tail graph the
    variant probes' descent dies on every step of a round, the first and
    the second; back-branch checks on and off; and the superstep caps."""
    walks = _naive_probe_walks(cuda, graph_kind, tip_probe_depth, back)
    kern = _naive_kernel_and_plain(*walks)
    assert int(kern.hops.sum()) > 0
    _naive_kernel_and_plain(*walks, superstep_hops=3, max_supersteps=5)


@pytest.mark.parametrize(
    "max_len,bounds", [(107, (100, 500)), (108, (100, 500)), (525, (1, 14))],
    ids=["max_len_even", "max_len_odd", "small_bounds"],
)
@pytest.mark.parametrize("graph_kind", ["sim", "tail"])
def test_naive_kernel_full_on_either_hop(cuda, max_len, bounds, graph_kind):
    """FULL at max_len - 1 after an even or an odd number of hops, and at
    hop bounds of 1-13: on a hop that read or was handed its counts, by a
    hop or by a resolve."""
    from rnabloom_tpu_torch.graph import traverse

    kern = _naive_kernel_and_plain(*_naive_probe_walks(cuda, graph_kind, 8, True, max_len, bounds))
    assert int((kern.status == traverse.FULL).sum()) > 0


@pytest.mark.parametrize("period", [37, 38])
@pytest.mark.parametrize("tip_probe_depth", [3, 8])
def test_naive_kernel_cycle_on_either_hop(cuda, period, tip_probe_depth):
    """CYCLE after an odd or an even number of hops."""
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, frags, lens = _cycle_graph(period, cuda)
    wcfg = traverse.WalkConfig(max_len=600, check_back_branches=True, tip_probe_depth=tip_probe_depth)
    st = traverse.make_walks(cfg, wcfg, frags, lens, device=cuda)
    min_cov, bound = traverse.lane_args(st, 1.0, 500)
    kern = _naive_kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound)
    assert int((kern.status == traverse.CYCLE).sum()) > 0


def _tipped_cycle_walks(dev):
    """A sequence repeating a 50-base unit, with a 3-k-mer tip (a changed
    base, then the read ends) off the unit's k-mer at offset 20; seeds at
    every offset.  A walk from offset 22 resolves the tip at offset 20
    after a lap and hands its choice on; the next hop comes back to the
    seed: CYCLE right after a resolve's hand-off."""
    from rnabloom_tpu_torch.graph import traverse

    rng = np.random.default_rng(50)
    k, P, b = 25, 50, 20
    unit = rng.integers(0, 4, P, dtype=np.uint8)
    seq = np.tile(unit, 8)
    reads = [seq[s : s + 100] for _ in range(3) for s in range(0, len(seq) - 99, 10)]
    tip = np.full(100, 4, np.uint8)
    tip[: k + 2] = seq[P + b : P + b + k + 2]
    tip[k] = (tip[k] + 1) % 4  # the base after the k-mer at offset b, changed
    reads += [tip] * 2
    cfg = dbg.GraphConfig(k=k, stranded=False, dbgbf=BloomConfig(18, 2), cbf=CountingConfig(18, 2, dtype="mf8"),
                          pkbf=BloomConfig(18, 2))
    graph = dbg.build_step(dbg.make_graph(cfg, device=dev), cfg, torch.from_numpy(np.stack(reads)).to(dev))
    wcfg = traverse.WalkConfig(max_len=600, check_back_branches=True, tip_probe_depth=8)
    st = traverse.make_walks(cfg, wcfg, np.stack([seq[P + o : P + o + k] for o in range(P)]), device=dev)
    min_cov, bound = traverse.lane_args(st, 1.0, 500)
    return graph, cfg, wcfg, st, min_cov, bound


def test_naive_kernel_cycle_after_a_resolve(cuda):
    from rnabloom_tpu_torch.graph import traverse

    kern = _naive_kernel_and_plain(*_tipped_cycle_walks(cuda))
    assert int((kern.status == traverse.CYCLE).sum()) > 0


@pytest.mark.parametrize("W", [1, 2, 45, 64, 70, 2048, 9000])
def test_naive_kernel_lane_counts(cuda, W):
    """One lane to more lanes than the card holds at once (blocks of two
    lanes: the last ones start as the first finish)."""
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, wcfg, st, _, _ = _naive_walks(cuda, "mf8_right")
    rows = _naive_graphs[("sim", "mf8", False, False, 2)][2]
    st = traverse.make_walks(cfg, wcfg, rows[np.arange(W) % len(rows)], device=cuda)
    st = traverse.take_lanes(st, slice(0, W))
    rng = np.random.default_rng(W)
    min_cov, bound = traverse.lane_args(st, rng.choice([1.0, 2.0], size=W).astype(np.float32),
                                        rng.integers(50, 700, size=W).astype(np.int32))
    kern = _naive_kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound)
    assert kern.pos.shape[0] == W and int(kern.hops.sum()) > 0


def test_naive_walk_refuses_a_ring_and_greedy_back_branches(cuda):
    from rnabloom_tpu_torch.graph import traverse
    from rnabloom_tpu_torch.ops import walk

    cfg, graph, seeds = _walk_graph("mf8", False, False, cuda)
    wcfg = traverse.WalkConfig(max_len=200, pair_ring=64)
    st = traverse.make_walks(cfg, wcfg, seeds, device=cuda)
    min_cov, bound = traverse.lane_args(st, 1.0, 100)
    with pytest.raises(ValueError, match="pair ring"):
        walk.walk_naive(st, graph, cfg, wcfg, min_cov, bound)
    wcfg = traverse.WalkConfig(max_len=200, check_back_branches=True)
    st = traverse.make_walks(cfg, wcfg, seeds, device=cuda)
    with pytest.raises(ValueError, match="naive-mode option"):
        walk.walk_greedy(st, graph, cfg, wcfg, min_cov, bound)


def test_extend_fragments_card_equals_cpu(cuda):
    """-extend's walks (naive with back-branch checks, right, the
    reverse-complement hand-off, left) on the card and on the CPU."""
    from rnabloom_tpu_torch.assembly import fragments
    from rnabloom_tpu_torch.ops import walk

    cfg, graph, seeds = _walk_graph("mf8", False, False, cuda)
    cpu = dbg.GraphState(*(None if t is None else t.cpu() for t in graph))
    frags = [fragments.Fragment(codes=s, min_cov=1.0, length=len(s), connected=True) for s in seeds]
    params = fragments.FragmentParams(bound=300)
    rows = list(range(len(frags)))
    n0 = walk.LAUNCHES["walk_naive"]
    got = fragments._naive_extend_fragments(graph, cfg, list(frags), rows, params)
    assert walk.LAUNCHES["walk_naive"] == n0 + 2
    want = fragments._naive_extend_fragments(cpu, cfg, list(frags), rows, params)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.codes, b.codes)
        assert a.length == b.length


def _screen_on(cuda, cfg, rows, num_hash=2):
    """A screening filter (2^18 lanes) on the card holding ``rows``."""
    from rnabloom_tpu_torch.assembly import transcripts
    from rnabloom_tpu_torch.bloom import filters

    scfg = BloomConfig(18, num_hash)
    return scfg, transcripts.screen_add(filters.make_bloom(scfg, device=cuda), scfg, cfg, rows)


def test_gap_rewalk_walks_match_plain(cuda):
    """The greedy walk batch of a gap re-walk: k-mer seeds in a power-of-two
    lane count, a per-lane bound (0 on the padded lanes), ``max_len = k +
    max_ext`` with ``max_ext`` a power of two of at least 64."""
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, seeds = _walk_graph("mf8", False, False, cuda)
    rng = np.random.default_rng(4)
    n = 45
    wcfg = traverse.WalkConfig(max_len=25 + 128, lookahead=3)
    st = traverse.make_walks(cfg, wcfg, seeds[:n], device=cuda)
    bounds = np.zeros(st.pos.shape[0], np.int32)
    bounds[:n] = rng.integers(1, 128, n)
    min_cov, bound = traverse.lane_args(st, 1.0, bounds)
    kern = _kernel_and_plain(graph, cfg, wcfg, st, min_cov, bound)
    assert int(kern.hops[n:].sum()) == 0 and int(kern.hops[:n].sum()) > 0


@pytest.mark.parametrize("bound", [8, 40])
@pytest.mark.parametrize("num_hash", [2, 3])
def test_depth_probe_walks_match_plain(cuda, bound, num_hash):
    """The depth probes' walks, on the graph and on the screen viewed as an
    mf8 graph (lanes 0/1, the screen's num_hash): seeds padded with all-A
    rows (live walks), ``max_len = 1 << max(6, (k + bound).bit_length())``."""
    from rnabloom_tpu_torch.assembly import transcripts
    from rnabloom_tpu_torch.graph import traverse

    cfg, graph, seeds = _walk_graph("mf8", False, False, cuda)
    tx = np.random.default_rng(7).integers(0, 4, size=(24, 600), dtype=np.uint8)  # the graph's transcripts
    scfg, screen = _screen_on(cuda, cfg, tx[:12], num_hash)
    sgraph, pcfg = transcripts._screen_as_graph(screen, scfg, cfg)
    assert sgraph.cbf is screen and pcfg.cbf.dtype == "mf8" and pcfg.cbf.num_hash == num_hash
    rows = np.zeros((32, 25), np.uint8)  # 20 seeds (12 of them screened), then all-A rows
    rows[:20] = seeds[:20]
    wcfg = traverse.WalkConfig(max_len=1 << max(6, (25 + bound).bit_length()), lookahead=3)
    for g, c in ((graph, cfg), (sgraph, pcfg)):
        st = traverse.make_walks(c, wcfg, rows, device=cuda)
        min_cov, bd = traverse.lane_args(st, 1.0, bound)
        _kernel_and_plain(g, c, wcfg, st, min_cov, bd)


def test_stage3_screen_and_probes_card_equal_cpu(cuda):
    """``screen_represented`` with the graph (its gap re-walks and tip
    probes) and ``_depth_probe`` on the screen as a graph, card against
    CPU; the card's calls launch the walk kernel."""
    from rnabloom_tpu_torch.assembly import transcripts
    from rnabloom_tpu_torch.ops import walk

    cfg, graph, seeds = _walk_graph("mf8", False, False, cuda)
    cpu = dbg.GraphState(*(None if t is None else t.cpu() for t in graph))
    rng = np.random.default_rng(5)
    tx = rng.integers(0, 4, size=(8, 400), dtype=np.uint8)
    rows = np.full((16, 512), 4, np.uint8)
    rows[:8, :400] = tx
    for i in range(8, 16):  # errors clustered inside, and at the edges
        rows[i, :400] = tx[i - 8]
        for p in (200, 212, 2, 396):
            rows[i, p] = (rows[i, p] + 1) % 4
    lens = np.full(16, 400)
    scfg, screen = _screen_on(cuda, cfg, rows[:8])
    n0 = walk.LAUNCHES["walk_greedy"]
    got = transcripts.screen_represented(screen, scfg, cfg, rows, lens, transcripts.TranscriptParams(), graph=graph)
    want = transcripts.screen_represented(screen.cpu(), scfg, cfg, rows, lens, transcripts.TranscriptParams(),
                                          graph=cpu)
    np.testing.assert_array_equal(got, want)
    sgraph, pcfg = transcripts._screen_as_graph(screen, scfg, cfg)
    sgraph_cpu, _ = transcripts._screen_as_graph(screen.cpu(), scfg, cfg)
    probe = [tx[i, 100:125] for i in range(8)]
    np.testing.assert_array_equal(transcripts._depth_probe(sgraph, pcfg, probe, 50),
                                  transcripts._depth_probe(sgraph_cpu, pcfg, probe, 50))
    assert walk.LAUNCHES["walk_greedy"] > n0 + 1


def test_stage3_card_equals_cpu(cuda, tmp_path):
    """``-stage 3 -norr`` on the card and on the CPU: every output file
    byte-identical but report.json's elapsed_s."""
    import json
    import os

    from rnabloom_tpu_torch import cli
    from rnabloom_tpu_torch.ops import walk
    from rnabloom_tpu_torch.utils import pesim

    left, right = str(tmp_path / "r_1.fq"), str(tmp_path / "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=11, num_transcripts=20, tx_len=(500, 1500), num_pairs=600)
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = str(tmp_path / dev)
        n0 = walk.launch_counts()
        cli.run(["-left", left, "-right", right, "-revcomp-right", "-o", outs[dev], "-stage", "3", "-norr",
                 "-mem", "0.00390625", "-batch", "1024", "-sample", "300", "-bound", "200", "--device", dev])
        if dev == "cuda":
            assert walk.LAUNCHES["walk_pair"] > n0["walk_pair"]
    for root, _, files in os.walk(outs["cpu"]):
        for f in files:
            a = os.path.join(root, f)
            with open(a, "rb") as fa, open(a.replace(outs["cpu"], outs["cuda"], 1), "rb") as fb:
                x, y = fa.read(), fb.read()
            if f.endswith("report.json"):
                x, y = json.loads(x), json.loads(y)
                x.pop("elapsed_s"), y.pop("elapsed_s")
            assert x == y, a


def _lr_reads(seed=0, n_tx=6, cov=6):
    from rnabloom_tpu_torch.utils import lrsim, seq as sequtils

    rng = np.random.default_rng(seed)
    tx = lrsim.simulate_transcriptome(rng, n_tx, (400, 1500))
    reads = [sequtils.encode(r) for r in lrsim.simulate_reads(rng, tx, coverage=cov, err=0.07)]
    for i in range(0, len(reads), 5):  # N and the 255 of a flipped N
        reads[i][rng.choice(len(reads[i]), 3, replace=False)] = 4 if i % 2 else 255
    return reads + [reads[0][:n].copy() for n in (10, 25, 63, 64, 65, 86, 87, 88, 255, 256, 257)]


@pytest.mark.parametrize("k,stranded", [(25, False), (35, False), (21, True), (11, False)])
def test_lr_kmer_keys_kernel_matches_plain(cuda, k, stranded):
    from rnabloom_tpu_torch.ops import lr_keys

    reads = _lr_reads()
    n0 = lr_keys.LAUNCHES["lr_kmer_keys"]
    got = lr_keys.kmer_keys(reads, k, stranded, device=cuda)
    assert lr_keys.LAUNCHES["lr_kmer_keys"] == n0 + 1
    want = lr_keys.kmer_keys_plain(reads, k, stranded, device=cuda)
    assert len(got) == len(want) and sum(w.size for w in want) > 1000
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("k,n,w_min,w_max,stranded", [(25, 3, 11, 50, False), (15, 2, 5, 9, False),
                                                      (25, 3, 11, 50, True), (11, 4, 3, 8, False)])
def test_lr_randstrobe_kernel_matches_plain(cuda, k, n, w_min, w_max, stranded):
    from rnabloom_tpu_torch.ops import lr_keys, strobemer

    reads = _lr_reads(1)
    n0 = strobemer.LAUNCHES["lr_randstrobe_keys"]
    got = lr_keys.strobemer_keys(reads, k, n, w_min, w_max, stranded, device=cuda)
    assert strobemer.LAUNCHES["lr_randstrobe_keys"] == n0 + 1
    want = lr_keys.strobemer_keys_plain(reads, k, n, w_min, w_max, stranded, device=cuda)
    assert len(got) == len(want) and sum(w.size for w in want) > 1000
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _tile_edge_reads(k, min_len, seed=11):
    """Reads where the long-read kernels' tiles bite: one of 20,000 bases
    (several tiles of both kernels), empty reads, a run of reads shorter
    than k filling more than a k-mer tile, one of reads of k to min_len - 1
    bases filling more than a randstrobe tile, reads of every length from
    k - 1 to min_len + 1, lrsim reads; then codes 4 and 255 on every tile
    edge of both kernels (the last position of a tile, the first of the
    next) and inside the halo past it."""
    from rnabloom_tpu_torch.ops import lr_keys

    rng = np.random.default_rng(seed)
    reads = [rng.integers(0, 4, 20_000).astype(np.uint8), np.empty(0, np.uint8)]
    reads += _lr_reads(seed, 3, 3)[:12]
    c = lr_common.kernel_constants()
    kmer_tile, strobe_tile = c["kKmerTile"], c["kStrobeTile"]
    reads += [rng.integers(0, 4, rng.integers(1, k)).astype(np.uint8) for _ in range(2 * kmer_tile // max(k // 2, 1))]
    reads += [np.empty(0, np.uint8)] * 2
    reads += [rng.integers(0, 4, rng.integers(k, min_len)).astype(np.uint8)
              for _ in range(2 * strobe_tile // ((k + min_len) // 2))]
    reads += [rng.integers(0, 4, n).astype(np.uint8) for n in range(k - 1, min_len + 2)]
    bounds = np.concatenate([[0], np.cumsum([len(r) for r in reads])])
    total = int(bounds[-1])
    marks = [g for t, halo in ((kmer_tile, k // 2), (strobe_tile, 40)) for edge in range(t, total, t)
             for g in (edge - 1, edge, edge + halo) if g < total]
    for j, g in enumerate(marks):
        i = int(np.searchsorted(bounds, g, side="right")) - 1
        reads[i][g - bounds[i]] = (4, 255)[j % 2]
    assert lr_keys.strobemer_min_len(k, 3, 11, 50) > 0
    return reads


@pytest.mark.parametrize("k,stranded", [(64, False), (64, True), (11, False), (25, True)])
def test_lr_kmer_keys_kernel_tile_edges(cuda, k, stranded):
    """The k-mer kernel's full 64-bit hashes and flags equal the plain
    hash's at every position of reads where its tiles bite, and its keys the
    plain keys."""
    from rnabloom_tpu_torch.ops import lr_keys

    reads = _tile_edge_reads(k, lr_keys.strobemer_min_len(k, 3, 11, 50))
    codes, offsets, _ = lr_keys.pack(reads, cuda)
    assert codes.numel() > 8 * lr_common.kernel_constants()["kKmerTile"]
    h, v = lr_keys.kmer_hashes(codes, offsets, k, stranded)
    want_h, want_v = lr_common.ragged_plain(reads, k, stranded, cuda)
    torch.cuda.synchronize()
    assert torch.equal(v, want_v) and torch.equal(h, want_h)
    assert 0 < int(v.sum()) < v.numel() - 1000
    got = lr_keys.kmer_keys(reads, k, stranded, device=cuda)
    for g, w in zip(got, lr_keys.kmer_keys_plain(reads, k, stranded, device=cuda)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("k,n,w_min,w_max,stranded", [
    (25, 3, 11, 50, False), (25, 3, 11, 50, True), (11, 4, 3, 8, False), (11, 4, 3, 8, True),
    (25, 2, 5, 3600, False),  # windows past the kernel's staged positions
])
def test_lr_randstrobe_kernel_tile_edges(cuda, k, n, w_min, w_max, stranded):
    """The randstrobe kernel's full 64-bit hashes and flags equal the plain
    version's at every anchor of reads where its tiles bite."""
    from rnabloom_tpu_torch.ops import lr_keys, strobemer

    min_len = lr_keys.strobemer_min_len(k, n, w_min, w_max)
    reads = _tile_edge_reads(k, min_len)
    codes, offsets, lens = lr_keys.pack(reads, cuda)
    m = np.where(lens >= min_len, strobemer.num_anchors(lens, k, n, w_min, w_max), 0)
    aoff = torch.from_numpy(np.concatenate([[0], np.cumsum(m)]).astype(np.int64)).to(cuda)
    h, v = lr_keys.kmer_hashes(codes, offsets, k, stranded)
    n0 = strobemer.LAUNCHES["lr_randstrobe_keys"]
    sh, ok = strobemer.randstrobe_hashes(h, v, offsets, aoff, k, n, w_min, w_max)
    assert strobemer.LAUNCHES["lr_randstrobe_keys"] == n0 + 1
    want_h, want_ok = lr_common.ragged_plain(reads, k, stranded, cuda, (n, w_min, w_max))
    torch.cuda.synchronize()
    assert torch.equal(ok, want_ok) and torch.equal(sh, want_h)
    assert 1000 < int(ok.sum()) < ok.numel()


def test_lr_randstrobe_refuses_bad_layouts(cuda):
    """The randstrobe wrapper raises on offsets or anchor counts the kernel
    does not take (offsets not from 0, more anchors than k-mers)."""
    from rnabloom_tpu_torch.ops import lr_keys, strobemer

    codes, offsets, _ = lr_keys.pack(_lr_reads()[:3], cuda)
    h, v = lr_keys.kmer_hashes(codes, offsets, 25, False)
    lens = offsets.diff()
    good = torch.cat([offsets[:1], (lens - 24).clamp(min=0).cumsum(0)])
    strobemer.randstrobe_hashes(h, v, offsets, good, 25, 3, 11, 50)
    for bad_offsets, bad_aoff in ((offsets + 1, good), (offsets, good + torch.arange(4, device=cuda))):
        with pytest.raises(ValueError, match="anchors"):
            strobemer.randstrobe_hashes(h, v, bad_offsets, bad_aoff, 25, 3, 11, 50)


VOTE_FULL = (3423, 3938, 2048, 3938)  # phase 10's run (i) 7 times over: its unitigs and first batch


@pytest.mark.parametrize("shape,case,min_depth", [
    ((5, 90, 40, 50), "overhang", 2), ((64, 3000, 2048, 4000), "overhang", 2), ((1, 7, 3, 5), "overhang", 1),
] + [
    ((6, 300, 80, 120), case, d) for case in lr_common.VOTE_CASES for d in (0, 1, 3)  # L under one tile
] + [
    ((8, 5000, 600, 2500), case, 2) for case in lr_common.VOTE_CASES  # L not a multiple of the tile
] + [
    ((2, 2100, 5000, 300), "one_unitig", 2),  # 5,000 reads on one unitig: two windows of the read list
    ((2200, 4200, 5000, 300), "one_unitig", 1),  # a block a unitig over three tiles, each refilling its list
    ((2200, 4200, 2000, 300), "untouched", 0),  # a block a unitig, its list kept over its tiles
    ((600, 4200, 2000, 300), "overhang", 2),  # two blocks a unitig, over two tiles and one
    (VOTE_FULL, "overhang", 2),
    ((1, 7, 0, 5), "overhang", 0),  # no read: every cell on a base becomes A
])
def test_consensus_vote_kernel_matches_plain(cuda, shape, case, min_depth):
    """The vote kernel's polished codes and depths equal the plain
    version's in every cell, on ``lr_common.vote_case``'s edge cases at
    shapes where its tiles and read lists bite."""
    from rnabloom_tpu_torch.ops import consensus_vote as cv

    U, L, R, Lr = shape
    args = [torch.from_numpy(a).to(cuda) for a in lr_common.vote_case(case, U, L, R, Lr, seed=U + R)]
    n0 = cv.LAUNCHES["consensus_vote"]
    kp, kd = cv.consensus_vote(*args, min_depth)
    assert cv.LAUNCHES["consensus_vote"] == n0 + 1
    pp, pd = cv.consensus_vote_plain(*args, min_depth)
    torch.cuda.synchronize()
    assert torch.equal(kp, pp) and torch.equal(kd, pd)


def test_consensus_vote_allocates_no_vote_table(cuda):
    """At the full-size shape a call allocates its outputs (5 B a cell) and
    no U * L * 4 int32 vote table: the peak stays under 6 B a cell above
    the inputs."""
    from rnabloom_tpu_torch.ops import consensus_vote as cv

    U, L, R, Lr = VOTE_FULL
    args = [torch.from_numpy(a).to(cuda) for a in lr_common.vote_case("overhang", U, L, R, Lr)]
    cv.consensus_vote(*args, 2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    polished, depth = cv.consensus_vote(*args, 2)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < U * L * 6
    assert int(depth.sum()) > 0


def test_long_card_equals_cpu(cuda, tmp_path):
    """-long and -long -lrsub (strobemers, then k-mers) on the card and on
    the CPU: every output file byte-identical; the card run launches the
    long-read kernels."""
    import os

    from rnabloom_tpu_torch import cli
    from rnabloom_tpu_torch.ops import lr_keys, strobemer
    from rnabloom_tpu_torch.utils import seq as sequtils

    path = str(tmp_path / "lr.fa")
    with open(path, "w") as f:
        for i, r in enumerate(_lr_reads(2, 8, 8)):
            f.write(f">r{i}\n{sequtils.decode(r)}\n")
    for extra in ([], ["-lrsub", "5,11,0,50"], ["-lrsub", "5,25,0"]):
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = str(tmp_path / f"{dev}{len(extra)}{extra[-1][-1] if extra else ''}")
            n0 = (lr_keys.LAUNCHES["lr_kmer_keys"], strobemer.LAUNCHES["lr_randstrobe_keys"])
            cli.run(["-long", path, "-o", outs[dev], "-mem", "0.00390625", "--device", dev] + extra)
            if dev == "cuda" and extra:
                assert lr_keys.LAUNCHES["lr_kmer_keys"] > n0[0]
                assert (strobemer.LAUNCHES["lr_randstrobe_keys"] > n0[1]) == (len(extra[1].split(",")) == 4)
        names = sorted(os.listdir(outs["cpu"]))
        assert names == sorted(os.listdir(outs["cuda"])) and "rnabloom.transcripts.fa" in names
        for name in names:
            with open(os.path.join(outs["cpu"], name), "rb") as a, open(os.path.join(outs["cuda"], name), "rb") as b:
                assert a.read() == b.read(), name


# ---- exact counts: the max op, the exact-count build, gated walks, the oracle ----

MAX_DTYPES = {"int32": (torch.int32, np.int32, 1 << 20), "u16": (torch.int16, np.int16, 1 << 16),
              "mf8": (torch.uint8, np.uint8, 128)}


def _max_batch(case, dtype, rng):
    """(table, idx, values) of one max edge case on the CPU."""
    tdt, ndt, hi = MAX_DTYPES[dtype]
    size = 1 << 20
    numel = size + 1 if case != "ragged_end" else size + 3
    table = rng.integers(0, hi, numel).astype(np.int64).astype(ndt)
    if case == "fresh":
        table[:] = 0
    n = {"empty": 0, "one_index": 1}.get(case, 300_000)
    idx = rng.integers(0, size, n)
    vals = rng.integers(0, hi, n).astype(np.int64)
    if case == "mixed":
        idx[:100_000] = 4242  # one cell, many values
        idx[100_000:101_000] = size  # the trash cell
        idx[101_000:102_000] = numel + 17  # dropped
        idx[102_000:102_100] = -5  # dropped
    elif case == "already_larger":
        table[idx[:1000]] = np.array(hi - 1).astype(ndt)
    elif case == "high_u16":
        vals[::2] = 40000
        vals[1::2] = 30000
        idx[: n // 2] = idx[n // 2 : 2 * (n // 2)]
    elif case == "ragged_end":  # the last cells, whose 32-bit word reaches past a uint8 table
        idx[:3000] = numel - 1 - np.arange(3000) % 4
    elif case == "one_word":  # the cells of one 32-bit word (four uint8, two uint16), spread over tiles
        idx[::3] = 800 + rng.integers(0, 4, len(idx[::3]))
    return torch.from_numpy(table), torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(vals.astype(ndt))


@pytest.mark.parametrize("case", ["mixed", "fresh", "already_larger", "high_u16", "ragged_end", "one_word", "empty",
                                  "one_index"])
@pytest.mark.parametrize("dtype", sorted(MAX_DTYPES))
def test_max_kernel_matches_plain(cuda, dtype, case):
    """Duplicates, a 10^5-value cell, the trash cell, dropped indices,
    unsigned u16 values >= 32,768 against smaller ones on the same cells,
    cells already larger, the last cells of a table, the cells of one
    word in every tile; tables byte-identical to the plain version's, one
    launch a call."""
    table, idx, vals = _max_batch(case, dtype, np.random.default_rng(len(case)))
    kern, plain = table.to(cuda), table.clone()
    before = ci.launch_counts()["max"]
    ci.cell_insert(kern, idx.to(cuda), "max", values=vals.to(cuda))
    ci.cell_insert_plain(plain, idx, "max", values=vals)
    torch.cuda.synchronize()
    assert ci.launch_counts()["max"] == before + 1
    assert torch.equal(kern.cpu(), plain)


# case -> (cells log2, scratch log2, hashes a key, valid: None, a key's or a lane's)
CONSERVATIVE_CASES = {"spread": (20, 14, 2, "key"), "collide": (10, 10, 3, "key"), "no_masks": (16, 12, 2, None),
                      "lane_valid": (16, 12, 4, "lane"), "empty": (12, 10, 2, "key")}


@pytest.mark.parametrize("case", sorted(CONSERVATIVE_CASES))
@pytest.mark.parametrize("dtype", sorted(MAX_DTYPES))
def test_conservative_kernel_matches_plain(cuda, dtype, case):
    """The conservative update on prefilled tables (a 2^10-cell one where
    keys collide heavily), over salted batches with repeated keys,
    dec_first and invalid keys or lanes: the table equals the plain
    version's on the CPU after every batch, each of its two launches once
    a call.  h = 2 takes the first launch's specialised path, h = 3 and 4
    its loop over any h."""
    from rnabloom_tpu_torch.bloom import filters

    tdt, ndt, hi = MAX_DTYPES[dtype]
    size_log2, scratch_log2, h, valid_kind = CONSERVATIVE_CASES[case]
    rng = np.random.default_rng(size_log2 + h)
    table = torch.from_numpy(rng.integers(0, hi, (1 << size_log2) + 1).astype(np.int64).astype(ndt))
    kern, plain = table.to(cuda), table.clone()
    n = 0 if case == "empty" else 300_000
    for salt in (0, 977, 2**31 + 7):
        vals = rng.integers(-(2**63), 2**63 - 1, size=(n, h), dtype=np.int64)
        if n:
            vals[: n // 5] = vals[0]  # one key 60,000 times
            vals[n // 5 : n // 2] = vals[n // 5 : n // 5 + 1000][rng.integers(0, 1000, n // 2 - n // 5)]
            rng.shuffle(vals)
        hashes = torch.from_numpy(vals)
        valid = None if valid_kind is None else torch.from_numpy(
            rng.random((n, h) if valid_kind == "lane" else n) < 0.9)
        dec = None if valid_kind is None else torch.from_numpy(rng.random(n) < 0.3)
        # the batch's scratch sketch, as counting_increment makes it
        scratch = torch.zeros((1 << scratch_log2) + 1, dtype=torch.int32)
        sidx = filters.bloom_indices(hashes, scratch_log2, filters._bcast_valid(valid, hashes))
        ci.cell_insert_plain(scratch, sidx.reshape(-1), "add")
        before = ci.launch_counts()
        ci.conservative_update(kern, scratch.to(cuda), hashes.to(cuda), size_log2, scratch_log2,
                               None if valid is None else valid.to(cuda), None if dec is None else dec.to(cuda), salt)
        ci.conservative_update_plain(plain, scratch, hashes, size_log2, scratch_log2, valid, dec, salt)
        torch.cuda.synchronize()
        after = ci.launch_counts()
        assert all(after[op] == before[op] + 1 for op in ci.CONSERVATIVE_OPS)
        assert torch.equal(kern.cpu(), plain), salt


@pytest.mark.parametrize("dtype", ["int32", "u16", "mf8"])
def test_exact_build_card_equals_cpu(cuda, dtype):
    """build_step of an exact-count graph with the kernels (set for the
    dbgbf, add for the multiplicity scratch, the conservative update for
    the counters) equals the plain CPU build in every table, over salted
    batches."""
    from rnabloom_tpu_torch.graph import engine

    cfg = dbg.GraphConfig(k=25, stranded=False, dbgbf=BloomConfig(16, 2),
                          cbf=CountingConfig(15, 2, scratch_log2=12, dtype=dtype), pkbf=BloomConfig(16, 2),
                          read_pair_distance=40, exact_counts=True)
    rng = np.random.default_rng(4)
    base = rng.integers(0, 4, size=(256, 100), dtype=np.uint8)
    card = engine.make_graph(cfg, with_rpkbf=True, device=cuda)
    host = engine.make_graph(cfg, with_rpkbf=True, device="cpu")
    before = ci.launch_counts()
    for salt in range(4):
        codes = base[rng.integers(0, 256, size=512)].copy()
        codes[rng.random(codes.shape) < 0.01] = 4
        engine.build_step(card, cfg, codes, add_read_pairs=True, salt=salt)
        engine.build_step(host, cfg, codes, add_read_pairs=True, salt=salt)
    after = ci.launch_counts()
    assert all(after[op] == before[op] + 4 for op in ("add", *ci.CONSERVATIVE_OPS))
    for name in ("dbgbf", "cbf", "rpkbf"):
        assert torch.equal(getattr(card, name).cpu(), getattr(host, name)), name


_gate_graphs = {}
GATE_FIELDS = {"greedy": WALK_FIELDS, "pair": PAIR_FIELDS, "naive": WALK_FIELDS}


def _gate_graph(dtype, exact, dev, num_hash=2, dbg_hash=2, stranded=False, blocked=False):
    """A graph of the walk tests' simulated reads (``stage3_common.WALK_DATA``)
    with both pair-key filters, exact-count or count-min, with its seeds,
    fragment rows and terminators (the k-mers of every 61st read); cached."""
    from rnabloom_tpu_torch.bloom import filters
    from rnabloom_tpu_torch.ops import nthash
    from stage3_common import WALK_DATA

    key = (dtype, exact, num_hash, dbg_hash, stranded, blocked, str(dev))
    if key not in _gate_graphs:
        reads, seeds = WALK_DATA["sim"]()
        cfg = dbg.GraphConfig(k=25, stranded=stranded, dbgbf=BloomConfig(18, dbg_hash),
                              cbf=CountingConfig(18, num_hash, dtype=dtype, blocked=blocked), pkbf=BloomConfig(18, 2),
                              read_pair_distance=40, fragment_pair_distance=60, exact_counts=exact)
        r = torch.from_numpy(reads).to(dev)
        graph = dbg.build_step(dbg.make_graph(cfg, with_rpkbf=True, with_fpkbf=True, device=dev), cfg, r,
                               add_read_pairs=True)
        fh, rh, _, valid = dbg.seq_hashes(cfg, r)
        dbg.add_fragment_pair_kmers(graph, cfg, fh, rh, valid)
        tcfg = BloomConfig(16, 2)
        term = filters.make_bloom(tcfg, device=dev)
        fh, rh, valid = nthash.rolling_hash(r[::61], 25, stranded)
        q = fh if stranded else nthash.canonical(fh, rh)
        filters.bloom_add(term, tcfg, nthash.multi_hash(q, 25, 2), valid)
        frags = reads[::37][:56, :100].copy()
        _gate_graphs[key] = (cfg, graph, seeds, reads, frags, tcfg, term)
    return _gate_graphs[key]


def _gate_walks(cuda, mode, graph_key, term, lookahead=3):
    from rnabloom_tpu_torch.graph import traverse
    from stage3_common import naive_walk_rows

    cfg, graph, seeds, reads, frags, tcfg, lanes = _gate_graph(*graph_key[:2], cuda, *graph_key[2:])
    kw = dict(max_len=25 + 700, lookahead=lookahead, use_terminators=term, term_cfg=tcfg if term else None)
    lens = None
    if mode == "pair":
        rows, lens = frags, np.full(len(frags), 100)
        kw.update(max_len=25 + 400, pair_ring=64)
    elif mode == "naive":
        rows = naive_walk_rows("sim", reads, seeds, cfg.stranded)
        kw.update(check_back_branches=True, tip_probe_depth=8)
    else:
        rows = seeds
    wcfg = traverse.WalkConfig(**kw)
    st = traverse.make_walks(cfg, wcfg, rows, lens, device=cuda)
    rng = np.random.default_rng(8)
    W = st.pos.shape[0]
    min_cov, bound = traverse.lane_args(st, rng.choice([1.0, 2.0, 3.5], size=W).astype(np.float32),
                                        rng.integers(100, 700, size=W).astype(np.int32))
    return cfg, graph, wcfg, st, min_cov, bound, lanes if term else None


def _gated_kernel_and_plain(cuda, mode, graph_key, term, lookahead=3):
    from rnabloom_tpu_torch.graph import traverse
    from rnabloom_tpu_torch.ops import walk

    cfg, graph, wcfg, st, min_cov, bound, lanes = _gate_walks(cuda, mode, graph_key, term, lookahead)
    name = f"walk_{mode}"
    n0 = walk.LAUNCHES[name]
    kern = getattr(walk, name)(st, graph, cfg, wcfg, min_cov, bound, terminators=lanes)
    plain = getattr(walk, f"{name}_plain")(st, graph, cfg, wcfg, min_cov, bound, terminators=lanes)
    torch.cuda.synchronize()
    assert walk.LAUNCHES[name] == n0 + 1
    for f in GATE_FIELDS[mode]:
        assert torch.equal(getattr(kern, f), getattr(plain, f)), f
    assert int(kern.hops.sum()) > 0
    if term:
        live = st.status == traverse.ACTIVE
        stops = kern.status == traverse.TERM
        assert bool(stops.any()) and bool((live & ~stops).any())
    return kern


GATE_GRAPHS = [("int32", True), ("u16", True), ("mf8", True), ("mf8", False)]


# (graph, terminators): count-min walks without terminators are the tests above
GATE_CASES = [(g, term) for g in GATE_GRAPHS for term in (False, True) if g[1] or term]


@pytest.mark.parametrize("graph_key,term", GATE_CASES,
                         ids=[f"{g[0]}_{'exact' if g[1] else 'cm'}-{'term' if t else 'noterm'}" for g, t in GATE_CASES])
@pytest.mark.parametrize("mode", ["greedy", "pair", "naive"])
def test_gated_walk_kernel_matches_plain(cuda, mode, graph_key, term):
    """The exact-count gate (a count is in dbgbf ? cbf + 1 : 0) over int32,
    u16 and mf8 graphs, and terminators, in each mode of the walk kernel:
    every field equal to the plain loop's; some lanes stop TERM, some not."""
    _gated_kernel_and_plain(cuda, mode, graph_key, term)


@pytest.mark.parametrize("mode", ["greedy", "pair", "naive"])
@pytest.mark.parametrize("graph_key", [("mf8", True, 3, 3), ("int32", True, 2, 5), ("u16", True, 2, 2, True),
                                       ("u16", False, 3, 2), ("int32", False, 2, 2, False, True)],
                         ids=["hash3_generic", "dbgbf_hash5", "u16_stranded", "cm_hash3_generic", "cm_int32_blocked"])
def test_gated_walk_kernel_options_match_plain(cuda, mode, graph_key):
    """Exact graphs off the specialised read: cbf num_hash 3 (the generic
    read), a dbgbf of 5 hashes (lanes past the first round), stranded; and
    the count-min layouts with terminators off the mf8 graph: num_hash 3
    (the generic read) and the blocked int32 layout."""
    _gated_kernel_and_plain(cuda, mode, graph_key, True)


@pytest.mark.parametrize("lookahead", [1, 5])
def test_gated_greedy_lookaheads_match_plain(cuda, lookahead):
    """Lookahead 1 and 5 (the descents) over an exact int32 graph."""
    _gated_kernel_and_plain(cuda, "greedy", ("int32", True), True, lookahead)


def test_oracle_on_the_card_equals_the_golden(cuda):
    """``measure_all(device="cuda")``: the twin graphs on the card, built by
    the insert kernels, the screen's gap re-walks by the walk kernel; the
    dict equals the JAX package's golden."""
    import json
    import os

    from rnabloom_tpu_torch.oracle import divergence
    from rnabloom_tpu_torch.ops import walk

    n0, w0 = ci.launch_counts(), walk.launch_counts()
    got = divergence.measure_all(device=cuda)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "oracle_divergence.json")) as f:
        assert json.loads(json.dumps(got)) == json.load(f)
    n1, w1 = ci.launch_counts(), walk.launch_counts()
    assert all(n1[op] > n0[op] for op in ("set", "add", "conservative")) and w1["walk_greedy"] > w0["walk_greedy"]


@pytest.mark.parametrize("salt", [0, 977])
@pytest.mark.parametrize("base", [1 << 20, (1 << 31) + 5, (1 << 32) - 100])
def test_add_mf8_with_base_matches_plain(cuda, base, salt):
    """add_mf8 keyed by base + index (a shard of a sharded table): the
    kernel equals its plain version, and base 0 is the whole-table insert."""
    rng = np.random.default_rng(11)
    table, idx = _mf8_batch("hot_cell_every_tile", (1 << 20) + 1, rng)
    kern, plain, idx = table.to(cuda), table.to(cuda), idx.to(cuda)
    ci.cell_insert(kern, idx, "add_mf8", salt, base=base)
    ci.cell_insert_plain(plain, idx, "add_mf8", salt, base=base)
    zero = table.to(cuda)
    ci.cell_insert(zero, idx, "add_mf8", salt, base=0)
    torch.cuda.synchronize()
    assert torch.equal(kern, plain)
    assert not torch.equal(kern, zero)  # the key moved with the base


def _mesh_cases():
    return {
        "mf8": CountingConfig(20, 2, dtype="mf8"),
        "u16": CountingConfig(20, 2, dtype="u16"),
        "int32_blocked": CountingConfig(20, 2, blocked=True),
        "exact_int32": CountingConfig(20, 2, scratch_log2=16),
    }


def _mesh_build(cfg, graph, batches):
    from rnabloom_tpu_torch.graph import engine

    for salt, codes in enumerate(batches):
        engine.build_step(graph, cfg, codes, add_read_pairs=True, salt=salt)
    return graph


def _mesh_batches():
    """A random batch, a poly-A-heavy one (its buckets overflow into a
    second round at 8 shards) and a random one with N codes."""
    rng = np.random.default_rng(12)
    a = rng.integers(0, 4, size=(4096, 100), dtype=np.uint8)
    b = rng.integers(0, 4, size=(4096, 100), dtype=np.uint8)
    b[:3000] = 0
    c = rng.integers(0, 4, size=(4000, 100), dtype=np.uint8)  # padded to a multiple of 8 rows
    c[rng.random(c.shape) < 0.01] = 4
    return [a, b, c]


def _assert_mesh_equals_single(mesh_graph, single, cfg):
    from rnabloom_tpu_torch.graph import engine

    host = engine.to_host_state(mesh_graph, cfg)
    for name in ("dbgbf", "cbf", "rpkbf"):
        a, b = getattr(single, name), getattr(host, name)
        assert (a is None) == (b is None), name
        if a is not None:
            trash = cfg.cbf.trash if name == "cbf" else 1
            assert torch.equal(a.cpu()[:-trash], b[:-trash]), name


@pytest.mark.parametrize("case", sorted(_mesh_cases()))
def test_mesh_build_on_one_card_equals_single_device(cuda, case):
    """Build steps on a mesh of 8 shards on one card (the insert kernels on
    every shard, mf8 keyed by the global cell) equal the single-device
    kernel build in every lane outside the trash, and its counts."""
    from rnabloom_tpu_torch.graph import engine
    from rnabloom_tpu_torch.parallel import sharded

    ccfg = _mesh_cases()[case]
    cfg = dbg.GraphConfig(k=25, stranded=False, dbgbf=BloomConfig(20, 2), cbf=ccfg, pkbf=BloomConfig(20, 2),
                          read_pair_distance=40, exact_counts=case.startswith("exact"))
    batches = _mesh_batches()
    mesh = sharded.make_mesh([cuda] * 8)
    before = ci.launch_counts()
    mg = _mesh_build(cfg, engine.make_graph(cfg, with_rpkbf=True, mesh=mesh), batches)
    after = ci.launch_counts()
    single = _mesh_build(cfg, engine.make_graph(cfg, with_rpkbf=True, device=cuda), batches)
    torch.cuda.synchronize()
    op = "max" if cfg.exact_counts else {"mf8": "add_mf8", "u16": "add_u16", "int32": "add"}[ccfg.dtype]
    assert after[op] - before[op] == 8 * len(batches)  # one launch a shard and step
    _assert_mesh_equals_single(mg, single, cfg)
    probes = batches[1][-300:]
    c8, v8 = engine.count_step(mg, cfg, probes)
    c1, v1 = engine.count_step(single, cfg, probes)
    assert torch.equal(c8, c1) and torch.equal(v8, v1)


def test_mesh_build_across_cards_equals_single_device(cuda):
    """One shard a card, over every visible card (a power of two of them,
    at least 2): the routing moves buckets between cards, and the build
    equals the single-device build; the mesh's walks split their lanes over
    the cards and equal the one-card walks."""
    from rnabloom_tpu_torch.graph import engine, traverse

    mesh = engine.make_mesh_if_multi(cuda)
    if mesh is None:
        pytest.skip("needs at least 2 CUDA devices")
    cfg = dbg.GraphConfig(k=25, stranded=False, dbgbf=BloomConfig(20, 2), cbf=CountingConfig(20, 2, dtype="mf8"),
                          pkbf=BloomConfig(20, 2), read_pair_distance=40)
    batches = _mesh_batches()
    mg = _mesh_build(cfg, engine.make_graph(cfg, with_rpkbf=True, mesh=mesh), batches)
    single = _mesh_build(cfg, engine.make_graph(cfg, with_rpkbf=True, device=cuda), batches)
    _assert_mesh_equals_single(mg, single, cfg)
    assert {s.device for s in mg.state.cbf} == set(mesh.devices) and len(mesh.distinct) >= 2
    wcfg = traverse.WalkConfig(max_len=300)
    seeds = batches[0][:1000, :25]
    got = engine.extend_walks(traverse.make_walks(cfg, wcfg, seeds, device=cuda), mg, cfg, wcfg, 1.0, 200)
    want = engine.extend_walks(traverse.make_walks(cfg, wcfg, seeds, device=cuda), single, cfg, wcfg, 1.0, 200)
    for f in WALK_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---- walks over a mesh's shards: the kernel's sharded layouts ----

# (dtype, exact[, num_hash, dbgbf num_hash, stranded, blocked]) of _gate_graph
SHARDED_GRAPHS = {
    "mf8": ("mf8", False), "u16": ("u16", False), "int32": ("int32", False),
    "int32_blocked": ("int32", False, 2, 2, False, True), "mf8_hash3_generic": ("mf8", False, 3),
    "exact_int32": ("int32", True), "exact_mf8": ("mf8", True), "exact_u16_dbgbf_hash5": ("u16", True, 2, 5),
}
SHARDED_CASES = [(g, 8) for g in SHARDED_GRAPHS] + [(g, 2) for g in ("mf8", "int32_blocked", "exact_int32")]


def _sharded_walk_case(cuda, mode, graph_key, mesh):
    """The gate tests' walks of ``mode`` on a graph, and the graph split
    over ``mesh``; the mesh walks' default speculative depth."""
    from rnabloom_tpu_torch.graph import engine
    from rnabloom_tpu_torch.parallel import sharded

    cfg, graph, wcfg, st, min_cov, bound, _ = _gate_walks(cuda, mode, graph_key, False)
    mg = engine.from_host_state(engine.to_host_state(graph, cfg), cfg, mesh)
    return cfg, graph, sharded._with_spec_default(wcfg), st, min_cov, bound, mg


def _sharded_kernel_plain_and_one(cuda, mode, graph_key, mesh):
    """The sharded kernel (one launch a card of the mesh) against the plain
    routed loop and the single-device kernel: every field equal."""
    from rnabloom_tpu_torch.ops import walk

    cfg, graph, wcfg, st, min_cov, bound, mg = _sharded_walk_case(cuda, mode, graph_key, mesh)
    name = f"walk_{mode}_sharded"
    n0 = walk.LAUNCHES[name]
    kern = walk.walk_mesh(mode, st, mg.state, mesh, cfg, wcfg, min_cov, bound)
    torch.cuda.synchronize()
    assert walk.LAUNCHES[name] == n0 + len(mesh.distinct)
    plain = walk.walk_mesh_plain(mode, st, mg.state, mesh, cfg, wcfg, min_cov, bound)
    one = getattr(walk, f"walk_{mode}")(st, graph, cfg, wcfg, min_cov, bound)
    for f in GATE_FIELDS[mode]:
        assert torch.equal(getattr(kern, f), getattr(plain, f)), f
        assert torch.equal(getattr(kern, f), getattr(one, f)), f
    assert int(kern.hops.sum()) > 0
    return kern


@pytest.mark.parametrize("graph,shards", SHARDED_CASES, ids=[f"{g}-{n}shards" for g, n in SHARDED_CASES])
@pytest.mark.parametrize("mode", ["greedy", "pair", "naive"])
def test_sharded_walk_kernel_matches_plain_routed_loop(cuda, mode, graph, shards):
    """Each sharded layout (count-min mf8, u16, int32, blocked int32, the
    generic read; exact int32, mf8, u16 with a dbgbf of 5 hashes) in each
    mode, on 8 (and 2) shards of the card: the kernel reading the shards in
    place equals the plain routed loop and the single-device kernel."""
    from rnabloom_tpu_torch.parallel import sharded

    _sharded_kernel_plain_and_one(cuda, mode, SHARDED_GRAPHS[graph], sharded.make_mesh([cuda] * shards))


@pytest.mark.parametrize("walk_env,group", [("routed", None), ("grouped", "2"), ("grouped", "4"),
                                            ("grouped", "8")])
def test_mesh_walk_engines_on_one_card_equal_single_device(cuda, monkeypatch, walk_env, group):
    """engine.extend_walks on 8 shards of the card under RNB_MESH_WALK=routed
    and grouped (R = 2, 4, 8), each mode: one launch (every group reads one
    copy of the regrouped shards), the single-device walks; an uneven lane
    count pads (grouped) or raises before any launch (routed)."""
    from rnabloom_tpu_torch.graph import engine, traverse
    from rnabloom_tpu_torch.ops import walk
    from rnabloom_tpu_torch.parallel import sharded

    monkeypatch.setenv("RNB_MESH_WALK", walk_env)
    if group:
        monkeypatch.setenv("RNB_MESH_GROUP", group)
    mesh = sharded.make_mesh([cuda] * 8)
    for mode in ("greedy", "pair", "naive"):
        cfg, graph, wcfg, st, min_cov, bound, _ = _gate_walks(cuda, mode, ("mf8", False), False)
        mg = engine.from_host_state(engine.to_host_state(graph, cfg), cfg, mesh)
        n0 = walk.launch_counts()
        got = engine.extend_walks(st, mg, cfg, wcfg, min_cov, bound, mode=mode)
        want = getattr(walk, f"walk_{mode}")(st, graph, cfg, wcfg, min_cov, bound)
        assert walk.launch_counts()[f"walk_{mode}_sharded"] == n0[f"walk_{mode}_sharded"] + 1
        for f in GATE_FIELDS[mode]:
            assert torch.equal(getattr(got, f), getattr(want, f)), (mode, f)
    odd = traverse.take_lanes(st, slice(0, 60))
    n0 = walk.launch_counts()
    if walk_env == "routed":
        with pytest.raises(ValueError, match="not evenly divisible"):
            engine.extend_walks(odd, mg, cfg, wcfg, 1.0, 300, mode="naive")
        assert walk.launch_counts() == n0
    else:
        got = engine.extend_walks(odd, mg, cfg, wcfg, 1.0, 300, mode="naive")
        want = walk.walk_naive(odd, graph, cfg, wcfg, *traverse.lane_args(odd, 1.0, 300))
        for f in WALK_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_routed_walk_allocates_no_filter(cuda):
    """A routed walk over 8 shards of a 2^26-cell graph allocates nothing
    the size of a filter: its peak above the graph is the walk state's."""
    from rnabloom_tpu_torch.graph import engine, traverse
    from rnabloom_tpu_torch.parallel import sharded

    cfg = dbg.GraphConfig(k=25, stranded=False, dbgbf=BloomConfig(26, 2), cbf=CountingConfig(26, 2, dtype="int32"),
                          pkbf=BloomConfig(26, 2), read_pair_distance=40)
    mesh = sharded.make_mesh([cuda] * 8)
    mg = _mesh_build(cfg, engine.make_graph(cfg, with_rpkbf=True, mesh=mesh), _mesh_batches()[:1])
    wcfg = traverse.WalkConfig(max_len=300)
    st = traverse.make_walks(cfg, wcfg, _mesh_batches()[0][:1024, :25], device=cuda)
    fn = sharded.sharded_extend_walks(mesh, cfg, wcfg, "greedy")
    fn(st, mg.state, 1.0, 200)  # the shard table and decode table, once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    held = torch.cuda.memory_allocated(cuda)
    out = fn(st, mg.state, 1.0, 200)
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size() for t in out if t is not None)
    assert torch.cuda.max_memory_allocated(cuda) - held <= 2 * state_bytes + (1 << 20)
    assert (1 << 26) * 4 // 8 > 4 * state_bytes  # a shard is larger than what the walk allocates


def test_sharded_walks_across_cards_match_plain_and_one_card(cuda, monkeypatch):
    """One shard a card over every visible card (at least 2): the routed and
    grouped (R = 2) walks in each mode, one launch a card, read the other
    cards' shards through peer access and equal the plain routed loop and
    the one-card kernel; without peer access between two cards they raise
    before any launch."""
    from rnabloom_tpu_torch.graph import engine
    from rnabloom_tpu_torch.ops import walk
    from rnabloom_tpu_torch.parallel import sharded

    mesh = engine.make_mesh_if_multi(cuda)
    if mesh is None:
        pytest.skip("needs at least 2 CUDA devices")
    for mode in ("greedy", "pair", "naive"):
        _sharded_kernel_plain_and_one(cuda, mode, ("mf8", False), mesh)
        _sharded_kernel_plain_and_one(cuda, mode, ("int32", True), mesh)
        cfg, graph, wcfg, st, min_cov, bound, mg = _sharded_walk_case(cuda, mode, ("mf8", False), mesh)
        want = getattr(walk, f"walk_{mode}")(st, graph, cfg, wcfg, min_cov, bound)
        monkeypatch.setenv("RNB_MESH_WALK", "grouped")
        monkeypatch.setenv("RNB_MESH_GROUP", "2")
        got = engine.extend_walks(st, mg, cfg, wcfg, min_cov, bound, mode=mode)
        for f in GATE_FIELDS[mode]:
            assert torch.equal(getattr(got, f), getattr(want, f)), (mode, f)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)
    monkeypatch.setattr(walk, "_peers", set())
    n0 = walk.launch_counts()
    with pytest.raises(RuntimeError, match="no peer access"):
        walk.walk_mesh("naive", st, mg.state, mesh, cfg, wcfg, min_cov, bound)
    assert walk.launch_counts() == n0


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kind", ["max", "sum", "sum_u16", "sum_mf8"])
def test_multihost_reducers_on_the_card_equal_the_cpu(cuda, kind, n):
    """The merge's reducers (``parallel.multihost.reduce_tables``) on the
    card: every cell equal to the same reduction on the CPU, over more
    cells than one slice of the reduction (``_CHUNK``)."""
    from rnabloom_tpu_torch.parallel import multihost

    rng = np.random.default_rng(n)
    size = multihost._CHUNK + 4097
    op = {"max": "set", "sum": "add", "sum_u16": "add_u16", "sum_mf8": "add_mf8"}[kind]
    parts = [_table(op, size, rng) for _ in range(n)]
    if kind == "sum":
        parts = [p * 3_000_000 for p in parts]  # sums past 2^31 wrap
    want = multihost.reduce_tables(parts, kind, "cpu")
    got = multihost.reduce_tables(parts, kind, cuda)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
