"""Exact counts in the port (``GraphConfig.exact_counts``: dbgbf bit lanes
and conservative-update counters) against the JAX package's, for int32,
u16 and mf8 counters: ``build_step`` over salted batches with k-mers
repeated within a batch, invalid windows and read-pair keys (every table
bit-identical); ``get_counts``, ``contains``, ``count_step`` and ``fprs``;
checkpoint bytes, both ways.  Also the ``max`` insert's plain version
against a numpy model of a scatter-max, and walks over an exact-count
graph with terminators (a screening filter as walk stops) against the
JAX package's ``extend_walks(terminators=...)`` in each mode.

Small filters (2^13-2^14 cells, a 2^10-cell multiplicity scratch) so that
keys collide, which the conservative update must resolve as the JAX
package does.  The JAX package compiles a program for each configuration,
so each is built once a module and shared."""

import filecmp
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.graph import dbg as jdbg, traverse as jtr
from rnabloom_tpu.utils import checkpoint as jck
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.graph import dbg as tdbg, engine, traverse as ttr
from rnabloom_tpu_torch.ops import cell_insert as ci, nthash
from rnabloom_tpu_torch.utils import checkpoint as tck
from stage3_common import WALK_DATA, WALK_K, naive_walk_rows, pair_walk_rows

torch.set_num_threads(2)

DTYPES = ["int32", "u16", "mf8"]
NAMES = ("dbgbf", "cbf", "rpkbf")

# the JAX package's queries, each one compiled program (op by op they
# compile dozens of small ones); the hashes of every counter's graph by
# one program (they read only k and stranded)
_j_hashes = jax.jit(jdbg.seq_hashes, static_argnums=0)
_j_contains = jax.jit(jdbg.contains, static_argnums=1)
_j_counts = jax.jit(jdbg.get_counts, static_argnums=1)


def _cfgs(dtype):
    kw = dict(k=25, stranded=False, read_pair_distance=40, exact_counts=True)
    return (
        jdbg.GraphConfig(dbgbf=jf.BloomConfig(14, 2), cbf=jf.CountingConfig(13, 2, scratch_log2=10, dtype=dtype),
                         pkbf=jf.BloomConfig(14, 2), **kw),
        tdbg.GraphConfig(dbgbf=tf.BloomConfig(14, 2), cbf=tf.CountingConfig(13, 2, scratch_log2=10, dtype=dtype),
                         pkbf=tf.BloomConfig(14, 2), **kw),
    )


def _batches(n=3):
    """Salted batches of 128 reads drawn from 64 templates (k-mers repeat
    within a batch and across batches), with Ns and one all-N row."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, size=(64, 100), dtype=np.uint8)
    out = []
    for _ in range(n):
        codes = base[rng.integers(0, 64, size=128)].copy()
        codes[rng.random(codes.shape) < 0.01] = 4
        codes[7] = 4
        out.append(codes)
    return base, out


_built = {}


def _hashes(codes):
    """(JAX, port) query hashes of ``codes`` (k and strandedness are those
    of every counter's configuration)."""
    cj, ct = _cfgs(DTYPES[0])
    _, _, bj, _ = _j_hashes(cj, jnp.asarray(codes))
    _, _, bt, _ = tdbg.seq_hashes(ct, torch.from_numpy(codes))
    return bj, bt


def _graphs(dtype):
    """(cfg_j, graph_j, cfg_t, graph_t) after three salted batches."""
    if dtype not in _built:
        cj, ct = _cfgs(dtype)
        sj = jdbg.make_graph(cj, with_rpkbf=True)
        st = engine.make_graph(ct, with_rpkbf=True, device="cpu")
        for salt, codes in enumerate(_batches()[1]):
            sj = jdbg.build_step(sj, cj, jnp.asarray(codes), add_read_pairs=True, salt=salt)
            st = engine.build_step(st, ct, codes, add_read_pairs=True, salt=salt)
        _built[dtype] = (cj, sj, ct, st)
    return _built[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_build_and_queries_match_jax(dtype):
    cj, sj, ct, st = _graphs(dtype)
    for name in NAMES:
        want = np.asarray(getattr(sj, name))
        np.testing.assert_array_equal(getattr(st, name).numpy().view(want.dtype), want, err_msg=name)
    assert int(st.cbf.to(torch.int32).count_nonzero()) > 0
    base, _ = _batches()
    q = np.concatenate([base[:20], np.random.default_rng(9).integers(0, 4, size=(20, 100), dtype=np.uint8)])
    cnt_j, val_j = jdbg.count_step(sj, cj, jnp.asarray(q))
    cnt_t, val_t = engine.count_step(st, ct, q)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert (cnt_t.numpy() > 1).any() and (cnt_t.numpy() == 0).any()  # repeats and absent k-mers
    bj, bt = _hashes(q)
    np.testing.assert_array_equal(tdbg.contains(st, ct, bt).numpy(), np.asarray(_j_contains(sj, cj, bj)))
    np.testing.assert_array_equal(tdbg.get_counts(st, ct, bt).numpy(), np.asarray(_j_counts(sj, cj, bj)))
    assert jdbg.fprs(sj, cj) == tdbg.fprs(st, ct) and "dbgbf" in tdbg.fprs(st, ct)


@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_checkpoint_bytes_equal_jax_and_load_both_ways(dtype, tmp_path):
    cj, sj, ct, st = _graphs(dtype)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jck.save_graph(str(jdir / "g"), sj, cj)
    tck.save_graph(str(tdir / "g"), engine.to_host_state(st, ct), ct)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and "g.dbgbf.npy" in names
    for name in names:
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    # the JAX package's checkpoint loads into the port as into the JAX
    # package, every table equal, and queries as it does there (int32
    # counters come back through MiniFloat)
    lt, lcfg = tck.load_graph(str(jdir / "g"), device="cpu")
    jl, jcfg = jck.load_graph(str(jdir / "g"))
    assert lcfg == ct and jcfg == cj and lt.dbgbf is not None
    for name in NAMES:
        want = np.asarray(getattr(jl, name))
        np.testing.assert_array_equal(getattr(lt, name).numpy().view(want.dtype), want, err_msg=name)
    bj, bt = _hashes(_batches()[0][:16])
    np.testing.assert_array_equal(tdbg.get_counts(lt, lcfg, bt).numpy(), np.asarray(_j_counts(jl, jcfg, bj)))
    np.testing.assert_array_equal(tdbg.contains(lt, lcfg, bt).numpy(), np.asarray(_j_contains(jl, jcfg, bj)))


def _max_model(table: np.ndarray, idx: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Sequential scatter-max in unsigned arithmetic for the narrow cells;
    indices outside the table are dropped."""
    out = table.copy()
    u = out.view(np.uint16) if out.dtype == np.int16 else out
    v = vals.view(np.uint16) if vals.dtype == np.int16 else vals
    for i, x in zip(idx, v):
        if 0 <= i < len(u):
            u[i] = max(u[i], x)
    return out


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16, torch.uint8])
def test_max_plain_matches_a_numpy_model(dtype):
    """Duplicates with different values, the trash cell, dropped indices
    (negative and past the end), u16 values >= 32,768 (compared unsigned:
    40,000 beats 30,000), cells already larger than every value."""
    rng = np.random.default_rng(11)
    size = 1 << 10
    npd = {torch.int32: np.int32, torch.int16: np.int16, torch.uint8: np.uint8}[dtype]
    hi = {torch.int32: 1 << 20, torch.int16: 1 << 16, torch.uint8: 128}[dtype]
    table = rng.integers(0, hi, size + 1).astype(np.int64).astype(npd)
    table[:8] = np.array(hi - 1).astype(npd)  # already larger than every value
    idx = np.concatenate([rng.integers(0, size, 3000), np.full(50, 17), np.full(20, size), [-3, size + 1, 1 << 40],
                          np.arange(8)])
    vals = rng.integers(0, hi - 1, len(idx)).astype(np.int64)
    vals[3000:3050] = rng.integers(0, hi - 1, 50)  # one cell, many values
    if dtype == torch.int16:
        vals[:10], idx[:10] = 40000, 5 + np.arange(10) * 3
        vals[10:20], idx[10:20] = 30000, 5 + np.arange(10) * 3
    vals = vals.astype(npd)
    want = _max_model(table, idx, vals)
    got = torch.from_numpy(table.copy())
    ci.cell_insert(got, torch.from_numpy(idx.astype(np.int64)), "max", values=torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == torch.int16:
        assert (got.numpy()[5:35:3].view(np.uint16) >= 40000).all()


def test_max_checks_its_arguments():
    table = torch.zeros(1025, dtype=torch.int32)
    idx = torch.tensor([0, 5])
    with pytest.raises(TypeError, match="values"):
        ci.cell_insert(table, idx, "max")
    with pytest.raises(TypeError, match="values"):
        ci.cell_insert(table, idx, "max", values=torch.tensor([1, 2], dtype=torch.int16))
    with pytest.raises(TypeError, match="int32, int16 or uint8"):
        ci.cell_insert(torch.zeros(8, dtype=torch.float32), idx, "max", values=torch.zeros(2))
    with pytest.raises(TypeError, match="takes no values"):
        ci.cell_insert(table, idx, "add", values=torch.tensor([1, 2], dtype=torch.int32))


def test_fresh_rebuild_state_drops_the_dbgbf():
    """As the JAX package's (its exact mode ends at stage 1)."""
    _, _, ct, st = _graphs("int32")
    fresh = engine.fresh_rebuild_state(st, ct)
    assert fresh.dbgbf is None and fresh.cbf.shape == st.cbf.shape and int(fresh.cbf.count_nonzero()) == 0


# ---- walks over an exact-count graph, with terminators ----

WALK_FIELDS = ("buf", "pos", "status", "hops", "path_min", "fh", "rh", "hist")
TERM_CFG = (16, 2)  # the terminator filter's size_log2 and num_hash
_walk_graph = {}


def _exact_walk_graph():
    """The walk tests' simulated reads (``stage3_common.WALK_DATA``) in an
    exact-count int32 graph with read-pair keys, built by both packages
    (every table asserted equal), and terminator lanes holding
    the query hashes of the k-mers of every 61st read, as a screening
    filter holds assembled sequence; one build for the three modes."""
    if not _walk_graph:
        reads, seeds = WALK_DATA["sim"]()
        kw = dict(k=WALK_K, stranded=False, read_pair_distance=40, exact_counts=True)
        cj = jdbg.GraphConfig(dbgbf=jf.BloomConfig(18, 2), cbf=jf.CountingConfig(18, 2, dtype="int32"),
                              pkbf=jf.BloomConfig(18, 2), **kw)
        ct = tdbg.GraphConfig(dbgbf=tf.BloomConfig(18, 2), cbf=tf.CountingConfig(18, 2, dtype="int32"),
                              pkbf=tf.BloomConfig(18, 2), **kw)
        gj = jdbg.build_step(jdbg.make_graph(cj, with_rpkbf=True), cj, jnp.asarray(reads), add_read_pairs=True)
        gt = tdbg.build_step(tdbg.make_graph(ct, with_rpkbf=True, device="cpu"), ct, torch.from_numpy(reads),
                             add_read_pairs=True)
        for name in NAMES:
            want = np.asarray(getattr(gj, name))
            np.testing.assert_array_equal(getattr(gt, name).numpy().view(want.dtype), want, err_msg=name)
        tcfg = tf.BloomConfig(*TERM_CFG)
        lanes = tf.make_bloom(tcfg, device="cpu")
        fh, rh, valid = nthash.rolling_hash(torch.from_numpy(reads[::61]), WALK_K, ct.stranded)
        tf.bloom_add(lanes, tcfg, nthash.multi_hash(nthash.canonical(fh, rh), WALK_K, tcfg.num_hash), valid)
        _walk_graph.update(cj=cj, gj=gj, ct=ct, gt=gt, reads=reads, seeds=seeds, tcfg=tcfg, lanes=lanes)
    return _walk_graph


@pytest.mark.parametrize("mode", ["greedy", "pair", "naive"])
def test_terminator_walks_over_exact_graphs_equal_jax(mode):
    """Walks over an exact-count graph (a count is in dbgbf ? cbf + 1 : 0)
    with terminators, against the JAX package's
    ``extend_walks(terminators=...)``, every field equal: greedy from the
    walk seeds, pair from fragment rows with a 64-slot ring (read-pair
    support), naive with
    back-branch checks; some lanes stop TERM and some do not.  Without
    ``use_terminators`` the filter is ignored, as in the JAX package
    (greedy mode)."""
    g = _exact_walk_graph()
    reads, seeds = g["reads"], g["seeds"]
    kw, lens, fields = dict(max_len=WALK_K + 700), None, WALK_FIELDS
    if mode == "pair":
        rows, lens = pair_walk_rows("sim", reads, seeds)
        kw, fields = dict(max_len=WALK_K + 400, pair_ring=64), WALK_FIELDS + ("ring_fh", "ring_rh")
    elif mode == "naive":
        rows = naive_walk_rows("sim", reads, seeds)
        kw.update(check_back_branches=True, tip_probe_depth=8)
    else:
        rows = seeds
    wj = jtr.WalkConfig(**kw, use_terminators=True, term_cfg=jf.BloomConfig(*TERM_CFG))
    wt = ttr.WalkConfig(**kw, use_terminators=True, term_cfg=g["tcfg"])
    j0 = jtr.make_walks(g["cj"], wj, rows, lens)
    s0 = ttr.make_walks(g["ct"], wt, rows, lens, device="cpu")
    min_cov, bound = np.float32(1.0), np.int32(300 if mode == "pair" else 500)
    want = ttr.walk_state_from_limbs(jax.device_get(jtr.extend_walks(
        j0, g["gj"], g["cj"], wj, min_cov, bound, mode=mode, terminators=jnp.asarray(g["lanes"].numpy()))))
    got = ttr.extend_walks(s0, g["gt"], g["ct"], wt, min_cov, bound, mode=mode, terminators=g["lanes"])
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f"{mode} on an exact graph with terminators: {f}"
    live = s0.status == ttr.ACTIVE
    term = got.status == ttr.TERM
    assert bool(term.any()) and bool((live & ~term).any()), torch.bincount(got.status[live], minlength=7)
    assert int(got.hops.sum()) > 0
    if mode == "greedy":
        plain = ttr.extend_walks(s0, g["gt"], g["ct"], ttr.WalkConfig(**kw), min_cov, bound, terminators=g["lanes"])
        assert not bool((plain.status == ttr.TERM).any())
