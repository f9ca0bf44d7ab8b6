"""The port's stage-3 transcript assembly (rnabloom_tpu_torch/assembly/
transcripts.py) against the JAX package's, on the CPU.

A graph of simulated reads (16 transcripts at uneven depth, 30% of reads
with one substitution) with the read-pair keys (distance 40) and the
fragment-pair keys of the same reads (distance 60), built by both packages
(tables asserted equal).  Fragments: read rows cut to several lengths, one
empty row.  A screening filter (2^18 lanes, 2 hashes) holding transcripts
0-5, filled by both packages' ``screen_add`` (bit-identical).

Held equal: the extension (at stage 3's own sizes and at a short walk with
a ring shorter than a fragment); ``screen_represented`` on rows that are
assembled, carry substitutions, indels or clustered or edge errors, are
novel, half novel or chimeric, with and without the graph and the chimera
flags; the five scenarios of ``tests/test_screen_rewalk.py``;
``sequential_dedup``; ``break_check`` with ``-nofc`` on and off;
``_depth_probe`` on the graph and on the screen viewed as a graph;
``branch_free_batch``; ``screen_template_switch`` (stranded); and
``assemble_transcripts_batch`` over three batches in turn (transcripts,
shorts and the screen's bits) for the default and each option, and on a
graph built so that the blunt-end screen drops a fragment.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import transcripts as jtx
from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.graph import dbg as jdbg
from rnabloom_tpu_torch.assembly import transcripts as ttx
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.graph import dbg as tdbg
from rnabloom_tpu_torch.utils import seq as tseq
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

K = 25


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(7)
    tx = rng.integers(0, 4, size=(16, 600), dtype=np.uint8)
    tx[1, :200] = tx[0, :200]
    reads = []
    for t, depth in zip(tx, rng.integers(1, 9, size=16)):
        for _ in range(depth):
            for s in range(0, 500, 20):
                r = t[s : s + 100].copy()
                if rng.random() < 0.3:
                    r[rng.integers(100)] = rng.integers(4)
                reads.append(r)
    reads = np.stack(reads)
    kw = dict(k=K, stranded=False, read_pair_distance=40, fragment_pair_distance=60)
    cj = jdbg.GraphConfig(dbgbf=jf.BloomConfig(18, 2), cbf=jf.CountingConfig(18, 2, dtype="mf8"),
                          pkbf=jf.BloomConfig(18, 2), **kw)
    ct = tdbg.GraphConfig(dbgbf=tf.BloomConfig(18, 2), cbf=tf.CountingConfig(18, 2, dtype="mf8"),
                          pkbf=tf.BloomConfig(18, 2), **kw)
    gj = jdbg.build_step(jdbg.make_graph(cj, with_rpkbf=True, with_fpkbf=True), cj, jnp.asarray(reads),
                         add_read_pairs=True)
    gj = jdbg.rebuild_step(gj, cj, jnp.asarray(reads), salt=1)
    gt = tdbg.build_step(tdbg.make_graph(ct, with_rpkbf=True, with_fpkbf=True, device="cpu"), ct, torch.from_numpy(reads),
                         add_read_pairs=True)
    gt = tdbg.rebuild_step(gt, ct, torch.from_numpy(reads), salt=1)
    for name in ("cbf", "rpkbf", "fpkbf"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)))
    frags = np.full((40, 120), 4, np.uint8)
    lens = np.zeros(40, np.int64)
    for i, r in enumerate(reads[::53][:39]):
        lens[i] = (60, 100, 80, 26)[i % 4]
        frags[i, : lens[i]] = r[: lens[i]]
    return cj, gj, ct, gt, frags, lens, tx


@pytest.mark.parametrize(
    "kw", [{}, {"max_walk_len": 300, "pair_ring": 64, "bound": 150, "lookahead": 2}],
    ids=["stage3_defaults", "short_walks_short_ring"],
)
def test_extend_fragments_pair_equals_jax(graphs, kw):
    cj, gj, ct, gt, frags, lens, _ = graphs
    want = jtx.extend_fragments_pair(gj, cj, frags, lens, jtx.TranscriptParams(**kw))
    got = ttx.extend_fragments_pair(gt, ct, frags, lens, ttx.TranscriptParams(**kw))
    names = ("codes", "lengths", "orig_start", "orig_end")
    for name, a, b in zip(names, got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
        assert a.dtype == np.asarray(b).dtype, name
    out, out_len, orig_s, orig_e = got
    assert out.shape == (40, kw.get("max_walk_len", 4096))
    assert (out_len[lens > 0] >= lens[lens > 0]).all() and (out_len > lens).any()
    # each original fragment sits inside its extension
    for i in np.flatnonzero(lens >= K):
        np.testing.assert_array_equal(out[i, orig_s[i] : orig_e[i]], frags[i, : lens[i]])


SCFG_J, SCFG_T = jf.BloomConfig(18, 2), tf.BloomConfig(18, 2)


def _rows(seqs, width=None):
    width = width or max(64, 1 << (max(len(x) for x in seqs) - 1).bit_length())
    codes = np.full((len(seqs), width), 4, np.uint8)
    for i, x in enumerate(seqs):
        codes[i, : len(x)] = x
    return codes, np.array([len(x) for x in seqs], np.int64)


def _screens(cj, ct, codes):
    sj = jtx.screen_add(jf.make_bloom(SCFG_J), SCFG_J, cj, jnp.asarray(codes))
    st = ttx.screen_add(tf.make_bloom(SCFG_T, device="cpu"), SCFG_T, ct, codes)
    return sj, st


def _assert_screen_equal(st, sj):
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.fixture(scope="module")
def screened(graphs):
    """Screens holding transcripts 0-5 (a row with N bases too)."""
    cj, gj, ct, gt, frags, lens, tx = graphs
    codes = np.full((8, 640), 4, np.uint8)
    codes[:6, :600] = tx[:6]
    codes[6, :300] = tx[6, :300]
    codes[6, 100:110] = 4
    sj, st = _screens(cj, ct, codes)
    return sj, st


def test_screen_add_equals_jax(graphs, screened):
    sj, st = screened
    _assert_screen_equal(st, sj)
    assert int(st[:-1].sum()) > 6000 and st[-1] == 1  # windows with N or padding set the trash lane


def _probe_rows(tx, rng):
    """Rows for the redundancy screen: assembled, one substitution, a
    1-base deletion and insertion, two substitutions 12 apart, errors at
    both edges, novel, half novel and chimeric (two assembled arms)."""
    rows = []
    for t in range(6):
        a = int(rng.integers(0, 250))
        seg = tx[t, a : a + 300].copy()
        rows.append(seg.copy())
        v = seg.copy(); v[150] = (v[150] + 1) % 4; rows.append(v)
        rows.append(np.delete(seg, 140))
        rows.append(np.insert(seg, 140, (seg[140] + 2) % 4))
        v = seg.copy(); v[100] = (v[100] + 1) % 4; v[112] = (v[112] + 3) % 4; rows.append(v)
        v = seg.copy(); v[2] = (v[2] + 1) % 4; v[296] = (v[296] + 1) % 4; rows.append(v)
        rows.append(np.concatenate([seg[:200], tx[12 + t % 4, :150]]))
        rows.append(np.concatenate([tx[t, :150], tx[(t + 1) % 6, 300:450]]))
    rows += [tx[i, 100:400] for i in range(10, 16)]
    return rows


@pytest.mark.parametrize("use_graph", [False, True], ids=["no_graph", "graph"])
@pytest.mark.parametrize("kw", [{}, {"max_indel": 2, "percent_identity": 0.8, "screen_max_edge_clip": 10}],
                         ids=["defaults", "indel2_edge10"])
def test_screen_represented_equals_jax(graphs, screened, use_graph, kw):
    cj, gj, ct, gt, _, _, tx = graphs
    sj, st = screened
    codes, lens = _rows(_probe_rows(tx, np.random.default_rng(3)))
    chim_j, chim_t = np.zeros(len(lens), bool), np.zeros(len(lens), bool)
    want = jtx.screen_represented(sj, SCFG_J, cj, codes, lens, jtx.TranscriptParams(**kw), chimera_out=chim_j,
                                  graph=gj if use_graph else None)
    got = ttx.screen_represented(st, SCFG_T, ct, codes, lens, ttx.TranscriptParams(**kw), chimera_out=chim_t,
                                 graph=gt if use_graph else None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(chim_t, chim_j)
    assert got.any() and not got.all() and chim_t.any()
    plain = ttx.screen_represented(st, SCFG_T, ct, codes, lens, ttx.TranscriptParams(**kw),
                                   graph=gt if use_graph else None)
    np.testing.assert_array_equal(plain, got)


def _rewalk_setup(dbg_mod, filters_mod, tx_mod, t, device=None):
    """tests/test_screen_rewalk.py's set-up in either package."""
    cfg = dbg_mod.GraphConfig(
        k=K, stranded=False, dbgbf=filters_mod.BloomConfig(18, 2), cbf=filters_mod.CountingConfig(18, 2, 16),
        pkbf=filters_mod.BloomConfig(18, 2), read_pair_distance=60,
    )
    scfg = filters_mod.BloomConfig(18, 2)
    base = np.full((4, 512), 4, np.uint8)
    base[:3, :400] = t
    if device is None:
        graph = dbg_mod.build_step(dbg_mod.make_graph(cfg), cfg, jnp.asarray(base))
        screen = tx_mod.screen_add(filters_mod.make_bloom(scfg), scfg, cfg, jnp.asarray(base[:1]))
    else:
        graph = dbg_mod.build_step(dbg_mod.make_graph(cfg, device=device), cfg, torch.from_numpy(base))
        screen = tx_mod.screen_add(filters_mod.make_bloom(scfg, device=device), scfg, cfg, base[:1])
    return cfg, scfg, graph, screen


@pytest.mark.parametrize("scenario,want", [
    ("clustered_errors", True), ("three_spread_errors", True), ("edge_errors", True), ("novel", False),
    ("half_novel", False),
])
def test_screen_rewalk_scenarios_equal_jax(scenario, want):
    rng = np.random.default_rng(77)
    t = rng.integers(0, 4, size=400).astype(np.uint8)
    v = t.copy()
    if scenario == "clustered_errors":
        v[200] = (v[200] + 1) % 4
        v[212] = (v[212] + 2) % 4
    elif scenario == "three_spread_errors":
        for p, d in ((60, 1), (201, 3), (340, 2)):
            v[p] = (v[p] + d) % 4
    elif scenario == "edge_errors":
        v[2] = (v[2] + 1) % 4
        v[396] = (v[396] + 1) % 4
    elif scenario == "novel":
        v = rng.integers(0, 4, size=400).astype(np.uint8)
    else:
        v = np.concatenate([t, rng.integers(0, 4, size=250).astype(np.uint8)])
    codes, lens = _rows([v], max(512, 1 << int(len(v) - 1).bit_length()))
    j = _rewalk_setup(jdbg, jf, jtx, t)
    tt = _rewalk_setup(tdbg, tf, ttx, t, device="cpu")
    _assert_screen_equal(tt[3], j[3])
    rep = {}
    for graph in (True, False):
        rep_j = jtx.screen_represented(j[3], j[1], j[0], codes, lens, jtx.TranscriptParams(), graph=j[2] if graph else None)
        rep[graph] = ttx.screen_represented(tt[3], tt[1], tt[0], codes, lens, ttx.TranscriptParams(),
                                            graph=tt[2] if graph else None)
        np.testing.assert_array_equal(rep[graph], rep_j)
    assert bool(rep[True][0]) == want
    if scenario == "clustered_errors":  # only the graph re-walk explains it
        assert not rep[False][0]


def test_sequential_dedup_equals_jax(graphs):
    cj, _, ct, _, _, _, tx = graphs
    rows = [tx[0, :300], tx[0, 50:300], tx[7, :200], tx[0, :300], tx[2, :250], tx[2, 10:260], tx[3, :24],
            tx[4, :300], np.concatenate([tx[4, :150], tx[5, :150]])]
    codes, lens = _rows(rows)
    codes[8, 200] = 4
    lens[5] = 0
    for seen in (None, set(), "tx5"):
        sj, st = (set(), set()) if seen == set() else (seen, seen)
        if seen == "tx5":  # hashes accepted earlier: transcript 5's k-mers
            _, sj = jtx.sequential_dedup(cj, *_rows([tx[5]]), jtx.TranscriptParams(), set())
            _, st = ttx.sequential_dedup(ct, *_rows([tx[5]]), ttx.TranscriptParams(), set(), device="cpu")
            assert st == sj and len(st) > 500
        want, sj = jtx.sequential_dedup(cj, codes, lens, jtx.TranscriptParams(), sj)
        got, st = ttx.sequential_dedup(ct, codes, lens, ttx.TranscriptParams(), st, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert st == sj
        assert got[[1, 3, 5, 6]].all() and not got[[0, 2, 4]].any()


@pytest.mark.parametrize("frag_consistency", [True, False], ids=["fc", "nofc"])
def test_break_check_equals_jax(graphs, frag_consistency):
    cj, gj, ct, gt, frags, lens, tx = graphs
    params = dict(frag_consistency=frag_consistency, max_walk_len=700, pair_ring=256, bound=300)
    ext, ext_len, orig_s, orig_e = ttx.extend_fragments_pair(gt, ct, frags, lens, ttx.TranscriptParams(**params))
    # joined rows: a break the fragment pairs see
    ext[30, 300:600] = tx[12, :300]
    ext_len[30] = max(ext_len[30], 600)
    want = jtx.break_check(gj, cj, ext, ext_len, orig_s, orig_e, jtx.TranscriptParams(**params))
    got = ttx.break_check(gt, ct, ext, ext_len, orig_s, orig_e, ttx.TranscriptParams(**params))
    assert got == want
    if frag_consistency:
        assert any(r is None for r in got) and any(r is not None and r[1] - r[0] < ext_len[i] for i, r in enumerate(got))


@pytest.mark.parametrize("bound", [30, 200])
def test_depth_probe_equals_jax(graphs, screened, bound):
    """Greedy depth from seed k-mers on the graph and on the screen viewed
    as an mf8 graph (its lanes read as counts 0/1)."""
    cj, gj, ct, gt, frags, lens, tx = graphs
    sj, st = screened
    seeds = [frags[i, 30 : 30 + K] for i in range(20)] + [tx[t, 500:525] for t in range(8)]
    np.testing.assert_array_equal(ttx._depth_probe(gt, ct, seeds, bound), jtx._depth_probe(gj, cj, seeds, bound))
    sgj, pcj = jtx._screen_as_graph(sj, SCFG_J, cj)
    sgt, pct = ttx._screen_as_graph(st, SCFG_T, ct)
    assert sgt.cbf is st and pct.cbf.dtype == "mf8" and pct.cbf.size_log2 == 18 and pct.cbf.num_hash == 2
    got = ttx._depth_probe(sgt, pct, seeds, bound, lookahead=2)
    np.testing.assert_array_equal(got, jtx._depth_probe(sgj, pcj, seeds, bound, lookahead=2))
    assert (got[20:26] > 0).all() and (got[26:] == 0).all()  # transcripts 0-5 are screened, 6-7 not


def test_branch_free_batch_equals_jax(graphs):
    cj, gj, ct, gt, frags, lens, tx = graphs
    codes, lens2 = _rows([tx[i, :200] for i in range(16)] + [frags[i, : lens[i]] for i in range(12)], 256)
    got = ttx.branch_free_batch(gt, ct, codes, lens2)
    np.testing.assert_array_equal(got, jtx.branch_free_batch(gj, cj, codes, lens2))
    assert got.any() and not got.all()


def test_screen_template_switch_equals_jax(graphs):
    """Stranded: rows whose head is assembled and whose tail folds back
    onto the reverse complement of assembled sequence (and the mirror)."""
    cj, _, ct, _, _, _, tx = graphs
    cj, ct = replace(cj, stranded=True), replace(ct, stranded=True)
    sj, st = _screens(cj, ct, _rows([tx[0], tx[1], tx[2]], 640)[0])
    rc = tseq.revcomp_codes
    rows = [np.concatenate([tx[0, :200], rc(tx[0, 300:420])]), np.concatenate([rc(tx[1, 300:420]), tx[1, 100:300]]),
            np.concatenate([tx[2, :200], tx[9, :120]]), tx[0, :300], tx[10, :300], tx[2, 100:110]]
    codes, lens = _rows(rows)
    got = ttx.screen_template_switch(st, SCFG_T, ct, codes, lens)
    np.testing.assert_array_equal(got, jtx.screen_template_switch(sj, SCFG_J, cj, codes, lens))
    assert got[:2].all() and not got[2:].any()


def _batches(frags, lens, tx):
    """Three batches of 24 rows: fragments, then transcript pieces that
    overlap what the first batch assembled, then novel and chimeric rows."""
    rows2 = [tx[t, 50:350] for t in range(8)] + [tx[t, 250:600] for t in range(8)]
    rows3 = [np.concatenate([tx[t, :200], tx[t + 1, 300:500]]) for t in range(8)] + [tx[t, :400] for t in range(8, 16)]
    out = [(frags[:24], lens[:24])]
    for rows in (rows2, rows3):
        c, l = _rows(rows, frags.shape[1] * 4)
        out.append((c, l.astype(lens.dtype)))
    return out


ASSEMBLE_CASES = {
    "default": ({}, None),
    "template_switch_filter": ({"template_switch_filter": True}, None),
    "max_edge_clip": ({"max_edge_clip": 8}, None),
    "require_branch_free": ({}, "every_other"),
    "keep_chimeras": ({"keep_chimeras": True}, None),
    "keep_artifacts": ({"keep_artifacts": True, "max_edge_clip": 8, "template_switch_filter": True}, None),
}


def _assemble_both(gj, cj, gt, ct, batches, kw, gate):
    params = dict(max_walk_len=700, pair_ring=256, bound=300, min_transcript_length=250, **kw)
    sj, st = jf.make_bloom(SCFG_J), tf.make_bloom(SCFG_T, device="cpu")
    n_tx = n_short = 0
    for codes, lens in batches:
        bf = None if gate is None else (np.arange(len(lens)) % 2 == 0)
        tj, shj, sj = jtx.assemble_transcripts_batch(gj, cj, sj, SCFG_J, codes, lens, jtx.TranscriptParams(**params),
                                                     require_branch_free=bf)
        tt, sht, st = ttx.assemble_transcripts_batch(gt, ct, st, SCFG_T, codes, lens, ttx.TranscriptParams(**params),
                                                     require_branch_free=bf)
        for got, want in ((tt, tj), (sht, shj)):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.length == b.length
                np.testing.assert_array_equal(a.codes, b.codes)
        _assert_screen_equal(st, sj)
        n_tx, n_short = n_tx + len(tt), n_short + len(sht)
    return n_tx, n_short


@pytest.mark.parametrize("case", sorted(ASSEMBLE_CASES))
def test_assemble_transcripts_batch_equals_jax(graphs, case):
    cj, gj, ct, gt, frags, lens, tx = graphs
    kw, gate = ASSEMBLE_CASES[case]
    n_tx, n_short = _assemble_both(gj, cj, gt, ct, _batches(frags, lens, tx), kw, gate)
    assert n_tx > 0 and n_short > 0


def test_blunt_end_screen_equals_jax():
    """A graph where isoform X = A[:300] + B is deep and the other end of A
    (A[:300] + a 30-base stub, the end of its transcript) is shallow; the
    screen holds X; there are no fragment-pair keys.  The fragment
    A[100:330] is a blunt-end candidate: its stub end dead-ends in the graph and the screen, walked as a graph,
    continues along B past the stub's length, so both packages drop it,
    and keep it with -artifact."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, 330, dtype=np.uint8)
    x = np.concatenate([a[:300], rng.integers(0, 4, 200, dtype=np.uint8)])
    reads = [x[s : s + 100] for s in range(0, 401, 10) for _ in range(6)] + [a[s : s + 100] for s in range(200, 231, 10)]
    reads = np.stack(reads)
    kw = dict(k=K, stranded=False, read_pair_distance=40, fragment_pair_distance=60)
    cj = jdbg.GraphConfig(dbgbf=jf.BloomConfig(16, 2), cbf=jf.CountingConfig(16, 2, dtype="mf8"),
                          pkbf=jf.BloomConfig(16, 2), **kw)
    ct = tdbg.GraphConfig(dbgbf=tf.BloomConfig(16, 2), cbf=tf.CountingConfig(16, 2, dtype="mf8"),
                          pkbf=tf.BloomConfig(16, 2), **kw)
    gj = jdbg.build_step(jdbg.make_graph(cj, with_rpkbf=True), cj, jnp.asarray(reads), add_read_pairs=True)
    gt = tdbg.build_step(tdbg.make_graph(ct, with_rpkbf=True, device="cpu"), ct, torch.from_numpy(reads),
                         add_read_pairs=True)
    codes, lens = _rows([a[100:330]], 512)
    for keep in (False, True):
        # a 5-k-mer edge-clip allowance: the screen does not forgive the stub
        params = dict(max_walk_len=700, pair_ring=256, bound=300, min_transcript_length=100, max_edge_clip=10,
                      screen_max_edge_clip=5, keep_artifacts=keep)
        sj, st = _screens(cj, ct, _rows([x], 512)[0])
        tj, shj, sj = jtx.assemble_transcripts_batch(gj, cj, sj, SCFG_J, codes, lens, jtx.TranscriptParams(**params))
        tt, sht, st = ttx.assemble_transcripts_batch(gt, ct, st, SCFG_T, codes, lens, ttx.TranscriptParams(**params))
        assert [t.codes.tolist() for t in tt + sht] == [t.codes.tolist() for t in tj + shj]
        _assert_screen_equal(st, sj)
        assert len(tt + sht) == int(keep)
