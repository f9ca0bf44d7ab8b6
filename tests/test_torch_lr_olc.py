"""The port's long-read OLC (``olc/consensus.py``, ``olc/realign.py``, the
long-read methods of ``olc/graph.py``, ``olc/layout.py::unique_olc``,
``io/paf.py``, ``ops/consensus_vote.py``) and ``reduce_redundancy`` vs the
JAX package, on the CPU.

Reads are lrsim reads at 2% error (what the correction leaves), from one
seed: windows tiling transcripts (dovetails) and the simulator's cDNA
reads (containments).  Every output must be equal, exactly: mappings and placements, the
polished unitigs of both polish modes (the column vote over several
batches, each with a fresh vote table), the realignment's traceback and
votes, the unique reads, the graph after each long-read method (edges
with offsets, overlaps, support and weights), ``unique_olc``'s
transcripts and counts (float64 from the same operations) with and
without seeds and external overlaps, and the nr index list.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import stage1 as js1, transcripts as jtx
from rnabloom_tpu.bloom.filters import BloomConfig as JBloom, merge_default
from rnabloom_tpu.io import paf as jpaf
from rnabloom_tpu.olc import consensus as jcns, graph as jgraph, layout as jlayout, overlap as jov, realign as jre
from rnabloom_tpu.utils import lrsim as jsim, seq as jseq
from rnabloom_tpu_torch.assembly import stage1 as ts1, transcripts as ttx
from rnabloom_tpu_torch.bloom.filters import BloomConfig as TBloom
from rnabloom_tpu_torch.io import paf as tpaf
from rnabloom_tpu_torch.olc import consensus as tcns, graph as tgraph, layout as tlayout, overlap as tov
from rnabloom_tpu_torch.olc import realign as tre
from rnabloom_tpu_torch.ops import consensus_vote as cv
from rnabloom_tpu_torch.utils import polya
from lr_common import VOTE_CASES, vote_case
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

K = 25
OV_FIELDS = ("q", "t", "strand", "q_start", "q_end", "t_start", "t_end", "shared")


def _reads():
    rng = np.random.default_rng(21)
    tx = jsim.simulate_transcriptome(rng, 5, (1500, 3000))
    reads = []
    for t in tx:
        s = 0
        while s < len(t) - 300:
            r = jsim.ont_noise(rng, t[s : s + int(rng.integers(500, 900))], 0.02)
            reads.append(jseq.revcomp(r) if rng.random() < 0.5 else r)
            s += int(rng.integers(150, 450))
    reads += jsim.simulate_reads(rng, tx[:3], coverage=4, err=0.02)
    reads = [jseq.encode(r) for r in reads]
    return reads, [polya.find_polya_tail(r) is not None for r in reads]


READS, POLYA = _reads()
PARAMS = dict(min_shared=4, w=10)


def _jp():
    return jov.OverlapParams(**PARAMS)


def _tp():
    return tov.OverlapParams(**PARAMS)


def _same_ov(a, b):
    assert len(a) == len(b)
    for f in OV_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def mapped():
    """Unitigs over all reads, both packages' minimizers and placements."""
    unitigs, _, _ = tlayout.layout_unitigs(READS, K, _tp(), device="cpu")
    jall = jov.extract_minimizers_reads(READS, K, 10)
    tall = tov.extract_minimizers_reads(READS, K, 10, device="cpu")
    jum = jov.extract_minimizers_reads(unitigs, K, 10)
    tum = tov.extract_minimizers_reads(unitigs, K, 10, device="cpu")
    jpl = jcns.place_reads(jall, jum, jall.lengths, _jp())
    tpl = tcns.place_reads(tall, tum, tall.lengths, _tp())
    return unitigs, jall, tall, jum, tum, jpl, tpl


def test_map_to_targets_equals_jax(mapped):
    _, jall, tall, jum, tum, _, _ = mapped
    want = jov.map_to_targets(jall, jum, _jp())
    _same_ov(tov.map_to_targets(tall, tum, _tp()), want)
    assert len(want) > len(READS) // 2


def test_place_reads_equals_jax(mapped):
    unitigs, *_, jpl, tpl = mapped
    assert [dataclasses.astuple(p) for p in tpl] == [dataclasses.astuple(p) for p in jpl]
    assert len(tpl) > len(READS) // 2 and {p.orient for p in tpl} == {0, 1}
    assert tcns.normalized_read_counts(tpl, np.array([len(u) for u in unitigs])) == jcns.normalized_read_counts(
        jpl, np.array([len(u) for u in unitigs]))
    assert tcns.junction_placements(tpl) == jcns.junction_placements(jpl)


@pytest.mark.parametrize("indel_band,batch_reads,min_depth", [(16, 2048, 2), (16, 7, 3), (0, 2048, 2), (0, 9, 2)])
def test_polish_equals_jax(mapped, indel_band, batch_reads, min_depth):
    unitigs, *_, jpl, tpl = mapped
    want = jcns.polish(unitigs, READS, jpl, min_depth=min_depth, batch_reads=batch_reads, indel_band=indel_band)
    got = tcns.polish(unitigs, READS, tpl, min_depth=min_depth, batch_reads=batch_reads, indel_band=indel_band,
                      device="cpu")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert any(len(a) != len(u) or not np.array_equal(a, u) for a, u in zip(got, unitigs))


def test_column_vote_takes_a_fresh_table_per_batch():
    """Three reads vote C at one position of an all-A unitig with
    min_depth 2: one batch of three polishes it; batches of one read each
    leave it, in both packages (votes do not add up across batches)."""
    unitig = np.zeros(60, np.uint8)
    read = np.zeros(30, np.uint8)
    read[5] = 1
    place = [tcns.Placement(read=i, target=0, orient=0, start=10, q_start=0, q_end=30, t_start=10, t_end=40)
             for i in range(3)]
    jplace = [jcns.Placement(**dataclasses.asdict(p)) for p in place]
    for batch, polished in ((3, True), (1, False)):
        got = tcns.polish([unitig], [read] * 3, place, min_depth=2, batch_reads=batch, indel_band=0, device="cpu")
        want = jcns.polish([unitig], [read] * 3, jplace, min_depth=2, batch_reads=batch, indel_band=0)
        assert np.array_equal(got[0], want[0])
        assert (got[0][15] == 1) == polished


def test_consensus_vote_plain_equals_jax_vote_kernel():
    rng = np.random.default_rng(4)
    U, L, R, Lr = 5, 90, 40, 50
    unitigs = rng.integers(0, 4, (U, L), dtype=np.uint8)
    unitigs[1, 70:] = 4  # a shorter unitig
    reads = rng.integers(0, 5, (R, Lr), dtype=np.uint8)
    reads[:, 45:] = 4
    tgt = rng.integers(0, U, R).astype(np.int32)
    start = rng.integers(-20, L - 10, R).astype(np.int32)
    jp, jd = jcns._vote_kernel(jnp.asarray(unitigs), jnp.asarray(reads), jnp.asarray(tgt), jnp.asarray(start), 2, U, L)
    tp, td = cv.consensus_vote(*(torch.from_numpy(a) for a in (unitigs, reads, tgt, start)), 2)
    assert np.array_equal(tp.numpy(), np.asarray(jp)) and np.array_equal(td.numpy(), np.asarray(jd))
    assert (td.numpy() >= 2).sum() > 100 and not np.array_equal(tp.numpy(), unitigs)
    with pytest.raises(ValueError, match="int32"):
        cv.consensus_vote_plain(*(torch.from_numpy(a) for a in (unitigs, reads, tgt.astype(np.int64), start)), 2)


@pytest.mark.parametrize("min_depth", [0, 1, 3])
@pytest.mark.parametrize("case", VOTE_CASES)
def test_consensus_vote_edge_cases_equal_jax_vote_kernel(case, min_depth):
    """The plain vote (what the card kernel is held to) equals the JAX
    function bit for bit where a kernel is likely to go wrong
    (``lr_common.vote_case``): reads over both ends of a unitig, an
    untouched unitig (with min_depth 0 a cell on a base becomes A), ties of
    two and of four bases (the first maximum wins), every read on one
    unitig, codes 4 and above inside reads, a unitig of pad 4 past its
    length."""
    unitigs, reads, tgt, start = vote_case(case)
    U, L = unitigs.shape
    Lr = reads.shape[1]
    jp, jd = jcns._vote_kernel(*(jnp.asarray(a) for a in (unitigs, reads, tgt, start)), min_depth, U, L)
    tp, td = cv.consensus_vote(*(torch.from_numpy(a) for a in (unitigs, reads, tgt, start)), min_depth)
    assert tp.dtype == torch.uint8 and td.dtype == torch.int32
    assert np.array_equal(tp.numpy(), np.asarray(jp)) and np.array_equal(td.numpy(), np.asarray(jd))
    tp, td = tp.numpy(), td.numpy()
    assert (unitigs[1, 2 * L // 3:] == 4).all() and (tp[1, 2 * L // 3:] == 4).all()
    if case == "untouched":
        assert (td[2] == 0).all()
        assert np.array_equal(tp[2], np.where(unitigs[2] < 4, 0, unitigs[2]) if min_depth <= 0 else unitigs[2])
    if case == "ties":
        two = slice(Lr, Lr + Lr // 2)  # G and T once each
        assert (td[0, : Lr // 2] == 4).all() and (td[0, Lr // 2 : Lr] == 6).all() and (td[0, two] == 2).all()
        assert (tp[0, : Lr // 2] == 0).all() and (tp[0, Lr // 2 : Lr] == 2).all()
        assert np.array_equal(tp[0, two], np.full(Lr // 2, 2) if min_depth <= 2 else unitigs[0, two])
    if case == "one_unitig":
        assert (td[:-1] == 0).all() and td[-1].sum() > 0
    if case == "pads":
        assert td.sum() < ((reads < 4).sum())


def test_realign_functions_equal_jax(mapped):
    unitigs, *_, tpl = mapped
    w, R = 16, 12
    placed = tpl[:R]
    Lr = max(len(READS[p.read]) for p in placed)
    rcodes = np.full((R, Lr), 4, np.uint8)
    rlens = np.zeros(R, np.int32)
    wins = np.full((R, Lr + 2 * w), 4, np.uint8)
    wstart = np.zeros(R, np.int32)
    tgt = np.zeros(R, np.int32)
    for i, p in enumerate(placed):
        r = READS[p.read] if p.orient == 0 else jseq.revcomp_codes(READS[p.read])
        rcodes[i, : len(r)] = r
        rlens[i], tgt[i], wstart[i] = len(r), p.target, p.start - w
        u = unitigs[p.target]
        a, b = max(p.start - w, 0), min(p.start - w + Lr + 2 * w, len(u))
        wins[i, a - (p.start - w) : b - (p.start - w)] = u[a:b]
    got = tre.banded_align_batch(rcodes, rlens, wins, w)
    want = jre.banded_align_batch(rcodes, rlens, wins, w)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    ulens = np.array([len(u) for u in unitigs], np.int64)
    args = (rcodes, rlens, wstart, tgt, ulens, w, np.maximum((rlens * 0.35).astype(np.int32), 4), got[2])
    votes = tre.alignment_votes(got[0], got[1], *args)
    assert all(np.array_equal(a, b) for a, b in zip(votes, jre.alignment_votes(want[0], want[1], *args)))
    edited = tre.apply_edits(unitigs, *votes, 1)
    assert all(np.array_equal(a, b) for a, b in zip(edited, jre.apply_edits(unitigs, *votes, 1)))


@pytest.fixture(scope="module")
def overlaps():
    jm = jov.extract_minimizers_reads(READS, K, 10)
    tm = tov.extract_minimizers_reads(READS, K, 10, device="cpu")
    return jov.find_overlaps(jm, _jp()), tov.find_overlaps(tm, _tp()), tm.lengths


@pytest.mark.parametrize("min_depth,with_polya", [(1, False), (1, True), (3, True)])
def test_extract_unique_equals_jax(overlaps, min_depth, with_polya):
    jo, to, lens = overlaps
    flags = POLYA if with_polya else None
    got = tlayout.extract_unique(to, lens, _tp(), min_depth, flags)
    assert got == jlayout.extract_unique(jo, lens, _jp(), min_depth, flags)
    assert 0 < len(got) < len(READS)


def _edges(g):
    return {u: {v: dataclasses.astuple(e) for v, e in d.items()} for u, d in g.out.items() if d}


@pytest.mark.parametrize("method", ["add_overlap", "resolve_junctions", "prune_polya", "mapping_and_filter",
                                    "greedy_paths"])
def test_graph_methods_equal_jax(overlaps, mapped, method):
    jo, to, lens = overlaps
    if method == "add_overlap":
        jg, tg = jgraph.OverlapGraph(lengths=lens), tgraph.OverlapGraph(lengths=lens)
        kinds = [tg.add_overlap(rec, _tp()) for rec in to]
        assert kinds == [jg.add_overlap(rec, _jp()) for rec in jo]
        assert {"dovetail", "q_contained", "t_contained", "internal"} <= set(kinds)
        assert tg.num_edges() == jg.num_edges() > 0 and _edges(tg) == _edges(jg)
        assert [tov.classify(rec, lens[rec.q], lens[rec.t], _tp()) for rec in to] == [
            jov.classify(rec, lens[rec.q], lens[rec.t], _jp()) for rec in jo]
        return
    jg, _ = jgraph.build_graph(jo, lens, _jp())
    tg, _ = tgraph.build_graph(to, lens, _tp())
    assert _edges(tg) == _edges(jg) and tg.num_edges() > 0
    if method == "resolve_junctions":
        assert tg.resolve_junctions() == jg.resolve_junctions()
    elif method == "prune_polya":
        flags = [i % 3 == 0 for i in range(len(READS))]
        assert tg.prune_polya(flags) == jg.prune_polya(flags) > 0
    else:
        _, _, _, _, _, jpl, tpl = mapped
        # placements of reads on reads: each read's own minimizers as targets
        tm = tov.extract_minimizers_reads(READS, K, 10, device="cpu")
        jm = jov.extract_minimizers_reads(READS, K, 10)
        tpl = tcns.place_reads(tm, tm, tm.lengths, _tp())
        jpl = jcns.place_reads(jm, jm, jm.lengths, _jp())
        tg.add_mapping_support(tcns.junction_placements(tpl))
        jg.add_mapping_support(jcns.junction_placements(jpl))
        assert _edges(tg) == _edges(jg)
        counts = tcns.normalized_read_counts(tpl, lens)
        if method == "greedy_paths":
            assert tg.greedy_paths(counts) == jg.greedy_paths(counts)
            assert len(tg.greedy_paths(counts)) > 1
            return
        sample = np.asarray(lens, np.int64)
        assert tg.filter_edges_binomial(counts, sample) == jg.filter_edges_binomial(counts, sample)
    assert _edges(tg) == _edges(jg)


@pytest.mark.parametrize("s,c,p", [(0, 10, 0.3), (3, 10, 0.5), (7, 7, 0.9), (2, 5, 0.0), (2, 5, 1.0), (9, 40, 0.6)])
def test_binom_cdf_equals_jax(s, c, p):
    assert tgraph._binom_cdf(s, c, p) == jgraph._binom_cdf(s, c, p)


@pytest.fixture(scope="module")
def paf_overlaps(tmp_path_factory, overlaps):
    """A PAF of the internal overlaps written by the port, read back by both."""
    _, to, lens = overlaps
    path = str(tmp_path_factory.mktemp("paf") / "ava.paf")
    tpaf.write_paf(path, tpaf.overlaps_to_paf(to, lens, K))
    names = {f"lr.{i}": i for i in range(len(READS))}
    want = jpaf.paf_to_overlaps(path, names, K, min_identity=0.0, params=_jp())
    got = tpaf.paf_to_overlaps(path, names, K, min_identity=0.0, params=_tp())
    _same_ov(got, want)
    with open(path) as f:
        lines = f.read()
    jpath = path + ".jax"
    jpaf.write_paf(jpath, jpaf.overlaps_to_paf(to, lens, K))
    with open(jpath) as f:
        assert f.read() == lines
    return got, want


@pytest.mark.parametrize("case", ["default", "seeds", "external"])
def test_unique_olc_equals_jax(paf_overlaps, case):
    kw = dict(polya_flags=POLYA, sample_lengths=np.array([len(r) for r in READS], np.int64), min_seq_depth=2,
              polya_finder=lambda c: polya.find_polya_tail(c) is not None)
    jkw, tkw = dict(kw), dict(kw)
    if case == "seeds":
        jkw["seed_indices"] = tkw["seed_indices"] = list(range(0, len(READS), 2))
    elif case == "external":
        tkw["external_overlaps"], jkw["external_overlaps"] = paf_overlaps
    want = jlayout.unique_olc(READS, K, _jp(), **jkw)
    got = tlayout.unique_olc(READS, K, _tp(), **tkw, device="cpu")
    assert len(got.transcripts) == len(want.transcripts) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got.transcripts, want.transcripts))
    assert got.counts == want.counts
    assert (got.n_unique, got.n_unitigs, got.n_paths) == (want.n_unique, want.n_unitigs, want.n_paths)


def test_reduce_redundancy_equals_jax():
    """The port's screen and dedup over sequences with duplicates,
    substrings and reverse complements: the same nr index list."""
    rng = np.random.default_rng(8)
    seqs = [r.copy() for r in READS[:30]]
    seqs += [READS[0][50:400].copy(), jseq.revcomp_codes(READS[1]), READS[2].copy(), READS[3][:150].copy()]
    seqs += [rng.integers(0, 4, 300, dtype=np.uint8)]
    jcfg, tcfg = js1.default_graph_config(K, False, 1 << 22), ts1.default_graph_config(K, False, 1 << 22)
    want = jtx.reduce_redundancy(jcfg, JBloom(jcfg.pkbf.size_log2, jcfg.pkbf.num_hash, merge=merge_default()), seqs,
                                 jtx.TranscriptParams(min_transcript_length=200), batch=16)
    got = ttx.reduce_redundancy(tcfg, TBloom(tcfg.pkbf.size_log2, tcfg.pkbf.num_hash), seqs,
                                ttx.TranscriptParams(min_transcript_length=200), batch=16, device="cpu")
    assert got == want
    assert len(seqs) - 4 <= len(got) < len(seqs)
