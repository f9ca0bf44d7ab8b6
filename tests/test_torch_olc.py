"""The port's copies of the nr pass's OLC modules (``rnabloom_tpu_torch/olc``,
``io/seqstore.py``) against the JAX package's, on the CPU.

Inputs are made from seeds with numpy and fed to both packages; every
output must be equal, exactly: the minimizers (keys, positions, strands,
read ids; the port hashes them with plain torch, the JAX package with its
jitted ``_minimizer_keys``), the overlaps, the overlap graph (edges with
their offsets, overlaps and support, the contained set), the simple paths
and the unitigs of ``layout_unitigs``.
"""

import numpy as np
import pytest
import torch

from rnabloom_tpu.io import seqstore as jseqstore
from rnabloom_tpu.olc import graph as jgraph, layout as jlayout, overlap as jov
from rnabloom_tpu.ops import nthash as jnthash
from rnabloom_tpu_torch.io import seqstore as tseqstore
from rnabloom_tpu_torch.olc import graph as tgraph, layout as tlayout, overlap as tov
from rnabloom_tpu_torch.ops import nthash as tnthash
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

MIN_FIELDS = ("key", "pos", "strand", "read", "lengths")


def _random_reads(seed, n, lo=5, hi=3000, n_rate=0.01):
    """Random reads with N codes (4), lengths from under k to a few kb."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        r = rng.integers(0, 4, int(rng.integers(lo, hi)), dtype=np.uint8)
        r[rng.random(len(r)) < n_rate] = 4
        reads.append(r)
    return reads


def _rc(r):
    return np.where(r < 4, 3 - r, r)[::-1].astype(np.uint8)


def _tiled_reads(seed, n_tx=6, tx_len=(900, 2500)):
    """Reads tiling random templates with overlaps of 150-450 bases, about
    half reverse-complemented, a few with a substitution, some contained in
    others (whole windows inside a read), and unrelated reads."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n_tx):
        t = rng.integers(0, 4, int(rng.integers(*tx_len)), dtype=np.uint8)
        s = 0
        while s < len(t) - 200:
            r = t[s : s + int(rng.integers(400, 800))].copy()
            if rng.random() < 0.2:
                r[rng.integers(len(r))] = rng.integers(4)
            reads.append(_rc(r) if rng.random() < 0.5 else r)
            if rng.random() < 0.3:  # a contained read
                a = s + int(rng.integers(0, 100))
                reads.append(t[a : a + 250].copy())
            s += int(rng.integers(150, 450))
    for _ in range(3):
        reads.append(rng.integers(0, 4, 500, dtype=np.uint8))
    order = rng.permutation(len(reads))
    return [reads[i] for i in order]


def _assert_minimizers_equal(got, want):
    for f in MIN_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.k == want.k


@pytest.mark.parametrize("k,w,chunk,seed", [(25, 10, 1024, 0), (25, 10, 16, 1), (17, 5, 7, 2), (31, 12, 64, 3)])
def test_minimizers_equal_jax(k, w, chunk, seed):
    """extract_minimizers_reads on random reads with Ns, in both
    orientations, in chunks; among the picked minimizers some have forward
    and reverse hashes of different signs, where the strand flag (an
    unsigned compare) names the other hash than the key's (a signed
    min)."""
    reads = _random_reads(seed, 60)
    reads += [_rc(r) for r in reads[:20]]
    want = jov.extract_minimizers_reads(reads, k, w, chunk=chunk)
    got = tov.extract_minimizers_reads(reads, k, w, chunk=chunk, device="cpu")
    _assert_minimizers_equal(got, want)
    assert got.key.size > 1000 and got.strand.any() and not got.strand.all()
    # the sign case: hash every read again and look at the picked windows
    sign_split = 0
    for b, r in enumerate(reads[:30]):
        if len(r) < k:
            continue
        fh, rh, _ = tnthash.rolling_hash(torch.from_numpy(r[None]), k, stranded=False)
        pos = got.pos[got.read == b]
        sign_split += int(((fh[0, pos] < 0) != (rh[0, pos] < 0)).sum())
    assert sign_split > 0


def test_minimizer_keys_equal_jax_on_a_padded_batch():
    """_minimizer_keys itself: keys (all ones where a window holds an N or
    padding) and strand flags at every position of a padded batch."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (8, 256), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    codes[3, 100:] = 4
    lo, hi, fwd = jov._minimizer_keys(jnp.asarray(codes), 25)
    want = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)
    key, got_fwd = tov._minimizer_keys(torch.from_numpy(codes), 25)
    np.testing.assert_array_equal(key.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(got_fwd.numpy(), np.asarray(fwd))
    assert (want == np.uint64(0xFFFFFFFFFFFFFFFF)).any()
    # the JAX package's nthash gives the same rolling hashes
    fh, rh, _ = jnthash.rolling_hash(jnp.asarray(codes), 25, stranded=False)
    tfh, trh, _ = tnthash.rolling_hash(torch.from_numpy(codes), 25, stranded=False)
    u = lambda x: (np.asarray(x.hi).astype(np.uint64) << np.uint64(32)) | np.asarray(x.lo).astype(np.uint64)  # noqa
    np.testing.assert_array_equal(tfh.numpy().view(np.uint64), u(fh))
    np.testing.assert_array_equal(trh.numpy().view(np.uint64), u(rh))


def _edges(g):
    return {u: {v: (e.offset, e.ovl, e.support) for v, e in d.items()} for u, d in g.out.items()}, \
        {v: {u: (e.offset, e.ovl, e.support) for u, e in d.items()} for v, d in g.inn.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlaps_and_graph_equal_jax(seed):
    """find_overlaps and build_graph on tiled reads in both orientations,
    with contained reads: every overlap record, every edge (and its dict
    order) and the contained set equal."""
    reads = _tiled_reads(seed)
    params = tov.OverlapParams(min_overlap=100)
    jm = jov.extract_minimizers_reads(reads, 25, params.w)
    tm = tov.extract_minimizers_reads(reads, 25, params.w, device="cpu")
    want = jov.find_overlaps(jm, jov.OverlapParams(min_overlap=100))
    got = tov.find_overlaps(tm, params)
    for f in ("q", "t", "strand", "q_start", "q_end", "t_start", "t_end", "shared"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert len(got) > 10 and (got.strand == -1).any() and (got.strand == 1).any()
    # the record views, and the target span on the target's own strand
    for rt, rj in zip(got, want):
        assert vars(rt) == vars(rj)
        t_len = int(tm.lengths[rt.t])
        assert tov.oriented_t_coords(rt, t_len) == jov.oriented_t_coords(rj, t_len)
    np.testing.assert_array_equal(tov.classify_batch(got, tm.lengths, params),
                                  jov.classify_batch(want, jm.lengths, jov.OverlapParams(min_overlap=100)))
    gj, cj = jgraph.build_graph(want, jm.lengths, jov.OverlapParams(min_overlap=100))
    gt, ct = tgraph.build_graph(got, tm.lengths, params)
    assert ct == cj and len(ct) > 0
    ej, et = _edges(gj), _edges(gt)
    assert et == ej and [list(d) for d in et[0].values()] == [list(d) for d in ej[0].values()]
    assert list(gt.out) == list(gj.out) and list(gt.inn) == list(gj.inn)
    assert gt.vertices() == gj.vertices() and len(gt.vertices()) > 4
    # the simplification and the paths
    assert gt.remove_redundant_nodes() == gj.remove_redundant_nodes()
    assert gt.remove_transitive_edges(fuzz=params.diag_band) == gj.remove_transitive_edges(fuzz=params.diag_band)
    assert _edges(gt) == _edges(gj)
    assert gt.simple_paths() == gj.simple_paths()


@pytest.mark.parametrize("seed,min_overlap", [(3, 150), (4, 100), (5, 300)])
def test_layout_unitigs_equal_jax(seed, min_overlap):
    """layout_unitigs: unitigs, paths and contained ids equal; some paths
    stitch several reads, some through reverse-complemented ones."""
    reads = _tiled_reads(seed)
    uj, pj, cj = jlayout.layout_unitigs(reads, 25, jov.OverlapParams(min_overlap=min_overlap))
    ut, pt, ct = tlayout.layout_unitigs(reads, 25, tov.OverlapParams(min_overlap=min_overlap), device="cpu")
    assert pt == pj and ct == cj
    assert len(ut) == len(uj)
    for a, b in zip(ut, uj):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert max(len(p) for p in pt) >= 2 and any(v & 1 for p in pt for v, _ in p if len(p) > 1)


def test_stitch_path_equals_jax():
    reads = _tiled_reads(6)
    paths = [[(3, 0)], [(4, 0)], [(0, 0), (3, 120), (8, 300)], [(5, 0), (2, 50)]]
    for p in paths:
        np.testing.assert_array_equal(tlayout.stitch_path(p, reads), jlayout.stitch_path(p, reads))


def test_layout_unitigs_of_no_or_short_reads():
    for reads in ([], [np.zeros(10, np.uint8)], [np.full(40, 4, np.uint8), np.arange(30, dtype=np.uint8) % 4]):
        uj, pj, cj = jlayout.layout_unitigs(reads, 25, jov.OverlapParams())
        ut, pt, ct = tlayout.layout_unitigs(reads, 25, tov.OverlapParams(), device="cpu")
        assert pt == pj and ct == cj and [u.tolist() for u in ut] == [u.tolist() for u in uj]


def test_seqstore_equals_jax(tmp_path):
    """Appends, lengths, int (and negative) and slice reads, iteration and
    close(delete=): the same sequences and the same file bytes, non-ACGT
    codes stored as A."""
    rng = np.random.default_rng(8)
    seqs = [rng.integers(0, 6, int(n), dtype=np.uint8) for n in rng.integers(0, 50, 40)]
    seqs[3] = np.array([4, 4, 0, 1, 5, 2, 3], np.uint8)
    pj, pt = str(tmp_path / "j" / "s.2bit"), str(tmp_path / "t" / "s.2bit")
    sj, st = jseqstore.SeqStore(pj), tseqstore.SeqStore(pt)
    for i, s in enumerate(seqs):
        assert st.append(s) == sj.append(s) == i
        if i == 10:  # reads between appends
            np.testing.assert_array_equal(st[i], sj[i])
    assert len(st) == len(sj) == len(seqs)
    np.testing.assert_array_equal(st.lengths, sj.lengths)
    for i in (0, 3, 17, -1, -len(seqs)):
        np.testing.assert_array_equal(st[i], sj[i])
    assert st[3].tolist() == [0, 0, 0, 1, 0, 2, 3]
    for a, b in zip(st[5:30:3], sj[5:30:3]):
        np.testing.assert_array_equal(a, b)
    for a, b, s in zip(st, sj, seqs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.where(s < 4, s, 0))
    with pytest.raises(IndexError):
        st[len(seqs)]
    st._f.flush()
    sj._f.flush()
    with open(pt, "rb") as ft, open(pj, "rb") as fj:
        assert ft.read() == fj.read()
    with st:
        pass
    assert st._f.closed
    st.close(delete=True)
    sj.close(delete=True)
    assert not (tmp_path / "t" / "s.2bit").exists()
    empty = tseqstore.SeqStore(str(tmp_path / "e.2bit"))
    assert len(empty) == 0 and empty.lengths.dtype == np.int32 and empty.lengths.size == 0
    empty.close(delete=True)
