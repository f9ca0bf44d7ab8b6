"""The port's fragment assembly (rnabloom_tpu_torch/assembly/fragments.py)
vs the JAX package's, on the same graph and read pairs.

``assemble_fragments_batch`` on simulated pairs (overlapping and gapped
fragments, with sequencing errors); ``bridge_pairs`` on constructed gaps
that connect by each of its three rules (the right walk reaches the right
mate, only the left walk reaches the left mate, the two walks meet in the
middle) and on overlapping mates; ``connect_segments_batch`` on reads split
into segments.  Fragments, gap sequences, overlaps and joined reads must
be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnabloom_tpu.assembly import fragments as jfrag
from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.graph import dbg as jdbg
from rnabloom_tpu_torch.assembly import fragments as tfrag
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.graph import dbg as tdbg
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

K = 25
D = 60  # read-pair distance of the graphs


def _graphs(reads, stranded=False):
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
    kw = dict(k=K, stranded=stranded, read_pair_distance=D)
    cj = jdbg.GraphConfig(dbgbf=jf.BloomConfig(20, 2), cbf=jf.CountingConfig(20, 2),
                          pkbf=jf.BloomConfig(20, 2), **kw)
    ct = tdbg.GraphConfig(dbgbf=tf.BloomConfig(20, 2), cbf=tf.CountingConfig(20, 2),
                          pkbf=tf.BloomConfig(20, 2), **kw)
    gj = jdbg.build_step(jdbg.make_graph(cj, with_rpkbf=True), cj, jnp.asarray(codes), add_read_pairs=True)
    gt = tdbg.build_step(tdbg.make_graph(ct, with_rpkbf=True, device="cpu"), ct, torch.from_numpy(codes), add_read_pairs=True)
    return cj, gj, ct, gt


def _pack(rows, L):
    out = np.full((len(rows), L), 4, np.uint8)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out, np.array([len(r) for r in rows], np.int64)


def _tile(seq, copies, step=20, L=100):
    return [seq[s : s + L] for _ in range(copies) for s in range(0, len(seq) - L + 1, step)]


@pytest.fixture(scope="module")
def bridge_setup():
    """One transcript per bridge rule, tiled by reads at depth 2, plus
    decoys at depth 8 that lead the greedy walks astray:

    gap:     T[0:100] .. T[300:400]; both walks run straight through.
    left:    a decoy branches off T after position 250 going right, so the
             right walk leaves T; the left walk reaches the left mate.
    middle:  decoys branch off going right after 250 and going left before
             200, so neither walk reaches the other mate; they share
             T[200:250].
    overlap: mates T[0:100] and T[80:180]."""
    rng = np.random.default_rng(77)
    rand = lambda n: rng.integers(0, 4, size=n, dtype=np.uint8)  # noqa: E731
    ts = {name: rand(500) for name in ("gap", "left", "middle", "overlap")}
    reads = []
    for t in ts.values():
        reads += _tile(t, 2)
    for name in ("left", "middle"):
        reads += _tile(np.concatenate([ts[name][:250], rand(150)]), 8)
    reads += _tile(np.concatenate([rand(150), ts["middle"][200:]]), 8)
    pairs = {
        "gap": (ts["gap"][:100], ts["gap"][300:400]),
        "left": (ts["left"][:100], ts["left"][350:450]),
        "middle": (ts["middle"][:100], ts["middle"][350:450]),
        "overlap": (ts["overlap"][:100], ts["overlap"][80:180]),
    }
    return pairs, reads


@pytest.mark.parametrize("stranded", [False, True])
def test_bridge_pairs_matches_jax(bridge_setup, stranded):
    pairs, reads = bridge_setup
    cj, gj, ct, gt = _graphs(reads, stranded)  # stranded: two walk batches
    names = list(pairs)
    left, ll = _pack([pairs[n][0] for n in names], 128)
    right, rl = _pack([pairs[n][1] for n in names], 128)
    rows = np.arange(len(names))
    params_j, params_t = jfrag.FragmentParams(), tfrag.FragmentParams()
    ov_j, ov_t = np.zeros(len(names), np.int32), np.zeros(len(names), np.int32)
    bj = jfrag.bridge_pairs(gj, cj, left, ll, right, rl, rows, params_j, ov_j)
    bt = tfrag.bridge_pairs(gt, ct, left, ll, right, rl, rows, params_t, ov_t)
    np.testing.assert_array_equal(ov_t, ov_j)
    assert bt.keys() == bj.keys()
    for b in bj:
        np.testing.assert_array_equal(bt[b], bj[b])
    if not stranded:
        for n in ("gap", "left", "middle"):  # each rule connected its pair
            assert names.index(n) in bt, n
        assert ov_t[names.index("overlap")] == 20


@pytest.fixture(scope="module")
def pe_setup():
    """Read pairs of 8 transcripts at uneven depth, fragments of 120-330
    bases from 100-base reads (overlapping and gapped mates), 0.5%
    substitutions; the graph holds every read."""
    rng = np.random.default_rng(5)
    tx = rng.integers(0, 4, size=(8, 900), dtype=np.uint8)
    lefts, rights = [], []
    for i in range(400):
        t = tx[min(int(rng.exponential(2.5)), 7)]
        flen = int(rng.integers(120, 331))
        s = int(rng.integers(0, 900 - flen))
        lefts.append(t[s : s + 100].copy())
        rights.append(t[s + flen - 100 : s + flen].copy())
    for r in lefts + rights:
        hit = rng.random(100) < 0.005
        r[hit] = (r[hit] + 1) % 4
    return lefts, rights, _graphs(lefts + rights)


def _frag_tuple(f):
    return None if f is None else (f.codes.tolist(), f.min_cov, f.length, f.connected)


@pytest.mark.parametrize("lookahead", [3, 5])
def test_assemble_fragments_batch_matches_jax(pe_setup, lookahead):
    lefts, rights, (cj, gj, ct, gt) = pe_setup
    left, ll = _pack(lefts[:256], 110)
    right, rl = _pack(rights[:256], 110)
    rl[7] = 10  # a mate shorter than k is never bridged
    fj = jfrag.assemble_fragments_batch(gj, cj, left, ll, right, rl, jfrag.FragmentParams(lookahead=lookahead))
    ft = tfrag.assemble_fragments_batch(gt, ct, left, ll, right, rl, tfrag.FragmentParams(lookahead=lookahead))
    assert [_frag_tuple(f) for f in ft] == [_frag_tuple(f) for f in fj]
    assert sum(f is not None for f in ft) > 128
    assert all(type(f.min_cov) is float for f in ft if f is not None)


def test_connect_segments_batch_matches_jax(pe_setup):
    lefts, rights, (cj, gj, ct, gt) = pe_setup
    rng = np.random.default_rng(8)
    segments = []
    for i in range(40):
        r = lefts[i]
        kind = i % 5
        if kind == 0:  # a 10-base gap between two segments
            segments.append([r[:40], r[50:]])
        elif kind == 1:  # overlapping segments
            segments.append([r[:60], r[45:]])
        elif kind == 2:  # three segments
            segments.append([r[:30], r[35:65], r[70:]])
        elif kind == 3:  # a junction that cannot join
            segments.append([r[:50], rng.integers(0, 4, size=40, dtype=np.uint8)])
        else:  # one segment, and a read with none
            segments.append([r] if i % 10 else [])
    pj = jfrag.FragmentParams()
    out_j = jfrag.connect_segments_batch(gj, cj, segments, pj)
    out_t = tfrag.connect_segments_batch(gt, ct, segments, tfrag.FragmentParams())
    assert [o.tolist() for o in out_t] == [o.tolist() for o in out_j]


def test_host_helpers_match_jax():
    rng = np.random.default_rng(12)
    buf = rng.integers(0, 5, size=(16, 90), dtype=np.uint8)
    pos = rng.integers(0, 91, size=16)
    np.testing.assert_array_equal(tfrag.revcomp_rows(buf, pos), jfrag.revcomp_rows(buf, pos))
    needles = np.stack([buf[i, 5:30] if i % 2 else rng.integers(0, 4, 25, dtype=np.uint8) for i in range(16)])
    np.testing.assert_array_equal(tfrag.find_kmer_rows(buf, pos, needles), jfrag.find_kmer_rows(buf, pos, needles))
    sup = rng.random((16, 80)) < 0.8
    lens = rng.integers(0, 200, size=16)
    assert tfrag.supported_ranges_np(sup, lens, 25, 30, 2) == jfrag.supported_ranges_np(sup, lens, 25, 30, 2)
    for c in (0.5, 9.99, 10.0, 123.0, 1e5):
        assert tfrag.coverage_order_of_magnitude(c) == jfrag.coverage_order_of_magnitude(c)
