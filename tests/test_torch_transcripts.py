"""The port's stage-3 extension (rnabloom_tpu_torch/assembly/transcripts.py,
``extend_fragments_pair``) against the JAX package's, on the CPU.

A graph of simulated reads (16 transcripts at uneven depth, 30% of reads
with one substitution) with the read-pair keys (distance 40) and the
fragment-pair keys of the same reads (distance 60), built by both packages
(tables asserted equal).  Fragments: read rows cut to several lengths, one
empty row.  The extended codes, lengths and the original fragments' ranges
must be equal, at stage 3's own sizes (4096-base walks, a 1024-slot ring)
and at a short walk with a ring shorter than a fragment.
"""

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
    gt = tdbg.build_step(tdbg.make_graph(ct, with_rpkbf=True, with_fpkbf=True), ct, torch.from_numpy(reads),
                         add_read_pairs=True)
    gt = tdbg.rebuild_step(gt, ct, torch.from_numpy(reads), salt=1)
    for name in ("cbf", "rpkbf", "fpkbf"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)))
    frags = np.full((40, 120), 4, np.uint8)
    lens = np.zeros(40, np.int64)
    for i, r in enumerate(reads[::53][:39]):
        lens[i] = (60, 100, 80, 26)[i % 4]
        frags[i, : lens[i]] = r[: lens[i]]
    return cj, gj, ct, gt, frags, lens


@pytest.mark.parametrize(
    "kw", [{}, {"max_walk_len": 300, "pair_ring": 64, "bound": 150, "lookahead": 2}],
    ids=["stage3_defaults", "short_walks_short_ring"],
)
def test_extend_fragments_pair_equals_jax(graphs, kw):
    cj, gj, ct, gt, frags, lens = graphs
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
