"""Port's graph build/count steps (rnabloom_tpu_torch/graph) vs the JAX
package's dbg.build_step / count_step on the same code batches
(tests/test_histmerge.py shapes: 512 x 100 codes, k=25, pair distance 40),
with JAX on its scatter path (merge=False)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.graph import dbg as jdbg
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.graph import dbg as tdbg, engine
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

COUNTERS = [("mf8", False), ("u16", False), ("int32", True), ("int32", False)]


def _cfgs(dtype, blocked, stranded=False):
    kw = dict(k=25, stranded=stranded, read_pair_distance=40)
    j = jdbg.GraphConfig(
        dbgbf=jf.BloomConfig(16, 2), cbf=jf.CountingConfig(17, 2, blocked=blocked, dtype=dtype),
        pkbf=jf.BloomConfig(16, 2), **kw,
    )
    t = tdbg.GraphConfig(
        dbgbf=tf.BloomConfig(16, 2), cbf=tf.CountingConfig(17, 2, blocked=blocked, dtype=dtype),
        pkbf=tf.BloomConfig(16, 2), **kw,
    )
    return j, t


def _codes(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(512, 100), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[:40] = codes[40:80]  # repeated reads: multi-occurrence k-mers
    return codes


@pytest.mark.parametrize("dtype,blocked", COUNTERS)
@pytest.mark.parametrize("stranded", [False, True])
def test_build_and_count_steps_match_jax(dtype, blocked, stranded):
    cj, ct = _cfgs(dtype, blocked, stranded)
    sj = jdbg.make_graph(cj, with_rpkbf=True)
    st = engine.make_graph(ct, with_rpkbf=True, device="cpu")
    for salt in range(3):
        codes = _codes(salt)
        sj = jdbg.build_step(sj, cj, jnp.asarray(codes), add_read_pairs=True, salt=salt)
        st = engine.build_step(st, ct, codes, add_read_pairs=True, salt=salt)
    for name in ("cbf", "rpkbf"):
        want = np.asarray(getattr(sj, name))
        np.testing.assert_array_equal(getattr(st, name).numpy().view(want.dtype), want)
    q = _codes(9)
    cnt_j, val_j = jdbg.count_step(sj, cj, jnp.asarray(q))
    cnt_t, val_t = engine.count_step(st, ct, q)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert jdbg.fprs(sj, cj) == tdbg.fprs(st, ct)


@pytest.mark.parametrize("dtype,blocked", COUNTERS)
def test_stage2_queries_match_jax(dtype, blocked):
    """contains, the fragment/read pair-support planes and counts + read
    support (the stage-2 engine queries) on one built graph."""
    from rnabloom_tpu.graph import engine as jengine

    cj, ct = _cfgs(dtype, blocked)
    sj = jdbg.make_graph(cj, with_rpkbf=True, with_fpkbf=True)
    st = engine.make_graph(ct, with_rpkbf=True, with_fpkbf=True, device="cpu")
    codes = _codes(4)
    sj = jdbg.build_step(sj, cj, jnp.asarray(codes), add_read_pairs=True)
    st = engine.build_step(st, ct, codes, add_read_pairs=True)
    sj = sj._replace(fpkbf=sj.rpkbf)  # a fragment-pair filter with content
    st = st._replace(fpkbf=st.rpkbf.clone())
    q = _codes(5)
    _, _, bj, _ = jdbg.seq_hashes(cj, jnp.asarray(q))
    _, _, bt, _ = tdbg.seq_hashes(ct, torch.from_numpy(q))
    np.testing.assert_array_equal(tdbg.contains(st, ct, bt).numpy(), np.asarray(jdbg.contains(sj, cj, bj)))
    for d_frag, d_read in ((30, 40), (0, 40), (30, 0)):
        np.testing.assert_array_equal(
            engine.pair_support_both(st, ct, q, d_frag, d_read),
            jengine.pair_support_both(sj, cj, q, d_frag, d_read),
        )
    for got, want in zip(engine.counts_and_read_support(st, ct, q), jengine.counts_and_read_support(sj, cj, q)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,blocked", COUNTERS)
@pytest.mark.parametrize("stranded", [False, True])
def test_variant_exists_matches_jax(dtype, blocked, stranded):
    """The SNV-variant lookups of the -stratum branch-free gate: reads with
    single-base variants of earlier reads (so many k-mers have a variant in
    the graph), queried with N bases."""
    from rnabloom_tpu.graph import engine as jengine

    cj, ct = _cfgs(dtype, blocked, stranded)
    codes = _codes(6)
    rng = np.random.default_rng(6)
    codes[80:160] = codes[:80]
    cols = rng.integers(0, 100, 80)
    codes[np.arange(80, 160), cols] = (codes[np.arange(80, 160), cols] + 1) % 4
    sj = jdbg.build_step(jdbg.make_graph(cj), cj, jnp.asarray(codes))
    st = engine.build_step(engine.make_graph(ct, device="cpu"), ct, codes)
    q = np.concatenate([codes[:40], _codes(7)[:40]])
    hit_j, val_j = jengine.variant_exists(sj, cj, q)
    n0 = engine.dispatch_counts()["query"]
    hit_t, val_t = engine.variant_exists(st, ct, q)
    assert engine.dispatch_counts()["query"] == n0 + 1
    np.testing.assert_array_equal(val_t, np.asarray(val_j))
    np.testing.assert_array_equal(hit_t, np.asarray(hit_j))
    assert hit_t[:40].any() and not hit_t[~val_t].any()
