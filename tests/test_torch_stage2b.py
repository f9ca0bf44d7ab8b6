"""Stage 2b (the fragment-graph rebuild) of the port against the JAX package,
and merge-layout checkpoints loaded by the port.

Rebuild: the port's ``-stage 2 -savebf --device cpu`` output (graph
checkpoint and fragment store) is rebuilt by both packages, the JAX
package with the loop of ``pipeline._finish_pe_stage3`` (fresh state,
``engine.rebuild_step`` over ``store.iter_batches(1024)``).  The cbf, rpkbf
and fpkbf must be bit-identical, for mf8 and u16 counters, with fragment
pairs added (the default walk length) and not (a walk length so short that
a fragment row holds fewer k-mers than the fragment pair distance), and
for each variant of ``fresh_rebuild_state``.

Merge layout: the JAX package writes filters with ``merge=True`` on a TPU
(a trash block after the cells; here its Pallas sweep runs in interpret
mode).  The port loads such a checkpoint as its scatter layout: the first
``size`` cells of every table must equal the JAX package's, and counts and
pair lookups must give the same answers.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import fragstore as jfragstore
from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.graph import dbg as jdbg, engine as jengine
from rnabloom_tpu.utils import checkpoint as jckpt
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import fragstore as tfragstore, pipeline as tpipe
from rnabloom_tpu_torch.graph import dbg as tdbg, engine as tengine
from rnabloom_tpu_torch.utils import checkpoint as tckpt, pesim
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

K = 25


@pytest.fixture(scope="module")
def stage2_outputs(tmp_path_factory):
    """counter -> the output directory of the port's -stage 2 -savebf run
    on 1500 simulated pairs (two stage-2 batches)."""
    d = tmp_path_factory.mktemp("stage2b")
    left, right = str(d / "r_1.fq"), str(d / "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=21, num_transcripts=20, tx_len=(500, 1500), num_pairs=1500)
    outs = {}
    for counter in ("mf8", "u16"):
        outs[counter] = str(d / counter)
        cli.run(["-left", left, "-right", right, "-revcomp-right", "-o", outs[counter], "-stage", "2",
                 "-savebf", "-mem", "0.00390625", "-batch", "1024", "-sample", "300", "-bound", "200",
                 "-cnt", counter, "--device", "cpu"])
    return outs


def _jax_rebuild(prefix, outdir, max_walk_len, ref_paths=(), **fresh):
    """The rebuild loop of the JAX package's ``_finish_pe_stage3``, its
    ``-ref`` branch included."""
    from rnabloom_tpu.io import fastx as jfastx
    from rnabloom_tpu.utils import seq as jseq

    state, cfg = jckpt.load_graph(prefix)
    store = jfragstore.FragmentStore.open(outdir)
    frag_L = int(min(max(store.max_len, 2 * K), max_walk_len))
    state = jengine.fresh_rebuild_state(state, cfg, **fresh)
    add_pairs = frag_L - K + 1 > cfg.fragment_pair_distance
    nbatch = 0
    for codes, _, _, _ in store.iter_batches(1024, width=frag_L):
        state = jengine.rebuild_step(state, cfg, codes, add_frag_pairs=add_pairs, salt=nbatch)
        nbatch += 1
    for rp in ref_paths:
        for _, rseq in jfastx.read_fasta(rp):
            codes_r = jseq.encode(rseq.upper())
            if len(codes_r) < K:
                continue
            for s0 in range(0, len(codes_r), max_walk_len - K + 1):
                chunk_np = np.full((1, max_walk_len), 4, np.uint8)
                piece = codes_r[s0 : s0 + max_walk_len]
                chunk_np[0, : len(piece)] = piece
                state = jengine.rebuild_step(state, cfg, chunk_np, add_frag_pairs=max_walk_len - K + 1 >
                                             cfg.fragment_pair_distance, salt=nbatch)
                nbatch += 1
    return state, add_pairs


def _assert_filters_equal(got, want):
    for name in ("cbf", "rpkbf", "fpkbf"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            b = np.asarray(b)
            np.testing.assert_array_equal(a.numpy().view(b.dtype), b, err_msg=name)


@pytest.mark.parametrize("max_walk_len", [4096, 60])
@pytest.mark.parametrize("counter", ["mf8", "u16"])
def test_rebuild_equals_jax(stage2_outputs, counter, max_walk_len):
    out = stage2_outputs[counter]
    prefix = os.path.join(out, "rnabloom.graph")
    want, add_pairs = _jax_rebuild(prefix, out, max_walk_len)
    assert add_pairs == (max_walk_len == 4096)

    state, cfg = tckpt.load_graph(prefix, device="cpu")
    store = tfragstore.FragmentStore.open(out)
    rpkbf = state.rpkbf.clone()
    n0 = tengine.dispatch_counts()["build"]
    got = tpipe.rebuild_fragment_graph(state, cfg, store, tpipe.PipelineParams(max_walk_len=max_walk_len))
    assert tengine.dispatch_counts()["build"] - n0 == sum(1 for _ in store.iter_batches(1024)) >= 2
    _assert_filters_equal(got, want)
    assert got.rpkbf is state.rpkbf and torch.equal(got.rpkbf, rpkbf)  # kept, not written
    assert int(got.cbf.count_nonzero()) > 0
    assert bool(got.fpkbf.any()) == add_pairs


@pytest.mark.parametrize("max_walk_len", [4096, 300])
def test_rebuild_with_reference_transcripts_equals_jax(stage2_outputs, tmp_path, max_walk_len):
    """-ref: reference transcripts (one longer than a row, one shorter than
    k, one with lower-case bases and Ns) go into the rebuilt graph after
    the fragments, one row of ``max_walk_len`` bases a step."""
    out = stage2_outputs["mf8"]
    prefix = os.path.join(out, "rnabloom.graph")
    rng = np.random.default_rng(8)
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in (900, 20, 400)]
    seqs[2] = seqs[2][:100].lower() + "NN" + seqs[2][102:]
    refs = [str(tmp_path / "a.fa"), str(tmp_path / "b.fa")]
    with open(refs[0], "w") as f:
        f.write(f">r0\n{seqs[0]}\n>r1\n{seqs[1]}\n")
    with open(refs[1], "w") as f:
        f.write(f">r2\n{seqs[2][:200]}\n{seqs[2][200:]}\n")
    want, _ = _jax_rebuild(prefix, out, max_walk_len, ref_paths=refs)
    state, cfg = tckpt.load_graph(prefix, device="cpu")
    store = tfragstore.FragmentStore.open(out)
    params = tpipe.PipelineParams(max_walk_len=max_walk_len)
    got = tpipe.rebuild_fragment_graph(state, cfg, store, params, ref_paths=refs)
    _assert_filters_equal(got, want)
    plain = tpipe.rebuild_fragment_graph(tckpt.load_graph(prefix, device="cpu")[0], cfg, store, params)
    assert not torch.equal(plain.cbf, got.cbf)


@pytest.mark.parametrize(
    "fresh",
    [{"keep_rpkbf": False}, {"with_fpkbf": False}, {"copy_rpkbf": True}],
    ids=["no_rpkbf", "no_fpkbf", "copy_rpkbf"],
)
def test_fresh_rebuild_state_variants_equal_jax(stage2_outputs, fresh):
    out = stage2_outputs["mf8"]
    prefix = os.path.join(out, "rnabloom.graph")
    want, add_pairs = _jax_rebuild(prefix, out, 4096, **fresh)
    state, cfg = tckpt.load_graph(prefix, device="cpu")
    store = tfragstore.FragmentStore.open(out)
    frag_L = int(min(max(store.max_len, 2 * K), 4096))
    got = tengine.fresh_rebuild_state(state, cfg, **fresh)
    assert not got.cbf.any() and got.cbf.shape == state.cbf.shape
    if fresh.get("copy_rpkbf"):
        assert got.rpkbf is not state.rpkbf and torch.equal(got.rpkbf, state.rpkbf)
    for nbatch, (codes, _, _, _) in enumerate(store.iter_batches(1024, width=frag_L)):
        got = tengine.rebuild_step(got, cfg, codes, add_frag_pairs=add_pairs, salt=nbatch)
    _assert_filters_equal(got, want)


def test_store_of_stage2_reads_as_jax(stage2_outputs):
    """The port's reading side on the port's own -stage 2 store."""
    out = stage2_outputs["u16"]
    port, jax_ = tfragstore.FragmentStore.open(out), jfragstore.FragmentStore.open(out)
    assert port._ordered_keys() == jax_._ordered_keys()
    assert list(port.iter_lengths()) == list(jax_.iter_lengths())
    assert port.count == jax_.count > 1024
    for width in (None, 60):
        got, want = list(port.iter_batches(1024, width)), list(jax_.iter_batches(1024, width))
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


# ---- merge-layout checkpoints (the JAX package on a TPU) ----


def _merge_graph(counter, tmp_path):
    """A JAX graph with merge=True filters (cbf, rpkbf, fpkbf), a few salted
    batches of random reads in, saved with the JAX save_graph."""
    rng = np.random.default_rng(12)
    cfg = jdbg.GraphConfig(
        k=K, stranded=False, dbgbf=jf.BloomConfig(16, 2),
        cbf=jf.CountingConfig(17, 2, merge=True, dtype=counter), pkbf=jf.BloomConfig(16, 2, merge=True),
        read_pair_distance=40, fragment_pair_distance=60,
    )
    state = jdbg.make_graph(cfg, with_rpkbf=True, with_fpkbf=True)
    for salt in range(3):
        codes = jnp.asarray(rng.integers(0, 4, size=(256, 100), dtype=np.uint8))
        state = jdbg.build_step(state, cfg, codes, add_read_pairs=True, salt=salt)
        state = jdbg.rebuild_step(state, cfg, codes, salt=salt + 3)
    prefix = str(tmp_path / "merged.graph")
    jckpt.save_graph(prefix, state, cfg)
    # queries: reads of the last batch and fresh ones
    return state, cfg, prefix, np.concatenate([np.asarray(codes)[:32], rng.integers(0, 4, (32, 100), np.uint8)])


@pytest.mark.parametrize("counter", ["mf8", "u16", "int32"])
def test_merge_layout_checkpoint_loads(tmp_path, counter):
    jstate, jcfg, prefix, codes = _merge_graph(counter, tmp_path)
    with open(prefix + ".graph.json") as f:
        desc = json.load(f)
    assert desc["cbf"]["merge"] and desc["pkbf"]["merge"]
    assert np.asarray(jstate.cbf).shape[0] > jcfg.cbf.size + 1  # a trash block
    # what was saved is compared with what was loaded (the merge path's mf8
    # tables differ from a scatter rebuild's)
    saved = jckpt.load_graph(prefix)[0]
    state, cfg = tckpt.load_graph(prefix, device="cpu")
    assert not cfg.cbf.merge and not cfg.pkbf.merge
    for name, size in (("cbf", cfg.cbf.size), ("rpkbf", cfg.pkbf.size), ("fpkbf", cfg.pkbf.size)):
        got, want = getattr(state, name), np.asarray(getattr(saved, name))
        assert got.shape[0] == size + 1 and int(got[size]) == 0
        np.testing.assert_array_equal(got[:size].numpy().view(want.dtype), want[:size], err_msg=name)

    want_c, want_v = jdbg.count_step(saved, jcfg, jnp.asarray(codes))
    got_c, got_v = tdbg.count_step(state, cfg, torch.from_numpy(codes))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    got_p = tengine.pair_support_both(state, cfg, codes, cfg.fragment_pair_distance, cfg.read_pair_distance)
    want_p = np.asarray(jengine.pair_support_both(saved, jcfg, codes, jcfg.fragment_pair_distance,
                                                  jcfg.read_pair_distance))
    np.testing.assert_array_equal(got_p, want_p)
    assert got_p[:, :32].any(axis=(1, 2)).all() and (got_c.numpy()[:32] > 0).all()

    # saved again by the port: the scatter layout, merge false
    tckpt.save_graph(str(tmp_path / "again.graph"), state, cfg)
    with open(tmp_path / "again.graph.graph.json") as f:
        again = json.load(f)
    assert not again["cbf"]["merge"] and not again["pkbf"]["merge"]
    back, _ = tckpt.load_graph(str(tmp_path / "again.graph"), device="cpu")
    jback, _ = jckpt.load_graph(str(tmp_path / "again.graph"))  # and in the JAX package
    for name in ("cbf", "rpkbf", "fpkbf"):
        assert torch.equal(getattr(back, name), getattr(state, name)), name
        want = np.asarray(getattr(jback, name))
        np.testing.assert_array_equal(getattr(state, name).numpy().view(want.dtype), want, err_msg=name)
