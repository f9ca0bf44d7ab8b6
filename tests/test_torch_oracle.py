"""The port's decision oracle (rnabloom_tpu_torch/oracle/) against the
JAX package's: its copy of refsim against the original on the oracle's
fixture, the cheap measurements (counts, k-mer by k-mer; greedy choices,
the beam tip probe) against the JAX package's, and ``measure_all(device="cpu")``
against ``tests/golden/oracle_divergence.json``, which the JAX package
writes (``python -m rnabloom_tpu.oracle.divergence``; the ``slow`` test
below re-derives it, tier-1 does not run the JAX package's
``measure_all``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnabloom_tpu.graph import dbg as jdbg
from rnabloom_tpu.oracle import divergence as jdiv, refsim as jref
from rnabloom_tpu_torch.oracle import divergence as tdiv, refsim as tref

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "oracle_divergence.json")
K = 17


@pytest.fixture(scope="module")
def fixture():
    reads, transcripts, _ = tdiv.make_fixture(0, K)
    jreads, jtx, _ = jdiv.make_fixture(0, K)
    assert (reads, transcripts) == (jreads, jtx)
    return reads, transcripts


@pytest.fixture(scope="module")
def twins(fixture):
    """The twin graphs of both packages over the fixture's reads."""
    reads, _ = fixture
    return jdiv.build_twin_graphs(reads, K), tdiv.build_twin_graphs(reads, K, device="cpu")


def _graphs(reads):
    gj, gt = jref.ExactGraph(K), tref.ExactGraph(K)
    for s in reads:
        gj.add_seq(s)
        gt.add_seq(s)
    return gj, gt


@pytest.mark.parametrize("fn", ["ExactGraph", "successors", "greedy_extend_right_once", "correct_errors_se",
                                "represented"])
def test_refsim_copy_equals_the_original(fixture, fn):
    """Each refsim function that the oracle calls gives the original's
    result on the oracle's own inputs."""
    reads, transcripts = fixture
    gj, gt = _graphs(reads)
    if fn == "ExactGraph":
        assert gt.counts == gj.counts and gt.get_kmers(transcripts[0]) == gj.get_kmers(transcripts[0])
        return
    bks = tdiv.branch_kmers(gt)
    assert bks == jdiv.branch_kmers(gj) and len(bks) > 10
    if fn == "successors":
        for km in sorted(gt.counts)[:200] + bks:
            assert tref.successors(gt, km) == jref.successors(gj, km)
    elif fn == "greedy_extend_right_once":
        for km in bks:
            for la in (1, 3):
                assert (tref.greedy_extend_right_once(gt, tref.successors(gt, km), la)
                        == jref.greedy_extend_right_once(gj, jref.successors(gj, km), la))
    elif fn == "correct_errors_se":
        rng = np.random.default_rng(1)
        kw = dict(lookahead=3, max_indel=1, max_cov_gradient=0.5, cov_fpr=0.01, percent_identity=0.9, min_cov=1.0)
        changed = 0
        for t in transcripts[:2]:
            for s0 in range(0, len(t) - 60 + 1, 30):
                r = t[s0: s0 + 60]
                p = int(rng.integers(20, 40))
                for read in (tdiv._mutate(rng, r, p), r[:p] + r[p + 1:], r):
                    want = jref.correct_errors_se(read, gj, **kw)
                    assert tref.correct_errors_se(read, gt, **kw) == want
                    changed += want is not None
        assert changed > 0
    else:
        rng = np.random.default_rng(2)
        a = transcripts[0]
        screen = set(gt.get_kmers(a))
        kw = dict(lookahead=3, max_indel=1, max_edge_clip=8, percent_identity=0.9)
        verdicts = []
        for s in (a, a[10:-10], tdiv._mutate(rng, a, 110), tdiv._rand_seq(rng, 150), a[:110] + tdiv._rand_seq(rng, 80)):
            want = jref.represented(gj.get_kmers(s), gj, screen, **kw)
            assert tref.represented(gt.get_kmers(s), gt, screen, **kw) == want
            verdicts.append(want)
        assert True in verdicts and False in verdicts


@pytest.mark.parametrize("measure", ["counts", "greedy", "tip_probe"])
def test_cheap_measurements_equal_jax(twins, measure):
    """Each measurement equals the JAX package's.  The counts are held k-mer
    by k-mer, each of the oracle's k-mers counted by the JAX package's
    ``get_counts`` in one compiled program (``jdiv.tpu_counts`` runs it op
    by op); ``measure_counts`` reduces them to the golden's ratios."""
    (gj, sj, cj), (gt, st, ct) = twins
    assert gt.counts == gj.counts
    if measure == "counts":
        kmers = sorted(gt.counts)
        _, _, base, _ = jax.jit(jdbg.seq_hashes, static_argnums=0)(cj, jnp.asarray(jdiv._encode_batch(kmers, K)))
        want = np.asarray(jax.jit(jdbg.get_counts, static_argnums=1)(sj, cj, base))[:, 0].astype(np.float64)
        np.testing.assert_array_equal(tdiv.tpu_counts(st, ct, kmers), want)
        got = tdiv.measure_counts(gt, st, ct)
    else:
        fn_j, fn_t = getattr(jdiv, f"measure_{measure}"), getattr(tdiv, f"measure_{measure}")
        want, got = fn_j(gj, sj, cj), fn_t(gt, st, ct)
        assert got == want
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert got == {key: golden[key] for key in got}


def test_measure_all_on_the_cpu_equals_the_golden():
    with open(GOLDEN) as f:
        golden = json.load(f)
    got = tdiv.measure_all(device="cpu")
    assert json.loads(json.dumps(got)) == golden
    assert got["count_agreement"] == 1.0 and got["n_reads"] == 380


@pytest.mark.slow
def test_golden_is_the_jax_package_s_output():
    """Re-derives the golden from the JAX package's measure_all (about 30 s
    on the CPU: not in tier-1)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert json.loads(json.dumps(jdiv.measure_all())) == golden
