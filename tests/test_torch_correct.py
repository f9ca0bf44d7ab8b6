"""The port's error correction (rnabloom_tpu_torch/assembly/correct.py) vs
the JAX package's ``correct.correct_batch`` on the same graph and reads.

Fixtures follow ``tests/test_correct.py`` (a 500-base transcript read at
uniform depth; reads with planted substitutions, insertions and deletions)
plus a batch of simulated read pairs from several transcripts with planted
substitutions and indels.  Corrected codes, lengths and the changed mask
must be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rnabloom_tpu.assembly import correct as jcorrect
from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.graph import dbg as jdbg
from rnabloom_tpu_torch.assembly import correct as tcorrect
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.graph import dbg as tdbg
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

K = 25


def _graphs(reads: np.ndarray, dtype="mf8"):
    kw = dict(k=K, stranded=False)
    cj = jdbg.GraphConfig(dbgbf=jf.BloomConfig(18, 2), cbf=jf.CountingConfig(18, 2, dtype=dtype),
                          pkbf=jf.BloomConfig(18, 2), **kw)
    ct = tdbg.GraphConfig(dbgbf=tf.BloomConfig(18, 2), cbf=tf.CountingConfig(18, 2, dtype=dtype),
                          pkbf=tf.BloomConfig(18, 2), **kw)
    gj = jdbg.build_step(jdbg.make_graph(cj), cj, jnp.asarray(reads))
    gt = tdbg.build_step(tdbg.make_graph(ct, device="cpu"), ct, torch.from_numpy(reads))
    return cj, gj, ct, gt


@pytest.fixture(scope="module")
def transcript_graph():
    """tests/test_correct.py's graph: one transcript, 20x uniform reads."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, size=500, dtype=np.uint8)
    reads = np.stack([t[s : s + 100] for _ in range(20) for s in range(0, 401, 25)])
    return (t,) + _graphs(reads)


@pytest.fixture(scope="module")
def simulated():
    """Read pairs from 12 transcripts (uneven depth) with planted errors:
    substitutions, 1-base insertions and deletions, and two substitutions
    within k; a graph of their error-free reads and of the erroneous ones."""
    rng = np.random.default_rng(9)
    tx = rng.integers(0, 4, size=(12, 800), dtype=np.uint8)
    clean = []
    for t, depth in zip(tx, rng.integers(3, 12, size=12)):
        for _ in range(depth):
            s = rng.integers(0, 700)
            clean.append(t[s : s + 100])
    L = 110
    batch = np.full((256, L), 4, np.uint8)
    lens = np.zeros(256, np.int64)
    for i in range(256):
        t = tx[rng.integers(12)]
        s = rng.integers(0, 690)
        r = list(t[s : s + 100])
        kind = rng.integers(6)
        p = int(rng.integers(2, 98))
        if kind == 1:
            r[p] = (r[p] + 1) % 4
        elif kind == 2:
            r.insert(p, int(rng.integers(4)))
        elif kind == 3:
            del r[p]
        elif kind == 4:
            r[p] = (r[p] + 2) % 4
            q = min(p + int(rng.integers(5, K)), 99)
            r[q] = (r[q] + 3) % 4
        elif kind == 5:
            r[0] = (r[0] + 1) % 4  # at the very edge
        batch[i, : len(r)] = r
        lens[i] = len(r)
    graph_reads = np.concatenate([np.stack(clean), batch[:64, :100]])
    return (batch, lens) + _graphs(graph_reads)


def _mutate(r: np.ndarray, pos: int) -> np.ndarray:
    r = r.copy()
    r[pos] = (r[pos] + 1) % 4
    return r


def _reads(t, case):
    """(codes, lengths, params, pair_ids) of one tests/test_correct.py case."""
    clean = t[100:200]
    params = jcorrect.CorrectParams()
    pair_ids = None
    if case == "clean":
        rows = [t[i : i + 100] for i in range(0, 300, 50)]
    elif case == "interior_substitutions":
        rows = [_mutate(clean, p) for p in (30, 50, 70)]
    elif case == "edge_substitutions":
        rows = [_mutate(clean, p) for p in (5, 94)]
    elif case == "two_errors_far_apart":
        rows = [_mutate(_mutate(clean, 20), 80)]
    elif case == "pair_threshold_sharing":
        rows, pair_ids = [_mutate(clean, 50), t[300:400]], np.array([0, 0])
    elif case == "insertions":
        rows = [np.insert(clean, p, (clean[p] + 1) % 4) for p in (40, 60)]
    elif case == "deletions":
        rows = [np.delete(clean, p) for p in (40, 60)]
    else:  # indel repair gated off by -indel 0 / -p 1.0
        rows = [np.delete(clean, 50)]
        params = jcorrect.CorrectParams(max_indel=0) if case == "indel_off" else jcorrect.CorrectParams(
            percent_identity=1.0
        )
    codes = np.full((len(rows), 110), 4, np.uint8)
    for i, r in enumerate(rows):
        codes[i, : len(r)] = r
    return codes, np.array([len(r) for r in rows]), params, pair_ids


def _port_params(p: jcorrect.CorrectParams) -> tcorrect.CorrectParams:
    return tcorrect.CorrectParams(**vars(p))


def _assert_same(j, t):
    for a, b, what in zip(j, t, ("codes", "lengths", "changed")):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=what)


@pytest.mark.parametrize("case", [
    "clean", "interior_substitutions", "edge_substitutions", "two_errors_far_apart",
    "pair_threshold_sharing", "insertions", "deletions", "indel_off", "identity_one",
])
def test_correct_batch_matches_jax_on_fixtures(transcript_graph, case):
    t, cj, gj, ct, gt = transcript_graph
    codes, lens, params, pair_ids = _reads(t, case)
    j = jcorrect.correct_batch(gj, cj, codes, lens, params, pair_ids)
    out = tcorrect.correct_batch(gt, ct, codes, lens, _port_params(params), pair_ids)
    _assert_same(j, out)
    if case in ("interior_substitutions", "insertions", "deletions"):
        assert out[2].all()  # the fixture's errors are repaired


@pytest.mark.parametrize("paired", [False, True])
def test_correct_batch_matches_jax_on_simulated_reads(simulated, paired):
    batch, lens, cj, gj, ct, gt = simulated
    pair_ids = np.arange(256) // 2 if paired else None
    params = jcorrect.CorrectParams()
    j = jcorrect.correct_batch(gj, cj, batch, lens, params, pair_ids)
    out = tcorrect.correct_batch(gt, ct, batch, lens, _port_params(params), pair_ids)
    _assert_same(j, out)
    assert out[2].sum() > 30 and (out[1] != lens).any()  # substitutions and indels were repaired


def test_thresholds_and_window_scores_match_jax():
    """coverage_thresholds and the (min, median) window scores on random
    counts with ties, zeros, invalid entries and odd and even valid counts."""
    rng = np.random.default_rng(3)
    counts = rng.choice([0.0, 1.0, 2.0, 3.0, 7.5, 8.0, 40.0, 41.0, 1000.0], size=(64, 76)).astype(np.float32)
    valid = rng.random((64, 76)) < 0.9
    valid[:4] = False
    valid[4, 1:] = False
    counts = np.where(valid, counts, 0.0).astype(np.float32)
    fp = rng.integers(0, 4, size=64).astype(np.int32)
    for grad in (0.5, 0.3):
        tj, fj = jcorrect.coverage_thresholds(jnp.asarray(counts), jnp.asarray(valid), jnp.asarray(fp), grad)
        tt, ft = tcorrect.coverage_thresholds(torch.from_numpy(counts), torch.from_numpy(valid),
                                              torch.from_numpy(fp), grad)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    mj, medj = jcorrect._scores_from_counts(jnp.asarray(counts), jnp.asarray(valid))
    mt, medt = tcorrect._scores_from_counts(torch.from_numpy(counts), torch.from_numpy(valid))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(medt.numpy(), np.asarray(medj))


def test_find_candidates_matches_jax(simulated):
    batch, lens, cj, gj, ct, gt = simulated
    cnt, val, thr, found = tcorrect._ec_stats(gt, ct, batch, 0.5, 0.01)
    j = jcorrect._ec_stats(gj, cj, batch, 0.5, 0.01)
    for a, b in zip((cnt, val, thr, found), j):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tcorrect.find_candidates(cnt, val, thr, found, K), jcorrect.find_candidates(cnt, val, thr, found, K)):
        np.testing.assert_array_equal(a, b)
