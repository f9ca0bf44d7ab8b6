"""The port's long-read correction (``assembly/longreads.py``) and its host
helpers vs the JAX package.

``orient_long_read`` (poly-T-headed reads flipped, an N becoming 255),
the low-complexity detectors and ``extract_non_low_complexity_segments``
on lrsim reads with poly-A tails, N and repeats; then
``correct_long_reads`` on lrsim reads at 7% error against a stage-1 graph
that each package builds from the same FASTA: every list of
``LongCorrectionResult`` equal, with bridge and edge walks made.
"""

import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import artifacts as jart, longreads as jlr, stage1 as js1
from rnabloom_tpu.utils import lrsim as jsim, polya as jpolya, seq as jseq
from rnabloom_tpu_torch.assembly import artifacts as tart, longreads as tlr, stage1 as ts1
from rnabloom_tpu_torch.graph import engine
from rnabloom_tpu_torch.utils import lrsim as tsim, polya as tpolya
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


def _sim(seed, n_tx, cov, err):
    """(transcripts, reads) from each package's lrsim with one seed; both
    must give the same strings."""
    out = []
    for sim in (jsim, tsim):
        rng = np.random.default_rng(seed)
        tx = sim.simulate_transcriptome(rng, n_tx, (500, 1200))
        out.append((tx, sim.simulate_reads(rng, tx, coverage=cov, err=err)))
    assert out[0] == out[1]
    return out[1]


def test_lrsim_equals_jax():
    tx, reads = _sim(7, 5, 4, 0.07)
    assert len(reads) == 20 and any(t.endswith("A" * 20) for t in tx)
    truth = tx[:3]
    assembled = [tx[0][50:], tx[1], reads[0]]
    assert tsim.evaluate(assembled, truth) == jsim.evaluate(assembled, truth)


def _helper_reads():
    _, reads = _sim(11, 6, 3, 0.05)
    reads = [jseq.encode(r) for r in reads]
    rng = np.random.default_rng(1)
    out = []
    for i, r in enumerate(reads):
        r = r.copy()
        if i % 3 == 0:
            r[rng.choice(len(r), 4, replace=False)] = 4  # N
        if i % 4 == 1:  # a low-complexity block inside the read
            mid = len(r) // 2
            r = np.concatenate([r[:mid], jseq.encode("AT" * 60), r[mid:]])
        if i % 5 == 2:
            r = np.concatenate([jseq.encode("T" * 30), r])  # a poly-T head
        out.append(r)
    out.append(jseq.encode("CAG" * 100))  # all low-complexity
    out.append(jseq.encode("T" * 25 + "ACGTTGCA" * 20 + "A" * 40))
    return out


HELPER_READS = _helper_reads()


def test_orient_long_read_equals_jax():
    flips = 0
    for r in HELPER_READS:
        got, want = tpolya.orient_long_read(r), jpolya.orient_long_read(r)
        assert got[1:] == want[1:]
        assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
        flips += got[2]
        if got[2] and (r == 4).any():
            assert (got[0] == 255).sum() == (r == 4).sum()  # 3 - 4 in uint8
    assert flips >= 3


@pytest.mark.parametrize("fn", ["is_low_complexity_long", "is_low_complexity2"])
def test_low_complexity_detectors_equal_jax(fn):
    hits = 0
    for r in HELPER_READS:
        o = tpolya.orient_long_read(r)[0]
        for s in range(0, len(o) - 50, 25):
            w = o[s : s + 50]
            got = getattr(tart, fn)(w)
            assert got == getattr(jart, fn)(w)
            hits += got
    assert hits > 0


@pytest.mark.parametrize("min_len", [1, 200])
def test_extract_non_low_complexity_segments_equals_jax(min_len):
    split = 0
    for r in HELPER_READS:
        o = tpolya.orient_long_read(r)[0]
        got = tart.extract_non_low_complexity_segments(o, min_len=min_len)
        assert got == jart.extract_non_low_complexity_segments(o, min_len=min_len)
        split += len(got) != 1
    assert split > 0


@pytest.fixture(scope="module")
def corrected(tmp_path_factory):
    """Both packages' stage-1 graphs over the same reads, then
    correct_long_reads on each (with the port's walks counted)."""
    d = tmp_path_factory.mktemp("lrcorrect")
    _, reads = _sim(3, 6, 8, 0.07)
    path = str(d / "lr.fa")
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    codes = [jseq.encode(r) for r in reads]
    jcfg = js1.default_graph_config(25, False, 1 << 22, 2, -1, with_pkbf=True)
    jstate, _, jcfg = js1.build_graph_autosized(
        [path], jcfg, js1.Stage1Params(k=25, max_seq_len=512), max_fpr=0.01, mesh=None)
    tcfg = ts1.default_graph_config(25, False, 1 << 22, 2, -1, with_pkbf=True)
    tstate, _, tcfg = ts1.build_graph_autosized(
        [path], tcfg, ts1.Stage1Params(k=25, max_seq_len=512), max_fpr=0.01, device="cpu")
    params = dict(min_kmer_cov=2.0, min_seq_len=200)
    want = jlr.correct_long_reads(jstate, jcfg, codes, jlr.LongReadParams(**params))
    walks = []
    extend = engine.extend_walks

    def spy(st, graph, cfg, wcfg, min_cov, bound, mode="greedy"):
        walks.append((wcfg.max_len, st.pos.shape[0], np.asarray(bound).size))
        return extend(st, graph, cfg, wcfg, min_cov, bound, mode=mode)

    engine.extend_walks = spy
    try:
        got = tlr.correct_long_reads(tstate, tcfg, codes, tlr.LongReadParams(**params))
    finally:
        engine.extend_walks = extend
    return got, want, walks


@pytest.mark.parametrize("field", ["long", "polya", "short", "short_polya", "repeats"])
def test_correct_long_reads_equals_jax(corrected, field):
    got, want, _ = corrected
    g, w = getattr(got, field), getattr(want, field)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b
    if field == "long":
        assert len(g) > 20


def test_correction_makes_bridge_and_edge_walks(corrected):
    """Both launches of every batch: bridge walks (max_len k + max_gap + k,
    one bound) and edge walks (k + max_gap + 8, a bound per lane, padded
    to the walks' lane count)."""
    _, _, walks = corrected
    kinds = {max_len for max_len, _, _ in walks}
    assert kinds == {25 + 200 + 25, 25 + 200 + 8}
    for max_len, lanes, bounds in walks:
        assert bounds == (lanes if max_len == 25 + 200 + 8 else 1)
