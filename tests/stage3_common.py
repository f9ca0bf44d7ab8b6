"""Shared inputs and checks of the port's stage-3 parity tests
(``tests/test_torch_stage3.py``, ``tests/test_torch_stage3_options.py``):
the simulated read sets, a reference FASTA, and the comparison of two
output directories."""

import json
import os

import numpy as np

from rnabloom_tpu_torch.utils import pesim

MEM = 1 << 22
COMMON = dict(total_mem_bytes=MEM, bound=200, batch_size=1024, sample_size=300)


def _polya_fastq(left, right):
    """Pairs off 12 transcripts of 500-900 bases: four end in a 40-base
    poly-A tail, four start with a 40-base poly-T head (an antisense tail),
    four have neither; a PAS motif sits 20 bases before each tail."""
    rng = np.random.default_rng(31)
    txs = []
    for i in range(12):
        t = rng.integers(0, 4, int(rng.integers(500, 900)), dtype=np.uint8)
        if i % 3 == 0:
            t[-26:-20] = [0, 0, 3, 0, 0, 0]  # AATAAA
            t = np.concatenate([t, np.zeros(40, np.uint8)])
        elif i % 3 == 1:
            t[20:26] = [3, 3, 3, 0, 3, 3]  # reverse complement of AATAAA
            t = np.concatenate([np.full(40, 3, np.uint8), t])
        txs.append(t)
    lengths = np.array([len(t) for t in txs])
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    tx = (np.concatenate(txs), offsets, lengths)
    w = rng.lognormal(0.0, 1.0, size=12)
    lreads, rreads = pesim.sample_pairs(rng, tx, w / w.sum(), 700, frag_range=(250, 400))
    with open(left, "wb") as fl, open(right, "wb") as fr:
        fl.write(pesim.fastq_bytes(lreads, 0, 1))
        fr.write(pesim.fastq_bytes(rreads, 0, 2))


def make_inputs(d):
    """{"plain": (left, right), "polya": (left, right), "ref": path} under
    the directory ``d``."""
    out = {"plain": (str(d / "r_1.fq"), str(d / "r_2.fq")), "polya": (str(d / "a_1.fq"), str(d / "a_2.fq"))}
    tx = pesim.write_pe_fastq(*out["plain"], seed=11, num_transcripts=20, tx_len=(500, 1500), num_pairs=600)
    _polya_fastq(*out["polya"])
    # -ref: two of the simulated transcripts, one cut to 300 bases, and a
    # novel one
    bases, offsets, lengths = tx
    refs = [bases[offsets[1] : offsets[1] + lengths[1]], bases[offsets[5] : offsets[5] + 300],
            np.random.default_rng(2).integers(0, 4, 700, dtype=np.uint8)]
    out["ref"] = str(d / "ref.fa")
    with open(out["ref"], "w") as f:
        for i, r in enumerate(refs):
            f.write(f">ref{i}\n" + "".join("ACGT"[c] for c in r) + "\n")
    return out


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def assert_same_outputs(tout, jout, report=True):
    got, want = _files(tout), _files(jout)
    assert sorted(got) == sorted(want)
    name = "rnabloom.report.json"
    assert (name in want) == report
    if report:
        a, b = json.loads(got.pop(name)), json.loads(want.pop(name))
        assert a.pop("elapsed_s") >= 0 and b.pop("elapsed_s") >= 0
        assert a == b
    for f in want:
        assert got[f] == want[f], f
    assert want["rnabloom.transcripts.fa"]
    return want
