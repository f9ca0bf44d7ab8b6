"""The port's paired-end stages 1-2 as a whole vs the JAX package.

Same FASTQ pair (simulated with numpy), same settings: the JAX package's
``pipeline.assemble_pe(..., stop_stage=2, save_graph=True)`` on its
single-device engine (``sharded="off"``; the tests' 8-device CPU mesh
would pick the mesh engine) against the port's CLI ``-stage 2 -savebf
--device cpu``.  Every file under the output directory must be
byte-identical: the fragment store's ``.nbits`` files and metadata, the
graph checkpoint with the learned fragment pair distance, the read
statistics and the stage stamps.  The reads carry low-quality bases and
Ns, so reads split into segments that stage 2 re-joins through the graph.
The u16 case runs two stage-2 batches with a fragment sample that fills
in the first, so the second walks with the learned bound, and both
packages read the FASTQ with the pure-Python reader instead of the native
one.  ``-bound 200`` (the JAX package's ``bound``) keeps the walks, and
so the CPU run, short.
"""

import os

import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu.io import native
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.io import native as tnative
from rnabloom_tpu_torch.utils import pesim
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

MEM = 1 << 22


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("pe2")
    left, right = str(d / "r_1.fq"), str(d / "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=11, num_transcripts=20, tx_len=(500, 1500), num_pairs=1500)
    rng = np.random.default_rng(4)
    for path in (left, right):
        with open(path) as f:
            lines = f.read().split("\n")
        for i in range(1, len(lines) - 1, 4):
            if rng.random() < 0.15:  # one low-quality base (q2 < -q 3) and one N
                seq, qual = list(lines[i]), list(lines[i + 2])
                qual[rng.integers(30, 120)] = "#"
                seq[rng.integers(len(seq))] = "N"
                lines[i], lines[i + 2] = "".join(seq), "".join(qual)
        with open(path, "w") as f:
            f.write("\n".join(lines))
    return left, right


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize(
    "counter,batch,sample,native_reader", [("mf8", 8192, 1000, True), ("u16", 1024, 300, False)]
)
def test_stage2_outputs_byte_identical(reads, tmp_path, monkeypatch, counter, batch, sample, native_reader):
    left, right = reads
    if not native_reader:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_pe(
        left, right, jout,
        jpipe.PipelineParams(stop_stage=2, total_mem_bytes=MEM, counter=counter, sharded="off",
                             batch_size=batch, sample_size=sample, bound=200),
        save_graph=True,
    )
    trep = cli.run([
        "-left", left, "-right", right, "-revcomp-right", "-o", tout, "-stage", "2", "-savebf",
        "-mem", repr(MEM / (1 << 30)), "-cnt", counter, "-batch", str(batch), "-sample", str(sample),
        "-bound", "200", "--device", "cpu",
    ])
    for name in ("num_pairs", "num_fragments", "fragment_pair_distance", "stage2_batches"):
        assert getattr(trep, name) == getattr(jrep, name), name
    assert trep.num_fragments > 900 and trep.stage2_batches == -(-1500 // batch)
    want, got = _files(jout), _files(tout)
    assert sorted(got) == sorted(want)
    assert any(f.startswith("fragments") and f.endswith(".nbits") for f in got)
    for f in want:
        assert got[f] == want[f], f"{f} differs"


def test_stage2_cli_quality_and_coverage_flags_byte_identical(reads, tmp_path):
    """-stranded, -Q, -c and -grad through the port's CLI against the JAX
    package's assemble_pe with the same PipelineParams fields."""
    left, right = reads
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_pe(
        left, right, jout,
        jpipe.PipelineParams(stop_stage=2, total_mem_bytes=MEM, sharded="off", batch_size=8192, sample_size=1000,
                             bound=200, stranded=True, min_avg_qual=30, min_kmer_cov=2, max_cov_gradient=0.3),
        save_graph=True,
    )
    trep = cli.run([
        "-left", left, "-right", right, "-revcomp-right", "-o", tout, "-stage", "2", "-savebf",
        "-mem", repr(MEM / (1 << 30)), "-bound", "200", "-stranded", "-Q", "30", "-c", "2", "-grad", "0.3",
        "--device", "cpu",
    ])
    assert (trep.num_pairs, trep.num_fragments) == (jrep.num_pairs, jrep.num_fragments)
    assert 0 < trep.num_fragments
    want, got = _files(jout), _files(tout)
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f"{f} differs"
