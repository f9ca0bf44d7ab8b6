"""The port's single-end and mixed assembly vs the JAX package.

Unpaired reads of simulated transcripts (``stage3_common.write_se_reads``:
left mates as -sef, right mates as -ser, every 8th read split by a run of
low-quality bases, six low-complexity reads), the same settings on both
sides: the JAX package's ``assemble_se`` (``sharded="off"``; the tests'
8-device CPU mesh would pick the mesh engine) against the port on the
CPU, at ``-stage 3`` with the nr pass, mf8 through the port's CLI and u16
through ``assemble_se``; every file byte-identical.  The paired-end runs
with the unpaired reads mixed in are ``tests/test_torch_se_mixed.py``, a
file of its own: with ``--dist loadfile`` a file runs in one test process.
"""

import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import artifacts, pipeline as tpipe
from rnabloom_tpu_torch.utils import pesim
from stage3_common import COMMON, MEM, assert_same_outputs, write_se_reads
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

NUM_READS = 400  # per file


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("se")
    fwd, rev = str(d / "se_f.fq"), str(d / "se_r.fq")
    junk = write_se_reads(fwd, rev, seed=3, num_reads=NUM_READS)
    left, right = str(d / "pe_1.fq"), str(d / "pe_2.fq")
    pesim.write_pe_fastq(left, right, seed=12, num_transcripts=10, tx_len=(500, 1200), num_pairs=400)
    return {"se": (fwd, rev), "junk": junk, "pe": (left, right), "dir": d}


@pytest.mark.parametrize("counter", ["mf8", "u16"])
def test_se_stage3_outputs_byte_identical(inputs, tmp_path, monkeypatch, counter):
    fwd, rev = inputs["se"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_se(
        [fwd, rev], jout, jpipe.PipelineParams(stop_stage=3, sharded="off", counter=counter, **COMMON),
        revcomp_flags=[False, True],
    )
    joined, dropped = [], []
    connect, low_complexity = tpipe.fragmod.connect_segments_batch, artifacts.is_low_complexity_short
    monkeypatch.setattr(tpipe.fragmod, "connect_segments_batch",
                        lambda state, cfg, segs, fp: joined.append(len(segs)) or connect(state, cfg, segs, fp))
    monkeypatch.setattr(artifacts, "is_low_complexity_short",
                        lambda codes: dropped.append(low_complexity(codes)) or dropped[-1])
    if counter == "mf8":  # through the CLI
        trep = cli.run(["-sef", fwd, "-ser", rev, "-o", tout, "-stage", "3", "-mem", str(MEM / (1 << 30)),
                        "-bound", "200", "-batch", "1024", "-sample", "300", "--device", "cpu"])
    else:
        trep = tpipe.assemble_se(
            [fwd, rev], tout, tpipe.PipelineParams(stop_stage=3, counter=counter, **COMMON),
            revcomp_flags=[False, True], device="cpu",
        )
    want = assert_same_outputs(tout, jout, report=False)
    assert "rnabloom.transcripts.nr.fa" in want
    assert not any(name.endswith(".DONE") or name.endswith("readstats") for name in want)
    # the quality-split reads were re-joined through the graph, and the
    # low-complexity reads dropped before they were counted
    assert sum(joined) >= NUM_READS // 8
    assert sum(dropped) == inputs["junk"]
    assert trep.num_pairs == jrep.num_pairs == 2 * NUM_READS
    assert trep.num_fragments == jrep.num_fragments > 0
    assert (trep.num_transcripts, trep.num_short, trep.num_nr) == (jrep.num_transcripts, jrep.num_short,
                                                                   jrep.num_nr)
    assert trep.num_transcripts > 0
