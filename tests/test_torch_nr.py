"""The port's default ``-stage 3`` (with the non-redundant pass) against the
JAX package's, on the CPU.

Same FASTQ pair (600 simulated pairs, ``tests/stage3_common.py``), same
settings: the JAX package's ``pipeline.assemble_pe(..., stop_stage=3)`` on
its single-device engine (``sharded="off"``) against the port, mf8
through the port's CLI, u16 through ``assemble_pe``.  Every file under the
output directory must be byte-identical, ``transcripts.nr.fa`` included,
but ``report.json``, which must be equal but for ``elapsed_s``; the
spool of emitted transcripts is gone in both.  Then a ``-stage 3`` rerun
into a ``-stage 2 -savebf`` directory, which resumes at stage 2b in both
packages and runs the same nr pass, and the JAX run's transcripts through
both packages' ``layout_unitigs``.  The u16 run and the resume are
``tests/test_torch_nr_u16.py``, a file of its own: with ``--dist
loadfile`` a file runs in one test process.
"""

import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu.io import fastx as jfastx
from rnabloom_tpu.olc import layout as jlayout, overlap as jov
from rnabloom_tpu.utils import seq as jseq
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.olc import layout as tlayout, overlap as tov
from stage3_common import COMMON, MEM, assert_same_outputs, make_inputs
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("nr"))


@pytest.fixture(scope="module")
def jax_mf8(inputs, tmp_path_factory):
    """The JAX package's -stage 3 output directory and report, mf8."""
    left, right = inputs["plain"]
    out = str(tmp_path_factory.mktemp("nr_jax") / "jax")
    rep = jpipe.assemble_pe(left, right, out, jpipe.PipelineParams(stop_stage=3, sharded="off", **COMMON))
    return out, rep


def _nr_records(files):
    return files["rnabloom.transcripts.nr.fa"].decode().splitlines()


def check_nr_outputs(tout, jout, trep, jrep):
    """Every file byte-identical, ``report.json`` but ``elapsed_s``; the nr
    pass ran and reduced something."""
    files = assert_same_outputs(tout, jout)
    assert trep.num_transcripts == jrep.num_transcripts > 0
    assert trep.num_nr == jrep.num_nr > 0
    # the pass reduced something: a transcript was contained or merged
    assert trep.num_nr < trep.num_transcripts
    nr = _nr_records(files)
    assert len(nr) == 2 * trep.num_nr and nr[0].startswith(">rnabloom.nr.0 l=")
    assert "nr" in trep.stage3_spans
    assert not any(name.endswith(".2bit") for name in files)


@pytest.mark.parametrize("counter", ["mf8"])  # u16: tests/test_torch_nr_u16.py
def test_nr_outputs_byte_identical(inputs, jax_mf8, tmp_path, counter):
    """mf8 through the CLI, ``-stage 3`` being its default."""
    left, right = inputs["plain"]
    tout = str(tmp_path / "torch")
    jout, jrep = jax_mf8
    trep = cli.run(["-left", left, "-right", right, "-revcomp-right", "-o", tout,
                    "-mem", str(MEM / (1 << 30)), "-bound", "200", "-batch", "1024", "-sample", "300",
                    "--device", "cpu"])
    check_nr_outputs(tout, jout, trep, jrep)


@pytest.mark.parametrize("min_overlap", [100, 300])
def test_layout_unitigs_of_jax_transcripts(jax_mf8, min_overlap):
    """The JAX run's transcripts (its transcripts.fa, the poly-A tails
    upper-cased) through both packages' layout_unitigs."""
    out, _ = jax_mf8
    reads = [np.asarray(jseq.encode(s.upper()), np.uint8)
             for _, s in jfastx.read_fasta(f"{out}/rnabloom.transcripts.fa")]
    assert len(reads) > 5
    uj, pj, cj = jlayout.layout_unitigs(reads, 25, jov.OverlapParams(min_overlap=min_overlap))
    ut, pt, ct = tlayout.layout_unitigs(reads, 25, tov.OverlapParams(min_overlap=min_overlap), device="cpu")
    assert pt == pj and ct == cj and len(ut) == len(uj)
    for a, b in zip(ut, uj):
        np.testing.assert_array_equal(a, b)
    assert len(ut) < len(reads)
