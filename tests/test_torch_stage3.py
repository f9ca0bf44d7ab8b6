"""The port's paired-end stages 1-3 (``-stage 3 -norr``) as a whole vs the
JAX package, for both counter widths.

Same FASTQ pair (600 simulated pairs), same settings: the JAX package's
``pipeline.assemble_pe(..., stop_stage=3, no_reduce=True)`` on its
single-device engine (``sharded="off"``; the tests' 8-device CPU mesh
would pick the mesh engine) against the port on the CPU: mf8 through the
port's CLI, u16 through ``assemble_pe``.  Every file under the output
directory must be byte-identical, ``transcripts.fa`` and
``transcripts.short.fa`` included, except ``report.json``, which must be
equal but for ``elapsed_s``.  ``tests/test_torch_stage3_options.py``
holds the option cases and the resume (the files are split to keep each
one's run short).
"""

import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import pipeline as tpipe
from stage3_common import COMMON, MEM, assert_same_outputs, make_inputs
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("pe3"))


@pytest.mark.parametrize("counter", ["mf8", "u16"])
def test_stage3_outputs_byte_identical(inputs, tmp_path, counter):
    left, right = inputs["plain"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_pe(
        left, right, jout,
        jpipe.PipelineParams(stop_stage=3, no_reduce=True, sharded="off", counter=counter, **COMMON),
    )
    if counter == "mf8":  # through the CLI
        trep = cli.run(["-left", left, "-right", right, "-revcomp-right", "-o", tout, "-stage", "3", "-norr",
                        "-mem", str(MEM / (1 << 30)), "-bound", "200", "-batch", "1024", "-sample", "300",
                        "--device", "cpu"])
    else:
        trep = tpipe.assemble_pe(
            left, right, tout, tpipe.PipelineParams(stop_stage=3, no_reduce=True, counter=counter, **COMMON),
            device="cpu",
        )
    assert_same_outputs(tout, jout)
    assert trep.num_transcripts == jrep.num_transcripts > 0
    assert trep.num_short == jrep.num_short
    assert set(trep.stage3_spans) >= {"extend", "screen", "break", "dedup", "write"}
    assert trep.stage3_dispatches["walk"] > 0
