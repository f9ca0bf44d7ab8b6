"""The port's ``-stage 3 -norr`` against the JAX package's with stage-3
options, on the CPU (see ``tests/test_torch_stage3.py`` for the set-up):
``-a`` on reads whose transcripts carry poly-A tails or poly-T heads (the
writer's flip, ``pas=`` and the lower-cased tail), with ``-length`` high
enough for short transcripts, ``-u`` and ``-prefix``; and ``-ref`` with
reference transcripts added to the fragment graph.  Every output file
byte-identical, ``report.json`` equal but for ``elapsed_s``.  Then a rerun
into a ``-stage 2 -savebf`` directory, which resumes at stage 2b from the
stamps in both packages, and a ``-stage 2`` rerun, which the port does not
resume.  The ``-ref`` case is ``tests/test_torch_stage3_ref.py``, a file
of its own: with ``--dist loadfile`` a file runs in one test process.
"""

import os
import shutil

import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu_torch.assembly import pipeline as tpipe
from stage3_common import COMMON, assert_same_outputs, make_inputs
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

CASES = {
    "polya_short_u_prefix": ("polya", {"polya_min_len": 10, "min_transcript_length": 600, "write_uracil": True,
                                       "header_prefix": "tx_"}, []),
    "ref": ("plain", {}, ["ref"]),
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("pe3o"))


def check_case(inputs, tmp_path, case):
    reads, kw, refs = CASES[case]
    left, right = inputs[reads]
    ref_paths = [inputs[r] for r in refs]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_pe(
        left, right, jout, jpipe.PipelineParams(stop_stage=3, no_reduce=True, sharded="off", **COMMON, **kw),
        ref_paths=ref_paths,
    )
    trep = tpipe.assemble_pe(
        left, right, tout, tpipe.PipelineParams(stop_stage=3, no_reduce=True, **COMMON, **kw),
        device="cpu", ref_paths=ref_paths,
    )
    files = assert_same_outputs(tout, jout)
    assert trep.num_transcripts == jrep.num_transcripts > 0
    assert trep.num_short == jrep.num_short
    if case.startswith("polya"):
        fa = files["rnabloom.transcripts.fa"].decode()
        seqs = fa.splitlines()[1::2]
        assert trep.num_short > 0 and fa.startswith(">tx_rnabloom.0 l=") and "pas=" in fa
        assert any("a" in s for s in seqs) and any("U" in s for s in seqs) and not any("T" in s for s in seqs)
        assert files["rnabloom.transcripts.short.fa"].decode().startswith(">tx_rnabloom.s0\n")


@pytest.mark.parametrize("case", ["polya_short_u_prefix"])  # ref: tests/test_torch_stage3_ref.py
def test_stage3_options_byte_identical(inputs, tmp_path, case):
    check_case(inputs, tmp_path, case)


def test_stage3_resumes_from_stamps(inputs, tmp_path):
    """A -stage 3 -norr rerun into a -stage 2 -savebf directory resumes at
    stage 2b in both packages: the same files, and no report.json."""
    left, right = inputs["plain"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpipe.assemble_pe(left, right, jout, jpipe.PipelineParams(stop_stage=2, sharded="off", **COMMON), save_graph=True)
    shutil.copytree(jout, tout)
    trep = tpipe.assemble_pe(left, right, tout, tpipe.PipelineParams(stop_stage=3, no_reduce=True, **COMMON),
                             device="cpu")
    jrep = jpipe.assemble_pe(left, right, jout,
                             jpipe.PipelineParams(stop_stage=3, no_reduce=True, sharded="off", **COMMON))
    assert trep.num_pairs == jrep.num_pairs == 0  # stages 1-2 did not run again
    assert trep.num_transcripts == jrep.num_transcripts > 0
    assert_same_outputs(tout, jout, report=False)
    assert os.path.exists(os.path.join(tout, "TRANSCRIPTS.DONE"))


def test_stage2_rerun_stops_at_stage_2(inputs, tmp_path):
    """Unlike the JAX package, whose resume jumps to stage 3 whatever
    -stage asks for, a -stage 2 rerun into a finished -stage 2 directory
    runs stages 1-2 again and writes no transcripts (the reference stops
    at -stage 2)."""
    left, right = inputs["plain"]
    out = str(tmp_path / "torch")
    params = tpipe.PipelineParams(stop_stage=2, **COMMON)
    first = tpipe.assemble_pe(left, right, out, params, save_graph=True, device="cpu")
    again = tpipe.assemble_pe(left, right, out, params, save_graph=True, device="cpu")
    assert again.num_pairs == first.num_pairs > 0 and again.num_fragments == first.num_fragments
    assert not os.path.exists(os.path.join(out, "rnabloom.transcripts.fa"))
