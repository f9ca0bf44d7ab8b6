"""The port's default ``-stage 3`` (with the non-redundant pass) against the
JAX package's on the CPU, u16 through ``assemble_pe``, and a ``-stage 3``
rerun into a ``-stage 2 -savebf`` directory, which resumes at stage 2b in
both packages and runs the same nr pass (the set-up and the mf8 run are
``tests/test_torch_nr.py``).
"""

import shutil

import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu_torch.assembly import pipeline as tpipe
from stage3_common import COMMON, assert_same_outputs
from test_torch_nr import _nr_records, check_nr_outputs, inputs  # noqa: F401  (the module fixture)
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


@pytest.mark.parametrize("counter", ["u16"])
def test_nr_outputs_byte_identical(inputs, tmp_path, counter):  # noqa: F811
    left, right = inputs["plain"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_pe(
        left, right, jout, jpipe.PipelineParams(stop_stage=3, sharded="off", counter=counter, **COMMON),
    )
    trep = tpipe.assemble_pe(
        left, right, tout, tpipe.PipelineParams(stop_stage=3, counter=counter, **COMMON), device="cpu",
    )
    check_nr_outputs(tout, jout, trep, jrep)


def test_nr_resume_from_stamps(inputs, tmp_path):  # noqa: F811
    """A -stage 3 rerun into a -stage 2 -savebf directory resumes at stage
    2b in both packages: the same files, transcripts.nr.fa included, and
    no report.json."""
    left, right = inputs["plain"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jpipe.assemble_pe(left, right, jout, jpipe.PipelineParams(stop_stage=2, sharded="off", **COMMON), save_graph=True)
    shutil.copytree(jout, tout)
    trep = tpipe.assemble_pe(left, right, tout, tpipe.PipelineParams(stop_stage=3, **COMMON), device="cpu")
    jrep = jpipe.assemble_pe(left, right, jout, jpipe.PipelineParams(stop_stage=3, sharded="off", **COMMON))
    assert trep.num_pairs == jrep.num_pairs == 0  # stages 1-2 did not run again
    assert trep.num_nr == jrep.num_nr > 0
    files = assert_same_outputs(tout, jout, report=False)
    assert _nr_records(files)
