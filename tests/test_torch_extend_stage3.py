"""The port's ``-stage 3 -norr -extend`` against the JAX package's, on the
CPU, on the reads of ``tests/stage3_common.py``: every file under the
output directory byte-identical, ``report.json`` equal but for
``elapsed_s`` (the ``-stage 2 -extend`` cases are
``tests/test_torch_extend.py``).
"""

import os

import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu_torch.assembly import pipeline as tpipe
from stage3_common import COMMON, assert_same_outputs, make_inputs
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


def test_stage3_norr_extend_byte_identical(tmp_path):
    left, right = make_inputs(tmp_path)["plain"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_pe(
        left, right, jout,
        jpipe.PipelineParams(stop_stage=3, no_reduce=True, extend_fragments=True, sharded="off", **COMMON),
    )
    trep = tpipe.assemble_pe(
        left, right, tout, tpipe.PipelineParams(stop_stage=3, no_reduce=True, extend_fragments=True, **COMMON),
        device="cpu",
    )
    assert_same_outputs(tout, jout)
    assert trep.num_transcripts == jrep.num_transcripts > 0
    assert not os.path.exists(os.path.join(tout, "rnabloom.transcripts.nr.fa"))
