"""The port's -rescue pass vs the JAX package, at -stage 2.

Pairs of one transcript in the shape of the JAX package's rescue test
(``stage3_common.write_gap_pairs``): gap pairs that a bridge walk of bound
20 cannot span come first, then overlapping pairs that fill the
fragment-length sample.  Stage 2 leaves the gap pairs unconnected; the
rescue pass retries them against a fragment graph.  The JAX package
(``sharded="off"``) and the port on the CPU must rescue the same number of
pairs (at least one) and write a byte-identical fragment store, read
statistics and stamps.
"""

import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import pipeline as tpipe
from stage3_common import MEM, _files, write_gap_pairs
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

RESCUE = dict(total_mem_bytes=MEM, batch_size=64, sample_size=100, bound=20, rescue_unconnected=True, stop_stage=2)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rescue")
    left, right = str(d / "g_1.fq"), str(d / "g_2.fq")
    write_gap_pairs(left, right, seed=5)
    return left, right


@pytest.mark.parametrize("case", ["mf8_cli", "u16", "spill_cap_5", "min_fragment_cov"])
def test_rescue_stage2_byte_identical(pairs, tmp_path, monkeypatch, case):
    """``spill_cap_5``: the spill holds at most 5 pairs (the cap, lowered
    in both packages); ``min_fragment_cov``: a rescued fragment below the
    coverage floor is not stored."""
    left, right = pairs
    kw = dict(RESCUE, counter="u16" if case == "u16" else "mf8")
    if case == "spill_cap_5":
        monkeypatch.setattr(jpipe, "_RESCUE_SPILL_CAP", 5)
        monkeypatch.setattr(tpipe, "_RESCUE_SPILL_CAP", 5)
    if case == "min_fragment_cov":
        kw["min_fragment_cov"] = 3.0
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_pe(left, right, jout, jpipe.PipelineParams(sharded="off", **kw))
    if case == "mf8_cli":
        trep = cli.run(["-left", left, "-right", right, "-o", tout, "-stage", "2", "-rescue", "-bound", "20",
                        "-mem", str(MEM / (1 << 30)), "-batch", "64", "-sample", "100", "--device", "cpu"])
    else:
        trep = tpipe.assemble_pe(left, right, tout, tpipe.PipelineParams(**kw), device="cpu")
    got, want = _files(tout), _files(jout)
    assert sorted(got) == sorted(want)
    assert got == want
    assert trep.num_rescued == jrep.num_rescued >= 1
    assert trep.num_fragments == jrep.num_fragments
    if case == "spill_cap_5":
        assert trep.num_rescued <= 5
