"""The port's paired-end run with unpaired reads mixed in against the JAX
package's, on the CPU, at ``-stage 2``: the fragment store, the read
statistics and the stamps byte-identical (the reads and the single-end
runs are ``tests/test_torch_se.py``).
"""

import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import pipeline as tpipe
from rnabloom_tpu_torch.assembly.fragstore import FragmentStore
from stage3_common import COMMON, MEM, _files
from test_torch_se import inputs  # noqa: F401  (the module fixture)
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["cli_at_list", "min_cov_extend"])
def test_mixed_pe_se_stage2_byte_identical(inputs, tmp_path, case):  # noqa: F811
    """-left/-right with -sef/-ser: the unpaired reads join the stage-1
    graph and become unconnected fragments after the pairs.  ``cli_at_list``:
    through the CLI, -sef given as an @list.  ``min_cov_extend``: with
    -extend and a coverage floor, which the JAX package applies to the
    pairs' fragments only; the unpaired reads' fragments are stored below
    it and were never extended."""
    left, right = inputs["pe"]
    fwd, rev = inputs["se"]
    kw = dict(COMMON, stop_stage=2)
    if case == "min_cov_extend":
        kw.update(min_fragment_cov=3.0, extend_fragments=True)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_pe(left, right, jout, jpipe.PipelineParams(sharded="off", **kw),
                             sef_paths=[fwd], ser_paths=[rev])
    if case == "cli_at_list":
        listed = tmp_path / "sef.txt"
        listed.write_text(f"{fwd}\n\n")
        trep = cli.run(["-left", left, "-right", right, "-sef", f"@{listed}", "-ser", rev, "-o", tout, "-stage",
                        "2", "-mem", str(MEM / (1 << 30)), "-bound", "200", "-batch", "1024", "-sample", "300",
                        "--device", "cpu"])
    else:
        trep = tpipe.assemble_pe(left, right, tout, tpipe.PipelineParams(**kw), sef_paths=[fwd], ser_paths=[rev],
                                 device="cpu")
    got, want = _files(tout), _files(jout)
    assert sorted(got) == sorted(want)
    assert got == want
    assert any(name.endswith(".un.nbits") for name in want)
    assert trep.num_pairs == jrep.num_pairs
    assert trep.num_fragments == jrep.num_fragments > 0
    if case == "min_cov_extend":  # unpaired reads' fragments below the floor
        covs = FragmentStore.open(tout)._covs
        assert any(c < 3.0 for key, v in covs.items() if ".un" in key for c in v)
