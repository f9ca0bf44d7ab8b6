"""The port's ``-extend`` (stage 2's naive fragment extension, with
back-branch checks) against the JAX package's, on the CPU.

``-stage 2 -extend -savebf`` on the reads of ``tests/test_torch_stage2.py``
(low-quality bases and Ns; mf8 through the port's CLI with one batch, u16
through ``assemble_pe`` with two batches and the pure-Python reader), and
``-stage 3 -norr -extend`` on the reads of ``tests/stage3_common.py``:
every file under the output directory byte-identical (the fragment store,
the checkpoint, the read statistics, the transcripts), ``report.json``
equal but for ``elapsed_s``.  The extension must change the fragments:
the same run without ``-extend`` stores other ones.  (The ``-stage 3``
case is ``tests/test_torch_extend_stage3.py``, a file of its own: with
``--dist loadfile`` a file runs in one test process.)
"""

import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu.io import native
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import pipeline as tpipe
from rnabloom_tpu_torch.io import native as tnative
from stage3_common import _files
from test_torch_stage2 import MEM, reads  # noqa: F401  (the module fixture)
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


def _fragments(root):
    return {f: b for f, b in _files(root).items() if f.startswith("fragments") and f.endswith(".nbits")}


@pytest.mark.parametrize("counter,batch,sample,native_reader", [("mf8", 8192, 1000, True), ("u16", 1024, 300, False)])
def test_stage2_extend_byte_identical(reads, tmp_path, monkeypatch, counter, batch, sample, native_reader):  # noqa: F811
    left, right = reads
    if not native_reader:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    jout, tout, plain = str(tmp_path / "jax"), str(tmp_path / "torch"), str(tmp_path / "plain")
    kw = dict(stop_stage=2, total_mem_bytes=MEM, counter=counter, batch_size=batch, sample_size=sample, bound=200)
    jrep = jpipe.assemble_pe(left, right, jout, jpipe.PipelineParams(sharded="off", extend_fragments=True, **kw),
                             save_graph=True)
    if counter == "mf8":
        trep = cli.run([
            "-left", left, "-right", right, "-revcomp-right", "-o", tout, "-stage", "2", "-savebf", "-extend",
            "-mem", repr(MEM / (1 << 30)), "-cnt", counter, "-batch", str(batch), "-sample", str(sample),
            "-bound", "200", "--device", "cpu",
        ])
    else:
        trep = tpipe.assemble_pe(left, right, tout, tpipe.PipelineParams(extend_fragments=True, **kw),
                                 save_graph=True, device="cpu")
    for name in ("num_pairs", "num_fragments", "fragment_pair_distance", "stage2_batches"):
        assert getattr(trep, name) == getattr(jrep, name), name
    want, got = _files(jout), _files(tout)
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f"{f} differs"
    tpipe.assemble_pe(left, right, plain, tpipe.PipelineParams(**kw), save_graph=True, device="cpu")
    assert _fragments(plain) != _fragments(tout)
