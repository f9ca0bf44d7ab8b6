"""The port reproduces the repo's golden transcript set on the CPU.

``tests/golden/pe_golden.json`` locks the strand-normalised sha1 set of
the JAX package's ``transcripts.fa`` on ``tests/test_golden.py``'s seeded
dataset (``no_reduce=True``).  The port's ``assemble_pe`` with the same
parameters, on the same reads, must give the same set.  The port writes
those reads itself (``utils/pesim.write_golden_fastq``, for the smoke
run, which imports no JAX); they must equal ``_make_dataset``'s.
"""

import gzip
import hashlib
import json
import os

import torch

from rnabloom_tpu_torch.assembly import pipeline
from rnabloom_tpu_torch.io import fastx
from rnabloom_tpu_torch.utils import pesim
from test_golden import GOLDEN, _canonical_set, _make_dataset

torch.set_num_threads(2)


def test_golden_reads_equal_the_jax_datasets(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    for a, b in zip(_make_dataset(str(tmp_path / "jax")), pesim.write_golden_fastq(str(tmp_path / "torch"))):
        assert os.path.basename(a) == os.path.basename(b)
        with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_port_reproduces_the_golden_set(tmp_path):
    left, right = pesim.write_golden_fastq(str(tmp_path))
    params = pipeline.PipelineParams(total_mem_bytes=1 << 22, batch_size=256, sample_size=100, no_reduce=True)
    report = pipeline.assemble_pe(left, right, str(tmp_path / "out"), params, device="cpu")
    fa = str(tmp_path / "out" / "rnabloom.transcripts.fa")
    got = _canonical_set(fa)
    with open(GOLDEN) as f:
        want = json.load(f)["transcript_sha1"]
    assert got == want
    assert report.num_transcripts == len(got) == 3
    # the same strand-normalised hashes without the JAX package's helpers
    rc = str.maketrans("ACGT", "TGCA")
    own = sorted(hashlib.sha1(min(s.upper(), s.upper().translate(rc)[::-1]).encode()).hexdigest()[:16]
                 for _, s in fastx.read_fasta(fa))
    assert own == want
