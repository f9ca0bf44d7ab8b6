"""The port's paired-end stage-1 slice as a whole vs the JAX package.

Same FASTQ pair (simulated with numpy), same settings: the JAX package's
``pipeline.assemble_pe(..., stop_stage=1, save_graph=True)`` on its
single-device engine (``sharded="off"``: the mesh engine, which the tests'
8-device CPU mesh would pick, merges shards into a checkpoint with zeroed
trash cells and is not ported) against the port's CLI ``-stage 1 -savebf
--device cpu``.  The checkpoints must be byte-identical and the stage-1
statistics equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.utils import pesim
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

FILES = ("rnabloom.graph.graph.json", "rnabloom.graph.cbf.npy", "rnabloom.graph.rpkbf.npy")


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("pe")
    left, right = str(d / "r_1.fq"), str(d / "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=11, num_transcripts=20, tx_len=(500, 1500), num_pairs=1500)
    return left, right


def _run_both(reads, tmp_path, mem_bytes, counter):
    left, right = reads
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrep = jpipe.assemble_pe(
        left, right, jout,
        jpipe.PipelineParams(stop_stage=1, total_mem_bytes=mem_bytes, counter=counter, sharded="off"),
        save_graph=True,
    )
    trep = cli.run([
        "-left", left, "-right", right, "-revcomp-right", "-o", tout, "-stage", "1", "-savebf",
        "-mem", repr(mem_bytes / (1 << 30)), "-cnt", counter, "--device", "cpu",
    ])
    return jout, tout, jrep.stage1, trep.stage1


def _assert_same(jout, tout, js, ts):
    for f in FILES:
        with open(os.path.join(jout, f), "rb") as a, open(os.path.join(tout, f), "rb") as b:
            assert a.read() == b.read(), f"{f} differs"
    for f in FILES[1:]:
        np.testing.assert_array_equal(np.load(os.path.join(tout, f)), np.load(os.path.join(jout, f)))
    with open(os.path.join(jout, FILES[0])) as a, open(os.path.join(tout, FILES[0])) as b:
        assert json.load(a) == json.load(b)
    for name in ("num_reads", "num_segments", "num_bases", "num_batches",
                 "read_pair_distance", "max_tip_length", "distinct_kmers_est"):
        assert getattr(ts, name) == getattr(js, name), name
    # the JAX package sums popcounts in float32 on its device; the port
    # counts exactly and divides in float32, so the sums may round apart
    # in the last place once a popcount passes 2^24
    assert ts.fprs.keys() == js.fprs.keys()
    for k in js.fprs:
        np.testing.assert_allclose(ts.fprs[k], js.fprs[k], rtol=1e-6)


@pytest.mark.parametrize("counter", ["mf8", "u16", "int32"])
def test_stage1_checkpoint_matches_jax(reads, tmp_path, counter):
    jout, tout, js, ts = _run_both(reads, tmp_path, 1 << 22, counter)
    _assert_same(jout, tout, js, ts)
    assert ts.num_reads == 3000 and ts.num_batches == 2


def test_stage1_fpr_resize_matches_jax(reads, tmp_path):
    """A 16 KiB budget overfills every filter: the resize loop fires in
    both packages and ends at the same sizes."""
    jout, tout, js, ts = _run_both(reads, tmp_path, 1 << 14, "mf8")
    _assert_same(jout, tout, js, ts)
    with open(os.path.join(tout, FILES[0])) as f:
        desc = json.load(f)
    assert desc["cbf"]["size_log2"] > 13 and desc["pkbf"]["size_log2"] > 11
