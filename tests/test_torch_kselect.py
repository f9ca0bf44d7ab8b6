"""The port's k selection and distinct-k-mer estimates (``utils/kselect``)
and the CLI options that use them, vs the JAX package.

Each ``kselect`` function against the JAX one on the same reads: the
spec parser, the int32 count-min sketch counts, the chosen k, the ntCard
``.hist`` parser and the ``-ntcard`` estimate.  Then the port's CLI with
``-k 25,27``, ``-pair``, ``-sensitive``, ``-hist``, ``-ntcard``, ``@list``
inputs and ``-t`` against the JAX CLI with the same flags (and
``-sharded off``) at ``-stage 2 -savebf``: every file byte-identical, the
graph checkpoint (its filter sizes) included.
"""

import numpy as np
import pytest
import torch

from rnabloom_tpu import cli as jcli
from rnabloom_tpu.utils import kselect as jks
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.io import fastx
from rnabloom_tpu_torch.utils import kselect as tks, pesim, seq as sequtils
from stage3_common import MEM, _files
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("kselect")
    left, right = str(d / "r_1.fq"), str(d / "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=9, num_transcripts=10, tx_len=(500, 1000), num_pairs=500)
    return left, right


@pytest.mark.parametrize("spec", ["25", "25,27", "21-31:2", "31,21-25,25", " 25 , 30-50:5 ", "19-21"])
def test_parse_k_spec_equals_jax(spec):
    assert tks.parse_k_spec(spec) == jks.parse_k_spec(spec)


@pytest.mark.parametrize("k", [21, 25, 31])
def test_count_nonsingletons_equals_jax(reads, k):
    sample = [sequtils.encode(s) for _, s, _ in fastx.read_seqs(reads[0])][:300]
    # a few short reads, one shorter than k
    sample += [sample[0][:40], sample[1][: k - 1]]
    got = tks.count_nonsingletons(sample, k, device="cpu")
    assert got == jks.count_nonsingletons(sample, k)
    assert got[0] > got[1] > 0
    assert tks.count_nonsingletons([sample[0][: k - 1]], k, device="cpu") == (0, 0)


@pytest.mark.parametrize("k_values", [[25, 27], [21, 25, 31], [27]])
def test_select_k_equals_jax(reads, k_values):
    assert tks.select_k(list(reads), k_values, sample_size=400, device="cpu") == jks.select_k(
        list(reads), k_values, sample_size=400)


def test_select_k_tie_takes_the_first_k(monkeypatch):
    monkeypatch.setattr(tks, "count_nonsingletons", lambda reads, k, device: (9, 7))
    assert tks.select_k([], [27, 25, 31], device="cpu") == 27


def test_ntcard_histogram_equals_jax(tmp_path):
    path = tmp_path / "k25.hist"
    path.write_text("F1\t812345\nF0\t54321\n1\t30000\n2\t9000\n3\t4000\n4\t4100\n5\t3000\nbad line here\n70000\t5\n")
    t, j = tks.NTCardHistogram(str(path)), jks.NTCardHistogram(str(path))
    assert (t.f0, t.f1, t.num_unique, t.num_singletons, t.min_cov_threshold()) == (
        j.f0, j.f1, j.num_unique, j.num_singletons, j.min_cov_threshold())
    assert np.array_equal(t.counts, j.counts)
    assert t.num_unique == 54321 and t.min_cov_threshold() == 3


@pytest.mark.parametrize("sample_size", [10000, 200])
def test_estimate_num_unique_kmers_equals_jax(reads, sample_size):
    got = tks.estimate_num_unique_kmers(list(reads), 25, sample_size=sample_size, device="cpu")
    assert got == jks.estimate_num_unique_kmers(list(reads), 25, sample_size=sample_size)
    assert got > 0


CLI_CASES = {
    # -k list, -pair, -sensitive, -hist (which wins over -ntcard), -t;
    # every case reads @list inputs
    "k_list_hist": ["-k", "25,27", "-pair", "5", "-sensitive", "-hist", "HIST", "-ntcard", "-t", "4"],
    # -ntcard sizes the filters when -nk is 0
    "ntcard": ["-k", "27", "-ntcard", "-t", "4"],
    # -nk wins over -ntcard
    "nk_over_ntcard": ["-k", "21-25:4", "-nk", "30000", "-ntcard", "-pair", "8"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_options_byte_identical(reads, tmp_path, monkeypatch, case):
    left, right = reads
    hist = tmp_path / "k.hist"
    hist.write_text("F1\t300000\nF0\t40000\n1\t20000\n2\t8000\n")
    (tmp_path / "l.txt").write_text(f"{left}\n")
    (tmp_path / "r.txt").write_text(f"\n{right}\n")
    flags = [str(hist) if f == "HIST" else f for f in CLI_CASES[case]]
    common = ["-left", f"@{tmp_path / 'l.txt'}", "-right", f"@{tmp_path / 'r.txt'}", "-stage", "2", "-savebf",
              "-mem", str(MEM / (1 << 30)), "-bound", "200", "-batch", "1024", "-sample", "300"] + flags
    # the JAX CLI without its persistent compilation cache (it would
    # write under the home directory)
    monkeypatch.setattr(jcli, "_enable_compilation_cache", lambda: None)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jcli.main(common + ["-o", jout, "-sharded", "off"]) == 0
    assert cli.main(common + ["-o", tout, "--device", "cpu"]) == 0
    got, want = _files(tout), _files(jout)
    assert sorted(got) == sorted(want)
    assert got == want
    assert any(name.endswith(".nbits") for name in want) and "rnabloom.graph.graph.json" in want
