"""The port's pooled assembly (-pool, -mergepool) vs the JAX package.

``parse_pool_list`` against the JAX function on header rows, '-' cells and
comma lists.  ``assemble_pool`` over two samples of simulated pairs, the
second with unpaired reads in a ``sef`` column, at ``-stage 3`` with the
nr pass, then ``merge_pool``: the JAX package (``sharded="off"``) and the
port on the CPU write every file byte-identical, and the per-sample
reports agree.  A sample run alone on the shared graph writes what it
writes inside the pool: the samples before it leave the shared graph as
it was.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import pipeline as jpipe
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import pipeline as tpipe
from rnabloom_tpu_torch.utils import pesim
from stage3_common import COMMON, MEM, _files, write_se_reads
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

REPORT_FIELDS = ("num_pairs", "num_fragments", "num_rescued", "num_transcripts", "num_short", "num_nr",
                 "fragment_pair_distance", "stage2_batches")

POOL_LISTS = {
    "default_columns": "sA a_1.fq a_2.fq\nsB b_1.fq b_2.fq x.fq,y.fq z.fq\n",
    "header_reordered": "# name right left ser\n\nsA a_2.fq a_1.fq -\nsB b_2.fq b_1.fq r1.fq,,r2.fq\n",
    "dash_and_comma_cells": "sA a_1.fq a_2.fq - -\nsB b_1.fq b_2.fq f1.fq,f2.fq -\n",
    "comment_that_is_no_header": "# samples of run 7\nsA a_1.fq a_2.fq\n",
    "header_with_sef_only": "#name left right sef\nsB b_1.fq b_2.fq x.fq\n",
}


@pytest.mark.parametrize("case", sorted(POOL_LISTS))
def test_parse_pool_list_equals_jax(tmp_path, case):
    path = tmp_path / "pool.txt"
    path.write_text(POOL_LISTS[case])
    assert tpipe.parse_pool_list(str(path)) == jpipe.parse_pool_list(str(path))


@pytest.mark.parametrize("text", ["sA a_1.fq\n", "#name left sef\nsA a_1.fq x.fq\n"])
def test_parse_pool_list_rejects_what_jax_rejects(tmp_path, text):
    path = tmp_path / "pool.txt"
    path.write_text(text)
    with pytest.raises(ValueError):
        jpipe.parse_pool_list(str(path))
    with pytest.raises(ValueError):
        tpipe.parse_pool_list(str(path))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    d = tmp_path_factory.mktemp("pool")
    pesim.write_pe_fastq(str(d / "a_1.fq"), str(d / "a_2.fq"), seed=21, num_transcripts=8, tx_len=(500, 1000),
                         num_pairs=300)
    pesim.write_pe_fastq(str(d / "b_1.fq"), str(d / "b_2.fq"), seed=22, num_transcripts=8, tx_len=(500, 1000),
                         num_pairs=300)
    write_se_reads(str(d / "bf.fq"), str(d / "br.fq"), seed=23, num_transcripts=4, num_reads=100)
    path = d / "pool.txt"
    # listed out of name order: samples run sorted by name
    path.write_text(f"#name left right sef\nsB {d}/b_1.fq {d}/b_2.fq {d}/bf.fq\nsA {d}/a_1.fq {d}/a_2.fq -\n")
    return str(path)


def test_pool_and_merge_byte_identical(pool, tmp_path):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jparams = jpipe.PipelineParams(stop_stage=3, sharded="off", **COMMON)
    jreps = jpipe.assemble_pool(pool, jout, jparams)
    n_merged = jpipe.merge_pool(jout, sorted(jreps), jparams)
    # through the CLI: -mergepool after the pool run
    treps = cli.run(["-pool", pool, "-mergepool", "-o", tout, "-mem", str(MEM / (1 << 30)), "-bound", "200",
                     "-batch", "1024", "-sample", "300", "--device", "cpu"])
    got, want = _files(tout), _files(jout)
    assert sorted(got) == sorted(want)
    assert got == want
    assert n_merged > 0 and "rnabloom.transcripts.merged.fa" in want
    for name in ("sA", "sB"):
        assert f"{name}/rnabloom.transcripts.nr.fa" in want
    assert any(f.startswith("sB/fragments/") and f.endswith(".un.nbits") for f in want)
    assert list(treps) == list(jreps) == ["sA", "sB"]
    # the JAX package's quirk: a pool sample counts every row of its
    # stage-2 batches, the padded ones included (one batch of 1024 here)
    assert treps["sA"].num_pairs == 1024
    for name in treps:
        t, j = dataclasses.asdict(treps[name]), dataclasses.asdict(jreps[name])
        assert {f: t[f] for f in REPORT_FIELDS} == {f: j[f] for f in REPORT_FIELDS}
        assert t["num_transcripts"] > 0


def test_pool_stage2_keeps_the_reference_quirks(pool, tmp_path):
    """As in the JAX package, a pool sample's stage 2 holds no fragment
    to ``min_fragment_cov`` and walks with the given bound throughout (it
    never learns one from the fragment sample): with a floor no fragment
    reaches and a small sample, the stores still equal the JAX package's,
    and hold fragments."""
    kw = dict(COMMON, stop_stage=2, min_fragment_cov=1e9, bound=20, sample_size=20)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jreps = jpipe.assemble_pool(pool, jout, jpipe.PipelineParams(sharded="off", **kw))
    treps = tpipe.assemble_pool(pool, tout, tpipe.PipelineParams(**kw), device="cpu")
    assert _files(tout) == _files(jout)
    assert [r.num_fragments for r in treps.values()] == [r.num_fragments for r in jreps.values()]
    assert all(r.num_fragments > 0 for r in treps.values())


def test_merge_pool_falls_back_to_transcripts_fa(tmp_path):
    """-mergepool reads a sample's transcripts.fa when it has no nr set,
    and skips a sample with neither."""
    seqs = [pesim.make_transcripts(np.random.default_rng(i), 3, 300, 600) for i in range(2)]
    for name, (bases, offsets, lengths) in zip(("s1", "s2"), seqs):
        (tmp_path / name).mkdir()
        fname = "rnabloom.transcripts.nr.fa" if name == "s1" else "rnabloom.transcripts.fa"
        with open(tmp_path / name / fname, "w") as f:
            for i, (o, n) in enumerate(zip(offsets, lengths)):
                f.write(f">t{i}\n" + "".join("ACGT"[c] for c in bases[o : o + n]) + "\n")
    (tmp_path / "s3").mkdir()
    tparams, jparams = tpipe.PipelineParams(), jpipe.PipelineParams(sharded="off")
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    n = tpipe.merge_pool(str(tmp_path), ["s1", "s2", "s3"], tparams, device="cpu")
    (tmp_path / "rnabloom.transcripts.merged.fa").rename(tdir)
    assert jpipe.merge_pool(str(tmp_path), ["s1", "s2", "s3"], jparams) == n == 6
    (tmp_path / "rnabloom.transcripts.merged.fa").rename(jdir)
    assert tdir.read_bytes() == jdir.read_bytes()
    assert tpipe.merge_pool(str(tmp_path), ["s3"], tparams, device="cpu") == 0


def test_sample_alone_equals_sample_in_pool(pool, tmp_path):
    """Sample sB run alone on the shared graph writes what it writes in
    the pool, after sA: a sample's rebuild reads the shared read-pair keys
    in place and leaves the shared cbf and rpkbf as they were."""
    params = tpipe.PipelineParams(stop_stage=3, **COMMON)
    samples = sorted(tpipe.parse_pool_list(pool))
    dev = torch.device("cpu")
    shared, _, cfg, read_L = tpipe._pool_shared_graph(samples, params, False, True, dev)
    before = [None if a is None else a.clone() for a in shared]
    in_pool = {}
    for sample in samples:
        in_pool[sample[0]] = tpipe._pool_sample(shared, cfg, sample, str(tmp_path / "pool"), params, False, True,
                                                read_L)
    for a, b in zip(before, shared):
        assert (a is None and b is None) or torch.equal(a, b)
    alone = tpipe._pool_sample(shared, cfg, samples[1], str(tmp_path / "alone"), params, False, True, read_L)
    assert _files(str(tmp_path / "alone" / "sB")) == _files(str(tmp_path / "pool" / "sB"))
    t, p = dataclasses.asdict(alone), dataclasses.asdict(in_pool["sB"])
    assert {f: t[f] for f in REPORT_FIELDS} == {f: p[f] for f in REPORT_FIELDS}
    assert t["num_transcripts"] > 0
