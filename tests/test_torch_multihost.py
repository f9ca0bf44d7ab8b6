"""The port's multi-host layout (``rnabloom_tpu_torch/parallel/multihost.py``,
``pipeline.assemble_pe_multihost`` / ``assemble_long_multihost``, the
CLI's ``-coordinator -nprocs -procid``) against the JAX package on the CPU.

A group is simulated in one process: each process's local tables are built
first; then each process runs with its index and count patched and its one
collective answered from those tables (the port's ``multihost._gather``,
the JAX package's ``jax.make_array_from_process_local_data``), its
barriers no-ops, process 1 before process 0.  The JAX package runs its own
functions so, reducers included.  Then real groups of two CLI processes
(gloo over 127.0.0.1) must give the simulated group's files.  Inputs are
``tests/test_multihost.py``'s: 60 reads, 240 pairs off three 400-base
transcripts, 100 long reads off two truths.
"""

import contextlib
import gzip
import os
import shutil
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rnabloom_tpu.assembly import pipeline as jpipe, stage1 as js1
from rnabloom_tpu.bloom.filters import BloomConfig as JBloom, CountingConfig as JCounting
from rnabloom_tpu.graph import dbg as jdbg
from rnabloom_tpu.io import native as jnative
from rnabloom_tpu.parallel import multihost as jmh
from rnabloom_tpu.utils import checkpoint as jckpt
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import pipeline, stage1
from rnabloom_tpu_torch.bloom.filters import BloomConfig, CountingConfig
from rnabloom_tpu_torch.graph import dbg
from rnabloom_tpu_torch.io import fastx, native
from rnabloom_tpu_torch.parallel import multihost as mh
from rnabloom_tpu_torch.utils import seq as sequtils
from stage3_common import _files
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEM = int(0.02 * (1 << 30))  # -mem 0.02
CLI_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# inputs (tests/test_multihost.py's generators)
# ---------------------------------------------------------------------------


def _write_reads(d) -> dict:
    rng = np.random.default_rng(7)
    reads = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(60)]
    paths = {"gz": str(d / "mh.fq.gz"), "fastq": str(d / "mh.fq"), "fasta": str(d / "mh.fa")}
    with gzip.open(paths["gz"], "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    # plain FASTQ with '@' quality lines (the cut's hard case) and a FASTA
    rng = np.random.default_rng(0)
    with open(paths["fastq"], "w") as f, open(paths["fasta"], "w") as g:
        for i in range(101):
            r = "".join(rng.choice(list("ACGT"), size=80))
            f.write(f"@read{i}\n{r}\n+\n{'@' * len(r)}\n")
            g.write(f">read{i}\n{r[:40]}\n{r[40:]}\n")
    paths["reads"] = reads
    rng = np.random.default_rng(77)
    pts = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(3)]
    paths["left"], paths["right"] = str(d / "p_1.fq.gz"), str(d / "p_2.fq.gz")
    paths["left_plain"], paths["right_plain"] = str(d / "p_1.fq"), str(d / "p_2.fq")
    q = "I" * 100
    with gzip.open(paths["left"], "wt") as fl, gzip.open(paths["right"], "wt") as fr, \
            open(paths["left_plain"], "w") as pl, open(paths["right_plain"], "w") as pr:
        n = 0
        for t in pts:
            for _ in range(80):
                s = rng.integers(0, len(t) - 220 + 1)
                frag = t[s : s + 220]
                for fh in (fl, pl):
                    fh.write(f"@r{n}/1\n{frag[:100]}\n+\n{q}\n")
                for fh in (fr, pr):
                    fh.write(f"@r{n}/2\n{sequtils.revcomp(frag[-100:])}\n+\n{q}\n")
                n += 1
    rng = np.random.default_rng(31)
    paths["truths"] = ["".join(rng.choice(list("ACGT"), size=m)) for m in (1300, 1000)]
    paths["long"] = str(d / "lr.fa")
    with open(paths["long"], "w") as f:
        i = 0
        for t in paths["truths"]:
            for _ in range(50):
                s = rng.integers(0, len(t) - 550 + 1)
                read = list(t[s : s + 550])
                for j in range(len(read)):
                    if rng.random() < 0.005:
                        read[j] = "ACGT"[rng.integers(0, 4)]
                r = "".join(read)
                if rng.random() < 0.5:
                    r = sequtils.revcomp(r)
                f.write(f">lr{i}\n{r}\n")
                i += 1
    return paths


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_reads(tmp_path_factory.mktemp("mh_reads"))


# ---------------------------------------------------------------------------
# the simulated group
# ---------------------------------------------------------------------------


def _port_tables(paths, cfg, s1p, n, flags=None, pairs=False) -> list:
    """Each process's local tables (GraphState order, Nones dropped)."""
    out = []
    for p in range(n):
        st, _ = mh.build_local(paths, cfg, s1p, pid=p, n=n, device="cpu", revcomp_flags=flags, add_read_pairs=pairs)
        out.append([t for t in st if t is not None])
    return out


@contextlib.contextmanager
def port_process(tables: list, pid: int):
    """The port as process ``pid`` of ``len(tables)``, its collective
    answered from ``tables``."""
    n, calls = len(tables), iter(range(1 << 10))

    def gather(host):
        i = next(calls)
        assert torch.equal(host, tables[pid][i])
        return [tables[q][i] for q in range(n)]

    with pytest.MonkeyPatch.context() as m:
        m.setattr(mh, "process_index", lambda: pid)
        m.setattr(mh, "process_count", lambda: n)
        m.setattr(mh, "_gather", gather)
        m.setattr(mh, "barrier", lambda: None)
        yield


def _jax_rows(paths, cfg, s1p, n, mesh, flags=None, pairs=False) -> list:
    """Each JAX process's local rows of each merged table, in call order,
    recorded through ``build_graph_local_merge`` itself."""
    out = []
    for p in range(n):
        rows = []

        def record(sharding, local):
            rows.append(local)
            return jax.device_put(np.zeros((mesh.devices.size,) + local.shape[1:], local.dtype), sharding)

        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax, "process_index", lambda: p)
            m.setattr(jax, "process_count", lambda: n)
            m.setattr(jax, "make_array_from_process_local_data", record)
            jmh.build_graph_local_merge(paths, cfg, s1p, mesh, revcomp_flags=flags, add_read_pairs=pairs)
        out.append(rows)
    return out


@contextlib.contextmanager
def jax_process(rows: list, pid: int, check_own: bool = True):
    """The JAX package as process ``pid`` of ``len(rows)``: its global
    arrays made of every process's recorded rows."""
    n, calls = len(rows), iter(range(1 << 10))

    def make_global(sharding, local):
        i = next(calls)
        if check_own:
            np.testing.assert_array_equal(local, rows[pid][i])
        return jax.device_put(np.concatenate([rows[q][i] for q in range(n)]), sharding)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax, "process_index", lambda: pid)
        m.setattr(jax, "process_count", lambda: n)
        m.setattr(jax, "make_array_from_process_local_data", make_global)
        m.setattr(jmh, "barrier", lambda mesh: None)
        yield


def _host(t) -> np.ndarray:
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return t.view(np.uint16) if t.dtype == np.int16 else t


def _same_graph(got: dbg.GraphState, want, upto=None) -> None:
    for name in dbg.GraphState._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a, b = _host(a), np.asarray(b)
            if upto is not None:
                a, b = a[: upto[name]], b[: upto[name]]
            np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# input partitioning and the reader's slices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_partition_records_matches_jax(data, n):
    for pid in range(n):
        assert list(mh.partition_records(iter(range(10)), pid, n)) == list(jmh.partition_records(iter(range(10)), pid, n))
        got = list(mh.partition_records(fastx.read_seqs(data["gz"]), pid, n))
        assert got == list(jmh.partition_records(fastx.read_seqs(data["gz"]), pid, n))
        assert len(got) in (60 // n, 60 // n + 1)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("fmt", ["fastq", "fasta", "gz"])
def test_byte_ranges_match_jax(data, fmt, n):
    path = data[fmt]
    got = mh.byte_ranges(path, n)
    assert got == jmh.byte_ranges(path, n)
    if fmt == "gz":
        assert got is None
        return
    size = os.path.getsize(path)
    assert got[0][0] == 0 and got[-1][1] == size and all(a[1] == b[0] for a, b in zip(got, got[1:]))
    with open(path, "rb") as f:  # every cut lands on a record header
        for start, _ in got[1:]:
            f.seek(start)
            assert f.readline().startswith(b"@read" if fmt == "fastq" else b">read")


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("fmt", ["fastq", "fasta", "gz"])
def test_native_reader_slices_match_jax(data, fmt, n):
    """Each process's slice through the native reader (its byte range of
    a plain file, else its stride), and the masked reader's stride: the
    same codes, lengths and parsed counts as the JAX package's reader."""
    assert native.available() and jnative.available()
    path = data[fmt]
    ranges = mh.byte_ranges(path, n)
    total = 0
    for pid in range(n):
        kw = dict(byte_range=ranges[pid]) if ranges else dict(stride=(pid, n))
        got = list(native.read_code_batches(path, 16, 64, 3, 25, **kw))
        want = list(jnative.read_code_batches(path, 16, 64, 3, 25, **kw))
        assert len(got) == len(want) > 0
        for (c, ln, parsed), (jc, jln, jparsed) in zip(got, want):
            np.testing.assert_array_equal(c, jc)
            np.testing.assert_array_equal(ln, jln)
            assert parsed == jparsed
        total += got[-1][2]
        # the stride on any file, through both readers
        for (c, ln, p_), (jc, jln, jp_) in zip(native.read_code_batches(path, 16, 64, 3, 25, stride=(pid, n)),
                                                jnative.read_code_batches(path, 16, 64, 3, 25, stride=(pid, n))):
            np.testing.assert_array_equal(c, jc)
            assert p_ == jp_
        got_m = list(native.read_masked_batches(path, 16, 128, 3, stride=(pid, n)))
        want_m = list(jnative.read_masked_batches(path, 16, 128, 3, stride=(pid, n)))
        assert len(got_m) == len(want_m) > 0
        for a, b in zip(got_m, want_m):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert total == (60 if fmt == "gz" else 101)  # the slices hold every read once


def test_byte_range_of_a_gzip_stream_raises_as_jax(data):
    for reader in (native, jnative):
        with pytest.raises(ValueError, match="cannot byte-partition a compressed stream"):
            next(reader.read_code_batches(data["gz"], 16, 64, 3, 25, byte_range=(0, 100)))


# ---------------------------------------------------------------------------
# the local builds and the merge
# ---------------------------------------------------------------------------


def _configs(counter: str):
    """tests/test_multihost.py's worker configuration, both packages."""
    kw = dict(k=25, stranded=False, read_pair_distance=20)
    cfg = dbg.GraphConfig(dbgbf=BloomConfig(14, 2), cbf=CountingConfig(14, 2, scratch_log2=16, dtype=counter),
                          pkbf=BloomConfig(14, 2), **kw)
    jcfg = jdbg.GraphConfig(dbgbf=JBloom(14, 2), cbf=JCounting(14, 2, scratch_log2=16, dtype=counter),
                            pkbf=JBloom(14, 2), **kw)
    return cfg, stage1.Stage1Params(k=25, batch_size=64, max_seq_len=192), jcfg, \
        js1.Stage1Params(k=25, batch_size=64, max_seq_len=192)


def _mixed_inputs(data):
    """A plain file (byte ranges) then a gzip stream (the stride), the
    second revcomp'd, so the batches carry over from one file to the next."""
    return [data["fastq"], data["gz"]], [False, True]


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("counter", ["int32", "u16", "mf8"])
def test_local_tables_and_merge_match_jax(data, counter, n):
    """Each process's tables equal the JAX package's local build over its
    own slice (salt b * n + pid); the merged tables equal the JAX
    reducers' on the JAX tables; for int32 and u16 they also equal a
    one-process JAX build of every read outside the trash cells."""
    cfg, s1p, jcfg, js1p = _configs(counter)
    paths, flags = _mixed_inputs(data)
    mesh = Mesh(np.array(jax.devices()[:n]), ("d",))
    tables = _port_tables(paths, cfg, s1p, n, flags, pairs=True)
    rows = _jax_rows(paths, jcfg, js1p, n, mesh, flags, pairs=True)
    for p in range(n):
        assert len(tables[p]) == len(rows[p]) == 2  # cbf, rpkbf
        for t, r in zip(tables[p], rows[p]):
            assert r.shape[0] == 1
            np.testing.assert_array_equal(_host(t), r[0])
    with port_process(tables, 0):
        merged, stats = mh.build_graph_local_merge(paths, cfg, s1p, device="cpu", revcomp_flags=flags,
                                                   add_read_pairs=True)
    with jax_process(rows, 0):
        jmerged, jstats = jmh.build_graph_local_merge(paths, jcfg, js1p, mesh, revcomp_flags=flags,
                                                      add_read_pairs=True)
    _same_graph(merged, jmerged)
    assert stats.num_reads == jstats.num_reads and stats.num_batches == jstats.num_batches
    assert stats.merge_bytes == (n - 1) * sum(t.numel() * t.element_size() for t in tables[0])
    if counter != "mf8":
        one, _ = jmh.build_graph_local_merge(paths, jcfg, js1p, Mesh(np.array(jax.devices()[:1]), ("d",)),
                                             revcomp_flags=flags, add_read_pairs=True)
        _same_graph(merged, one, upto={"cbf": cfg.cbf.size, "rpkbf": cfg.pkbf.size})


@pytest.mark.parametrize("counter", ["int32", "u16", "mf8"])
def test_one_process_local_merge_is_jax_build_graph_local_merge(data, counter):
    """No group: the port's build_graph_local_merge equals the JAX one in
    a process of its own (its 8 virtual devices), every cell."""
    cfg, s1p, jcfg, js1p = _configs(counter)
    paths, flags = _mixed_inputs(data)
    got, stats = mh.build_graph_local_merge(paths, cfg, s1p, device="cpu", revcomp_flags=flags, add_read_pairs=True)
    want, jstats = jmh.build_graph_local_merge(paths, jcfg, js1p, Mesh(np.array(jax.devices()), ("d",)),
                                               revcomp_flags=flags, add_read_pairs=True)
    _same_graph(got, want)
    assert (stats.num_reads, stats.num_segments, stats.num_bases, stats.num_batches) == \
        (jstats.num_reads, jstats.num_segments, jstats.num_bases, jstats.num_batches)
    assert stats.merge_bytes == 0
    assert stats.fprs == pytest.approx(jstats.fprs)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("counter", ["int32", "u16", "mf8"])
def test_reducers_match_jax_on_random_tables(counter, n):
    """The merge of random tables (int32 sums that wrap, u16 sums past
    65535, mf8 sums over 3-4 processes whose float32 order matters), the
    JAX package's reducers run by its own build_graph_local_merge."""
    cfg, s1p, jcfg, js1p = _configs(counter)
    rng = np.random.default_rng(n * 10 + len(counter))
    size = cfg.cbf.size + cfg.cbf.trash
    high = {"int32": None, "u16": 1 << 16, "mf8": 128}[counter]
    if counter == "int32":
        cbf = [rng.integers(-(1 << 31), 1 << 31, size, dtype=np.int64).astype(np.int32) for _ in range(n)]
    else:
        cbf = [rng.integers(0, high, size).astype(np.uint16 if counter == "u16" else np.uint8) for _ in range(n)]
    lanes = [rng.integers(0, 2, cfg.pkbf.size + 1).astype(np.uint8) for _ in range(n)]
    rows = [[c[None], r[None]] for c, r in zip(cbf, lanes)]
    with jax_process(rows, 0, check_own=False):
        want, _ = jmh.build_graph_local_merge([], jcfg, js1p, Mesh(np.array(jax.devices()[:n]), ("d",)),
                                              add_read_pairs=True)
    kind = mh.COUNTER_KINDS[counter]
    parts = [torch.from_numpy(c.view(np.int16) if counter == "u16" else c) for c in cbf]
    np.testing.assert_array_equal(_host(mh.reduce_tables(parts, kind, "cpu")), np.asarray(want.cbf))
    got = mh.reduce_tables([torch.from_numpy(r) for r in lanes], "max", "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.rpkbf))


# ---------------------------------------------------------------------------
# the pipelines on a simulated group of two
# ---------------------------------------------------------------------------


def _pe_params(port: bool):
    module = pipeline if port else jpipe
    return module.PipelineParams(total_mem_bytes=MEM, no_reduce=True)


@pytest.fixture(scope="module")
def pe_sim(data, tmp_path_factory):
    """assemble_pe_multihost of both packages on a simulated group of two
    (process 1, then process 0) over the 240 pairs, as the CLI runs it
    (-revcomp-right -mem 0.02 -norr)."""
    d = tmp_path_factory.mktemp("pe_sim")
    left, right = data["left"], data["right"]
    params, jparams = _pe_params(True), _pe_params(False)
    lengths = stage1.sample_read_lengths([left, right], params.sample_size)
    cfg, s1p, _, _, _ = pipeline._read_config(lengths, params)
    d_read, _ = js1.read_length_params(lengths, 25, jparams.min_num_kmer_pairs)
    read_L = int(max(lengths.max(initial=150), 25 + d_read + 1))
    jcfg = js1.default_graph_config(25, False, MEM, 2, d_read, **jparams.graph_config_overrides())
    js1p = js1.Stage1Params(k=25, max_seq_len=max(read_L, 50))
    tables = _port_tables([left, right], cfg, s1p, 2, [False, True], pairs=True)
    rows = _jax_rows([left, right], jcfg, js1p, 2, Mesh(np.array(jax.devices()), ("d",)), [False, True], pairs=True)
    out, jout = str(d / "port"), str(d / "jax")
    reports = {}
    for pid in (1, 0):
        with port_process(tables, pid):
            reports[pid] = pipeline.assemble_pe_multihost(left, right, out, params, device="cpu")
        with jax_process(rows, pid):
            jpipe.assemble_pe_multihost(left, right, jout, jparams)
    return {"out": out, "jout": jout, "reports": reports, "tables": tables}


def _compare_trees(got: dict, want: dict, report: bool = True) -> None:
    import json

    assert sorted(got) == sorted(want)
    name = "rnabloom.report.json"
    if report:
        a, b = json.loads(got.pop(name)), json.loads(want.pop(name))
        a.pop("elapsed_s"), b.pop("elapsed_s")
        assert a == b
    for f in want:
        assert got[f] == want[f], f


@pytest.mark.parametrize("part", ["mh_p0", "mh_p1"])
def test_pe_stage2_slices_match_jax(pe_sim, part):
    """Each process's stage-2 store over its record-modulo pair slice."""
    got, want = _files(os.path.join(pe_sim["out"], part)), _files(os.path.join(pe_sim["jout"], part))
    assert any(f.endswith(".nbits") for f in want)
    _compare_trees(got, want, report=False)


def test_pe_merged_store_and_stage3_match_jax(pe_sim):
    """Process 0's merged store, stages 2b and 3 and report.json: every
    file of the simulated group's output equals the JAX package's."""
    got, want = _files(pe_sim["out"]), _files(pe_sim["jout"])
    assert want["rnabloom.transcripts.fa"] and "fragments/fragments.meta.json" in want
    _compare_trees(got, want)
    r0, r1 = pe_sim["reports"][0], pe_sim["reports"][1]
    assert r0.num_transcripts > 0 and r1.num_transcripts == 0 and r0.num_pairs + r1.num_pairs == 240


@pytest.fixture(scope="module")
def long_sim(data, tmp_path_factory):
    """assemble_long_multihost of both packages on a simulated group of
    two over the 100 long reads (-mem 0.02)."""
    d = tmp_path_factory.mktemp("long_sim")
    params = pipeline.PipelineParams(total_mem_bytes=MEM)
    jparams = jpipe.PipelineParams(total_mem_bytes=MEM)
    cfg = stage1.default_graph_config(25, False, MEM, 2, -1, with_pkbf=True, **params.graph_config_overrides())
    jcfg = js1.default_graph_config(25, False, MEM, 2, -1, with_pkbf=True, **jparams.graph_config_overrides())
    paths = [data["long"]]
    tables = _port_tables(paths, cfg, stage1.Stage1Params(k=25, max_seq_len=512), 2)
    rows = _jax_rows(paths, jcfg, js1.Stage1Params(k=25, max_seq_len=512), 2, Mesh(np.array(jax.devices()), ("d",)))
    out, jout = str(d / "port"), str(d / "jax")
    reports = {}
    for pid in (1, 0):
        with port_process(tables, pid):
            reports[pid] = pipeline.assemble_long_multihost(paths, out, params, device="cpu")
        with jax_process(rows, pid):
            jpipe.assemble_long_multihost(paths, jout, jparams)
    return {"out": out, "jout": jout, "reports": reports}


def test_long_correction_slices_and_merge_match_jax(long_sim):
    """The per-slice correction, process 0's renumbered corrected FASTA and
    its side files, and the OLC's transcripts: every file equal to the JAX
    package's."""
    got, want = _files(long_sim["out"]), _files(long_sim["jout"])
    prefix = "rnabloom.longreads.corrected"
    assert want[f"{prefix}.long.fa"].count(b">lr.") > 50 and want["rnabloom.transcripts.fa"]
    assert not any(f.startswith(".mh_lr_p") for f in want)
    _compare_trees(got, want, report=False)
    assert long_sim["reports"][0].num_pairs + long_sim["reports"][1].num_pairs == 100


# ---------------------------------------------------------------------------
# real groups of two CLI processes
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(timeout_s: int = CLI_TIMEOUT_S) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2", RNABLOOM_MH_TIMEOUT=str(timeout_s))
    return env


def _start_group(argv: list, n: int = 2, module: str = "rnabloom_tpu_torch.cli", env=None) -> list:
    port = _free_port()
    return [
        subprocess.Popen([sys.executable, "-m", module, *argv, "-coordinator", f"127.0.0.1:{port}",
                          "-nprocs", str(n), "-procid", str(pid)],
                         cwd=ROOT, env=env or _env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(n)
    ]


def _finish(procs: list, timeout: float = CLI_TIMEOUT_S) -> list:
    """(stdout, stderr) of each process; kills every one past ``timeout``
    so that a hang fails the test, not the run."""
    deadline = time.time() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.time())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0, f"process failed (rc {p.returncode}):\n{err[-3000:]}"
    return logs


def _rank_lines(logs: list) -> list:
    import json

    return [json.loads(next(ln for ln in err.splitlines() if ln.startswith('{"mh_rank"'))) for _, err in logs]


@pytest.fixture(scope="module")
def cli_runs(data, tmp_path_factory):
    """Three groups of two port CLI processes at once on the CPU: PE
    -stage 3 (gzip, -norr), -stage 1 -cnt int32 (plain FASTQ: byte ranges),
    -long; then the one-process runs they are held to."""
    d = tmp_path_factory.mktemp("mh_cli")
    mem = ["-mem", "0.02", "--device", "cpu"]
    out = {"pe": str(d / "pe"), "s1": str(d / "s1"), "long": str(d / "long")}
    groups = {
        "pe": _start_group(["-left", data["left"], "-right", data["right"], "-revcomp-right", "-norr", "-o",
                            out["pe"], *mem]),
        "s1": _start_group(["-left", data["left_plain"], "-right", data["right_plain"], "-revcomp-right", "-stage",
                            "1", "-cnt", "int32", "-o", out["s1"], *mem]),
        "long": _start_group(["-long", data["long"], "-o", out["long"], *mem]),
    }
    logs = {tag: _finish(procs) for tag, procs in groups.items()}
    single = {"pe": str(d / "pe_1"), "s1": str(d / "s1_1")}
    cli.run(["-left", data["left"], "-right", data["right"], "-revcomp-right", "-norr", "-o", single["pe"], *mem])
    cli.run(["-left", data["left_plain"], "-right", data["right_plain"], "-revcomp-right", "-stage", "1", "-savebf",
             "-cnt", "int32", "-o", single["s1"], *mem])
    return {"out": out, "logs": logs, "single": single}


def test_cli_pe_group_equals_the_simulated_group(cli_runs, pe_sim):
    """The two CLI processes' files equal the simulated group's (and so the
    JAX package's); process 0 prints the JAX CLI's line, each process its
    numbers."""
    import json

    _compare_trees(_files(cli_runs["out"]["pe"]), _files(pe_sim["out"]))
    (out0, _), (out1, _) = cli_runs["logs"]["pe"]
    line = json.loads(out0.strip().splitlines()[-1])
    assert set(line) == {"pairs", "fragments", "transcripts", "elapsed_s"} and line["transcripts"] > 0
    assert out1.strip() == ""
    ranks = _rank_lines(cli_runs["logs"]["pe"])
    assert [r["mh_rank"] for r in ranks] == [0, 1] and all(r["nprocs"] == 2 for r in ranks)
    table_bytes = sum(t.numel() * t.element_size() for t in pe_sim["tables"][0])
    assert all(r["merge_bytes"] == table_bytes and r["stage2_s"] > 0 for r in ranks)
    assert ranks[0]["stage3_s"] > 0 and ranks[1]["stage3_s"] == 0


def _canonical(path: str) -> list:
    return sorted(min(s.upper(), sequtils.revcomp(s.upper())) for _, s in fastx.read_fasta(path))


def test_cli_pe_group_transcripts_equal_a_one_process_run(cli_runs):
    """tests/test_multihost.py's claim: the canonical transcript set of the
    group equals a one-process run's."""
    got = _canonical(os.path.join(cli_runs["out"]["pe"], "rnabloom.transcripts.fa"))
    assert got and got == _canonical(os.path.join(cli_runs["single"]["pe"], "rnabloom.transcripts.fa"))


def test_cli_stage1_int32_graph_equals_a_one_process_build(cli_runs):
    """-stage 1 -cnt int32 across two processes (byte ranges of plain
    files): the saved graph equals the one-process -savebf build's outside
    the trash cells, and the JAX package's load_graph reads it."""
    prefix = os.path.join(cli_runs["out"]["s1"], "rnabloom.graph")
    single = os.path.join(cli_runs["single"]["s1"], "rnabloom.graph")
    with open(prefix + ".graph.json") as f, open(single + ".graph.json") as g:
        assert f.read() == g.read()
    state, cfg = jckpt.load_graph(prefix)
    assert cfg.cbf.dtype == "int32" and np.asarray(state.cbf).shape[0] > cfg.cbf.size
    for name, size in (("cbf", cfg.cbf.size), ("rpkbf", cfg.pkbf.size)):
        a, b = np.load(f"{prefix}.{name}.npy"), np.load(f"{single}.{name}.npy")
        assert a.shape == b.shape and a[:size].any()
        np.testing.assert_array_equal(a[:size], b[:size])
    assert os.path.exists(os.path.join(cli_runs["out"]["s1"], "DBG.DONE"))
    import json

    line = json.loads(cli_runs["logs"]["s1"][0][0].strip().splitlines()[-1])
    assert line["stage"] == 1 and line["reads_local"] > 0 and set(line["fprs"]) == {"cbf", "rpkbf"}


def test_cli_long_group_recovers_the_truths(cli_runs, long_sim, data):
    """tests/test_multihost.py's truth check on the -long group, whose
    files equal the simulated group's."""
    _compare_trees(_files(cli_runs["out"]["long"]), _files(long_sim["out"]), report=False)
    out = [s.upper() for _, s in fastx.read_fasta(os.path.join(cli_runs["out"]["long"], "rnabloom.transcripts.fa"))]
    assert out
    hits = set()
    for s in out:
        hit = next((i for i, t in enumerate(data["truths"]) if s in t or s in sequtils.revcomp(t)), None)
        assert hit is not None, f"transcript ({len(s)} nt) matches no truth"
        hits.add(hit)
    assert hits == {0, 1}


def test_a_process_whose_peer_never_arrives_exits_nonzero(data, tmp_path):
    """Process 0 of 2 alone: the group's timeout ends it with an error,
    nothing assembled."""
    port = _free_port()
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "rnabloom_tpu_torch.cli", "-left", data["left"], "-right", data["right"], "-o",
         str(tmp_path / "asm"), "--device", "cpu", "-coordinator", f"127.0.0.1:{port}", "-nprocs", "2",
         "-procid", "0"],
        cwd=ROOT, env=_env(timeout_s=3), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and time.time() - t0 < 100
    assert proc.stdout == "" and not (tmp_path / "asm").exists()


def test_a_process_without_a_card_raises_before_the_group(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["-left", "x", "-right", "y", "-o", str(tmp_path / "asm"), "-coordinator", "127.0.0.1:1",
                 "-nprocs", "2", "-procid", "1"])
    assert not (tmp_path / "asm").exists()


@pytest.mark.slow
def test_cli_groups_equal_the_jax_packages_groups(data, cli_runs, tmp_path):
    """The JAX package's own groups of two CLI processes (jax.distributed
    on the CPU) on the same reads and flags: every file equal to the
    port's groups' (report.json but elapsed_s; the saved graph)."""
    env = _env()
    env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1",
               RNABLOOM_TPU_JAX_CACHE=str(tmp_path / "jax_cache"))
    out = {tag: str(tmp_path / tag) for tag in ("pe", "s1", "long")}
    groups = {
        "pe": _start_group(["-left", data["left"], "-right", data["right"], "-revcomp-right", "-norr", "-mem",
                            "0.02", "-o", out["pe"]], module="rnabloom_tpu.cli", env=env),
        "s1": _start_group(["-left", data["left_plain"], "-right", data["right_plain"], "-revcomp-right", "-stage",
                            "1", "-cnt", "int32", "-mem", "0.02", "-o", out["s1"]], module="rnabloom_tpu.cli",
                           env=env),
        "long": _start_group(["-long", data["long"], "-mem", "0.02", "-o", out["long"]], module="rnabloom_tpu.cli",
                             env=env),
    }
    for procs in groups.values():
        _finish(procs, timeout=900)
    _compare_trees(_files(cli_runs["out"]["pe"]), _files(out["pe"]))
    _compare_trees(_files(cli_runs["out"]["s1"]), _files(out["s1"]), report=False)
    _compare_trees(_files(cli_runs["out"]["long"]), _files(out["long"]), report=False)
    shutil.rmtree(tmp_path / "jax_cache", ignore_errors=True)
