"""The port's copies of the JAX package's host modules give exactly what the
originals give: the FASTX readers and ``FastaWriter``, the native batch
readers, the sequence codecs, the poly-A tail and poly-T head finders and
PAS positions, ``.nbits`` files, the fragment store's files, the artifact
screens and percent identity, on the same seeded inputs.
"""

import gzip
import os

import numpy as np
import pytest

from rnabloom_tpu.assembly import artifacts as jart, fragstore as jfragstore
from rnabloom_tpu.io import fastx as jfastx, native as jnative, nbits as jnbits
from rnabloom_tpu.utils import align as jalign, polya as jpolya, seq as jseq
from rnabloom_tpu_torch.assembly import artifacts as tart, fragstore as tfragstore
from rnabloom_tpu_torch.io import fastx as tfastx, native as tnative, nbits as tnbits
from rnabloom_tpu_torch.utils import align as talign, polya as tpolya, seq as tseq
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)


def _reads(seed, n):
    """n (seq, qual) reads of 40-160 bases: low-quality bases, Ns and
    lowercase bases planted."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = int(rng.integers(40, 160))
        s = rng.choice(list("ACGTacgt"), size=m, p=[0.24] * 4 + [0.01] * 4)
        if i % 5 == 0:
            s[rng.integers(m)] = "N"
        q = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, m))
        out.append(("".join(s), q))
    return out


def _write(path, reads, fmt):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for i, (s, q) in enumerate(reads):
            if fmt == "fastq":
                f.write(f"@r{i} comment\n{s}\n+\n{q}\n")
            else:  # multi-line FASTA records
                f.write(f">r{i} comment\n" + "\n".join(s[j:j + 60] for j in range(0, len(s), 60)) + "\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("io")
    out = {}
    for name, fmt, seed in (("r_1.fq", "fastq", 1), ("r_2.fq.gz", "fastq", 2), ("r.fa", "fasta", 3),
                            ("r.fasta.gz", "fasta", 4), ("sniff.txt", "fastq", 5)):
        out[name] = str(d / name)
        _write(out[name], _reads(seed, 120), fmt)
    out["r_2.fq"] = str(d / "r_2.fq")
    _write(out["r_2.fq"], _reads(2, 120), "fastq")
    return out


@pytest.mark.parametrize("name", ["r_1.fq", "r_2.fq.gz", "r.fa", "r.fasta.gz", "sniff.txt"])
def test_fastx_read_seqs(files, name):
    assert tfastx.sniff_format(files[name]) == jfastx.sniff_format(files[name])
    assert list(tfastx.read_seqs(files[name])) == list(jfastx.read_seqs(files[name]))


def test_fastx_read_paired(files, tmp_path):
    left, right = files["r_1.fq"], files["r_2.fq.gz"]
    assert list(tfastx.read_paired(left, right)) == list(jfastx.read_paired(left, right))
    short = str(tmp_path / "short.fq")
    _write(short, _reads(9, 10), "fastq")
    for mod in (tfastx, jfastx):
        with pytest.raises(ValueError, match="more reads"):
            list(mod.read_paired(left, short))


@pytest.mark.parametrize("reader", ["masked", "code"])
@pytest.mark.parametrize("name,batch,max_len", [("r_1.fq", 32, 160), ("r_2.fq.gz", 50, 96), ("r.fa", 7, 64)])
def test_native_batches(files, reader, name, batch, max_len):
    if not (jnative.available() and tnative.available()):
        pytest.skip("native toolchain unavailable")
    if reader == "masked":
        got = list(tnative.read_masked_batches(files[name], batch, max_len, 3))
        want = list(jnative.read_masked_batches(files[name], batch, max_len, 3))
    else:
        got = list(tnative.read_code_batches(files[name], batch, max_len, 3, 25))
        want = list(jnative.read_code_batches(files[name], batch, max_len, 3, 25))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seq_codecs(seed):
    rng = np.random.default_rng(seed)
    reads = _reads(seed + 10, 40)
    for s, q in reads:
        codes = tseq.encode(s)
        np.testing.assert_array_equal(codes, jseq.encode(s))
        assert tseq.decode(codes) == jseq.decode(codes)
        np.testing.assert_array_equal(tseq.revcomp_codes(codes), jseq.revcomp_codes(codes))
        quals = np.frombuffer(q.encode("ascii"), np.uint8)
        for min_qual, min_len in ((3, 25), (20, 5), (0, 200)):
            got = tseq.segment_read(codes, quals, min_qual, min_len)
            want = jseq.segment_read(codes, quals, min_qual, min_len)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        segs = tseq.segment_read(codes, None, 0, 10)
        for a, b in zip(tseq.chunk_segments(segs, 50, 24), jseq.chunk_segments(segs, 50, 24)):
            np.testing.assert_array_equal(a, b)
    segs = [tseq.encode(s) for s, _ in reads]
    for a, b in zip(tseq.pack_batch(segs, 48, 100), jseq.pack_batch(segs, 48, 100)):
        np.testing.assert_array_equal(a, b)
    for n in (0, 1, 2, 3, 4, 7, 100, 101):
        values = rng.integers(0, 1000, n)
        assert tseq.quartiles(values) == jseq.quartiles(values)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_polya_tail(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        body = rng.integers(0, 4, int(rng.integers(0, 300)), dtype=np.uint8)
        tail = np.where(rng.random(int(rng.integers(0, 60))) < 0.93, 0, rng.integers(1, 4)).astype(np.uint8)
        codes = np.concatenate([body, tail, rng.integers(0, 4, int(rng.integers(0, 4)), dtype=np.uint8)])
        assert tpolya.find_polya_tail(codes) == jpolya.find_polya_tail(codes)
        head = (3 - codes[::-1]).astype(np.uint8)  # the tail as a poly-T head
        assert tpolya.find_polyt_head(head) == jpolya.find_polyt_head(head)
        assert tpolya.find_polyt_head(codes) == jpolya.find_polyt_head(codes)
        seq = tseq.decode(codes)
        for tail_start in (0, 3, len(codes) // 2, len(codes) - len(tail), len(codes)):
            assert tpolya.find_pas_positions(seq, tail_start) == jpolya.find_pas_positions(seq, tail_start)
    assert tpolya.PAS_MOTIFS == jpolya.PAS_MOTIFS


@pytest.mark.parametrize("name,kw", [("t.fa", {}), ("t.fa.gz", {}), ("w.fa", {"wrap": 60}), ("u.fa", {"uracil": True})])
def test_fasta_writer(tmp_path, name, kw):
    rng = np.random.default_rng(5)
    recs = [(f"rnabloom.{i}", "".join(rng.choice(list("ACGTacgt"), int(rng.integers(1, 200)))),
             f"l={i}" if i % 2 else "") for i in range(30)]
    for mod, sub in ((jfastx, "j"), (tfastx, "t")):
        (tmp_path / sub).mkdir()
        with mod.FastaWriter(str(tmp_path / sub / name), **kw) as w:
            for r in recs:
                w.write(*r)
        with mod.FastaWriter(str(tmp_path / sub / name), append=True, **kw) as w:
            w.write("extra", "ACGT")
    opener = gzip.open if name.endswith(".gz") else open
    with opener(tmp_path / "j" / name, "rb") as a, opener(tmp_path / "t" / name, "rb") as b:
        assert a.read() == b.read()


def _profiles(rng, n):
    """(seen, valid, counts) k-mer profiles of n rows: assembled arms,
    unseen junctions, tips and stubs, a few invalid k-mers."""
    out = []
    for i in range(n):
        m = int(rng.integers(2, 120))
        seen = np.ones(m, bool)
        kind = i % 5
        if kind == 0:  # a junction
            a = int(rng.integers(0, m))
            seen[a : a + int(rng.integers(1, 30))] = False
        elif kind == 1:  # an unseen head tip
            seen[: int(rng.integers(0, m))] = False
        elif kind == 2:  # an unseen tail stub
            seen[int(rng.integers(0, m)) :] = False
        elif kind == 3:
            seen = rng.random(m) < 0.7
        valid = rng.random(m) > 0.05
        counts = np.where(seen, rng.uniform(5, 50, m), rng.uniform(0, 8, m)).astype(np.float32)
        out.append((seen, valid, counts))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_artifact_screens(seed):
    rng = np.random.default_rng(seed)
    for seen, valid, counts in _profiles(rng, 200):
        for k in (5, 25):
            assert tart.is_chimera(seen, valid, k) == jart.is_chimera(seen, valid, k)
            assert tart.template_switch_tip(seen, valid, k) == jart.template_switch_tip(seen, valid, k)
        for d, depth in ((10, 8), (40, 30), (3, 0)):
            assert tart.blunt_end_candidate(seen, valid, counts, d, depth) == jart.blunt_end_candidate(
                seen, valid, counts, d, depth)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rc_trims_and_percent_identity(seed):
    """Self-revcomp folds (exact, with mismatches, with a loop, none) for
    the suffix-fold scan and the hairpin matcher; percent identity of
    mutated copies."""
    rng = np.random.default_rng(seed)
    for i in range(40):
        arm = rng.integers(0, 4, int(rng.integers(20, 200)), dtype=np.uint8)
        loop = rng.integers(0, 4, int(rng.integers(0, 300)), dtype=np.uint8)
        back = (3 - arm[::-1]).astype(np.uint8)
        back[rng.random(len(back)) < 0.04 * (i % 3)] = rng.integers(0, 4)
        codes = np.concatenate([rng.integers(0, 4, int(rng.integers(0, 50)), dtype=np.uint8), arm, loop, back])
        if i % 7 == 0:
            codes = rng.integers(0, 4, len(codes), dtype=np.uint8)
        for k in (0, 15, 25):
            np.testing.assert_array_equal(tart.trim_rc_artifact(codes, k=k), jart.trim_rc_artifact(codes, k=k))
        other = codes.copy()
        other[rng.random(len(other)) < 0.08] = rng.integers(0, 4)
        other = np.delete(other, rng.integers(0, len(other), int(rng.integers(0, 4))))
        assert talign.percent_identity(codes, other) == jalign.percent_identity(codes, other)
        assert talign.banded_edit_distance(codes, other, 3) == jalign.banded_edit_distance(codes, other, 3)
    assert talign.percent_identity(codes[:0], codes[:0]) == jalign.percent_identity(codes[:0], codes[:0])


def _fragments(seed, n):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 400, n)
    covs = rng.choice([0.5, 1.0, 1.5, 7.0, 99.0, 100.0, 2e3, 5e4, 3e5], n).astype(np.float32)
    frags = [rng.integers(0, 5 if i % 9 == 0 else 4, m, dtype=np.uint8) for i, m in enumerate(lens)]
    return frags, covs, rng.random(n) < 0.8, rng.random(n) < 0.3


def _tree(root):
    out = {}
    for dirpath, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("name", ["f.nbits", "f.nbits.gz"])
def test_nbits_round_trip(tmp_path, name):
    frags = _fragments(5, 50)[0]
    paths = {}
    for who, mod in (("port", tnbits), ("jax", jnbits)):
        paths[who] = str(tmp_path / f"{who}_{name}")
        with mod.NbitsWriter(paths[who]) as w:
            for f in frags:
                w.write_codes(f)
    if not name.endswith(".gz"):  # gzip headers carry the file name
        with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
            assert a.read() == b.read()
    got, want = list(tnbits.read_nbits_codes(paths["port"])), list(jnbits.read_nbits_codes(paths["jax"]))
    assert len(got) == len(want) == len(frags)
    for g, w, f in zip(got, want, frags):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.where(f < 4, f, 0))
    assert list(tnbits.read_nbits(paths["port"])) == list(jnbits.read_nbits(paths["jax"]))


@pytest.mark.parametrize("long_threshold,polya_priority", [(200, False), (120, True)])
def test_fragstore_files(tmp_path, long_threshold, polya_priority):
    frags, covs, connected, pa = _fragments(6, 300)
    for who, mod in (("port", tfragstore), ("jax", jfragstore)):
        with mod.FragmentStore(str(tmp_path / who), long_threshold, polya_priority) as store:
            for f, c, conn, p in zip(frags, covs, connected, pa):
                store.add(f, float(c), bool(conn), polya=bool(p))
        assert store.count == len(frags)
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) > 8
    for f in want:
        assert got[f] == want[f], f


def _batches(store, batch, width):
    return [tuple(np.array(x) for x in b) for b in store.iter_batches(batch, width=width)]


@pytest.mark.parametrize("batch,width", [(7, None), (64, 90), (1024, 400)])
@pytest.mark.parametrize("long_threshold,polya_priority", [(200, False), (120, True)])
def test_fragstore_reading(tmp_path, long_threshold, polya_priority, batch, width):
    """The reading side on a store the port wrote: flushed while open, then
    closed and reopened; batches (codes, lengths, coverages, connected), the
    stratum order and the lengths equal the JAX package's."""
    frags, covs, connected, pa = _fragments(6, 300)
    stores = {"port": tfragstore.FragmentStore(str(tmp_path / "port"), long_threshold, polya_priority),
              "jax": jfragstore.FragmentStore(str(tmp_path / "jax"), long_threshold, polya_priority)}
    for store in stores.values():
        for f, c, conn, p in zip(frags[:200], covs, connected, pa):
            store.add(f, float(c), bool(conn), polya=bool(p))
        store.flush()
    got, want = (_batches(stores[who], batch, width) for who in ("port", "jax"))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for store in stores.values():
        for f, c, conn, p in zip(frags[200:], covs[200:], connected[200:], pa[200:]):
            store.add(f, float(c), bool(conn), polya=bool(p))
        store.close()
    port, jax_ = tfragstore.FragmentStore.open(str(tmp_path / "port")), jfragstore.FragmentStore.open(str(tmp_path / "port"))
    assert (port.count, port.max_len, port.long_threshold, port.polya_priority) == \
        (jax_.count, jax_.max_len, jax_.long_threshold, jax_.polya_priority) == \
        (len(frags), max(len(f) for f in frags), long_threshold, polya_priority)
    assert port._ordered_keys() == jax_._ordered_keys() and len(port._ordered_keys()) > 4
    assert list(port.iter_lengths()) == list(jax_.iter_lengths())
    got, want = _batches(port, batch, width), _batches(jax_, batch, width)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert tfragstore.FragmentStore.open(str(tmp_path / "none")) is None
