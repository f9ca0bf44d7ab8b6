"""Shared inputs and checks of the port's parity tests: for the stage-3
and nr-pass tests (``tests/test_torch_stage3.py``,
``tests/test_torch_stage3_options.py``, ``tests/test_torch_nr.py``) the
simulated read sets, a reference FASTA and the comparison of two output
directories; for the single-end, pool and rescue tests
(``tests/test_torch_{se,pool,rescue}.py``) their read sets; for the walk tests (``tests/test_torch_traverse.py`` on the
CPU, ``tests/test_torch_gpu.py`` on the card) the walk graphs' reads and
seeds and the naive-walk cases.  Imports no JAX."""

import json
import os

import numpy as np

from rnabloom_tpu_torch.utils import pesim

MEM = 1 << 22
COMMON = dict(total_mem_bytes=MEM, bound=200, batch_size=1024, sample_size=300)


def _polya_fastq(left, right):
    """Pairs off 12 transcripts of 500-900 bases: four end in a 40-base
    poly-A tail, four start with a 40-base poly-T head (an antisense tail),
    four have neither; a PAS motif sits 20 bases before each tail."""
    rng = np.random.default_rng(31)
    txs = []
    for i in range(12):
        t = rng.integers(0, 4, int(rng.integers(500, 900)), dtype=np.uint8)
        if i % 3 == 0:
            t[-26:-20] = [0, 0, 3, 0, 0, 0]  # AATAAA
            t = np.concatenate([t, np.zeros(40, np.uint8)])
        elif i % 3 == 1:
            t[20:26] = [3, 3, 3, 0, 3, 3]  # reverse complement of AATAAA
            t = np.concatenate([np.full(40, 3, np.uint8), t])
        txs.append(t)
    lengths = np.array([len(t) for t in txs])
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    tx = (np.concatenate(txs), offsets, lengths)
    w = rng.lognormal(0.0, 1.0, size=12)
    lreads, rreads = pesim.sample_pairs(rng, tx, w / w.sum(), 700, frag_range=(250, 400))
    with open(left, "wb") as fl, open(right, "wb") as fr:
        fl.write(pesim.fastq_bytes(lreads, 0, 1))
        fr.write(pesim.fastq_bytes(rreads, 0, 2))


def make_inputs(d):
    """{"plain": (left, right), "polya": (left, right), "ref": path} under
    the directory ``d``."""
    out = {"plain": (str(d / "r_1.fq"), str(d / "r_2.fq")), "polya": (str(d / "a_1.fq"), str(d / "a_2.fq"))}
    tx = pesim.write_pe_fastq(*out["plain"], seed=11, num_transcripts=20, tx_len=(500, 1500), num_pairs=600)
    _polya_fastq(*out["polya"])
    # -ref: two of the simulated transcripts, one cut to 300 bases, and a
    # novel one
    bases, offsets, lengths = tx
    refs = [bases[offsets[1] : offsets[1] + lengths[1]], bases[offsets[5] : offsets[5] + 300],
            np.random.default_rng(2).integers(0, 4, 700, dtype=np.uint8)]
    out["ref"] = str(d / "ref.fa")
    with open(out["ref"], "w") as f:
        for i, r in enumerate(refs):
            f.write(f">ref{i}\n" + "".join("ACGT"[c] for c in r) + "\n")
    return out


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def assert_same_outputs(tout, jout, report=True):
    got, want = _files(tout), _files(jout)
    assert sorted(got) == sorted(want)
    name = "rnabloom.report.json"
    assert (name in want) == report
    if report:
        a, b = json.loads(got.pop(name)), json.loads(want.pop(name))
        assert a.pop("elapsed_s") >= 0 and b.pop("elapsed_s") >= 0
        assert a == b
    for f in want:
        assert got[f] == want[f], f
    assert want["rnabloom.transcripts.fa"]
    return want


def write_fastq(path, reads, quals, prefix):
    """FASTQ records @<prefix><i> of (n, L) codes, with (n, L) quality
    characters as bytes."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, (r, q) in enumerate(zip(reads, quals)):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), i, bases[r].tobytes(), bytes(q)))


def write_se_reads(fwd, rev, seed, num_transcripts=12, num_reads=400):
    """Unpaired reads of simulated transcripts: the left mates of
    ``num_reads`` pairs to ``fwd`` (-sef) and the right mates, reverse
    complemented as sequenced, to ``rev`` (-ser).  Every 8th read of each
    file has three bases at quality 2 in its middle, which splits it into
    two segments the graph re-joins; six low-complexity reads (a
    homopolymer, a dinucleotide and a trinucleotide repeat in each file)
    must be dropped.  Returns the number of low-complexity reads."""
    rng = np.random.default_rng(seed)
    tx = pesim.make_transcripts(rng, num_transcripts, 500, 1200)
    w = rng.lognormal(0.0, 1.0, size=num_transcripts)
    left, right = pesim.sample_pairs(rng, tx, w / w.sum(), num_reads, frag_range=(250, 400))
    junk = np.stack([np.zeros(150, np.uint8), np.tile([0, 1], 75).astype(np.uint8),
                     np.tile([0, 0, 3], 50).astype(np.uint8)])
    for path, reads in ((fwd, left), (rev, right)):
        reads = np.concatenate([reads, junk])
        quals = np.full(reads.shape, ord("I"), np.uint8)
        quals[::8, 70:73] = ord("#")
        write_fastq(path, reads, quals, "se")
    return 2 * len(junk)


def write_gap_pairs(left, right, seed, num_gap=24, num_overlap=600, read_len=100):
    """Pairs of one 600-base transcript in the shape of the JAX package's
    rescue test (``tests/test_pipeline_e2e.py``): first ``num_gap`` pairs
    off 300-base fragments (a 100-base inner gap, which a bridge walk of
    bound 20 cannot span), then ``num_overlap`` pairs off 150-base
    fragments whose mates overlap."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, 600, dtype=np.uint8)
    starts = np.concatenate([rng.integers(0, 301, num_gap), rng.integers(0, 451, num_overlap)])
    flen = np.concatenate([np.full(num_gap, 300), np.full(num_overlap, 150)])
    j = np.arange(read_len)
    lreads = t[starts[:, None] + j]
    rreads = 3 - t[(starts + flen - 1)[:, None] - j]
    q = np.full(lreads.shape, ord("I"), np.uint8)
    write_fastq(left, lreads, q, "p")
    write_fastq(right, rreads, q, "p")


WALK_K = 25


def sim_walk_data():
    """Simulated reads of 16 transcripts at uneven depth, 30% with one
    substitution; two transcripts share a 200-base prefix.  Seeds: head,
    middle and reverse-complemented tail k-mers, and one with an N."""
    K = WALK_K
    rng = np.random.default_rng(7)
    tx = rng.integers(0, 4, size=(16, 600), dtype=np.uint8)
    tx[1, :200] = tx[0, :200]
    reads = []
    for t, depth in zip(tx, rng.integers(1, 9, size=16)):
        for _ in range(depth):
            for s in range(0, 500, 20):
                r = t[s : s + 100].copy()
                if rng.random() < 0.3:
                    r[rng.integers(100)] = rng.integers(4)
                reads.append(r)
    seeds = np.concatenate([tx[:, :K], tx[:, 300 : 300 + K], 3 - tx[:, -K:][:, ::-1]])
    seeds[5, 10] = 4
    return np.stack(reads), seeds


def traverse_walk_data():
    """The tests/test_traverse.py graphs in one read set: a linear
    transcript, a branch at 8x against 2x, and a unit repeated three
    times; seeds at the head of each."""
    K = WALK_K
    rng = np.random.default_rng(2024)
    rand = lambda n: rng.integers(0, 4, size=n, dtype=np.uint8)  # noqa: E731
    linear = rand(300)
    prefix = rand(100)
    high, low = np.concatenate([prefix, rand(150)]), np.concatenate([prefix, rand(150)])
    unit = rand(60)
    cyc = np.concatenate([rand(80), unit, unit, unit])
    L = 260
    reads = []
    for seq, copies in ((linear, 2), (high, 8), (low, 2), (cyc, 2)):
        for s in range(0, max(len(seq) - L, 0) + 1, 20):
            chunk = np.full(L, 4, np.uint8)
            piece = seq[s : s + L]
            chunk[: len(piece)] = piece
            reads += [chunk] * copies
    seeds = np.stack([linear[:K], prefix[:K], cyc[:K], linear[100 : 100 + K]])
    return np.stack(reads), seeds


WALK_DATA = {"sim": sim_walk_data, "traverse": traverse_walk_data}

# naive walks (-extend): case -> (data, dtype, blocked, stranded, num_hash,
# left, check_back_branches, tip_probe_depth, max_len, per-lane args, the
# stops the case must show: "back" (a deep left variant), "none_deep" /
# "several_deep" (a resolve with 0 / 2+ deep candidates), FULL, CYCLE)
NAIVE_CASES = {
    "mf8_right": ("sim", "mf8", False, False, 2, False, True, 8, WALK_K + 700, True,
                  {"back", "several_deep", "full"}),
    "u16_left_deep_probe": ("sim", "u16", False, False, 2, True, True, 20, WALK_K + 700, False,
                            {"back", "none_deep", "several_deep"}),
    "mf8_stranded_left": ("sim", "mf8", False, True, 2, True, True, 8, WALK_K + 700, False, {"back"}),
    "int32_blocked_hash3": ("sim", "int32", True, False, 3, False, True, 8, WALK_K + 700, True, {"back"}),
    "traverse_no_back_branches": ("traverse", "mf8", False, False, 2, False, False, 8, 512, False,
                                  {"several_deep", "cycle"}),
    "traverse_u16_short_buffer": ("traverse", "u16", False, False, 2, True, True, 8, 300, False, {"back", "full"}),
}


def naive_walk_rows(data, reads, seeds, stranded=False, left=False):
    """The naive cases' seeds: the data's seeds and, for the simulated
    graph, the first k-mer of every 40th read; reverse-complemented for
    stranded left walks (a left walk extends the reverse complement)."""
    rows = seeds if data == "traverse" else np.concatenate([seeds, reads[::40][:, :WALK_K]])
    if stranded and left:
        rows = np.where(rows < 4, 3 - rows, rows)[:, ::-1].copy()
    return rows


def naive_lane_args(case, W):
    """(min_cov, bound) of a naive case: scalars, or per-lane values."""
    if not NAIVE_CASES[case][9]:
        return np.float32(1.0), np.int32(500)
    rng = np.random.default_rng(len(case))
    return (rng.choice([1.0, 2.0, 3.5, 0.5], size=W).astype(np.float32),
            rng.integers(50, 700, size=W).astype(np.int32))
