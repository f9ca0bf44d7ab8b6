"""Seeded paired-end RNA-seq simulator (numpy), for tests and the smoke run.

Random transcripts with log-normal expression; each pair is a fragment of
uniform length drawn from one transcript, the left mate its first
``read_len`` bases, the right mate the reverse complement of its last
``read_len`` bases; substitutions at ``sub_rate``; qualities all 'I'.
Reads are written as plain FASTQ in chunks, so a million pairs never sit
in memory as Python strings.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = np.array([3, 2, 1, 0], dtype=np.uint8)


def make_transcripts(
    rng: np.random.Generator, n: int, min_len: int, max_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bases, offsets, lengths): n random transcripts as 2-bit codes,
    concatenated."""
    lengths = rng.integers(min_len, max_len + 1, size=n)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    bases = rng.integers(0, 4, size=int(lengths.sum()), dtype=np.uint8)
    return bases, offsets, lengths


def sample_pairs(
    rng: np.random.Generator,
    tx: Tuple[np.ndarray, np.ndarray, np.ndarray],
    expression: np.ndarray,
    num_pairs: int,
    read_len: int = 150,
    frag_range: Tuple[int, int] = (250, 400),
    sub_rate: float = 0.003,
) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right) (num_pairs, read_len) uint8 codes; right mates are
    reverse-complemented.  ``expression``: per-transcript probabilities.
    Transcripts must be >= frag_range[1] long."""
    bases, offsets, lengths = tx
    t = rng.choice(len(lengths), size=num_pairs, p=expression)
    flen = rng.integers(frag_range[0], frag_range[1] + 1, size=num_pairs)
    start = offsets[t] + (rng.random(num_pairs) * (lengths[t] - flen + 1)).astype(np.int64)
    j = np.arange(read_len)
    left = bases[start[:, None] + j]
    right = _COMP[bases[(start + flen - 1)[:, None] - j]]
    for reads in (left, right):
        hit = rng.random(reads.shape) < sub_rate
        reads[hit] = (reads[hit] + rng.integers(1, 4, size=int(hit.sum()), dtype=np.uint8)) % 4
    return left, right


def fastq_bytes(reads: np.ndarray, first_id: int, mate: int) -> bytes:
    """FASTQ records for (n, L) codes, named @r<id>/<mate>, quality 'I'."""
    seqs = _BASES[reads]
    qual = b"I" * reads.shape[1]
    return b"".join(
        b"@r%d/%d\n%s\n+\n%s\n" % (first_id + i, mate, seqs[i].tobytes(), qual)
        for i in range(reads.shape[0])
    )


def write_pe_fastq(
    left_path: str,
    right_path: str,
    seed: int,
    num_transcripts: int,
    tx_len: Tuple[int, int],
    num_pairs: int,
    expr_sigma: float = 1.0,
    chunk: int = 100_000,
    **kw,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Write ``num_pairs`` simulated pairs to two FASTQ files; returns the
    transcripts (see ``make_transcripts``).  Expression is log-normal with
    ``expr_sigma``; ``kw`` goes to ``sample_pairs``."""
    rng = np.random.default_rng(seed)
    tx = make_transcripts(rng, num_transcripts, *tx_len)
    w = rng.lognormal(0.0, expr_sigma, size=num_transcripts)
    with open(left_path, "wb") as fl, open(right_path, "wb") as fr:
        for first in range(0, num_pairs, chunk):
            left, right = sample_pairs(rng, tx, w / w.sum(), min(chunk, num_pairs - first), **kw)
            fl.write(fastq_bytes(left, first, 1))
            fr.write(fastq_bytes(right, first, 2))
    return tx


def write_golden_fastq(directory: str) -> Tuple[str, str]:
    """The repo's golden paired-end dataset (``tests/test_golden.py``,
    which locks ``tests/golden/pe_golden.json``): 3 random transcripts of
    420, 380 and 500 bases (seed 20240817), 80 pairs each of 100-base mates
    off 250-base fragments, the right mate reverse-complemented, qualities
    all 'I'.  Writes {directory}/g_1.fq.gz and g_2.fq.gz; returns their
    paths."""
    import gzip
    import os

    rng = np.random.default_rng(20240817)
    transcripts = ["".join(rng.choice(list("ACGT"), size=n)) for n in (420, 380, 500)]
    left, right = os.path.join(directory, "g_1.fq.gz"), os.path.join(directory, "g_2.fq.gz")
    q = "I" * 100
    rc = str.maketrans("ACGT", "TGCA")
    with gzip.open(left, "wt") as fl, gzip.open(right, "wt") as fr:
        rid = 0
        for t in transcripts:
            for _ in range(80):
                s = rng.integers(0, len(t) - 250 + 1)
                frag = t[s : s + 250]
                fl.write(f"@r{rid}/1\n{frag[:100]}\n+\n{q}\n")
                fr.write(f"@r{rid}/2\n{frag[-100:].translate(rc)[::-1]}\n+\n{q}\n")
                rid += 1
    return left, right
