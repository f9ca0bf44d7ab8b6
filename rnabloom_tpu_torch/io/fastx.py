"""FASTQ/FASTA readers (gzip-aware, format-sniffing).

The port's copy of the readers and of ``FastaWriter`` (stage 3's output)
of ``rnabloom_tpu/io/fastx.py``, line for line.
Readers yield (name, seq[, qual]) tuples of str; batching and quality
segmentation live in ``utils/seq.py`` and the pipeline.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, List, Optional, Tuple

BUFFER_SIZE = 1 << 20

FASTA_EXTS = (".fa", ".fasta", ".fna")
FASTQ_EXTS = (".fq", ".fastq")
NBITS_EXT = ".nbits"


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(
            io.BufferedReader(gzip.open(path, "rb"), BUFFER_SIZE), encoding="ascii"
        )
    return open(path, "rt", buffering=BUFFER_SIZE, encoding="ascii")


def sniff_format(path: str) -> str:
    """'fastq' | 'fasta' | 'nbits' by extension, falling back to content."""
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext in FASTQ_EXTS:
        return "fastq"
    if ext in FASTA_EXTS:
        return "fasta"
    if ext == NBITS_EXT:
        return "nbits"
    with _open_text(path) as f:
        first = f.readline()
    if first.startswith("@"):
        return "fastq"
    if first.startswith(">"):
        return "fasta"
    raise ValueError(f"unrecognized sequence format: {path}")


def read_fastq(path: str) -> Iterator[Tuple[str, str, str]]:
    """Yield (name, seq, qual)."""
    with _open_text(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            header = header.rstrip()
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"bad FASTQ header in {path}: {header[:50]!r}")
            seq = f.readline().rstrip()
            plus = f.readline()
            if not plus.startswith("+"):
                raise ValueError(f"bad FASTQ separator in {path}")
            qual = f.readline().rstrip()
            yield header[1:].split(" ", 1)[0], seq, qual


def read_fasta(path: str, full_header: bool = False) -> Iterator[Tuple[str, str]]:
    """Yield (name, seq); multi-line records are joined.

    ``full_header`` keeps the whole header line (name + comment) instead of
    the first whitespace-delimited token.
    """
    name = None
    parts: List[str] = []
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(parts)
                name = line[1:] if full_header else line[1:].split(" ", 1)[0]
                parts = []
            else:
                parts.append(line)
        if name is not None:
            yield name, "".join(parts)


def read_seqs(path: str) -> Iterator[Tuple[str, str, Optional[str]]]:
    """Unified iterator: (name, seq, qual-or-None)."""
    fmt = sniff_format(path)
    if fmt == "fastq":
        for name, seq, qual in read_fastq(path):
            yield name, seq, qual
    elif fmt == "fasta":
        for name, seq in read_fasta(path):
            yield name, seq, None
    else:
        from . import nbits

        for i, seq in enumerate(nbits.read_nbits(path)):
            yield str(i), seq, None


def read_paired(
    left: str, right: str, revcomp_left: bool = False, revcomp_right: bool = False
) -> Iterator[Tuple[Tuple[str, str, Optional[str]], Tuple[str, str, Optional[str]]]]:
    """Synchronized paired iteration over two files (FastxFilePair).

    Orientation flags mark files whose reads must be reverse-complemented to
    the forward strand; the flip itself happens downstream on code arrays.
    """
    li = read_seqs(left)
    ri = read_seqs(right)
    for l, r in zip(li, ri):
        yield l, r
    # detect ragged pairing
    for leftover in li:
        raise ValueError(f"{left} has more reads than {right}")
    for leftover in ri:
        raise ValueError(f"{right} has more reads than {left}")


class FastaWriter:
    """Gzip-aware FASTA writer with optional line wrapping."""

    def __init__(self, path: str, wrap: int = 0, append: bool = False, uracil: bool = False):
        mode = "ab" if append else "wb"
        if path.endswith(".gz"):
            self._f = gzip.open(path, mode, compresslevel=4)
        else:
            self._f = open(path, mode, buffering=BUFFER_SIZE)
        self._wrap = wrap
        self._uracil = uracil  # -u: write RNA (T -> U), FastaWriter.java

    _URACIL = str.maketrans("Tt", "Uu")

    def write(self, name: str, seq: str, comment: str = "") -> None:
        if self._uracil:
            seq = seq.translate(self._URACIL)
        header = f">{name} {comment}\n" if comment else f">{name}\n"
        self._f.write(header.encode("ascii"))
        if self._wrap and len(seq) > self._wrap:
            for i in range(0, len(seq), self._wrap):
                self._f.write(seq[i : i + self._wrap].encode("ascii") + b"\n")
        else:
            self._f.write(seq.encode("ascii") + b"\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
