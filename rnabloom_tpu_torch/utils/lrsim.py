"""ONT cDNA read simulation + assembly accuracy evaluation.

The port's copy of ``rnabloom_tpu/utils/lrsim.py`` (numpy only; the same
seed gives the same reads).  The internal minimizer-overlap + layout +
realign pipeline replaces the reference's external minimap2/racon
(olc/OverlapLayoutConsensus.java:78-106, :849, :1129-1228), so its
assembly quality needs tracked numbers.  This module simulates reads with
an ONT-like error profile from a known transcript set and scores an
assembly against the truth:

  * ``lr_recall``      fraction of truth transcripts whose k-mers are
                       >= ``cov_frac`` covered by the assembly
  * ``lr_precision``   fraction of assembled sequences whose k-mers are
                       >= ``cov_frac`` supported by some truth transcript
  * ``lr_median_support``  median per-assembly truth-k-mer fraction (a
                       base-identity proxy: one error breaks k k-mers)

Scoring is canonical-k-mer based (k=31 by default): strand-symmetric,
alignment-free, and chance matches are negligible at that k.
``chip_smoke.py``'s long-read phase reports these scores.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import seq as sequtils

BASES = "ACGT"


def simulate_transcriptome(
    rng: np.random.Generator,
    n: int,
    len_range: Tuple[int, int] = (500, 2000),
    polya_frac: float = 0.5,
    polya_len: int = 20,
) -> List[str]:
    out = []
    for _ in range(n):
        L = int(rng.integers(len_range[0], len_range[1] + 1))
        t = "".join(rng.choice(list(BASES), size=L))
        if rng.random() < polya_frac:
            t += "A" * polya_len
        out.append(t)
    return out


def ont_noise(rng: np.random.Generator, seq: str, err: float) -> str:
    """ONT-like errors at total rate ``err``: 40% substitutions, 30%
    insertions, 30% deletions (indel-heavy, like nanopore basecalls)."""
    out = []
    for c in seq:
        r = rng.random()
        if r < err * 0.4:
            out.append(rng.choice([b for b in BASES if b != c]))
        elif r < err * 0.7:
            out.append(c)
            out.append(rng.choice(list(BASES)))
        elif r < err:
            continue  # deletion
        else:
            out.append(c)
    return "".join(out)


def simulate_reads(
    rng: np.random.Generator,
    transcripts: Sequence[str],
    coverage: int,
    err: float = 0.07,
    min_read: int = 300,
    full_length_frac: float = 0.35,
) -> List[str]:
    """cDNA reads: a mix of full-length and 5'-truncated molecules (ONT
    cDNA reads start mid-transcript when reverse transcription stops
    early), random strand, per-read error draw around ``err``."""
    reads = []
    for t in transcripts:
        for _ in range(coverage):
            if rng.random() < full_length_frac or len(t) <= min_read:
                frag = t
            else:
                start = int(rng.integers(0, max(len(t) - min_read, 1)))
                frag = t[start:]
            e = max(0.01, rng.normal(err, err * 0.25))
            read = ont_noise(rng, frag, e)
            if len(read) < 50:
                continue
            if rng.random() < 0.5:
                read = sequtils.revcomp(read)
            reads.append(read)
    rng.shuffle(reads)
    return reads


def _canon_kmers(seq: str, k: int) -> set:
    s = seq.upper()
    rc = sequtils.revcomp(s)
    n = len(s)
    return {
        min(s[i : i + k], rc[n - k - i : n - i]) for i in range(n - k + 1)
    }


def evaluate(
    assembled: Sequence[str],
    truth: Sequence[str],
    k: int = 31,
    cov_frac: float = 0.9,
) -> Dict[str, float]:
    truth_sets = [_canon_kmers(t, k) for t in truth]
    truth_all = set().union(*truth_sets) if truth_sets else set()
    asm_sets = [_canon_kmers(a, k) for a in assembled if len(a) >= k]
    asm_all = set().union(*asm_sets) if asm_sets else set()

    recovered = 0
    per_truth_cov = []
    for ts in truth_sets:
        cov = len(ts & asm_all) / max(len(ts), 1)
        per_truth_cov.append(cov)
        recovered += cov >= cov_frac

    precise = 0
    supports = []
    for asm in asm_sets:
        supp = len(asm & truth_all) / max(len(asm), 1)
        supports.append(supp)
        precise += supp >= cov_frac

    return {
        "lr_recall": round(recovered / max(len(truth_sets), 1), 3),
        "lr_precision": round(precise / max(len(asm_sets), 1), 3),
        "lr_median_support": round(float(np.median(supports)) if supports else 0.0, 3),
        "lr_mean_truth_cov": round(float(np.mean(per_truth_cov)) if per_truth_cov else 0.0, 3),
        "lr_n_assembled": len(asm_sets),
        "lr_n_truth": len(truth_sets),
    }
