"""Streaming stratified fragment store (stage 2 -> stage 3 handoff).

The port's copy of the writing side of ``rnabloom_tpu/assembly/fragstore.py``,
the equivalent of FragmentWriterWorker's stratified `.nbits` files
(RNABloom.java:4214-4301, FragmentPaths :4303-4434): stage 2 appends each
fragment to the file of its (coverage magnitude, length class, polyA)
stratum as it is assembled.  Nothing is held in host RAM beyond the open
writers and the per-fragment minimum coverages, which ride in the meta
JSON in write order, aligned with the `.nbits` records.

Strata match the reference exactly (RNABloom.java:150-158): singletons
(minCov == 1) go to their own "01" files, the rest to the file of their
coverage magnitude E0..E5.  The files and the meta JSON are byte-identical
to the JAX package's for the same fragments.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..io import nbits
from .fragments import coverage_order_of_magnitude


def _magnitude(c: float) -> int:
    return min(coverage_order_of_magnitude(c), 5)


class FragmentStore:
    """Append-only stratified fragment files under {outdir}/fragments/."""

    META = "fragments.meta.json"

    def __init__(self, outdir: str, long_threshold: int, polya_priority: bool = False):
        self.dir = os.path.join(outdir, "fragments")
        self.long_threshold = long_threshold
        self.polya_priority = polya_priority
        self._writers: dict = {}
        self._covs: dict = {}
        self.count = 0
        self.max_len = 0

    def _key(self, min_cov: float, length: int, connected: bool, polya: bool) -> str:
        cls = ("long" if length >= self.long_threshold else "short") if connected else "un"
        pa = ".polya" if (self.polya_priority and polya) else ""
        stratum = "01" if min_cov <= 1 else f"E{_magnitude(min_cov)}"
        return f"{stratum}.{cls}{pa}"

    def add(self, codes: np.ndarray, min_cov: float, connected: bool, polya: bool = False) -> None:
        os.makedirs(self.dir, exist_ok=True)
        key = self._key(min_cov, len(codes), connected, polya)
        w = self._writers.get(key)
        if w is None:
            w = nbits.NbitsWriter(os.path.join(self.dir, f"fragments.{key}.nbits"))
            self._writers[key] = w
            self._covs[key] = []
        w.write_codes(codes)
        self._covs[key].append(float(min_cov))
        self.count += 1
        self.max_len = max(self.max_len, len(codes))

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
        self._writers.clear()
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, self.META), "w") as f:
            json.dump(
                {
                    "long_threshold": self.long_threshold,
                    "polya_priority": self.polya_priority,
                    "count": self.count,
                    "max_len": self.max_len,
                    "strata": {k: {"min_covs": v} for k, v in self._covs.items()},
                },
                f,
            )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
