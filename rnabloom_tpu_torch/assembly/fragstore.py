"""Streaming stratified fragment store (stage 2 -> stage 3 handoff).

The port's copy of ``rnabloom_tpu/assembly/fragstore.py``, the equivalent of FragmentWriterWorker's stratified
`.nbits` files (RNABloom.java:4214-4301, FragmentPaths :4303-4434): stage 2
appends each fragment to the file of its (coverage magnitude, length class,
polyA) stratum as it is assembled, and stages 2b and 3 iterate the files in
the reference's priority order — magnitude E5..E0, long before short before
unconnected, polyA-tailed first within a class when prioritized
(assembleTranscriptsMultiThreaded :4886-4954).  Nothing is held in host RAM
beyond the open writers, one fixed-size batch and the per-fragment minimum
coverages, which ride in the meta JSON in write order, aligned with the
`.nbits` records.

Strata match the reference exactly (RNABloom.java:150-158): singletons
(minCov == 1) go to their own "01" files, read after every magnitude file
of their class; the rest to the file of their coverage magnitude E0..E5.
The files and the meta JSON are byte-identical to the JAX package's for the
same fragments.  ``merge_stores`` concatenates the stores of the processes
of a multi-host stage 2 into one.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..io import nbits
from .fragments import coverage_order_of_magnitude


_MAGS = range(5, -1, -1)  # E5 .. E0
_CLASSES = ("long", "short", "un")


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

    def flush(self) -> None:
        """Flush writer buffers so iter_batches sees every stored fragment
        while the store stays open for appends."""
        for w in self._writers.values():
            w._f.flush()

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

    # -- reading ----------------------------------------------------------

    @classmethod
    def open(cls, outdir: str) -> Optional["FragmentStore"]:
        store = cls(outdir, long_threshold=0)
        meta_path = os.path.join(store.dir, cls.META)
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        store.long_threshold = meta["long_threshold"]
        store.polya_priority = meta.get("polya_priority", False)
        store.count = meta["count"]
        store.max_len = meta["max_len"]
        store._covs = {k: v["min_covs"] for k, v in meta["strata"].items()}
        return store

    def _ordered_keys(self) -> List[str]:
        """Reference priority order (assembleTranscriptsMultiThreaded
        :4886-5020): polyA group first (when prioritized); within a group,
        class-outer — LONG E5..E0, SHORT E5..E0, UNCONNECTED E5..E0 — then
        the singleton ("01") file of each class."""
        keys = []
        for pa in (".polya", "") if self.polya_priority else ("",):
            for cl in _CLASSES:
                for mag in _MAGS:
                    k = f"E{mag}.{cl}{pa}"
                    if k in self._covs:
                        keys.append(k)
            for cl in _CLASSES:
                k = f"01.{cl}{pa}"
                if k in self._covs:
                    keys.append(k)
        return keys

    def iter_batches(
        self, batch_size: int, width: Optional[int] = None
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (codes (B, W), lens, min_covs, connected) in priority order.

        Rows are fragments; the final batch of a stratum is padded with
        zero-length rows so every yield has the same (batch_size, W) shape.
        """
        W = width or self.max_len
        for key in self._ordered_keys():
            covs = self._covs[key]
            path = os.path.join(self.dir, f"fragments.{key}.nbits")
            conn = not key.split(".")[1].startswith("un")
            buf = np.full((batch_size, W), 4, np.uint8)
            lens = np.zeros(batch_size, np.int32)
            cvs = np.zeros(batch_size, np.float32)
            n = 0
            for i, codes in enumerate(nbits.read_nbits_codes(path)):
                m = min(len(codes), W)
                buf[n, :m] = codes[:m]
                lens[n] = m
                cvs[n] = covs[i] if i < len(covs) else 1.0
                n += 1
                if n == batch_size:
                    yield buf, lens, cvs, np.full(batch_size, conn)
                    buf = np.full((batch_size, W), 4, np.uint8)
                    lens = np.zeros(batch_size, np.int32)
                    cvs = np.zeros(batch_size, np.float32)
                    n = 0
            if n:
                yield buf, lens, cvs, np.full(batch_size, conn)

    def iter_lengths(self) -> Iterator[int]:
        for key in self._ordered_keys():
            path = os.path.join(self.dir, f"fragments.{key}.nbits")
            for codes in nbits.read_nbits_codes(path):
                yield len(codes)


def merge_stores(dest_outdir: str, src_outdirs: List[str]) -> Optional[FragmentStore]:
    """Concatenate the fragment stores under ``src_outdirs`` (each process
    of a multi-host stage 2 writes its slice's fragments to its own) into
    one under ``dest_outdir``, in the order given.  ``.nbits`` records are
    self-delimiting, so each stratum's files concatenate byte-wise and its
    minimum coverages in the same order.  None when no source has a store."""
    srcs = [s for s in (FragmentStore.open(d) for d in src_outdirs) if s is not None]
    if not srcs:
        return None
    dest = FragmentStore(dest_outdir, long_threshold=srcs[0].long_threshold, polya_priority=srcs[0].polya_priority)
    shutil.rmtree(dest.dir, ignore_errors=True)  # appends must start clean
    os.makedirs(dest.dir, exist_ok=True)
    for src in srcs:
        for key, covs in src._covs.items():
            with open(os.path.join(src.dir, f"fragments.{key}.nbits"), "rb") as fi, \
                    open(os.path.join(dest.dir, f"fragments.{key}.nbits"), "ab") as fo:
                shutil.copyfileobj(fi, fo, 1 << 20)
            dest._covs.setdefault(key, []).extend(covs)
        dest.count += src.count
        dest.max_len = max(dest.max_len, src.max_len)
    dest.close()
    return FragmentStore.open(dest_outdir)
