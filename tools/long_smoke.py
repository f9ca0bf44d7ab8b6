#!/usr/bin/env python3
"""Phase 10 of ``chip_smoke.py`` alone: the long-read path on one CUDA card.

    python3 tools/long_smoke.py [--transcripts N] [--coverage C]

Builds the kernels, then runs ``chip_smoke.long_read_path``: lrsim reads
(seed 0; N transcripts of 500-4,000 bases at coverage C, 7% error) through
``-long``, ``-lrsub 5,11,0,50``, ``-lrsub 5,25,0`` and ``-paf`` on the
card, the long-read kernels against their plain versions on the runs' own
data, and card against CPU on the first 400 reads.  The last line is the
phase's results as JSON.  The quickest loop for the long-read path.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rnabloom_tpu_torch.ops import _build  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--transcripts", type=int, default=chip_smoke.LR_TRANSCRIPTS)
    ap.add_argument("--coverage", type=int, default=chip_smoke.LR_COVERAGE)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("long_smoke: no CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    t0 = time.time()
    built = _build.build_all()
    print(f"card: {card}; kernels built in {time.time() - t0:.1f} s: {built}", flush=True)
    log = _build.build_logs.get(_build.LR_SRC)
    if log is not None:
        print("nvcc -Xptxas -v, long-read kernels: "
              + "; ".join(chip_smoke.insert_ptxas(log, "kmer_keys|randstrobe|vote_scatter|vote_resolve")))
    tmp = tempfile.mkdtemp(prefix="long_smoke_")
    try:
        t0 = time.time()
        r = chip_smoke.long_read_path(tmp, card, torch.device("cuda"), args.transcripts, args.coverage)
        print(f"phase 10 took {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(r, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
