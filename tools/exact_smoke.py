#!/usr/bin/env python3
"""Phase 11's insert cells of ``chip_smoke.py`` alone: exact counts on the card.

    python3 tools/exact_smoke.py [--pairs N] [--insert-variant NAME=PATH ...]

Builds the kernels (and each ``--insert-variant``, another
``csrc/cell_insert.cu`` with the same C entry points, built with the port's
nvcc flags), simulates N pairs (default ``chip_smoke.EXACT_PAIRS``; the
smoke's simulation parameters, seed 0), then runs
``chip_smoke.exact_builds`` (the exact-count stage-1 build at ``-mem 1`` of
both mates, -cnt int32 and mf8, with the fused conservative update, with
the update composed of plain-torch gathers and the port's and each
variant's ``max`` kernel, and with the plain inserts: every table
byte-identical, the ms of a build step in turns; the -cnt u16 build's
first batch), ``chip_smoke.max_cells`` (``max`` for int32, u16 and mf8
cells on the builds' first batches and on synthetic batches, against its
plain version, ``scatter_reduce_`` and each variant, in turns) and
``chip_smoke.conservative_cells`` (the fused update on the first batches,
against its plain version and the compositions, in turns, and on a table
where keys collide).  The quickest loop for the
``max`` and conservative-update kernels.  The last line is the results as
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rnabloom_tpu_torch.ops import _build  # noqa: E402
from rnabloom_tpu_torch.utils import pesim  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=chip_smoke.EXACT_PAIRS)
    ap.add_argument("--insert-variant", action="append", default=[], metavar="NAME=PATH",
                    help="another insert kernel source (same C entry points) to check and time beside the port's")
    args = ap.parse_args(argv)
    srcs = dict(v.split("=", 1) for v in args.insert_variant)
    if not torch.cuda.is_available():
        print("exact_smoke: no CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    t0 = time.time()
    with ThreadPoolExecutor(1 + len(srcs)) as pool:
        port = pool.submit(_build.kernels)
        builds = {name: pool.submit(chip_smoke.build_variant, "insert", i, src) for i, (name, src) in enumerate(srcs.items())}
        port.result()
        variants = {name: f.result() for name, f in builds.items()}
    print(f"card: {card}; insert kernels built in {time.time() - t0:.1f} s: "
          + "; ".join(chip_smoke.insert_ptxas(_build.build_logs.get(_build.KERNEL_LIB, ""))), flush=True)
    tmp = tempfile.mkdtemp(prefix="exact_smoke_")
    try:
        left, right = os.path.join(tmp, "reads_1.fq"), os.path.join(tmp, "reads_2.fq")
        pesim.write_pe_fastq(left, right, seed=0, num_transcripts=2000, tx_len=(1000, 4000), num_pairs=args.pairs,
                             read_len=chip_smoke.READ_LEN, frag_range=(250, 400), sub_rate=0.003)
        chip_smoke.EXACT_PAIRS = args.pairs
        t0 = time.time()
        built = chip_smoke.exact_builds(left, right, card, dev, variants)
        first = built.pop("first")
        runs = {c: built[c] for c in ("int32", "mf8", "u16")}
        del built
        torch.cuda.empty_cache()
        maxc = chip_smoke.max_cells(first, card, dev, variants)
        consc = chip_smoke.conservative_cells(first, card, dev, variants)
        seconds = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"exact cells {seconds:.1f} s [{card}]")
    print(json.dumps({"builds": runs, "max": maxc, "conservative": consc, "seconds": seconds}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
