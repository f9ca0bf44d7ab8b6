#!/usr/bin/env python3
"""Phase 10 of ``chip_smoke.py`` alone: the long-read path on one CUDA card.

    python3 tools/long_smoke.py [--transcripts N] [--coverage C] [--lr-variant NAME=PATH ...]
                                [--kernels-only] [--sass PATH]

Builds the kernels (and each ``--lr-variant``, another
``csrc/lr_kernels.cu`` with the same C entry points), then runs
``chip_smoke.long_read_path``: lrsim reads (seed 0; N transcripts of
500-4,000 bases at coverage C, 7% error) through ``-long``, ``-lrsub
5,11,0,50``, ``-lrsub 5,25,0`` and ``-paf`` on the card, the long-read
kernels against their plain versions on the runs' own data and K1 and K2
at 7 times the raw reads (the variants in the same turns), and card
against CPU on the first 400 reads.  ``--kernels-only`` runs the kernel
cells alone: K1 and K2 at 7 times the raw reads
(``chip_smoke.lr_keys_full_size``), then run (i) alone for its polish
inputs and K3 on them (``chip_smoke.vote_vs_plain``) and on them 7 times
over (``chip_smoke.vote_full_size``), the quickest loop for the three
kernels; ``--sass PATH`` writes the port's long-read kernel library as
``cuobjdump -sass`` shows it to PATH.  The last line is the results as
JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rnabloom_tpu_torch.ops import _build  # noqa: E402
from rnabloom_tpu_torch.utils import lrsim  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--transcripts", type=int, default=chip_smoke.LR_TRANSCRIPTS)
    ap.add_argument("--coverage", type=int, default=chip_smoke.LR_COVERAGE)
    ap.add_argument("--lr-variant", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--kernels-only", action="store_true",
                    help="the kernel cells alone: K1 and K2 at the full size, K3 at run (i)'s and the full size")
    ap.add_argument("--sass", metavar="PATH", help="write the long-read kernel library's SASS here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("long_smoke: no CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    t0 = time.time()
    built = _build.build_all()
    variants = {name: chip_smoke.build_variant("lr", i, src)
                for i, (name, src) in enumerate(v.split("=", 1) for v in args.lr_variant)}
    print(f"card: {card}; kernels built in {time.time() - t0:.1f} s: {built}; long-read variants {args.lr_variant}",
          flush=True)
    log = _build.build_logs.get(_build.LR_SRC)
    if log is not None:
        print("nvcc -Xptxas -v, long-read kernels: "
              + "; ".join(chip_smoke.insert_ptxas(log, "kmer_keys|randstrobe|vote"))
              + "; randstrobe_kernel's dynamic shared memory at -lrsub 5,11,0,50: "
                f"{_build.lr_kernels().lr_randstrobe_smem(chip_smoke.LR_N, chip_smoke.LR_WMAX)} B")
    if args.sass:
        sass = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass", _build.LR_LIB],
                              capture_output=True, text=True, check=True).stdout
        os.makedirs(os.path.dirname(os.path.abspath(args.sass)), exist_ok=True)
        with open(args.sass, "w") as f:
            f.write(sass)
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="long_smoke_")
    try:
        t0 = time.time()
        if args.kernels_only:
            rng = np.random.default_rng(0)
            truth = lrsim.simulate_transcriptome(rng, args.transcripts, (500, 4000))
            raw = lrsim.simulate_reads(rng, truth, coverage=args.coverage, err=chip_smoke.LR_ERR)
            r = {"full_size": chip_smoke.lr_keys_full_size(raw, card, dev, variants)}
            fasta = os.path.join(tmp, "long.fa")
            with open(fasta, "w") as f:
                f.writelines(f">r{i}\n{s}\n" for i, s in enumerate(raw))
            _, captured = chip_smoke.captured_run(fasta, os.path.join(tmp, "long_a"), truth, card)
            r["vote"] = chip_smoke.vote_vs_plain(captured, card, dev, variants)
            r["vote_full_size"] = chip_smoke.vote_full_size(captured, card, dev, variants)
            print(f"the kernel cells took {time.time() - t0:.1f} s")
        else:
            r = chip_smoke.long_read_path(tmp, card, dev, args.transcripts, args.coverage, variants)
            print(f"phase 10 took {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(r, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
