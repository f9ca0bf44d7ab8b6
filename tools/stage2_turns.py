#!/usr/bin/env python3
"""Stage-2 pairs/s of checkouts of the port, in turns, on one CUDA card.

    python3 tools/stage2_turns.py [--pairs N] TREE[,FLAG...] [TREE[,FLAG...] ...]

Writes N simulated read pairs as ``chip_smoke.py`` phase 3 does (seed 0,
2000 transcripts of 1-4 kb, 150 bp reads of 250-400 bp fragments, 0.3%
substitutions), then runs ``cli -stage 2 -savebf -cnt mf8 --device cuda``
(``-mem 1``) from each TREE, a checkout of the repo, in the order given,
each in a process of its own, with the CLI flags that follow the TREE
after commas (``.,-extend`` runs the tree in ``.`` with ``-extend``).
Each run prints its stage-1 reads/s, its stage-2 pairs/s and its fragment
count; the last line is a JSON list of them.  Give the trees in turns (A B B A) so that the host's drift over the
call cancels.  Each tree's kernels and FASTX reader are built into its own
``build/`` before the first turn, so that no build falls in a timed stage.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUILD = """
from rnabloom_tpu_torch.io import native
from rnabloom_tpu_torch.ops import _build
_build.build_all()
assert native.available()
"""

RUN = """
import json, sys
from rnabloom_tpu_torch import cli
r = cli.run(["-left", sys.argv[1], "-right", sys.argv[2], "-revcomp-right", "-o", sys.argv[3], "-stage", "2",
             "-savebf", "-f", "-cnt", "mf8", "--device", "cuda", *sys.argv[4:]])
print(json.dumps({"pairs": r.num_pairs, "stage2_s": r.stage2_s, "fragments": r.num_fragments,
                  "reads": r.stage1.num_reads, "stage1_s": r.stage1.elapsed_s}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=250_000)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("stage2_turns: torch.cuda.is_available() is False; this needs a CUDA card", file=sys.stderr)
        return 1
    from rnabloom_tpu_torch.utils import pesim

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    results = []
    with tempfile.TemporaryDirectory(prefix="stage2_turns_") as tmp:
        left, right = os.path.join(tmp, "reads_1.fq"), os.path.join(tmp, "reads_2.fq")
        pesim.write_pe_fastq(left, right, seed=0, num_transcripts=2000, tx_len=(1000, 4000),
                             num_pairs=args.pairs, read_len=150, frag_range=(250, 400), sub_rate=0.003)
        turns = [spec.split(",") for spec in args.trees]
        for tree in dict.fromkeys(tree for tree, *_ in turns):
            subprocess.run([sys.executable, "-c", BUILD], cwd=os.path.abspath(tree), check=True)
        for turn, (tree, *flags) in enumerate(turns):
            out = os.path.join(tmp, f"out{turn}")
            proc = subprocess.run([sys.executable, "-c", RUN, left, right, out, *flags], cwd=os.path.abspath(tree),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise RuntimeError(f"the -stage 2 run from {tree} failed: exit code {proc.returncode}")
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            r.update(turn=turn, tree=tree, flags=flags, pairs_per_s=r["pairs"] / r["stage2_s"],
                     reads_per_s=r["reads"] / r["stage1_s"])
            print(f"turn {turn}, {' '.join([tree, *flags])}: stage 2 {r['pairs_per_s']:.1f} pairs/s ({r['pairs']} "
                  f"pairs, {r['stage2_s']:.2f} s, {r['fragments']} fragments); stage 1 {r['reads_per_s']:.0f} reads/s "
                  f"[{card}]", flush=True)
            results.append(r)
            shutil.rmtree(out)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
