#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone: the sharded graph engine on the card.

    python3 tools/mesh_smoke.py [--pairs N] [--builds-only]

Builds the kernels, simulates N pairs (default ``chip_smoke.MESH_PAIRS``;
the smoke's simulation parameters, seed 0), then runs
``chip_smoke.mesh_builds`` (the stage-1 build at ``-mem 1`` over both
mates of the pairs on meshes of 2 and 8 shards on the card, and one shard
a card where several are visible, each against the single-device kernel
build; on the 2- and 8-shard meshes the sharded walk kernel in each mode
against the single-device kernel on the replica and the plain routed loop,
``chip_smoke.mesh_walk_cells``; one batch each of u16, the blocked int32
cbf and the exact int32 path) and ``chip_smoke.mesh_pipeline``
(``-stage 3`` on the 8-shard mesh against one device on the first
``MESH_STAGE3_PAIRS`` pairs, then under ``RNB_MESH_WALK=routed`` and
``grouped`` against the replicated run, and against 8 CPU shards on the
first 2000, where ``-stage 2 -extend`` runs routed against replicated;
``--builds-only`` skips these runs).  The quickest loop for the sharded
engine and its walks.  The last line is the results as JSON.
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
from rnabloom_tpu_torch.utils import pesim  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=chip_smoke.MESH_PAIRS)
    ap.add_argument("--builds-only", action="store_true", help="the mesh builds alone, no pipeline run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_smoke: no CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    t0 = time.time()
    built = _build.build_all()
    print(f"card: {card}; kernels built in {time.time() - t0:.1f} s: {built}", flush=True)
    tmp = tempfile.mkdtemp(prefix="mesh_smoke_")
    try:
        left, right = os.path.join(tmp, "reads_1.fq"), os.path.join(tmp, "reads_2.fq")
        pesim.write_pe_fastq(left, right, seed=0, num_transcripts=2000, tx_len=(1000, 4000), num_pairs=args.pairs,
                             read_len=chip_smoke.READ_LEN, frag_range=(250, 400), sub_rate=0.003)
        heads = {}
        for n in (chip_smoke.MESH_STAGE3_PAIRS, chip_smoke.STAGE3_PAIRS):
            heads[n] = (os.path.join(tmp, f"head{n}_1.fq"), os.path.join(tmp, f"head{n}_2.fq"))
            chip_smoke.head_fastq(left, heads[n][0], n)
            chip_smoke.head_fastq(right, heads[n][1], n)
        t0 = time.time()
        builds = chip_smoke.mesh_builds(left, right, card, dev)
        t_builds = time.time() - t0
        t0 = time.time()
        runs = None if args.builds_only else chip_smoke.mesh_pipeline(
            *heads[chip_smoke.MESH_STAGE3_PAIRS], heads[chip_smoke.STAGE3_PAIRS], tmp, card, dev)
        t_runs = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"mesh builds {t_builds:.1f} s, pipeline runs {t_runs:.1f} s [{card}]")
    print(json.dumps({"builds": builds, "runs": runs, "builds_s": t_builds, "runs_s": t_runs}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
