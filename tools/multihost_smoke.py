#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone: multi-host groups on the card.

    python3 tools/multihost_smoke.py [--pairs N]

Builds the kernels, simulates N pairs (default
``chip_smoke.MESH_STAGE3_PAIRS``; the smoke's simulation parameters, seed
0) and phase 10's long reads (their first ``LR_CHECK``), runs ``-stage 3``
at ``-mem 1`` on the N pairs in this process on the card (the one-device
run that phase 12 gives the smoke), then ``chip_smoke.multihost_phase``:
groups of two CLI processes on the card for ``-stage 1 -cnt int32``
against one process, ``-stage 3`` on ``STAGE3_PAIRS`` pairs and ``-long``
card against CPU, and ``-stage 3`` on the N pairs with each process's
numbers.  The quickest loop for the multi-host layout.  The last line is
the results as JSON.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rnabloom_tpu_torch.assembly import pipeline  # noqa: E402
from rnabloom_tpu_torch.ops import _build  # noqa: E402
from rnabloom_tpu_torch.utils import lrsim, pesim  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=chip_smoke.MESH_STAGE3_PAIRS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("multihost_smoke: no CUDA card", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    t0 = time.time()
    built = _build.build_all()
    print(f"card: {card}; kernels built in {time.time() - t0:.1f} s: {built}", flush=True)
    tmp = tempfile.mkdtemp(prefix="multihost_smoke_")
    try:
        left, right = os.path.join(tmp, "reads_1.fq"), os.path.join(tmp, "reads_2.fq")
        n_pairs = max(args.pairs, chip_smoke.MH_S1_PAIRS, chip_smoke.STAGE3_PAIRS)
        pesim.write_pe_fastq(left, right, seed=0, num_transcripts=2000, tx_len=(1000, 4000), num_pairs=n_pairs,
                             read_len=chip_smoke.READ_LEN, frag_range=(250, 400), sub_rate=0.003)
        heads = {}
        for n in (args.pairs, chip_smoke.MH_S1_PAIRS, chip_smoke.STAGE3_PAIRS):
            heads[n] = (os.path.join(tmp, f"head{n}_1.fq"), os.path.join(tmp, f"head{n}_2.fq"))
            chip_smoke.head_fastq(left, heads[n][0], n)
            chip_smoke.head_fastq(right, heads[n][1], n)
        heads[chip_smoke.MESH_STAGE3_PAIRS] = heads[args.pairs]
        rng = np.random.default_rng(0)
        truth = lrsim.simulate_transcriptome(rng, chip_smoke.LR_TRANSCRIPTS, (500, 4000))
        reads = lrsim.simulate_reads(rng, truth, coverage=chip_smoke.LR_COVERAGE, err=chip_smoke.LR_ERR)
        long_head = os.path.join(tmp, "long_head.fa")
        with open(long_head, "w") as f:
            for i, r in enumerate(reads[: chip_smoke.LR_CHECK]):
                f.write(f">r{i}\n{r}\n")
        # the one-device run of the pairs, as phase 12's
        out = os.path.join(tmp, "single")
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.time()
        rep = pipeline.assemble_pe(*heads[args.pairs], out, pipeline.PipelineParams(sharded="off"), save_graph=True,
                                   device="cuda")
        torch.cuda.synchronize()
        single = {"wall_s": time.time() - t0, "stage1_s": rep.stage1.elapsed_s, "stage2_s": rep.stage2_s,
                  "stage3_s": rep.stage3_s, "peak_bytes": torch.cuda.max_memory_allocated() - held}
        single_transcripts = chip_smoke.canonical_transcripts(os.path.join(out, "rnabloom.transcripts.fa"))
        shutil.rmtree(out)
        torch.cuda.empty_cache()
        t0 = time.time()
        result = chip_smoke.multihost_phase(heads, long_head, single_transcripts, single, tmp, card, dev)
        t_phase = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 13 {t_phase:.1f} s [{card}]")
    print(json.dumps({"single": single, "phase13": result, "phase13_s": t_phase}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
