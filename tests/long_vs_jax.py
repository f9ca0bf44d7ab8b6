#!/usr/bin/env python3
"""The port's ``-long`` against the JAX package's on ``chip_smoke.py``'s
phase-10 reads, both on the CPU.

    JAX_PLATFORMS=cpu python3 tests/long_vs_jax.py [--transcripts N]
        [--coverage C] [--head R] [--mem GB] [--seed S] [--lengths A,B]
        [--workdir DIR]

Simulates the phase's reads (lrsim, seed 0, N transcripts of 500-4,000
bases at coverage C, 7% error; the JAX package's lrsim must give the same
strings), keeps the first R reads when ``--head`` is given, runs both CLIs
(``-long READS -mem GB``; the JAX one with ``-sharded off``), compares every
output file byte for byte and prints ``lrsim.evaluate``'s scores of each
package's transcripts.  The last line is the result as JSON.
``--seed 42 --transcripts 10 --lengths 500,1500 --coverage 20 --mem
0.015625`` is ``tests/test_lr_accuracy.py``'s setting.  Not a pytest
module: the phase's 1,500 reads take about two minutes on a CPU.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from rnabloom_tpu import cli as jcli  # noqa: E402
from rnabloom_tpu.utils import lrsim as jlrsim  # noqa: E402
from rnabloom_tpu_torch import cli  # noqa: E402
from rnabloom_tpu_torch.io import fastx  # noqa: E402
from rnabloom_tpu_torch.utils import lrsim  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--transcripts", type=int, default=chip_smoke.LR_TRANSCRIPTS)
    ap.add_argument("--coverage", type=int, default=chip_smoke.LR_COVERAGE)
    ap.add_argument("--head", type=int, default=0, help="keep the first R reads (0: all)")
    ap.add_argument("--mem", default="1", help="-mem of both runs, in GB (the smoke's is 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lengths", default="500,4000", help="transcript lengths, MIN,MAX")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    d = args.workdir or tempfile.mkdtemp(prefix="long_vs_jax_")
    os.makedirs(d, exist_ok=True)

    lengths = tuple(int(x) for x in args.lengths.split(","))
    rng, jrng = np.random.default_rng(args.seed), np.random.default_rng(args.seed)
    truth = lrsim.simulate_transcriptome(rng, args.transcripts, lengths)
    reads = lrsim.simulate_reads(rng, truth, coverage=args.coverage, err=chip_smoke.LR_ERR)
    jtruth = jlrsim.simulate_transcriptome(jrng, args.transcripts, lengths)
    assert jtruth == truth and jlrsim.simulate_reads(jrng, jtruth, coverage=args.coverage,
                                                     err=chip_smoke.LR_ERR) == reads
    if args.head:
        reads = reads[:args.head]
    path = os.path.join(d, "long.fa")
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    print(f"{len(reads)} reads, {sum(map(len, reads))} bases ({args.transcripts} transcripts of {lengths} bases, "
          f"coverage {args.coverage}, seed {args.seed}, -mem {args.mem})", flush=True)

    jcli._enable_compilation_cache = lambda: None  # it writes under the home directory
    out = {pkg: os.path.join(d, pkg) for pkg in ("torch", "jax")}
    argv_ = ["-long", path, "-mem", args.mem, "-o"]
    secs = {}
    t0 = time.time()
    assert cli.main(argv_ + [out["torch"], "--device", "cpu"]) == 0
    secs["torch"] = time.time() - t0
    t0 = time.time()
    assert jcli.main(argv_ + [out["jax"], "-sharded", "off"]) == 0
    secs["jax"] = time.time() - t0

    names = sorted(set(os.listdir(out["torch"])) | set(os.listdir(out["jax"])))
    differ = [n for n in names if not (os.path.isfile(os.path.join(out["torch"], n))
                                       and os.path.isfile(os.path.join(out["jax"], n))
                                       and filecmp.cmp(os.path.join(out["torch"], n),
                                                       os.path.join(out["jax"], n), shallow=False))]
    scores = {}
    for pkg, o in out.items():
        asm = [s for _, s in fastx.read_fasta(os.path.join(o, "rnabloom.transcripts.fa"))]
        scores[pkg] = lrsim.evaluate(asm, truth)
        print(f"{pkg}: {len(asm)} transcripts in {secs[pkg]:.1f} s on the CPU; {scores[pkg]}", flush=True)
    print(f"files compared {len(names)}, differing {differ}")
    print(json.dumps({"reads": len(reads), "files": len(names), "differing": differ, "scores": scores,
                      "cpu_s": secs}))
    return 0 if not differ else 1


if __name__ == "__main__":
    sys.exit(main())
