"""The port's ``-long`` path end to end vs the JAX package's, on the CPU.

Both CLIs (the JAX one with ``-sharded off``) on the same lrsim reads (7%
error) at ``-mem`` 4 MiB: every output file byte-identical (the corrected
reads and their side files, the transcripts, the PAF, the stamps) for the
default run, ``-rc -lrrd 2 -mw 12 -son 3``, ``-lrpb`` (k=35),
``-stage 1`` and ``-stage 2`` stops, ``-k 25,31 -ntcard -stage 2``, and,
resumed from a copy of each
package's ``-stage 2`` output (the ``LONGREADS.CORRECTED`` resume),
the default run, ``-lrsub`` with strobemers and with k-mers, ``-paf``, and
``-pafin`` fed the JAX package's ``-paf`` file.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from rnabloom_tpu import cli as jcli
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.utils import lrsim
from stage3_common import _files
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

MEM = ["-mem", str(4 / 1024)]  # 4 MiB of filters
FULL = {
    "default": [],
    "stage1": ["-stage", "1"],
    "stage2": ["-stage", "2"],
    "knobs": ["-rc", "-lrrd", "2", "-mw", "12", "-son", "3"],
    "lrpb": ["-lrpb"],
    "klist": ["-k", "25,31", "-ntcard", "-stage", "2"],  # the long reads are the probes
}
# resumed from a copy of the -stage 2 output
RESUMED = {
    "resume": [],
    "lrsub_strobemer": ["-lrsub", "5,11,0,50"],
    "lrsub_kmer": ["-lrsub", "5,25,0"],
    "paf": ["-paf"],
    "pafin": None,  # -pafin <the JAX package's -paf file>
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("long")
    rng = np.random.default_rng(0)
    tx = lrsim.simulate_transcriptome(rng, 6, (500, 1200))
    reads = lrsim.simulate_reads(rng, tx, coverage=8, err=0.07)
    path = str(d / "lr.fa")
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    cache = jcli._enable_compilation_cache
    jcli._enable_compilation_cache = lambda: None  # it writes under the home directory
    done = {}

    def run(case):
        if case in done:
            return done[case]
        out = {pkg: str(d / f"{pkg}_{case}") for pkg in ("torch", "jax")}
        if case in FULL:
            extra = FULL[case]
        else:
            stage2 = run("stage2")
            for pkg in out:
                shutil.copytree(stage2[pkg], out[pkg])
            extra = RESUMED[case] or ["-pafin", os.path.join(run("paf")["jax"], "rnabloom.ava.paf")]
        argv = ["-long", path, "-o"]
        assert cli.main(argv + [out["torch"]] + MEM + extra + ["--device", "cpu"]) == 0
        assert jcli.main(argv + [out["jax"]] + MEM + extra + ["-sharded", "off"]) == 0
        done[case] = out
        return out

    try:
        yield run
    finally:
        jcli._enable_compilation_cache = cache


@pytest.mark.parametrize("case", list(FULL) + list(RESUMED))
def test_long_output_trees_byte_identical(runs, case):
    out = runs(case)
    files = _files(out["torch"])
    assert files == _files(out["jax"])
    if case == "stage1":
        assert sorted(files) == ["DBG.DONE", "rnabloom.longreads.corrected.2bit"]  # an empty store, in both
        return
    assert "LONGREADS.CORRECTED" in files and files["rnabloom.longreads.corrected.long.fa"].count(b">") > 10
    if case in ("stage2", "klist"):
        assert "rnabloom.transcripts.fa" not in files and "LONGREADS.ASSEMBLED" not in files
        return
    assert "LONGREADS.ASSEMBLED" in files and files["rnabloom.transcripts.fa"].count(b">") >= 3
    assert ("rnabloom.ava.paf" in files) == (case == "paf")
    if case == "paf":
        assert files["rnabloom.ava.paf"].count(b"\n") > 20
    if case == "lrpb":  # k=35: the PacBio preset
        assert files != _files(runs("default")["torch"])
