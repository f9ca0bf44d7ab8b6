"""The port runs without JAX and without the JAX package, on the card
unless asked for the CPU, and refuses what it does not do."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import pipeline, stage1
from rnabloom_tpu_torch.utils import checkpoint, pesim

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rnabloom_tpu_torch")

_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["rnabloom_tpu"] = None  # and so does any import of the JAX package
import torch
torch.set_num_threads(2)
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.utils import pesim
out = sys.argv[1]
left, right = out + "/r_1.fq", out + "/r_2.fq"
pesim.write_pe_fastq(left, right, seed=5, num_transcripts=5, tx_len=(500, 800), num_pairs=300)
assert cli.main(["-left", left, "-right", right, "-o", out + "/asm", "-savebf", "-extend",
                 "-mem", "0.00390625", "--device", "cpu"]) == 0
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in ("jax", "rnabloom_tpu"))
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_cpu_slice_runs_with_jax_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert os.path.getsize(tmp_path / "asm" / "rnabloom.graph.cbf.npy") > 0
    assert os.path.exists(tmp_path / "asm" / "FRAGMENTS.DONE")
    assert os.path.exists(tmp_path / "asm" / "fragments" / "fragments.meta.json")
    assert os.path.getsize(tmp_path / "asm" / "rnabloom.transcripts.fa") > 0
    assert os.path.getsize(tmp_path / "asm" / "rnabloom.transcripts.nr.fa") > 0
    assert os.path.exists(tmp_path / "asm" / "TRANSCRIPTS.DONE")


_IMPORT_OF_JAX = re.compile(r"^\s*(from|import)\s+(jax|rnabloom_tpu)(?!_torch)\b", re.M)


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("import jax.numpy as jnp", True), ("from jax import lax", True),
    ("from rnabloom_tpu.io import fastx", True), ("  from rnabloom_tpu import cli", True),
    ("import rnabloom_tpu.utils.seq", True), ("from rnabloom_tpu_torch.io import fastx", False),
    ("import rnabloom_tpu_torch", False), ("from ..io import fastx", False), ("import jaxlib_free", False),
])
def test_import_pattern(line, bad):
    assert bool(_IMPORT_OF_JAX.search(line)) == bad


def test_no_jax_import_in_package_source():
    """No import of jax or of the JAX package anywhere in the port or in
    chip_smoke.py: the port keeps its own copies of the host modules."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    # the nr pass's copies are among them
    assert {os.path.join(PKG, "olc", name) for name in ("overlap.py", "graph.py", "layout.py")} <= set(paths)
    assert os.path.join(PKG, "io", "seqstore.py") in paths
    for path in paths:
        with open(path) as fh:
            assert not _IMPORT_OF_JAX.search(fh.read()), path


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["-left", "x", "-right", "y", "-o", str(tmp_path), "-stage", "1", "--device", "cuda"])


def test_later_stages_are_refused_before_any_work(tmp_path):
    """The default -stage 3 runs (the nr pass is ported), but its rescue
    pass (-rescue, stage 2b) is item 12: refused before any work."""
    left, right = str(tmp_path / "r_1.fq"), str(tmp_path / "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=6, num_transcripts=2, tx_len=(500, 600), num_pairs=10)
    out = tmp_path / "asm"
    with pytest.raises(NotImplementedError, match="ROADMAP queue-1 item 12"):
        pipeline.assemble_pe(left, right, str(out), pipeline.PipelineParams(stop_stage=3, rescue_unconnected=True),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue-1 item 12"):
        cli.run(["-left", left, "-right", right, "-o", str(out), "-rescue", "--device", "cpu"])  # -stage 3: default
    assert not out.exists()


class _Stop(Exception):
    pass


def _stage3_devices(entry, monkeypatch, tmp) -> list:
    """The devices stage 3 creates its screen (``screen``), its gap
    re-walks and depth probes (``screen_walks``) or the nr pass's minimizer
    keys (``nr``) on, and stage 2's -extend its naive walks
    (``extend_walks``), for a graph on the ``meta`` device: each spied
    function records its device and stops."""
    from rnabloom_tpu_torch.assembly import transcripts
    from rnabloom_tpu_torch.assembly.fragstore import FragmentStore
    from rnabloom_tpu_torch.bloom import filters
    from rnabloom_tpu_torch.graph import dbg, traverse

    cfg = dbg.GraphConfig(k=25, stranded=False, dbgbf=filters.BloomConfig(12, 2),
                          cbf=filters.CountingConfig(12, 2, dtype="mf8"), pkbf=filters.BloomConfig(12, 2),
                          read_pair_distance=40, fragment_pair_distance=60)
    graph = dbg.make_graph(cfg, with_rpkbf=True, with_fpkbf=True, device="meta")
    seen = []

    def spy(fn):
        def wrapped(*args, device, **kw):
            seen.append(torch.device(device))
            raise _Stop
        monkeypatch.setattr(fn[0], fn[1], wrapped)

    if entry == "screen":
        spy((filters, "make_bloom"))
        with pytest.raises(_Stop):
            pipeline._run_stage3(graph, cfg, FragmentStore("unused", 200), "unused", pipeline.PipelineParams(),
                                 pipeline.PipelineReport())
        return seen
    if entry == "nr":
        # one batch of one fragment that assembles into one transcript,
        # then the nr pass over it
        from rnabloom_tpu_torch.olc import layout as olc_layout

        batch = (np.zeros((1, 300), np.uint8), np.array([300]), np.array([5.0], np.float32), [True])
        monkeypatch.setattr(FragmentStore, "iter_batches", lambda self, n, width: iter([batch]))
        monkeypatch.setattr(transcripts, "assemble_transcripts_batch", lambda graph, cfg, screen, *a, **kw: (
            [transcripts.Transcript(codes=np.arange(300, dtype=np.uint8) % 4, length=300)], [], screen))
        spy((olc_layout, "layout_unitigs"))
        with pytest.raises(_Stop):
            pipeline._run_stage3(graph, cfg, FragmentStore(str(tmp), 200), str(tmp), pipeline.PipelineParams(),
                                 pipeline.PipelineReport())
        return seen
    if entry == "extend_walks":
        from rnabloom_tpu_torch.assembly import fragments

        spy((traverse, "make_walks"))
        frag = fragments.Fragment(codes=np.zeros(60, np.uint8), min_cov=1.0, length=60, connected=True)
        with pytest.raises(_Stop):
            fragments._naive_extend_fragments(graph, cfg, [frag], [0], fragments.FragmentParams())
        return seen
    spy((traverse, "make_walks"))
    screen = filters.make_bloom(filters.BloomConfig(12, 2), device="meta")
    sgraph, pcfg = transcripts._screen_as_graph(screen, filters.BloomConfig(12, 2), cfg)
    assert sgraph.cbf is screen
    seed = np.zeros(25, np.uint8)
    for g, c in ((graph, cfg), (sgraph, pcfg)):
        with pytest.raises(_Stop):
            transcripts._depth_probe(g, c, [seed], 10)
    codes = np.zeros((1, 60), np.uint8)
    seen_k = np.ones((1, 36), bool)
    seen_k[0, 10:14] = False
    with pytest.raises(_Stop):
        transcripts._gap_rewalk(graph, screen, filters.BloomConfig(12, 2), cfg, codes, np.array([60]), seen_k,
                                np.ones((1, 36), bool), transcripts.TranscriptParams())
    return seen


@pytest.mark.parametrize("entry", ["assemble_pe", "build_graph_autosized", "load_graph", "screen", "screen_walks",
                                   "nr", "extend_walks"])
def test_entry_points_default_to_the_card(tmp_path, monkeypatch, entry):
    """Without ``device="cpu"`` the entry points run on the card, and raise
    where there is none, before any work is done.  Stage 3 creates its
    screen and the walks of its screen (gap re-walks, depth probes, the
    screen viewed as a graph) on the graph's device, and hashes the nr
    pass's minimizers there (``layout_unitigs``); -extend makes its naive
    walks (``walk_naive``) there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if entry in ("screen", "screen_walks", "nr", "extend_walks"):
        devices = _stage3_devices(entry, monkeypatch, tmp_path)
        assert devices == [torch.device("meta")] * (3 if entry == "screen_walks" else 1)
        return
    left, right = str(tmp_path / "r_1.fq"), str(tmp_path / "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=6, num_transcripts=2, tx_len=(500, 600), num_pairs=10)
    out = tmp_path / "asm"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "assemble_pe":
            pipeline.assemble_pe(left, right, str(out), pipeline.PipelineParams(stop_stage=2))
        elif entry == "load_graph":
            checkpoint.load_graph(str(out / "rnabloom.graph"))  # raises before it opens a file
        else:
            cfg = stage1.default_graph_config(25, False, 1 << 20)
            stage1.build_graph_autosized([left, right], cfg, stage1.Stage1Params())
    assert not out.exists()


@pytest.mark.parametrize("flag", ["-rescue", "-sef", "-ser"])
def test_unported_stage2_options_are_refused_before_any_work(tmp_path, flag):
    left, right = str(tmp_path / "r_1.fq"), str(tmp_path / "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=6, num_transcripts=2, tx_len=(500, 600), num_pairs=10)
    out = tmp_path / "asm"
    extra = [flag, left] if flag in ("-sef", "-ser") else [flag]
    with pytest.raises(NotImplementedError, match="ROADMAP queue-1 item"):
        cli.run(["-left", left, "-right", right, "-o", str(out), "-stage", "2", "--device", "cpu"] + extra)
    assert not out.exists()
