"""The port runs without JAX and without the JAX package, on the card
unless asked for the CPU, maps the long-read flags as the JAX CLI does, and
refuses what it does not do: the multi-host flags, naming their ROADMAP
item."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import pipeline, stage1
from rnabloom_tpu_torch.utils import checkpoint, kselect, pesim

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
# single-end, pooled with the merge, and the k selection with -ntcard
assert cli.main(["-sef", left, "-ser", right, "-o", out + "/se", "-mem", "0.00390625", "--device", "cpu"]) == 0
with open(out + "/pool.txt", "w") as f:
    f.write(f"s1 {left} {right}\ns2 {right} {left} {left}\n")
assert cli.main(["-pool", out + "/pool.txt", "-mergepool", "-o", out + "/pool", "-mem", "0.00390625",
                 "--device", "cpu"]) == 0
assert cli.main(["-left", left, "-right", right, "-k", "25,27", "-ntcard", "-stage", "1", "-o", out + "/k",
                 "-mem", "0.00390625", "--device", "cpu"]) == 0
# the long-read path, with strobemer subsampling
from rnabloom_tpu_torch.utils import lrsim
import numpy as np
rng = np.random.default_rng(2)
with open(out + "/lr.fa", "w") as f:
    for i, r in enumerate(lrsim.simulate_reads(rng, lrsim.simulate_transcriptome(rng, 4, (500, 900)), 8, 0.05)):
        f.write(f">r{i}\n{r}\n")
assert cli.main(["-long", out + "/lr.fa", "-lrsub", "5,11,0,50", "-o", out + "/long", "-mem", "0.00390625",
                 "--device", "cpu"]) == 0
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
    assert os.path.getsize(tmp_path / "se" / "rnabloom.transcripts.nr.fa") > 0
    assert os.path.getsize(tmp_path / "pool" / "rnabloom.transcripts.merged.fa") > 0
    assert os.path.getsize(tmp_path / "pool" / "s2" / "rnabloom.transcripts.fa") > 0
    assert re.search(r"selected k=2[57] from \[25, 27\]", proc.stdout)
    assert os.path.exists(tmp_path / "k" / "DBG.DONE")
    assert os.path.getsize(tmp_path / "long" / "rnabloom.transcripts.fa") > 0
    assert os.path.exists(tmp_path / "long" / "LONGREADS.ASSEMBLED")


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
    # the nr pass's copies, the k selection's and the long-read path's are among them
    assert {os.path.join(PKG, "olc", name) for name in ("overlap.py", "graph.py", "layout.py", "consensus.py",
                                                        "realign.py")} <= set(paths)
    assert os.path.join(PKG, "io", "seqstore.py") in paths
    assert os.path.join(PKG, "utils", "kselect.py") in paths
    for path in paths:
        with open(path) as fh:
            assert not _IMPORT_OF_JAX.search(fh.read()), path


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["-left", "x", "-right", "y", "-o", str(tmp_path), "-stage", "1", "--device", "cuda"])


# one value of each refused flag that is not among the values that run
_REFUSED_ARGS = {
    "-sharded": ["-sharded", "on"], "-coordinator": ["-coordinator", "localhost:9999"], "-nprocs": ["-nprocs", "2"],
    "-procid": ["-procid", "1"], "-mhlayout": ["-mhlayout", "local"],
}


def test_every_refused_flag_has_a_case():
    assert sorted(_REFUSED_ARGS) == sorted(names[0] for names, *_ in cli._REFUSED)


@pytest.mark.parametrize("flag", sorted(_REFUSED_ARGS))
def test_long_read_and_multi_host_flags_are_refused_before_any_work(tmp_path, flag):
    """The JAX CLI's multi-host flags (item 14) are accepted and refused,
    naming the item, before any file is read or written, with short reads
    and with -long."""
    for reads in (["-left", "missing_1.fq", "-right", "missing_2.fq"], ["-long", "missing.fa"]):
        out = tmp_path / "asm"
        with pytest.raises(NotImplementedError, match=f"{flag} is not ported yet: ROADMAP queue-1 item 14$"):
            cli.run(reads + ["-o", str(out), "--device", "cpu"] + _REFUSED_ARGS[flag])
        assert not out.exists()


# each long-read flag with a value other than its default
_LONG_READ_ARGS = {
    "-long": [], "-lrop": ["-lrop", "0.5"], "-lrpb": ["-lrpb"], "-lrrd": ["-lrrd", "3"],
    "-lrsub": ["-lrsub", "30,25,5000"], "-rc": ["-rc"], "-m": ["-m", "15"], "-mw": ["-mw", "8"],
    "-sop": ["-sop", "0.2"], "-son": ["-son", "6"], "-hpc": ["-hpc"], "-mmopt": ["-mmopt", "-x ava-ont"],
    "-paf": ["-paf"], "-pafin": ["-pafin", "ava.paf"],
}


def _long_call(module, monkeypatch):
    """Replace ``module.assemble_long`` by a recorder of its arguments."""
    calls = []

    def record(paths, outdir, params, **kw):
        calls.append((list(paths), outdir, params, {key: kw[key] for key in ("subsample_spec", "force")}))
        return module.PipelineReport()

    monkeypatch.setattr(module, "assemble_long", record)
    return calls


@pytest.mark.parametrize("flag", sorted(_LONG_READ_ARGS))
def test_long_read_flag_maps_like_the_jax_cli(tmp_path, monkeypatch, capsys, flag):
    """Each long-read flag of the JAX CLI sets the same PipelineParams
    field to the same value in the port's CLI (``-lrpb``: k=35 at the
    default -k; ``-mmopt``: the same note), and -long reaches assemble_long
    with the same paths and arguments."""
    from rnabloom_tpu import cli as jcli
    from rnabloom_tpu.assembly import pipeline as jpipeline

    monkeypatch.setattr(jcli, "_enable_compilation_cache", lambda: None)
    tcalls, jcalls = _long_call(pipeline, monkeypatch), _long_call(jpipeline, monkeypatch)
    argv = ["-long", "a.fa", "b.fa", "-o", str(tmp_path / "asm")] + _LONG_READ_ARGS[flag]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    t_err = capsys.readouterr().err
    assert jcli.main(argv + ["-sharded", "off"]) == 0
    j_err = capsys.readouterr().err
    (tpaths, tout, tparams, tkw), = tcalls
    (jpaths, jout, jparams, jkw), = jcalls
    assert (tpaths, tout, tkw) == (jpaths, jout, jkw) == (["a.fa", "b.fa"], str(tmp_path / "asm"), jkw)
    tfields = {f.name: getattr(tparams, f.name) for f in dataclasses.fields(tparams)}
    jfields = {f.name: getattr(jparams, f.name) for f in dataclasses.fields(jparams)}
    shared = sorted((set(tfields) & set(jfields)) - {"sharded"})  # -sharded off runs the port's own engine
    assert len(shared) > 50
    assert {name: tfields[name] for name in shared} == {name: jfields[name] for name in shared}
    default = {f.name: f.default for f in dataclasses.fields(pipeline.PipelineParams)}
    changed = {name for name in shared if tfields[name] != default[name]} - {"verbose"}
    expected = {
        "-long": set(), "-lrop": {"lr_overlap_prop"}, "-lrpb": {"k"}, "-lrrd": {"lr_min_depth"}, "-lrsub": set(),
        "-rc": {"revcomp_long"}, "-m": {"minimizer_size"}, "-mw": {"minimizer_window"}, "-sop": {"sketch_overlap_prop"},
        "-son": {"sketch_overlap_num"}, "-hpc": {"hpc"}, "-mmopt": set(), "-paf": {"write_paf"}, "-pafin": {"paf_in"},
    }[flag]
    assert changed == expected
    if flag == "-lrpb":
        assert tparams.k == 35
    if flag == "-lrsub":
        assert tkw["subsample_spec"] == "30,25,5000"
    note = "note: -mmopt ignored (internal overlapper replaces minimap2)"
    assert (note in t_err) == (note in j_err) == (flag == "-mmopt")


_LR_MODULES = ("ops.lr_keys", "ops.strobemer", "ops.consensus_vote", "olc.overlap", "olc.graph", "olc.layout",
               "olc.consensus", "olc.realign", "io.paf", "assembly.longreads", "utils.lrsim")


def test_long_read_modules_import_no_jax():
    """The long-read path's modules import neither jax nor the JAX package."""
    script = ("import sys\nsys.modules['jax'] = None\nsys.modules['rnabloom_tpu'] = None\nimport importlib\n"
              f"for m in {_LR_MODULES!r}:\n    importlib.import_module('rnabloom_tpu_torch.' + m)\n"
              "bad = sorted(m for m, v in sys.modules.items() if v is not None and m.split('.')[0] in "
              "('jax', 'rnabloom_tpu'))\nassert not bad, bad\nprint('LR_NO_JAX_OK')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LR_NO_JAX_OK" in proc.stdout


def test_values_that_run_are_not_refused(tmp_path):
    """-sharded off is the port's own single-device engine; the rest at
    their defaults run too (the missing reads then fail to open)."""
    with pytest.raises(FileNotFoundError):
        cli.run(["-left", str(tmp_path / "missing_1.fq"), "-right", str(tmp_path / "missing_2.fq"), "-o",
                 str(tmp_path / "asm"), "-sharded", "off", "-nprocs", "1", "-procid", "0", "-mhlayout", "auto",
                 "--device", "cpu"])


def test_no_reads_exits_2_before_any_work(tmp_path, capsys):
    out = tmp_path / "asm"
    assert cli.main(["-left", "only_left.fq", "-o", str(out), "--device", "cpu"]) == 2
    assert "error: provide -left/-right (PE) or -sef/-ser (SE)" in capsys.readouterr().err
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


@pytest.mark.parametrize("entry", ["assemble_pe", "assemble_se", "assemble_pool", "merge_pool", "assemble_long", "select_k",
                                   "estimate_num_unique_kmers", "build_graph_autosized", "load_graph", "screen",
                                   "screen_walks", "nr", "extend_walks"])
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
        elif entry == "assemble_se":
            pipeline.assemble_se([left], str(out), pipeline.PipelineParams(stop_stage=2))
        elif entry == "assemble_pool":
            pool = tmp_path / "pool.txt"
            pool.write_text(f"s1 {left} {right}\n")
            pipeline.assemble_pool(str(pool), str(out), pipeline.PipelineParams(stop_stage=2))
        elif entry == "merge_pool":
            pipeline.merge_pool(str(out), ["s1"], pipeline.PipelineParams())
        elif entry == "assemble_long":
            pipeline.assemble_long([left], str(out), pipeline.PipelineParams(stop_stage=2))
        elif entry == "select_k":
            kselect.select_k([left, right], [25, 27])
        elif entry == "estimate_num_unique_kmers":
            kselect.estimate_num_unique_kmers([left, right], 25)
        elif entry == "load_graph":
            checkpoint.load_graph(str(out / "rnabloom.graph"))  # raises before it opens a file
        else:
            cfg = stage1.default_graph_config(25, False, 1 << 20)
            stage1.build_graph_autosized([left, right], cfg, stage1.Stage1Params())
    assert not out.exists()
