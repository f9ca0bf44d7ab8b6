#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rnabloom_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It imports
no JAX.  Phases (any failure raises and exits nonzero):

1. Environment: card name and power limit (nvidia-smi), torch/CUDA
   versions, the kernels' builds from csrc/ (one nvcc per source, started
   together) and their build times.  Then 1,000,000 simulated 150 bp pairs
   are written (seed 0).
2. Insert kernel vs its plain PyTorch version on the card, per op, at the
   stage-1 shapes of ``-mem 1`` (2^29-cell mf8 cbf, 2^28-cell u16 cbf,
   2^27-cell blocked int32 cbf, 2^27-lane rpkbf), on two kinds of batch:
   synthetic 2^20-index batches (prefilled tables, a 10^5-fold heavy cell,
   the trash cell, dropped indices, several salts) and a real-read batch
   (the k-mer cell indices of the first 4096 simulated reads, hashed by the
   port at k=25, h=2: 1,032,192 indices).  The tables must be equal.  Times
   from CUDA events, both batches in the same kernel/plain turns.
3. The main path: ``cli -stage 2 -savebf --device cuda`` with ``-cnt mf8``
   (the default) and ``-stage 1 -savebf -cnt u16``, both on the 1,000,000
   pairs at the default ``-mem 1``.  The launch
   counters must show the insert kernels and (stage 2) the walk kernel
   ran; every valid k-mer of 10,000 sampled input reads must count >= 1 on
   each saved graph (a count-min filter never undercounts).  Each run
   prints its rates and peak device memory; the u16 run must allocate no
   insert scratch.
4. Walk kernel vs its plain PyTorch version on the card, at stage-2
   shapes: the bridge-walk seeds of the first stage-2 batch (8192 pairs,
   error-corrected and overlap-tested as ``assemble_fragments_batch``
   does), walked on the mf8 and the u16 graph that phase 3 saved, with ``max_len = k + 500`` and lookahead 3.  Every field of the
   returned walk state must be equal.  Times from CUDA events in turns.
5. Card against CPU: ``-stage 1`` on a 20,000-pair subset for ``-cnt
   mf8``, ``u16`` and ``int32`` (byte-identical checkpoints), and
   ``-stage 2 -savebf`` on the first 8192 pairs (one stage-2 batch) for
   ``-cnt mf8`` and ``u16``: every file under the output directory (the
   fragment store, the checkpoint with its fragment distance, the read
   statistics, the stamps) must be byte-identical.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import filecmp
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rnabloom_tpu.io import fastx  # numpy-only reader of the JAX package
from rnabloom_tpu.utils import seq as sequtils
from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import correct, fragments, pipeline
from rnabloom_tpu_torch.bloom import filters
from rnabloom_tpu_torch.graph import engine, traverse
from rnabloom_tpu_torch.ops import _build, cell_insert as ci, nthash, walk
from rnabloom_tpu_torch.utils import checkpoint, pesim

KERNEL_SOURCE = "rnabloom_tpu_torch/csrc/cell_insert.cu"
TPU_KERNEL = "rnabloom_tpu/ops/histmerge.py:187"
WALK_SOURCE = "rnabloom_tpu_torch/csrc/walk_greedy.cu"
WALK_REPLACES = "rnabloom_tpu/graph/traverse.py:1032"
CKPT_FILES = ("rnabloom.graph.graph.json", "rnabloom.graph.cbf.npy", "rnabloom.graph.rpkbf.npy")

# op -> (table cells incl. trash, what it is at -mem 1)
SHAPES = {
    "add_mf8": ((1 << 29) + 1, "cbf -cnt mf8, 2^29 cells"),
    "set": ((1 << 27) + 1, "rpkbf, 2^27 lanes"),
    "add_u16": ((1 << 28) + 1, "cbf -cnt u16, 2^28 cells"),
    "add": ((1 << 27) + 128, "cbf -cnt int32 blocked, 2^27 cells"),
}
BATCH = 1 << 20
SALTS = (0, 1, 977, (1 << 31) + 7)
K, NUM_HASH, READ_LEN = 25, 2, 150
REAL_READS = 4096  # one stage-1 batch
PAIRS = 1_000_000
BATCH2 = 8192  # pairs per stage-2 batch
CBF_LOG2 = {"mf8": 29, "u16": 28}  # default cbf at -mem 1, before any resize


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def _prefill(op: str, numel: int, gen: torch.Generator, dev) -> torch.Tensor:
    if op == "set":
        return (torch.rand(numel, generator=gen, device=dev) < 0.1).to(torch.uint8)
    if op == "add_mf8":
        return torch.randint(0, 128, (numel,), generator=gen, device=dev, dtype=torch.uint8)
    if op == "add_u16":
        return torch.randint(-32768, 32768, (numel,), generator=gen, device=dev, dtype=torch.int16)
    return torch.randint(0, 1 << 20, (numel,), generator=gen, device=dev, dtype=torch.int32)


def _batch(numel: int, gen: torch.Generator, dev) -> torch.Tensor:
    """2^20 indices: random cells, one cell 10^5 times, the trash cell and
    indices past the end (dropped), shuffled."""
    size = numel - 1
    parts = [
        torch.randint(0, size, (BATCH - 100_000 - 2_000,), generator=gen, device=dev),
        torch.full((100_000,), 4242, device=dev),
        torch.full((1_000,), size, device=dev),
        torch.full((1_000,), numel + 17, device=dev),
    ]
    idx = torch.cat(parts)
    return idx[torch.randperm(idx.numel(), generator=gen, device=dev)]


def real_batches(codes: np.ndarray, dev) -> dict:
    """op -> the cell indices the main path gives that op's table for the
    k-mers of ``codes``: bloom_indices, or blocked_cells for the blocked
    int32 layout; invalid windows go to the trash cell."""
    fh, rh, valid = nthash.rolling_hash(torch.from_numpy(codes).to(dev), K, stranded=False)
    hashes = nthash.multi_hash(nthash.canonical(fh, rh), K, NUM_HASH)
    out = {}
    for op, (numel, _) in SHAPES.items():
        size_log2 = (numel - 1).bit_length() - 1
        if op == "add":
            cfg = filters.CountingConfig(size_log2, NUM_HASH, blocked=True, dtype="int32")
            row, lanes = filters.blocked_cells(cfg, hashes, valid)
            out[op] = (row[..., None] * 128 + lanes).reshape(-1)
        else:
            out[op] = filters.bloom_indices(hashes, size_log2, valid[..., None].expand(hashes.shape)).reshape(-1)
    return out


def _as_int(t: torch.Tensor) -> torch.Tensor:
    v = t.to(torch.int64)
    return v & 0xFFFF if t.dtype == torch.int16 else v


def _time_ms(fn, reps: int = 10) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _check_equal(kern: torch.Tensor, plain: torch.Tensor, op: str, what: str) -> None:
    torch.cuda.synchronize()
    if not torch.equal(kern, plain):
        diff = (_as_int(kern) - _as_int(plain)).abs()
        raise AssertionError(
            f"cell_insert[{op}] != plain {what}: {int((diff > 0).sum())} cells, max |diff| {int(diff.max())}"
        )


def kernel_vs_plain(dev, card: str, real: dict) -> dict:
    results = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for op, (numel, what) in SHAPES.items():
        base = _prefill(op, numel, gen, dev)
        kern, plain = base.clone(), base.clone()
        del base
        for salt in SALTS:  # successive batches into the same tables
            idx = _batch(numel, gen, dev)
            ci.cell_insert(kern, idx, op, salt)
            ci.cell_insert_plain(plain, idx, op, salt)
            _check_equal(kern, plain, op, f"at salt {salt}")
        ci.cell_insert(kern, real[op], op, 3)
        ci.cell_insert_plain(plain, real[op], op, 3)
        _check_equal(kern, plain, op, "on the real-read batch")
        # warm both, then time in turns: plain, kernel, kernel, plain; each
        # turn times the synthetic and the real-read batch
        batches = {"synthetic": idx, "real": real[op]}
        for b in batches.values():
            ci.cell_insert(kern, b, op, 5)
            ci.cell_insert_plain(plain, b, op, 5)
        t = {}
        for who in ("plain", "kernel", "kernel", "plain"):
            fn, tab = (ci.cell_insert, kern) if who == "kernel" else (ci.cell_insert_plain, plain)
            for name, b in batches.items():
                t.setdefault((who, name), []).append(_time_ms(lambda: fn(tab, b, op, 5)))
        # both tables took the same batches in the same order
        _check_equal(kern, plain, op, "after the timed batches")
        mean = {key: sum(v) / len(v) for key, v in t.items()}
        results[op] = {
            "max_abs_err": int((_as_int(kern) - _as_int(plain)).abs().max()),
            "ms": mean["kernel", "synthetic"], "plain_ms": mean["plain", "synthetic"],
            "real_ms": mean["kernel", "real"], "real_plain_ms": mean["plain", "real"],
        }
        r = results[op]
        print(
            f"cell_insert[{op}] ({what}): equal to plain on {len(SALTS)} salted synthetic batches "
            f"and the real-read batch; per batch, synthetic ({BATCH} indices): kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms; real reads ({real[op].numel()} indices): kernel "
            f"{r['real_ms']:.4f} ms, plain {r['real_plain_ms']:.4f} ms [{card}]",
            flush=True,
        )
        del kern, plain, idx, batches
        torch.cuda.empty_cache()
    return results


def sample_reads(path: str, picks: set, L: int) -> np.ndarray:
    """(len(picks), L) codes of the reads numbered ``picks``, in file order."""
    rows = []
    for i, (_, seq, _) in enumerate(fastx.read_seqs(path)):
        if i in picks:
            rows.append(sequtils.encode(seq))
            if len(rows) == len(picks):
                break
    codes, _ = sequtils.pack_batch(rows, len(rows), L)
    return codes


def head_fastq(src: str, dst: str, n_records: int) -> None:
    with open(src) as f, open(dst, "w") as g:
        g.writelines(itertools.islice(f, 4 * n_records))


def run_cli(left: str, right: str, out: str, device: str, counter: str = "mf8", stage: int = 1):
    return cli.run([
        "-left", left, "-right", right, "-revcomp-right", "-o", out, "-stage", str(stage),
        "-savebf", "-f", "-cnt", counter, "--device", device,
    ])


def same_tree(a: str, b: str) -> list:
    """Relative paths of the files under ``a``; raises unless ``b`` holds
    the same files, byte for byte."""
    rel = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    rel_b = sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b) for f in fs)
    if rel != rel_b:
        raise AssertionError(f"file sets differ: {sorted(set(rel) ^ set(rel_b))}")
    for f in rel:
        if not filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False):
            raise AssertionError(f"{f} differs between card and CPU")
    return rel


def main_path(left: str, right: str, out: str, counter: str, stage: int, n_pairs: int,
              codes: np.ndarray, card: str, dev):
    """One main-path run on the card with the launch counts and the peak
    device memory of that run alone; checks the saved graph, which stays
    on disk."""
    ci.reset_launch_counts()
    walk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.time()
    report = run_cli(left, right, out, "cuda", counter, stage)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**ci.launch_counts(), **walk.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    s1 = report.stage1
    tag = f"-cnt {counter} -stage {stage}"
    state, cfg = checkpoint.load_graph(os.path.join(out, "rnabloom.graph"), device=dev)
    resized = cfg.cbf.size_log2 > CBF_LOG2[counter] or cfg.pkbf.size_log2 > 27
    print(f"{tag}: {n_pairs} pairs; reads {s1.num_reads}, segments {s1.num_segments}, batches "
          f"{s1.num_batches}, FPRs {s1.fprs}, FPR resize fired: {resized} "
          f"(cbf 2^{cfg.cbf.size_log2}, rpkbf 2^{cfg.pkbf.size_log2})")
    print(f"{tag}: stage-1 build {s1.num_reads / s1.elapsed_s:.0f} reads/s (last build pass, "
          f"{s1.elapsed_s:.2f} s); CLI wall {wall:.2f} s incl. read sampling"
          f"{' and the resized rebuild' if resized else ''} [{card}]")
    if stage == 2:
        print(f"{tag}: stage 2 {report.num_pairs / report.stage2_s:.1f} pairs/s ({report.num_pairs} pairs, "
              f"{report.stage2_batches} batches, {report.stage2_s:.2f} s); fragments stored "
              f"{report.num_fragments}; d_frag {report.fragment_pair_distance}; graph desc "
              f"fragment_pair_distance {cfg.fragment_pair_distance}; dispatches {report.stage2_dispatches} [{card}]")
        assert report.num_pairs == n_pairs and report.num_fragments > n_pairs // 2, report
        assert cfg.fragment_pair_distance == report.fragment_pair_distance > 0
    print(f"{tag}: peak device memory {peak} B ({peak / 2**30:.3f} GiB; {held} B held before "
          f"the run); insert scratch after it: {sum(t.numel() * 4 for t in ci._scratch.values())} B")
    print(f"{tag}: kernel launches in the main-path run: {launches}", flush=True)
    assert s1.num_reads == 2 * n_pairs and s1.num_batches > 0, s1
    assert all(0.0 <= f < 1.0 for f in s1.fprs.values()), s1.fprs

    counts, valid = engine.count_step(state, cfg, codes)
    counts, valid = counts.cpu(), valid.cpu()
    assert bool(valid.any())
    assert bool((counts[valid] >= 1).all()), f"{tag}: a k-mer of an input read counts 0"
    print(f"{tag}: count-min check: {int(valid.sum())} valid k-mers of {codes.shape[0]} sampled reads all "
          f"count >= 1 (min {float(counts[valid].min())})", flush=True)
    del state
    torch.cuda.empty_cache()
    return launches, report, peak


def stage2_walk_seeds(left: str, right: str, graph, cfg) -> np.ndarray:
    """The bridge-walk seeds of the first stage-2 batch, as
    ``assemble_fragments_batch`` builds them: error correction with shared
    pair thresholds, then the seeds of the pairs whose mates do not
    overlap, right-walk seeds first."""
    params = pipeline.PipelineParams()
    batches = pipeline._iter_pair_batches(left, right, params, K, False, True, READ_LEN)
    lb, ll, rb, rl, _ = next(batches)
    batches.close()
    B = lb.shape[0]
    both, both_len, _ = correct.correct_batch(
        graph, cfg, np.concatenate([lb, rb]), np.concatenate([ll, rl]), params.correct_params(),
        np.concatenate([np.arange(B), np.arange(B)]),
    )
    lb, rb, ll, rl = both[:B], both[B:], both_len[:B], both_len[B:]
    overlaps = fragments.find_overlaps(lb, ll, rb, rl, params.min_overlap)
    rows = np.flatnonzero((overlaps == 0) & (ll >= K) & (rl >= K))
    seeds_r, seeds_l = fragments.bridge_seeds(cfg, lb, ll, rb, rows)
    return np.concatenate([seeds_r, seeds_l])


def _max_abs_diff(a, b) -> float:
    """Largest |kernel - plain| over the walk state's fields (inf - inf,
    an unwalked lane's path_min, counts as 0)."""
    return max(
        float((getattr(a, f).double() - getattr(b, f).double()).abs().nan_to_num(0.0).max())
        for f in ("buf", "pos", "status", "hops", "path_min", "fh", "rh", "hist")
    )


def walk_vs_plain(graph_prefix: str, left: str, right: str, what: str, card: str, dev) -> dict:
    """Walk kernel vs plain on the first stage-2 batch's bridge seeds."""
    graph, cfg = checkpoint.load_graph(graph_prefix, device=dev)
    seeds = stage2_walk_seeds(left, right, graph, cfg)
    wcfg, _ = fragments.bridge_walk_configs(cfg, fragments.FragmentParams())
    st = traverse.make_walks(cfg, wcfg, seeds, device=dev)
    mc, bd = traverse.lane_args(st, 1.0, fragments.FragmentParams().bound)
    kern = walk.walk_greedy(st, graph, cfg, wcfg, mc, bd)
    plain = walk.walk_greedy_plain(st, graph, cfg, wcfg, mc, bd)
    torch.cuda.synchronize()
    fields = ("buf", "pos", "status", "hops", "path_min", "fh", "rh", "hist")
    bad = [f for f in fields if not torch.equal(getattr(kern, f), getattr(plain, f))]
    if bad:
        raise AssertionError(f"walk_greedy != plain on {what}: {bad} differ")
    t = {"kernel": [], "plain": []}
    for who in ("plain", "kernel", "kernel", "plain"):
        fn = walk.walk_greedy if who == "kernel" else walk.walk_greedy_plain
        t[who].append(_time_ms(lambda: fn(st, graph, cfg, wcfg, mc, bd), reps=5 if who == "kernel" else 1))
    status = torch.bincount(kern.status.long(), minlength=7).tolist()
    r = {
        "max_abs_err": _max_abs_diff(kern, plain), "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2,
        "lanes": int(st.pos.shape[0]), "seeds": int(seeds.shape[0]),
        "hops": int(kern.hops.sum()), "max_hops": int(kern.hops.max()),
    }
    print(f"walk_greedy ({what}): {r['seeds']} bridge seeds in {r['lanes']} lanes, max_len {wcfg.max_len}, "
          f"lookahead {wcfg.lookahead}; every WalkState field equal to plain; {r['hops']} hops (max "
          f"{r['max_hops']}), statuses {status}; per call: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms [{card}]", flush=True)
    del graph, kern, plain, st
    torch.cuda.empty_cache()
    return r


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    t_start = time.time()

    phase("1 environment")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    t0 = time.time()
    built = _build.build_all()
    print(f"kernels built in parallel in {time.time() - t0:.2f} s: "
          + ", ".join(f"{os.path.relpath(src, os.path.dirname(os.path.abspath(__file__)))} "
                      f"{sec:.2f} s" for src, sec in built.items()))
    print(f"native FASTX reader in use: {_build.native_reader()}", flush=True)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        left, right = os.path.join(tmp, "reads_1.fq"), os.path.join(tmp, "reads_2.fq")
        t0 = time.time()
        pesim.write_pe_fastq(
            left, right, seed=0, num_transcripts=2000, tx_len=(1000, 4000),
            num_pairs=PAIRS, read_len=READ_LEN, frag_range=(250, 400), sub_rate=0.003,
        )
        print(f"simulated 1,000,000 pairs (2000 transcripts, seed 0) in {time.time() - t0:.1f} s", flush=True)
        heads = {}
        for n in (BATCH2, 20_000):
            heads[n] = (os.path.join(tmp, f"head{n}_1.fq"), os.path.join(tmp, f"head{n}_2.fq"))
            head_fastq(left, heads[n][0], n)
            head_fastq(right, heads[n][1], n)

        phase("2 insert kernel vs plain PyTorch on the card (stage-1 shapes at -mem 1)")
        real = real_batches(sample_reads(left, set(range(REAL_READS)), READ_LEN), dev)
        timing = kernel_vs_plain(dev, card, real)
        real_indices = {op: b.numel() for op, b in real.items()}
        del real

        phase("3 main path: -stage 2 -savebf -cnt mf8 and -stage 1 -savebf -cnt u16 on 1,000,000 pairs, "
              "--device cuda, -mem 1")
        rng = np.random.default_rng(1)
        picks = set(rng.choice(PAIRS, 5_000, replace=False).tolist())
        codes = np.concatenate([sample_reads(p, picks, READ_LEN) for p in (left, right)])
        out_mf8 = os.path.join(tmp, "out_mf8")
        launches, s2_report, s2_peak = main_path(left, right, out_mf8, "mf8", 2, PAIRS, codes, card, dev)
        assert launches["add_mf8"] > 0 and launches["set"] > 0 and launches["walk_greedy"] > 0, launches
        ci._scratch.clear()  # drop add_mf8's scratch so the u16 run's peak shows none
        torch.cuda.empty_cache()
        out_u16 = os.path.join(tmp, "out_u16")
        u16_launches, _, _ = main_path(left, right, out_u16, "u16", 1, PAIRS, codes, card, dev)
        assert u16_launches["add_u16"] > 0 and u16_launches["set"] > 0, u16_launches
        assert not ci._scratch, "the -cnt u16 run allocated an insert scratch"

        phase("4 walk kernel vs plain PyTorch on the card (bridge seeds of the first stage-2 batch)")
        walk_t = {
            "mf8": walk_vs_plain(os.path.join(out_mf8, "rnabloom.graph"), left, right,
                                 "1M-pair graph, -cnt mf8, 2^29 cells", card, dev),
            "u16": walk_vs_plain(os.path.join(out_u16, "rnabloom.graph"), left, right,
                                 "1M-pair graph, -cnt u16, resized to 2^29 cells", card, dev),
        }
        shutil.rmtree(out_mf8)
        shutil.rmtree(out_u16)

        phase("5 card vs CPU: -stage 1 on 20,000 pairs, -stage 2 on 8192 pairs, byte-identical outputs")
        run_launches = {"add_mf8": launches["add_mf8"], "set": launches["set"],
                        "add_u16": u16_launches["add_u16"]}
        mf8_run = "main path, -cnt mf8 -stage 2, 1M pairs"
        run_of = {"add_mf8": mf8_run, "set": mf8_run, "add_u16": "main path, -cnt u16 -stage 1, 1M pairs"}
        for counter, op in (("mf8", "add_mf8"), ("u16", "add_u16"), ("int32", "add")):
            ci.reset_launch_counts()
            gpu_out, cpu_out = os.path.join(tmp, f"gpu_{counter}"), os.path.join(tmp, f"cpu_{counter}")
            run_cli(*heads[20_000], gpu_out, "cuda", counter)
            torch.cuda.synchronize()
            n_launch = ci.launch_counts()
            run_cli(*heads[20_000], cpu_out, "cpu", counter)
            for f in CKPT_FILES:
                if not filecmp.cmp(os.path.join(gpu_out, f), os.path.join(cpu_out, f), shallow=False):
                    raise AssertionError(f"-cnt {counter}: {f} differs between card and CPU")
            assert n_launch[op] > 0, n_launch
            if op not in run_launches:
                run_launches[op] = n_launch[op]
                run_of[op] = f"main path, -cnt {counter}, 20k pairs"
            print(f"-cnt {counter} -stage 1: card and CPU checkpoints byte-identical ({', '.join(CKPT_FILES)}); "
                  f"card launches {n_launch}", flush=True)
            shutil.rmtree(gpu_out)
            shutil.rmtree(cpu_out)
        for counter in ("mf8", "u16"):
            gpu_out, cpu_out = os.path.join(tmp, f"gpu2_{counter}"), os.path.join(tmp, f"cpu2_{counter}")
            walk.reset_launch_counts()
            t0 = time.time()
            rep = run_cli(*heads[BATCH2], gpu_out, "cuda", counter, 2)
            t_gpu = time.time() - t0
            n_walk = walk.launch_counts()["walk_greedy"]
            t0 = time.time()
            run_cli(*heads[BATCH2], cpu_out, "cpu", counter, 2)
            t_cpu = time.time() - t0
            files = same_tree(gpu_out, cpu_out)
            assert n_walk > 0 and rep.num_fragments > 0 and any(f.endswith(".nbits") for f in files)
            print(f"-cnt {counter} -stage 2: card and CPU outputs byte-identical, {len(files)} files "
                  f"({', '.join(files)}); {rep.num_fragments} fragments of {rep.num_pairs} pairs, d_frag "
                  f"{rep.fragment_pair_distance}; walk launches {n_walk}; CLI wall card {t_gpu:.1f} s, "
                  f"CPU {t_cpu:.1f} s", flush=True)
            shutil.rmtree(gpu_out)
            shutil.rmtree(cpu_out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [
        {
            "name": f"cell_insert[{op}]",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": TPU_KERNEL,
            "launches": run_launches[op],
            "run": run_of[op],
            "max_abs_err": timing[op]["max_abs_err"],
            "ms": timing[op]["ms"],
            "plain_ms": timing[op]["plain_ms"],
            "real_batch_indices": real_indices[op],
            "real_ms": timing[op]["real_ms"],
            "real_plain_ms": timing[op]["real_plain_ms"],
        }
        for op in ("add_mf8", "set", "add_u16", "add")
    ]
    kernels.append({
        "name": "walk_greedy",
        "route": "cuda",
        "source": WALK_SOURCE,
        "replaces": WALK_REPLACES,
        "launches": launches["walk_greedy"],
        "run": mf8_run,
        "max_abs_err": max(w["max_abs_err"] for w in walk_t.values()),
        "ms": walk_t["mf8"]["ms"],
        "plain_ms": walk_t["mf8"]["plain_ms"],
        "lanes": walk_t["mf8"]["lanes"],
        "u16_ms": walk_t["u16"]["ms"],
        "u16_plain_ms": walk_t["u16"]["plain_ms"],
        "stage2_pairs_per_s": s2_report.num_pairs / s2_report.stage2_s,
        "stage2_pairs": s2_report.num_pairs,
        "stage2_peak_device_bytes": s2_peak,
    })
    print(f"\nsmoke wall time {time.time() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
