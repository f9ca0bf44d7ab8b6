#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rnabloom_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It imports
no JAX.  Phases (any failure raises and exits nonzero):

1. Environment: card name and power limit (nvidia-smi), torch/CUDA
   versions, the insert kernel's build from csrc/ and its build time.
   Then 1,000,000 simulated 150 bp pairs are written (seed 0).
2. Insert kernel vs its plain PyTorch version on the card, per op, at the
   stage-1 shapes of ``-mem 1`` (2^29-cell mf8 cbf, 2^28-cell u16 cbf,
   2^27-cell blocked int32 cbf, 2^27-lane rpkbf), on two kinds of batch:
   synthetic 2^20-index batches (prefilled tables, a 10^5-fold heavy cell,
   the trash cell, dropped indices, several salts) and a real-read batch
   (the k-mer cell indices of the first 4096 simulated reads, hashed by the
   port at k=25, h=2: 1,032,192 indices).  The tables must be equal.  Times
   from CUDA events, both batches in the same kernel/plain turns.
3. The main path: ``cli`` ``-stage 1 -savebf --device cuda`` on the
   1,000,000 pairs at the default ``-mem 1``, once with ``-cnt mf8`` (the
   default) and once with ``-cnt u16``; the launch counters must show the
   insert kernels ran; every valid k-mer of 10,000 sampled input reads
   must count >= 1 on the saved graph (a count-min filter never
   undercounts).  Each run prints its peak device memory; the u16 run must
   allocate no insert scratch.
4. Card against CPU: the same CLI on a 20,000-pair subset with ``--device
   cuda`` and ``--device cpu``, for ``-cnt mf8``, ``u16`` and ``int32``;
   the checkpoints must be byte-identical.

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
from rnabloom_tpu_torch.bloom import filters
from rnabloom_tpu_torch.graph import engine
from rnabloom_tpu_torch.ops import _build, cell_insert as ci, nthash
from rnabloom_tpu_torch.utils import checkpoint, pesim

KERNEL_SOURCE = "rnabloom_tpu_torch/csrc/cell_insert.cu"
TPU_KERNEL = "rnabloom_tpu/ops/histmerge.py:187"
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


def run_cli(left: str, right: str, out: str, device: str, counter: str = "mf8"):
    return cli.run([
        "-left", left, "-right", right, "-revcomp-right", "-o", out, "-stage", "1",
        "-savebf", "-f", "-cnt", counter, "--device", device,
    ])


def main_path(left: str, right: str, out: str, counter: str, codes: np.ndarray, card: str, dev):
    """One 1M-pair stage-1 run on the card with the launch counts and the
    peak device memory of that run alone; checks the saved graph."""
    ci.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.time()
    report = run_cli(left, right, out, "cuda", counter)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ci.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    s1 = report.stage1
    state, cfg = checkpoint.load_graph(os.path.join(out, "rnabloom.graph"), device=dev)
    resized = cfg.cbf.size_log2 > CBF_LOG2[counter] or cfg.pkbf.size_log2 > 27
    print(f"-cnt {counter}: reads {s1.num_reads}, segments {s1.num_segments}, batches {s1.num_batches}, "
          f"FPRs {s1.fprs}, FPR resize fired: {resized} "
          f"(cbf 2^{cfg.cbf.size_log2}, rpkbf 2^{cfg.pkbf.size_log2})")
    print(f"-cnt {counter}: stage-1 build {s1.num_reads / s1.elapsed_s:.0f} reads/s (last build pass, "
          f"{s1.elapsed_s:.2f} s); CLI wall {wall:.2f} s incl. read sampling"
          f"{' and the resized rebuild' if resized else ''} [{card}]")
    print(f"-cnt {counter}: peak device memory {peak} B ({peak / 2**30:.3f} GiB; {held} B held before "
          f"the run); insert scratch after it: {sum(t.numel() * 4 for t in ci._scratch.values())} B")
    print(f"-cnt {counter}: insert kernel launches in the main-path run: {launches}", flush=True)
    assert s1.num_reads == 2 * PAIRS and s1.num_batches > 0, s1
    assert all(0.0 <= f < 1.0 for f in s1.fprs.values()), s1.fprs

    counts, valid = engine.count_step(state, cfg, codes)
    counts, valid = counts.cpu(), valid.cpu()
    assert codes.shape[0] == 10_000 and bool(valid.any())
    assert bool((counts[valid] >= 1).all()), f"-cnt {counter}: a k-mer of an input read counts 0"
    print(f"-cnt {counter}: count-min check: {int(valid.sum())} valid k-mers of 10,000 sampled reads all "
          f"count >= 1 (min {float(counts[valid].min())})", flush=True)
    del state
    torch.cuda.empty_cache()
    shutil.rmtree(out)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()

    phase("1 environment")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    t0 = time.time()
    _build.kernels()
    print(f"insert kernel built from {KERNEL_SOURCE} in {_build.build_seconds:.2f} s "
          f"(load {time.time() - t0:.2f} s)")
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

        phase("2 insert kernel vs plain PyTorch on the card (stage-1 shapes at -mem 1)")
        real = real_batches(sample_reads(left, set(range(REAL_READS)), READ_LEN), dev)
        timing = kernel_vs_plain(dev, card, real)
        real_indices = {op: b.numel() for op, b in real.items()}
        del real

        phase("3 main path: -stage 1 -savebf --device cuda on 1,000,000 pairs, -mem 1, -cnt mf8 and u16")
        rng = np.random.default_rng(1)
        picks = set(rng.choice(PAIRS, 5_000, replace=False).tolist())
        codes = np.concatenate([sample_reads(p, picks, READ_LEN) for p in (left, right)])
        launches = main_path(left, right, os.path.join(tmp, "out_mf8"), "mf8", codes, card, dev)
        assert launches["add_mf8"] > 0 and launches["set"] > 0, launches
        ci._scratch.clear()  # drop add_mf8's scratch so the u16 run's peak shows none
        torch.cuda.empty_cache()
        u16_launches = main_path(left, right, os.path.join(tmp, "out_u16"), "u16", codes, card, dev)
        assert u16_launches["add_u16"] > 0 and u16_launches["set"] > 0, u16_launches
        assert not ci._scratch, "the -cnt u16 run allocated an insert scratch"

        phase("4 card vs CPU: 20,000-pair subset, byte-identical checkpoints")
        sl, sr = os.path.join(tmp, "sub_1.fq"), os.path.join(tmp, "sub_2.fq")
        head_fastq(left, sl, 20_000)
        head_fastq(right, sr, 20_000)
        run_launches = {"add_mf8": launches["add_mf8"], "set": launches["set"],
                        "add_u16": u16_launches["add_u16"]}
        mf8_run = "main path, -cnt mf8, 1M pairs"
        run_of = {"add_mf8": mf8_run, "set": mf8_run, "add_u16": "main path, -cnt u16, 1M pairs"}
        for counter, op in (("mf8", "add_mf8"), ("u16", "add_u16"), ("int32", "add")):
            ci.reset_launch_counts()
            gpu_out, cpu_out = os.path.join(tmp, f"gpu_{counter}"), os.path.join(tmp, f"cpu_{counter}")
            run_cli(sl, sr, gpu_out, "cuda", counter)
            torch.cuda.synchronize()
            n_launch = ci.launch_counts()
            run_cli(sl, sr, cpu_out, "cpu", counter)
            for f in CKPT_FILES:
                if not filecmp.cmp(os.path.join(gpu_out, f), os.path.join(cpu_out, f), shallow=False):
                    raise AssertionError(f"-cnt {counter}: {f} differs between card and CPU")
            assert n_launch[op] > 0, n_launch
            if op not in run_launches:
                run_launches[op] = n_launch[op]
                run_of[op] = f"main path, -cnt {counter}, 20k pairs"
            print(f"-cnt {counter}: card and CPU checkpoints byte-identical ({', '.join(CKPT_FILES)}); "
                  f"card launches {n_launch}", flush=True)
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
    print()
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
