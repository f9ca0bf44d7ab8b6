#!/usr/bin/env python3
"""Where a pair or naive walk's dependent round goes, on one CUDA card.

    python3 tools/pair_profile.py [--pairs N] [--walk-variant NAME=PATH ...]
    python3 tools/pair_profile.py --naive [--pairs N] [--walk-variant NAME=PATH ...]

Run from the root of a checkout.  Simulates N read pairs (chip_smoke.py's
simulation, seed 0; default 200,000), runs ``-stage 2`` and stage 2b on
the card, and takes stage 3's first full batch of fragments (2048) as
chip_smoke.py phase 6 does.  Then:

* the right pair walks of that batch by the port's kernel and by each
  ``--walk-variant`` (equal to the plain loop in every field), timed in
  turns, and the lane with the most dependent rounds (``pair_tally``)
  walked alone;
* a copy of ``csrc/walk_greedy.cu`` built with ``kProfile = 1``, whose
  rank 0 of each lane adds ``clock64()`` spans by phase (hop reads, the
  rest of hops, resolve heads, resolve rounds and their count waits,
  resolve tails; within them, advances, their tile.sync and the hand-offs
  of known counts to the next hop): the lone lane's and the batch's
  cycles per phase;
* one thread's chain of dependent random reads of the cbf, and of its
  first 4 MiB and 4 KiB (the card's latency at DRAM, L2 and L1); then
  rounds of 16 to 2560 such reads in flight from one SM (a lane's hop
  and resolve rounds, and a full SM's).

With ``--naive`` (default N: 1,000,000, chip_smoke.py phase 8's pairs):
``-stage 1`` on the card, then the ``-extend`` walks (right, then left) of
the first stage-2 batch's fragments, captured as phase 8 does.  For each
direction: the kernel and each variant equal to the plain loop and timed
in turns; ``naive_tally``'s rounds of every lane under the one-step
schedule and the kernel's (sum, quantiles, most); the lanes with the most
rounds under each walked alone; the kProfile copy's cycles by phase (hop
reads, the rest of hops, variant-probe and resolve rounds and their count
waits, the argmax reductions, the out-code loads, advances, hand-offs) for
the lone lane and the batch; one dependent random read of the cbf.

Prints the card's name and power limit; every time comes from CUDA events
or the card's clock.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from rnabloom_tpu_torch.assembly import pipeline, transcripts  # noqa: E402
from rnabloom_tpu_torch.graph import traverse  # noqa: E402
from rnabloom_tpu_torch.ops import _build, walk  # noqa: E402
from rnabloom_tpu_torch.utils import pesim  # noqa: E402

PHASES = ("hop read", "hop rest", "resolve head", "resolve count wait", "resolve round", "resolve tail",
          "advance", "advance's tile.sync", "hand-off to a hop")
# naive mode's phases, in the order of the kernel's kNv* indices
NAIVE_PHASES = ("hop read", "hop rest", "variant probe round", "variant probe count wait", "resolve round",
                "resolve count wait", "picks (argmax, top 2)", "out codes", "advance", "resolve tail", "kids round",
                "advance with a hand-off", "resolve head", "cycle-ring check", "back-branch check")
PROF_SLOTS = 16  # g_prof holds cycles, then counts, of up to 16 phases


def profiled_library() -> ctypes.CDLL:
    """The walk kernel built with kProfile = 1, with ``walk_profile`` bound."""
    src = open(_build.WALK_SRC).read()
    src, n = re.subn(r"^constexpr int kProfile = 0;", "constexpr int kProfile = 1;", src, flags=re.M)
    assert n == 1, "csrc/walk_greedy.cu has no kProfile switch"
    path = os.path.join(_build.BUILD_DIR, "profile", "walk_profile.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    lib = cs.build_variant("walk", 900, path)
    lib.walk_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.walk_profile.restype = ctypes.c_int
    return lib


def read_profile(lib: ctypes.CDLL) -> list:
    buf = (ctypes.c_ulonglong * (2 * PROF_SLOTS))()
    torch.cuda.synchronize()
    err = lib.walk_profile(ctypes.addressof(buf), 1)
    if err:
        raise RuntimeError(f"walk_profile failed: cudaError_t {err}")
    return list(buf)


def report(what: str, prof: list, ms: float, card: str, phases=PHASES) -> None:
    cycles, counts = prof[:PROF_SLOTS], prof[PROF_SLOTS:]
    print(f"{what}: {ms:.4f} ms [{card}]")
    for name, c, k in zip(phases, cycles, counts):
        print(f"  {name:26s} {k:9d} x {c / max(k, 1):9.1f} cycles = {c:14d} cycles")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=None, help="default 200,000; with --naive 1,000,000")
    ap.add_argument("--naive", action="store_true", help="the naive kernel on -extend's walks")
    ap.add_argument("--walk-variant", action="append", default=[], metavar="NAME=PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pair_profile: torch.cuda.is_available() is False; this run needs a CUDA card", file=sys.stderr)
        return 1
    dev, card = torch.device("cuda"), cs.card_line()
    print(f"card: {card}; {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    t0 = time.time()
    srcs = dict(v.split("=", 1) for v in args.walk_variant)
    with ThreadPoolExecutor(3 + len(srcs)) as pool:  # one nvcc a source, all at once
        port = pool.submit(_build.build_all)
        prof = pool.submit(profiled_library)
        chase_build = pool.submit(cs.build_chase)
        builds = {name: pool.submit(cs.build_variant, "walk", i, src) for i, (name, src) in enumerate(srcs.items())}
        port.result()
        prof_lib, chase = prof.result(), chase_build.result()
        variants = {name: b.result() for name, b in builds.items()}
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    mode = "naive" if args.naive else "pair"
    for line in cs.ptxas_report(_build.build_logs.get(_build.WALK_SRC, "")):
        if mode in line:
            print(f"  ptxas {line}")
    tmp = tempfile.mkdtemp(prefix="pair_profile_")
    try:
        if args.naive:
            args.pairs = args.pairs or cs.PAIRS
            return naive_profile(args, tmp, dev, card, prof_lib, variants, chase)
        args.pairs = args.pairs or 200_000
        return profile(args, tmp, dev, card, prof_lib, variants, chase)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile(args, tmp: str, dev, card: str, prof_lib, variants: dict, chase) -> int:
    left, right = os.path.join(tmp, "r_1.fq"), os.path.join(tmp, "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=0, num_transcripts=2000, tx_len=(1000, 4000),
                         num_pairs=args.pairs, read_len=cs.READ_LEN, frag_range=(250, 400), sub_rate=0.003)
    out = os.path.join(tmp, "out")
    t0 = time.time()
    cs.run_cli(left, right, out, "cuda", "mf8", 2)
    print(f"-stage 2 on {args.pairs} pairs: {time.time() - t0:.1f} s", flush=True)
    graph, cfg, store, _ = cs.rebuild_main_path(out, card, dev)
    params, tparams = pipeline.PipelineParams(), transcripts.TranscriptParams()
    width = int(min(max(store.max_len, cfg.k), params.max_walk_len))
    key, frags, lens = cs.stage3_batches(store, params.stage3_batch, width)[-1]
    wcfg = traverse.WalkConfig(max_len=tparams.max_walk_len, pair_ring=tparams.pair_ring,
                               lookahead=tparams.lookahead)
    st = traverse.make_walks(cfg, wcfg, frags, lens, device=dev)
    mc, bd = traverse.lane_args(st, 1.0, tparams.bound)
    builds = {"kernel": None, **variants, "profiled": prof_lib}

    def call(who, s, m, b):
        lib = builds[who]
        with cs.walk_library(lib) if lib is not None else contextlib.nullcontext():
            return walk.walk_pair(s, graph, cfg, wcfg, m, b)

    tally = cs.pair_tally(st, graph, cfg, wcfg, mc, bd)
    plain = tally["state"]
    w = int(torch.argmax(tally["new_rounds"]))
    one = traverse.take_lanes(st, slice(w, w + 1))
    one_mc, one_bd = mc[w : w + 1].contiguous(), bd[w : w + 1].contiguous()
    for who in builds:
        got = call(who, st, mc, bd)
        torch.cuda.synchronize()
        bad = [f for f in cs.PAIR_FIELDS if not torch.equal(getattr(got, f), getattr(plain, f))]
        assert not bad, f"{who} != plain: {bad}"
    t = {who: [] for who in builds}
    t1 = {who: [] for who in builds}
    order = list(builds)
    for who in (*order, *order[::-1]):
        t[who].append(cs._time_ms(lambda: call(who, st, mc, bd), reps=5))
        t1[who].append(cs._time_ms(lambda: call(who, one, one_mc, one_bd), reps=5))
    rounds = {name: int(tally[f"{name}_rounds"][w]) for name in ("old", "new")}
    print(f"stage 3's first full batch (stratum {key}, {int((lens > 0).sum())} fragments in {st.pos.shape[0]} lanes); "
          f"longest lane {w}: {int(tally['hops'][w])} hops ({int(tally['free_hops'][w])} free), "
          f"{int(tally['resolves'][w])} resolves, {rounds['new']} rounds (one-step schedule {rounds['old']}) [{card}]")
    for who in builds:
        lane = min(t1[who])
        print(f"  {who}: batch {cs._mean(t[who]):.4f} ms ({', '.join(f'{x:.4f}' for x in t[who])}), longest lane "
              f"alone {lane:.4f} ms ({', '.join(f'{x:.4f}' for x in t1[who])}): {lane * 1e6 / rounds['new']:.1f} ns a "
              f"round of this schedule, {lane * 1e6 / rounds['old']:.1f} of the one-step one [{card}]", flush=True)
    read_profile(prof_lib)
    ms = cs._time_ms(lambda: call("profiled", one, one_mc, one_bd), reps=1)
    report(f"profiled longest lane alone (rank 0's clock64 spans)", read_profile(prof_lib), ms, card)
    ms = cs._time_ms(lambda: call("profiled", st, mc, bd), reps=1)
    report(f"profiled batch, summed over lanes", read_profile(prof_lib), ms, card)
    for cells, what in ((0, f"the {graph.cbf.numel()}-cell cbf"), (1 << 22, "its first 4 MiB"),
                        (1 << 12, "its first 4 KiB")):
        print(f"one dependent random read of {what}: {cs.dependent_read_ns(chase, graph.cbf, cells):.1f} ns "
              f"[{card}]", flush=True)
    # a lane's rounds: a hop reads 2 k-mers a thread, a resolve 5, num_hash cells each; a full SM 16 lanes
    for threads, chains in ((16, 1), (16, 2), (16, 4), (16, 10), (256, 4), (256, 10)):
        ns = cs.dependent_read_ns(chase, graph.cbf, 0, threads, chains)
        print(f"a round of {threads} x {chains} dependent random reads of the cbf from one SM: {ns:.1f} ns "
              f"[{card}]", flush=True)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(f"SM clock now, max: {clocks}")
    return 0


def lanes_of(st, idx):
    """The walk state of the lanes ``idx`` (a tensor of lane indices)."""
    return traverse.WalkState(*(None if x is None else x[idx].contiguous() for x in st))


def naive_profile(args, tmp: str, dev, card: str, prof_lib, variants: dict, chase) -> int:
    left, right = os.path.join(tmp, "r_1.fq"), os.path.join(tmp, "r_2.fq")
    pesim.write_pe_fastq(left, right, seed=0, num_transcripts=2000, tx_len=(1000, 4000),
                         num_pairs=args.pairs, read_len=cs.READ_LEN, frag_range=(250, 400), sub_rate=0.003)
    out = os.path.join(tmp, "out")
    t0 = time.time()
    cs.run_cli(left, right, out, "cuda", "mf8", 1)
    print(f"-stage 1 on {args.pairs} pairs: {time.time() - t0:.1f} s", flush=True)
    graph, cfg, captured, n_frags = cs.first_batch_naive_walks(os.path.join(out, "rnabloom.graph"), left, right, dev)
    builds = {"kernel": None, **variants, "profiled": prof_lib}

    def call(who, s, w, m, b):
        lib = builds[who]
        with cs.walk_library(lib) if lib is not None else contextlib.nullcontext():
            return walk.walk_naive(s, graph, cfg, w, m, b)

    for side, (st, wcfg, mc, bd, _) in zip(("right", "left"), captured):
        tally = cs.naive_tally(st, graph, cfg, wcfg, mc, bd)
        plain = tally["state"]
        for who in builds:
            got = call(who, st, wcfg, mc, bd)
            torch.cuda.synchronize()
            bad = cs._same_state(got, plain)
            assert not bad, f"{who} != plain ({side}): {bad}"
        rounds = {name: tally[f"{name}_rounds"] for name in ("old", "new")}
        print(f"{side} -extend walks of the first stage-2 batch ({n_frags} fragments in {st.pos.shape[0]} lanes, "
              f"tip_probe_depth {wcfg.tip_probe_depth}): {int(tally['hops'].sum())} hops "
              f"({int(tally['free_hops'].sum())} free in the kernel's schedule), {int(tally['resolves'].sum())} "
              f"resolves; cell reads: plain loop {int(tally['reads'].sum())}, needed {int(tally['needed'].sum())}, "
              f"the kernel's schedule {int(tally['new_reads'].sum())} [{card}]")
        for name, r in rounds.items():
            q = torch.quantile(r.double(), torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=torch.float64, device=r.device))
            print(f"  rounds, {name} schedule: sum {int(r.sum())}, quantiles 0.5/0.9/0.99/0.999 "
                  f"{'/'.join(f'{x:.0f}' for x in q.tolist())}, most {int(r.max())} (lane {int(torch.argmax(r))}); "
                  f"lanes over 50 rounds {int((r > 50).sum())}")
        t = {who: [] for who in builds}
        order = list(builds)
        for who in (*order, *order[::-1]):
            t[who].append(cs._time_ms(lambda: call(who, st, wcfg, mc, bd), reps=5))
        for who in builds:
            print(f"  {who}: batch {cs._mean(t[who]):.4f} ms ({', '.join(f'{x:.4f}' for x in t[who])}) [{card}]")
        # where the batch's time over its longest lane goes: the lanes
        # sorted longest first (none starts late), and the batch without
        # its longest lanes (what the short ones cost together)
        longest_first = torch.argsort(rounds["new"], descending=True, stable=True)
        for what, idx in (("its lanes sorted by rounds, longest first", longest_first),
                          ("without its 64 longest lanes", torch.sort(longest_first[64:]).values)):
            sub = lanes_of(st, idx)
            sub_mc, sub_bd = mc[idx].contiguous(), bd[idx].contiguous()
            bad = cs._same_state(call("kernel", sub, wcfg, sub_mc, sub_bd), lanes_of(plain, idx))
            assert not bad, f"kernel != plain on the batch {what}: {bad}"
            ts = [cs._time_ms(lambda: call("kernel", sub, wcfg, sub_mc, sub_bd), reps=5) for _ in range(2)]
            print(f"  kernel: the batch {what} {cs._mean(ts):.4f} ms ({', '.join(f'{x:.4f}' for x in ts)}) "
                  f"[{card}]", flush=True)
        for name, r in rounds.items():
            w = int(torch.argmax(r))
            one = traverse.take_lanes(st, slice(w, w + 1))
            one_mc, one_bd = mc[w : w + 1].contiguous(), bd[w : w + 1].contiguous()
            for who in builds:
                got = call(who, one, wcfg, one_mc, one_bd)
                torch.cuda.synchronize()
                bad = [f for f in cs.WALK_FIELDS if not torch.equal(getattr(got, f), getattr(plain, f)[w : w + 1])]
                assert not bad, f"{who}: lane {w} alone != plain: {bad}"
            t1 = {who: [] for who in builds}
            for who in (*order, *order[::-1]):
                t1[who].append(cs._time_ms(lambda: call(who, one, wcfg, one_mc, one_bd), reps=5))
            print(f"  lane {w}, the most rounds of the {name} schedule: {int(tally['hops'][w])} hops "
                  f"({int(tally['free_hops'][w])} free), {int(tally['resolves'][w])} resolves, rounds old "
                  f"{int(rounds['old'][w])} / new {int(rounds['new'][w])}")
            for who in builds:
                lane = min(t1[who])
                print(f"    {who} alone: {lane:.4f} ms ({', '.join(f'{x:.4f}' for x in t1[who])}): "
                      f"{lane * 1e6 / max(int(rounds['old'][w]), 1):.1f} ns a round of the old schedule, "
                      f"{lane * 1e6 / max(int(rounds['new'][w]), 1):.1f} of the new [{card}]", flush=True)
            read_profile(prof_lib)
            ms = cs._time_ms(lambda: call("profiled", one, wcfg, one_mc, one_bd), reps=1)
            report(f"  profiled lane {w} alone (rank 0's clock64 spans)", read_profile(prof_lib), ms, card, NAIVE_PHASES)
        read_profile(prof_lib)
        ms = cs._time_ms(lambda: call("profiled", st, wcfg, mc, bd), reps=1)
        report(f"  profiled {side} batch, summed over lanes", read_profile(prof_lib), ms, card, NAIVE_PHASES)
    print(f"one dependent random read of the {graph.cbf.numel()}-cell cbf: {cs.dependent_read_ns(chase, graph.cbf):.1f} "
          f"ns [{card}]")
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(f"SM clock now, max: {clocks}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
