#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rnabloom_tpu_torch) on one GPU.

    python3 chip_smoke.py [--walk-variant NAME=PATH ...] [--insert-variant NAME=PATH ...]
                          [--lr-variant NAME=PATH ...]

Run from the root of a checkout on a machine with a CUDA card.  It imports
no JAX.  ``--walk-variant`` adds another walk kernel source with the same C
entry points (a copy of ``csrc/walk_greedy.cu`` with another constant, or
an older commit's kernel from ``git show``) to phases 4 and 7 (greedy
walks), 6 (pair walks, where the source has ``walk_pair``) and 8 (naive
walks, where it has ``walk_naive``), built beside the port's kernels, held
to the same equality and timed in the same turns (a source from before
the exact-count gate and terminators is called through
``GatelessWalks``, which drops their arguments).
``--insert-variant`` does the same for another ``csrc/cell_insert.cu`` in
phase 2 (an older source whose mf8 entry point is ``cell_add_mf8``, with
its int32 scratch as long as the table, gets that scratch; one whose
``cell_add_mf8_batch`` has no ``base`` argument is called through
``BaselessInserts``), and
``--lr-variant`` for another ``csrc/lr_kernels.cu`` in phase 10 (K1, K2
and K3: every output value equal to the port's kernels', times in the
same turns on both of the phase's kernel cells).
``tools/long_smoke.py`` runs phase 10 alone.  Phases (any failure raises
and exits nonzero):

1. Environment: card name and power limit (nvidia-smi), torch/CUDA
   versions, the kernels' builds from csrc/ (one nvcc per library, started
   together: the walk kernel's source gives four, the count-min layouts'
   greedy mode, their pair and naive modes, the exact-count layouts, the
   count-min layouts with terminators) and
   their build times, and what ``nvcc -Xptxas -v`` reports
   for each instantiation of the walk kernel (registers, stack, spills)
   and for each insert kernel (registers, spills) when this run built
   them; ``tools/dependent_read.cu`` (phase 6's latency probe) is built
   beside them.  While they build, 150,000 simulated 150 bp pairs are
   written (seed 0).
2. Insert kernel vs its plain PyTorch version on the card, per op, at the
   stage-1 shapes of ``-mem 1`` (2^29-cell mf8 cbf, 2^28-cell u16 cbf,
   2^27-cell blocked int32 cbf, 2^27-lane rpkbf), on two kinds of batch:
   synthetic 2^20-index batches (prefilled tables, a 10^5-fold heavy cell,
   the trash cell, dropped indices, several salts) and a real-read batch
   (the k-mer cell indices of the first 4096 simulated reads, hashed by the
   port at k=25, h=2: 1,032,192 indices).  The tables must be equal.  Times
   from CUDA events, both batches in the same kernel/plain turns; in the
   same turns the one-call PyTorch yardsticks of ``set``
   (``index_fill_``) and ``add`` (``index_add_``) on the batches' in-range
   indices, which must give the kernel's table.  ``set`` is also timed
   on 10 fresh random 2^20-index batches applied in turn to a zeroed
   table (zeroed outside the timed events), and every timed ``set`` batch
   prints the share of its in-range indices whose lane was already 1.
   Each op's bound: the index bytes plus one 32 B sector per distinct
   cell, read and written (written only, for ``set``), over 3.35 TB/s.
3. The main path: ``cli -stage 3 -savebf --device cuda`` (the nr pass
   included) with ``-cnt mf8`` (the default) and ``-stage 1 -savebf -cnt
   u16``, both on the 150,000 pairs at the default ``-mem 1``, stage 3
   over all of its batches of 2048.  The launch counters must show the
   insert kernels and the walk kernel ran, and in stage 3 both walk modes
   and ``set`` (the screen); every valid k-mer of 10,000 sampled input
   reads must count >= 1 on each saved graph (a count-min filter never
   undercounts); the transcript files must be well formed.  Each run
   prints its rates (stage 1 reads/s, stage 2 pairs/s, stage 2b and stage 3
   fragments/s), stage 3's wall time by ``utils/timer`` span, its launches
   per stage and per stage-3 use of the greedy kernel, the nr pass's
   seconds (span ``nr``), ``num_nr`` and the size of ``transcripts.nr.fa``
   (its records well formed), its peak device memory and its insert buffer (add_mf8's batch table: at most 64 MiB for
   mf8, none for u16), and the share of its stage-1-2 ``set`` indices
   that found their lane already set (1 - set lanes in the saved rpkbf /
   set indices applied).  The ``-stage 3`` run records a pair of CUDA
   events around every kernel launch (``ops/launch_timer.py``, read once
   after the run): launches and summed card time per kernel, and
   ``walk_pair``'s launches by lane count beside the ``extend`` span.
4. Walk kernel vs its plain PyTorch version on the card, at stage-2
   shapes: the bridge-walk seeds of the first stage-2 batch (8192 pairs,
   error-corrected and overlap-tested as ``assemble_fragments_batch``
   does), walked on the mf8 and the u16 graph that phase 3 saved, with
   ``max_len = k + 500`` and lookahead 3.  Every field of the returned walk
   state must be equal.  Times from CUDA events in turns.  A replay of the
   plain loop (``walk_tally``, which must end in the same state) counts the
   hops, resolves and cell reads the batch needs; the bound is those reads
   as 32 B sectors plus the walk state read and written, over 3.35 TB/s.
   The lane with the most dependent read rounds is then walked alone: the
   latency floor of the design.  Beside them, one torch gather of as many
   uniformly random cells of the same table as the batch reads: the card's
   random-read rate.
5. Card against CPU: ``-stage 1`` on a 5,000-pair subset for ``-cnt
   mf8``, ``u16`` and ``int32`` (byte-identical checkpoints), and
   ``-stage 2 -savebf`` on the first 2048 pairs (a quarter of a batch) for
   ``-cnt mf8`` and ``u16``: every file under the output directory (the
   fragment store, the checkpoint with its fragment distance, the read
   statistics, the stamps) must be byte-identical.  Stage 2b
   (``pipeline.rebuild_fragment_graph``) then runs on each of those outputs
   on the card and on the CPU: the rebuilt cbf, rpkbf and fpkbf, saved as
   checkpoints, must be byte-identical.  ``-stage 3`` on the first 2000
   pairs on the card and on the CPU: every file byte-identical (the
   transcripts and ``transcripts.nr.fa`` included), report.json equal but
   for elapsed_s.  ``-stage 2 -extend`` on the first 2000 pairs on the
   card and on the CPU: every file byte-identical.  The repo's
   golden dataset (``utils/pesim.write_golden_fastq``, the reads of
   ``tests/test_golden.py``) through ``assemble_pe`` on the card: the
   strand-normalised sha1 set must equal ``tests/golden/pe_golden.json``.
6. Stage 2b and the stage-3 extension, the main path of the latest slice,
   with every launch count set to 0 before it: the 150k-pair ``-cnt mf8``
   output of phase 3 loaded on the card and rebuilt (fragments/s, batches,
   launches, the batch table, peak device memory and what holds it; every
   valid k-mer of 10,000 sampled fragments must count >= 1 on the rebuilt
   cbf), then ``transcripts.extend_fragments_pair`` (the pair walk kernel,
   right then left) on stage 3's batches of 2048 fragments in its own
   order (one stratum at a time, a stratum's last batch padded), up to and
   including the first full batch.  On that batch each walk is run again
   by the kernel and once by the plain loop: every field equal, the pair
   ring included; the right walks of it, of stage 3's first batch and of
   that batch's fragments alone (in a launch of their own) by each
   ``--walk-variant`` too, and by the plain loop.  Times of the right
   walks of the three in turns (kernel, variants,
   variants, kernel; the plain loop's equality run is its turn); a replay
   of the plain loop (``pair_tally``, which must end in the plain loop's
   state) counts the cell, pkbf-lane and ring reads the plain loop needs
   (the bound: those reads as 32 B sectors plus the walk state read and
   written, over 3.35 TB/s), the cells this kernel's schedule reads, and
   each lane's dependent rounds under this schedule and the one-step one; beside it
   one torch gather of as many random cbf cells and fpkbf lanes.  The lane
   with the most rounds is walked alone (the latency floor; time per
   round), beside one thread's chain of dependent random reads of the cbf
   (the card's latency of one dependent read).
7. Stage 3's greedy walks on the rebuilt graph of phase 6: stage 3's
   batches in its own order on a fresh screen (as phase 3 ran them) up to
   the first that issues gap re-walks; that batch again from the screen it
   started with, with
   ``-maxclip 8`` (the default never reaches the blunt-end probes; later
   batches if that one has no candidate), for the depth probes on the
   graph and on the screen viewed as an mf8 graph.  Every captured walk by
   the kernel, each ``--walk-variant`` and the plain loop, every field
   equal; per use (gap re-walks; tip and depth probes; the screen as a
   graph) the largest batch timed in turns, replayed by ``walk_tally`` for
   its reads and bound, beside one gather of as many random cells of its
   table.
8. The naive walk kernel (``-extend``) vs its plain version: the first
   stage-2 batch of the 150k pairs joined into fragments on phase 3's mf8
   graph as stage 2 does, then extended; its two naive walks (right, then
   left; back-branch checks, tip_probe_depth 8, buffers padded to a power
   of two) run again by the kernel, by each ``--walk-variant`` with
   ``walk_naive`` and once by the plain loop: every field equal, the
   extension's own run too.  Times in turns (kernel, variants, variants,
   kernel); a replay of the plain loop (``naive_tally``, which must end in
   its state) counts the cells the plain loop reads, the cells it needs
   (a variant probe's steps once: all live variants follow one descent)
   and the cells this schedule reads, and each lane's dependent rounds
   under the one-step schedule and this one; the bound is the needed
   cells as 32 B sectors plus the walk state read and written, over 3.35
   TB/s; beside it one gather of as many random cells.  The lane with the
   most rounds is walked alone (time a round).  Then the main path of
   this slice, with every
   launch count set to 0 before it: ``-stage 2 -extend`` on the first 2
   batches of the 150k pairs (16,384 pairs: a depth cut), its pairs/s and
   its launches (``walk_naive`` among them).
9. The short-read entry points of the latest slice, each with every
   launch count set to 0 before it, on slices of the 150k pairs at the
   default ``-mem 1`` (150 bp reads, k=25; only the depth is cut):
   single-end ``-stage 3`` (``-sef`` the left and ``-ser`` the right mates
   of the first 10,000 pairs), ``-pool`` of two samples (pairs 0-4,999
   and 5,000-9,999) with ``-mergepool``, ``-stage 2 -rescue -bound 20``
   on the first 16,384 pairs, and ``-k 25,27 -ntcard -stage 1`` on the
   first 20,000 pairs.  Each prints its rates, launches per kernel (the
   single-end and pool runs must launch ``add_mf8``, ``set`` and
   ``walk_pair``, the ``-k`` run ``add``), its peak device memory, and
   the run's own numbers: the spill and ``num_rescued`` (at least 1), the
   chosen k and the sketch's estimate.  The ``-k`` run's sketches are held
   to the CPU's plain inserts on the same reads: each k's distinct and
   nonsingleton cells, the estimate, and every cell of a zeroed sketch of
   each size after the run's first batch into it.  The pair walks (right, then left)
   of the single-end run's first full stage-3 batch (read pairs only, no
   fpkbf) by the kernel and once by the plain loop, every field equal;
   the right walks timed in turns, a replay of the plain loop
   (``pair_tally``) for the bound, one gather of as many random cells and
   rpkbf lanes.  Then card against CPU on 1,000 reads or pairs a case:
   single-end ``-stage 3``, mixed ``-stage 2``, ``-pool -mergepool``,
   ``-stage 2 -rescue`` and ``-k 25,27 -ntcard -stage 1``, every file
   byte-identical.
10. The long-read path, the main path of the latest slice: ONT-like cDNA
   reads from the port's ``utils/lrsim.py`` (seed 0, LR_TRANSCRIPTS
   transcripts of 500-4,000 bases at LR_COVERAGE, 7% error; the reads and
   bases printed) through ``-long`` at ``-mem 1`` four ways on the card,
   each with every launch count set to 0 before it: (i) the default run,
   then, each resumed from a copy of (i)'s corrected reads and stamps (the
   ``LONGREADS.CORRECTED`` resume), (ii) ``-lrsub 5,11,0,50`` (strobemers:
   ``lr_kmer_keys`` and ``lr_randstrobe_keys`` must launch), (iii)
   ``-lrsub 5,25,0`` (k-mers: ``lr_kmer_keys``) and (iv) ``-paf``.  Each
   prints stage 1's and the correction's reads/s (run (i)), the seconds of
   each OLC step (subsampling, PAF, overlaps, unique reads, unitigs,
   placement, polish, layout, ``reduce_redundancy``), the transcript and
   short counts, ``lrsim.evaluate``'s recall and precision against the
   simulated transcripts, peak device memory and its launches per kernel
   (run (i) must launch ``add_mf8``, ``walk_greedy`` and ``set``).  Then
   the kernels against their plain versions on the card, every value
   equal: ``lr_kmer_keys`` and ``lr_randstrobe_keys`` on every corrected
   read of run (i), per read (the plain versions pad into the JAX
   package's buckets); ``consensus_vote`` through ``polish(...,
   indel_band=0)`` on run (i)'s own unitigs and placements (kernel, plain
   on the card, plain on the CPU).  K1 and K2 also at the size the phase
   was specified with: its 750 raw reads 14 times (10,500 reads), one
   launch each, the keys of every 7th read (each raw read twice) equal to
   the plain versions' on those reads alone; K3 too: run (i)'s unitigs
   and placements 14 times over (copy c on unitigs
   c U ..) through ``polish(..., indel_band=0)``, every batch's polished
   codes and depths equal to the plain version's on that batch, a call's
   peak device memory under 6 B a cell above its inputs; K3's turns also
   time it with no read (the scans and writes alone) and with the batch's
   reads spread evenly over the unitigs (no skew).  Each kernel is
   timed with CUDA events beside its plain version (all three on both
   cells, in turns with each ``--lr-variant``, K1 and K2 through the C
   entry points, K3 through its wrapper and a variant through its C entry
   with a zeroed vote table allocated in each call; K1's and K2's key path
   end to end, wrapper and C entry also on the host's clock, 5 calls
   each), with its bound (the larger of bytes over
   3.35 TB/s and, for K1 and K2, 32-bit integer instructions by pipe, 64
   lanes an SM on the ALU or FMA pipe and 128 issued, over 132 SMs at the
   highest SM clock nvidia-smi gives) and, for the vote, the
   ``scatter_add_`` + ``argmax`` composite as the library yardstick.
   Last, runs (i)-(iv) on the first 200 reads on the card and on the CPU:
   every file byte-identical.
11. The decision oracle, exact counts and terminators, the main path of
   the latest slice, each with every launch count set to 0 before it:
   ``oracle.divergence.measure_all`` on the card (its twin graphs built by
   the insert kernels, the screen's gap re-walks by the walk kernel), equal
   to the CPU's dict and to ``tests/golden/oracle_divergence.json``, with
   its launches by op; the exact-count stage-1 build at ``-mem 1`` (k=25,
   2 hashes, the flat layout: -cnt int32, a 2^27-lane dbgbf, 2^27 int32
   cells and a 2^27-lane rpkbf; -cnt mf8, 2^29 cells) over both mates of
   the first EXACT_PAIRS pairs (a depth cut) in batches of 4096 reads, with
   the kernels (``set``, ``add`` for the multiplicity scratch, the fused
   conservative update), with the update composed of plain-torch gathers
   and the ``max`` kernel (the port's and each ``--insert-variant``'s) and
   with the plain inserts on the card: every table byte-identical, the ms
   of a build step in turns, peak device memory; the -cnt u16 build's
   first batch, fused against plain.  The ``max`` insert against its plain
   version, ``scatter_reduce_`` (amax; none for u16 cells) and each
   variant, for int32, u16 and mf8 cells, on the builds' first batches
   (the composed update's indices and values: 1,032,192 a batch) and on
   synthetic 2^20-index batches, each call on a fresh copy of its table,
   with its bound (indices and values once, a 32 B sector read a distinct
   cell's sector and written a raised one's, over 3.35 TB/s).  The fused
   update against its plain version and the compositions on the same
   first batches (timed; its bound: the keys once, a sector a distinct
   scratch and count cell, a sector a raised cell written) and on a
   2^10-cell table where keys collide heavily.  Walks over the exact int32 graph
   against the plain loop in every field, timed in turns with the
   count-min int32 graph of the same reads: greedy on phase 4's bridge
   seeds (16,384 lanes), naive on phase 8's right walks (8,192 lanes;
   their bounds are in PERF.md: the replays that counted their reads
   were cut for the smoke's time).  Then
   terminators (a 2^27-lane, 2-hash filter holding the k-mers of every
   other simulated transcript, by ``screen_add``) on the greedy lanes over
   the count-min graph, against the plain loop, timed in turns with the
   same walks without them; some lanes, not all, end TERM.
12. The sharded graph engine (``-sharded on``; ``parallel/sharded.py``,
   collectives as device copies in one process), the main path of the
   latest slice: the stage-1 build at ``-mem 1`` (mf8: 2^29 cells, 2^27
   rpkbf lanes) over both mates of the first MESH_PAIRS pairs in batches
   of 4096 reads, on one device and on meshes of 2 and 8 shards on the
   card (and one shard a card where several cards are visible; the phase
   prints how many are), each with every launch count set to 0 before
   it: every lane outside the trash cells equal to the single-device
   kernel build, counts of 2,000 reads equal from the replica and routed
   to the shards, one ``add_mf8`` launch a shard and step; one batch each
   of ``-cnt u16``, the blocked int32 cbf (8 shards) and the exact int32
   path (``max``) held the same way.  Each build step timed with CUDA
   events beside the single-device step, with its routed calls' share,
   its all-to-all bytes a shard (``comm_accounting``), the routed calls
   that took a second round, and peak device memory.  Then ``-stage 3
   -savebf`` (the nr pass included) through ``pipeline.assemble_pe`` on
   MESH_STAGE3_PAIRS pairs with ``make_mesh_if_multi`` giving the 8-shard
   mesh, every launch count set to 0 before it: every file equal to the
   single-device run's but for what the JAX package's mesh run differs in
   (the checkpoint's trash cells; the read statistics' distinct-k-mer
   estimate, each run's equal to its engine's own arithmetic), report.json
   but elapsed_s; and the mesh run on the first 2000 pairs on the card
   and on 8 CPU shards, byte-identical.  The routed and grouped mesh walks
   (the latest slice's path): on the 2- and 8-shard mesh builds, the
   sharded walk kernel in each mode (greedy on phase 4's bridge lanes of
   the first stage-2 batch, naive on phase 8's right -extend lanes, pair on
   the first 2,048 reads as fragments, read pairs only) against the
   single-device kernel on the replica at the full lane count and against
   the plain routed loop on the card on the first MESH_WALK_HEAD lanes,
   every field equal, both kernels timed in turns; then the -stage 3 run
   again under ``RNB_MESH_WALK=routed`` and ``grouped`` (R = 2), every file
   byte-identical to the replicated run's, with wall time by stage, peak
   device memory and the replicas the engine gathered (none when routed);
   and ``-stage 2 -extend`` on the first 2000 pairs routed against
   replicated, byte-identical, each run with every launch count set to 0
   before it (the sharded kernels launched, the single-device walks not).

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import filecmp
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rnabloom_tpu_torch import cli
from rnabloom_tpu_torch.assembly import correct, fragments, pipeline, stage1, transcripts
from rnabloom_tpu_torch.assembly.fragstore import FragmentStore
from rnabloom_tpu_torch.bloom import filters
from rnabloom_tpu_torch.graph import dbg, engine, traverse
from rnabloom_tpu_torch.io import fastx, native
from rnabloom_tpu_torch.olc import consensus as olc_consensus
from rnabloom_tpu_torch.ops import _build, cell_insert as ci, consensus_vote, launch_timer, lr_keys, nthash, strobemer, walk
from rnabloom_tpu_torch.parallel import sharded
from rnabloom_tpu_torch.utils import checkpoint, kselect, lrsim, pesim, seq as sequtils

KERNEL_SOURCE = "rnabloom_tpu_torch/csrc/cell_insert.cu"
TPU_KERNEL = "rnabloom_tpu/ops/histmerge.py:187"
WALK_SOURCE = "rnabloom_tpu_torch/csrc/walk_greedy.cu"
WALK_REPLACES = "rnabloom_tpu/graph/traverse.py:1032"
CHASE_SOURCE = "tools/dependent_read.cu"  # phase 6's dependent-read latency probe
CKPT_FILES = ("rnabloom.graph.graph.json", "rnabloom.graph.cbf.npy", "rnabloom.graph.rpkbf.npy")
WALK_FIELDS = ("buf", "pos", "status", "hops", "path_min", "fh", "rh", "hist")
PAIR_FIELDS = WALK_FIELDS + ("ring_fh", "ring_rh")
REBUILT_FILES = ("rebuilt.graph.json", "rebuilt.cbf.npy", "rebuilt.rpkbf.npy", "rebuilt.fpkbf.npy")
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM, 3.35 TB/s (NVIDIA's data sheet)
SECTOR = 32  # bytes of one random DRAM access
# the walk kernel's layout template argument (csrc/walk_greedy.cu: the
# count-min layouts, + 4 the exact-count ones, + 8 with terminators)
WALK_LAYOUTS = {0: "mf8", 1: "u16", 2: "int32", 3: "int32 blocked", 4: "mf8 exact", 5: "u16 exact", 6: "int32 exact",
                8: "mf8 terminators", 9: "u16 terminators", 10: "int32 terminators", 11: "int32 blocked terminators"}
# cell_add_mf8(table, int32 scratch, numel, idx, n, salt, stream): the
# two-pass mf8 entry point of earlier insert sources
SCRATCH_MF8_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_uint, ctypes.c_void_p]
LIBRARY = {  # op -> the one PyTorch call computing the same function, or none
    "set": lambda table, idx: table.index_fill_(0, idx, 1),
    "add": lambda table, idx: table.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32)),
}

# op -> (table cells incl. trash, what it is at -mem 1)
SHAPES = {
    "add_mf8": ((1 << 29) + 1, "cbf -cnt mf8, 2^29 cells"),
    "set": ((1 << 27) + 1, "rpkbf, 2^27 lanes"),
    "add_u16": ((1 << 28) + 1, "cbf -cnt u16, 2^28 cells"),
    "add": ((1 << 27) + 128, "cbf -cnt int32 blocked, 2^27 cells"),
}
BATCH = 1 << 20
FRESH = 10  # fresh batches of set, applied in turn to a zeroed table
PAD_CYCLES = 2_000_000  # about 1 ms of the card's clock, ahead of each timed span
SALTS = (0, 1, 977, (1 << 31) + 7)
K, NUM_HASH, READ_LEN = 25, 2, 150
REAL_READS = 4096  # one stage-1 batch
# the simulated pairs: the main path of phase 3 and what it feeds (phases
# 4, 6-8); 1,000,000 before phase 12 took the routed and grouped walks,
# then cut for the smoke's time (it took 1126.8 s with 1,000,000 on one
# H100 80GB HBM3 at 700 W, over its 1,050 s mark); 700,000 until phase
# 12's plain routed loops went back to routing one shard at a time (W6's
# 940.9 s grew by about 55 s); 500,000 until a slower host than the
# builders' took over 1200 s on the tree that took 845.3 s on one H100
# 80GB HBM3 at 700 W; 200,000 took 727.8 s on another such card (the
# smoke aims at half its limit)
PAIRS = 150_000
PAIRS_K = f"{PAIRS // 1000}k"  # the label of the pairs in the phases' lines
BATCH2 = 8192  # pairs per stage-2 batch
CBF_LOG2 = {"mf8": 29, "u16": 28}  # default cbf at -mem 1, before any resize
STAGE3_PAIRS = 2000  # the card-vs-CPU -stage 3 run (with the nr pass)
# stage-2 batches of the -extend main-path run: a depth cut of the pairs,
# 8 before phase 10 came (the smoke took 1080.1 s with 8 on one H100 80GB
# HBM3 at 700 W, over its 1,050 s mark), 4 until the smoke aimed at half
# its limit
EXTEND_BATCHES = 2
STAGE2_PAIRS = 2048  # the card-vs-CPU -stage 2 runs and their stage 2b: a quarter of a stage-2 batch (was 4096)
STAGE1_PAIRS = 5_000  # the card-vs-CPU -stage 1 runs (cut from 20,000 for the smoke's time)
MAXCLIP = 8  # -maxclip of phase 7's rerun, which reaches the screen-as-graph probe
GOLDEN = "tests/golden/pe_golden.json"
# phase 9's pool depth, half the 2 x 50,000 pairs it first ran (67 s of a
# 1037 s smoke on one H100 80GB HBM3 at 700 W): margin under the 1200 s
# limit for a slow host (one took 1155 s before phase 9 existed)
SE_PAIRS = 10_000  # phase 9: the single-end run reads both mates of these pairs (cut from 100,000, then 25,000)
POOL_PAIRS = 5_000  # phase 9: pairs of each of the two pool samples (cut from 25,000, then 12,500)
RESCUE_PAIRS = 16_384  # phase 9: the -rescue run (two stage-2 batches)
KSELECT_PAIRS = 20_000  # phase 9: the -k 25,27 -ntcard run
CHECK9 = 1000  # phase 9: reads or pairs of each card-vs-CPU case
SE_PAIR_NAME = "walk_pair[single-end stage 3, read pairs only]"
# stage-3 uses of the greedy walk kernel: kind -> the kernels line's name
GREEDY_USES = {
    "gap_rewalk": "walk_greedy[stage-3 gap re-walks]",
    "probe": "walk_greedy[stage-3 tip and depth probes]",
    "screen": "walk_greedy[stage-3 screen as a graph]",
}
_T0 = time.time()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_report(log: str) -> list:
    """One line per kernel instantiation from ``nvcc -Xptxas -v``: its
    template arguments, registers, stack frame and spills."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*walk_greedy_kernelILi(\d+)ELi(\d+)ELb([01])ELi(\d)E", line)
        if m:
            name = (f"<{WALK_LAYOUTS[int(m.group(1))]}, {m.group(2)}, {('no', 'yes')[int(m.group(3))]}, "
                    f"{('greedy', 'pair', 'naive')[int(m.group(4))]}>")
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            frame = m.groups()
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {frame[0]} B stack frame, {frame[1]} B spill stores, "
                       f"{frame[2]} B spill loads")
            name = None
    return out


def insert_ptxas(log: str, kernels: str = "set_u8|add_i32|add_u16_tile|mf8_tile|mf8_apply|max|conservative_values") -> list:
    """One entry per kernel (the insert kernels unless ``kernels`` names
    others) from ``nvcc -Xptxas -v``: registers, static shared memory and
    spill stores."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(rf"Function properties for \S*?({kernels})_kernel(\S*)", line)
        if m:
            # a template's instantiations keep their mangled arguments apart
            name = m.group(1) + "_kernel" + (m.group(2) if m.group(2).startswith("I") else "")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name} {m.group(1)} registers, {m.group(2) or 0} B static shared memory, {spill} B spill "
                       f"stores")
            name = None
    return out


# the walk entries' gate arguments (dbgbf, its size_log2 and num_hash, the
# terminators, their size_log2 and num_hash), after max_supersteps
WALK_GATE_ARGS = slice(25, 31)
assert _build._WALK_ENTRIES["walk_greedy"][WALK_GATE_ARGS] == _build._WALK_GATES


def _without_gates(args: list) -> list:
    return args[:WALK_GATE_ARGS.start] + args[WALK_GATE_ARGS.stop:]


# the walk entries of a source from before the exact-count gate and
# terminators
WALK_SIGNATURES_BEFORE_GATES = {name: _without_gates(args) for name, args in _build._WALK_ENTRIES.items()}


class GatelessWalks:
    """A walk library built from a source from before the exact-count gate
    and terminators, called with the port's argument list: the gate
    arguments are dropped, and must be null (count-min, no terminators)."""

    def __init__(self, so: ctypes.CDLL):
        self.so = so
        self.source = so.source

    def __getattr__(self, name: str):
        fn = getattr(self.so, name)  # AttributeError where the source lacks it
        if name not in WALK_SIGNATURES_BEFORE_GATES:
            return fn

        def call(*args):
            gates = args[WALK_GATE_ARGS]
            if gates[0] is not None or gates[3] is not None:
                raise ValueError(f"{self.source}: this walk kernel has no exact-count gate or terminators")
            return fn(*_without_gates(list(args)))

        return call


# cell_add_mf8_batch's base argument (after the salt), which insert sources
# from before the sharded engine lack
MF8_BASE_ARG = 7
MF8_BATCH_BEFORE_BASE = [a for i, a in enumerate(_build._SIGNATURES[_build.KERNEL_LIB][1]["cell_add_mf8_batch"])
                         if i != MF8_BASE_ARG]


class BaselessInserts:
    """An insert library built from a source whose ``cell_add_mf8_batch``
    has no ``base`` argument, called with the port's argument list: the
    base is dropped, and must be 0 (a whole table)."""

    def __init__(self, so: ctypes.CDLL):
        self.so = so
        self.source = so.source

    def __getattr__(self, name: str):
        fn = getattr(self.so, name)  # AttributeError where the source lacks it
        if name != "cell_add_mf8_batch":
            return fn

        def call(*args):
            if args[MF8_BASE_ARG] != 0:
                raise ValueError(f"{self.source}: this mf8 insert keys cells by their table index only (base 0)")
            return fn(*args[:MF8_BASE_ARG], *args[MF8_BASE_ARG + 1:])

        return call


def build_variant(kind: str, i: int, src: str) -> ctypes.CDLL:
    """Another ``kind`` ("walk", "insert" or "lr") kernel source, built with the
    port's nvcc flags into ``build/{kind}_variants/``, its entry points
    bound as the port's are.  A walk source may lack ``walk_pair`` (then
    phase 6 skips it), or predate the gates (then it is wrapped in
    ``GatelessWalks``); an insert source may have, in place of
    ``cell_add_mf8_batch``, the older ``cell_add_mf8`` (an int32 scratch as
    long as the table), or a ``cell_add_mf8_batch`` without the ``base``
    argument (then it is wrapped in ``BaselessInserts``)."""
    lib = os.path.join(_build.BUILD_DIR, f"{kind}_variants", f"lib{i}.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, src, "-o", lib], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    so = ctypes.CDLL(lib)
    so.source = src
    lib_of = {"walk": _build.WALK_LIB, "insert": _build.KERNEL_LIB, "lr": _build.LR_LIB}
    signatures = dict(_build._SIGNATURES[lib_of[kind]][1])
    with open(src) as f:
        text = f.read()
    gateless = kind == "walk" and "term_num_hash" not in text  # before the exact gate and terminators
    # an mf8 batch entry from before its base argument
    baseless = kind == "insert" and re.search(r"int cell_add_mf8_batch\([^)]*\bbase\b", text) is None
    if gateless:
        signatures = dict(WALK_SIGNATURES_BEFORE_GATES)
    if kind == "walk" and not hasattr(so, "walk_pair"):  # an older source: greedy mode only
        del signatures["walk_pair"]
    if kind == "insert" and not hasattr(so, "cell_max_i32"):  # before the max op
        for name in ("cell_max_i32", "cell_max_u16", "cell_max_u8"):
            del signatures[name]
    if kind == "insert" and not hasattr(so, "cell_conservative_values_i32"):  # before the conservative update
        for name in [n for n in signatures if n.startswith("cell_conservative_")]:
            del signatures[name]
    if kind == "lr" and not hasattr(so, "lr_randstrobe_smem"):  # an older source: only the kernels are timed
        del signatures["lr_randstrobe_smem"]
    if kind == "insert" and not hasattr(so, "cell_add_mf8_batch"):
        del signatures["cell_add_mf8_batch"]
        signatures["cell_add_mf8"] = SCRATCH_MF8_ARGS
        baseless = False
    elif baseless:
        signatures["cell_add_mf8_batch"] = MF8_BATCH_BEFORE_BASE
    for name, args in signatures.items():
        fn = getattr(so, name)  # raises where the source lacks an entry point
        fn.argtypes = args
        fn.restype = ctypes.c_int
    if baseless:
        return BaselessInserts(so)
    return GatelessWalks(so) if gateless else so


@contextlib.contextmanager
def walk_library(lib: ctypes.CDLL):
    """Route the walk wrappers' count-min calls to ``lib`` (a
    ``--walk-variant`` build, every mode in one library)."""
    saved = {path: _build._load(path) for path in _build.WALK_COUNT_MIN_LIBS}
    _build._libs.update({path: lib for path in saved})
    try:
        yield
    finally:
        _build._libs.update(saved)


def build_chase() -> ctypes.CDLL:
    """``tools/dependent_read.cu``, built with the port's nvcc flags into
    ``build/tools/``."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), CHASE_SOURCE)
    lib = os.path.join(_build.BUILD_DIR, "tools", "libdependent_read.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, src, "-o", lib], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    so = ctypes.CDLL(lib)
    so.dependent_read.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_ulonglong,
                                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    so.dependent_read.restype = ctypes.c_int
    return so


def phase(name: str) -> None:
    print(f"\n== {name} ({time.time() - _T0:.1f} s into the run)", flush=True)


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
    # keep the card busy while the host enqueues the calls, so that no
    # launch waits on the host inside the timed span
    torch.cuda._sleep(PAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _check_equal(kern: torch.Tensor, plain: torch.Tensor, op: str, what: str, who: str = "cell_insert") -> None:
    torch.cuda.synchronize()
    if not torch.equal(kern, plain):
        diff = (_as_int(kern) - _as_int(plain)).abs()
        raise AssertionError(
            f"{who}[{op}] != plain {what}: {int((diff > 0).sum())} cells, max |diff| {int(diff.max())}"
        )


def insert_bound_ms(op: str, idx: torch.Tensor, numel: int) -> float:
    """Least time for one insert batch: its index bytes, read once, plus one
    sector per distinct in-range cell, read and written (written only for
    ``set``), at the card's memory rate."""
    distinct = torch.unique(idx[(idx >= 0) & (idx < numel)]).numel()
    return (idx.numel() * idx.element_size() + distinct * SECTOR * (1 if op == "set" else 2)) / HBM_BYTES_PER_MS


def already_set(table: torch.Tensor, idx: torch.Tensor) -> float:
    """Share of ``idx``'s in-range indices whose lane of ``table`` is 1."""
    sel = idx[(idx >= 0) & (idx < table.numel())]
    return float((table[sel] != 0).double().mean())


@contextlib.contextmanager
def insert_library(lib: ctypes.CDLL):
    """Route ``cell_insert`` to ``lib`` (an ``--insert-variant`` build)."""
    saved = _build.kernels()
    _build._libs[_build.KERNEL_LIB] = lib
    try:
        yield
    finally:
        _build._libs[_build.KERNEL_LIB] = saved


def insert_fn(who: str, op: str, variants: dict, scratch):
    """(table, idx, salt) -> None applying ``op`` by the port's kernel, its
    plain version or an ``--insert-variant`` build.  A variant source whose
    mf8 entry point is ``cell_add_mf8`` (two passes over an int32 scratch as
    long as the table, left zeroed by each launch) is handed ``scratch``."""
    if who == "kernel":
        return lambda t, b, salt: ci.cell_insert(t, b, op, salt)
    if who == "plain":
        return lambda t, b, salt: ci.cell_insert_plain(t, b, op, salt)
    lib = variants[who]
    if op == "add_mf8" and not hasattr(lib, "cell_add_mf8_batch"):
        def two_pass(t, b, salt):
            err = lib.cell_add_mf8(t.data_ptr(), scratch.data_ptr(), t.numel(), b.data_ptr(), b.numel(),
                                   salt & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"insert variant {who}[{op}] launch failed: cudaError_t {err}")
        return two_pass

    def swapped(t, b, salt):
        with insert_library(lib):
            ci.cell_insert(t, b, op, salt)
    return swapped


def _mean(v: list) -> float:
    return sum(v) / len(v)


def kernel_vs_plain(dev, card: str, real: dict, variants: dict) -> dict:
    """Each insert op (and each ``--insert-variant``) against its plain
    version at the stage-1 shapes; times in turns.  ``set`` also takes
    FRESH new batches in turn on a zeroed table."""
    results = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    builds = ["kernel", *variants]
    for op, (numel, what) in SHAPES.items():
        base = _prefill(op, numel, gen, dev)
        tabs = {who: base.clone() for who in ("plain", *builds)}
        del base
        old_mf8 = op == "add_mf8" and any(not hasattr(v, "cell_add_mf8_batch") for v in variants.values())
        scratch = torch.zeros(numel, dtype=torch.int32, device=dev) if old_mf8 else None
        apply = {who: insert_fn(who, op, variants, scratch) for who in tabs}

        def check(what: str) -> None:
            for who in builds:
                _check_equal(tabs[who], tabs["plain"], op, what, "cell_insert" if who == "kernel" else who)

        for salt in SALTS:  # successive batches into the same tables
            idx = _batch(numel, gen, dev)
            for who in tabs:
                apply[who](tabs[who], idx, salt)
            check(f"at salt {salt}")
        for who in tabs:
            apply[who](tabs[who], real[op], 3)
        check("on the real-read batch")
        batches = {"synthetic": idx, "real": real[op]}
        # the one-call yardstick takes the in-range indices (an index past
        # the end is an error there); it must compute the kernel's table
        lib = LIBRARY.get(op)
        in_range = {name: b[(b >= 0) & (b < numel)] for name, b in batches.items()}
        lib_tab = None
        if lib is not None:
            lib_tab, check_tab = tabs["kernel"].clone(), tabs["kernel"].clone()
            lib(lib_tab, in_range["real"])
            ci.cell_insert(check_tab, real[op], op, 5)
            _check_equal(check_tab, lib_tab, op, f"against its one-call yardstick {op}")
            del check_tab
        fresh, fresh_in_range, fresh_tabs, shares = [], [], {}, {}
        if op == "set":
            fresh = [torch.randint(0, numel, (BATCH,), generator=gen, device=dev) for _ in range(FRESH)]
            fresh_in_range = [b[(b >= 0) & (b < numel)] for b in fresh]
            fresh_tabs = {who: torch.zeros(numel, dtype=torch.uint8, device=dev)
                          for who in ("plain", *builds, *(("library",) if lib else ()))}
            for b in fresh:  # each batch's share on the table the earlier ones left
                shares.setdefault("fresh", []).append(already_set(fresh_tabs["plain"], b))
                ci.cell_insert_plain(fresh_tabs["plain"], b, op)
        # warm all, then time in turns: plain, library, kernel, variants,
        # variants, kernel, library, plain; each turn times every batch kind
        for name, b in batches.items():
            for who in tabs:
                apply[who](tabs[who], b, 5)
            if lib is not None:
                lib(lib_tab, in_range[name])
        if op == "set":
            shares.update({name: already_set(tabs["kernel"], b) for name, b in batches.items()})
        t = {}
        for who in ("plain", "library", *builds, *builds[::-1], "library", "plain"):
            if who == "library" and lib is None:
                continue
            for name, b in batches.items():
                if who == "library":
                    fn = lambda: lib(lib_tab, in_range[name])  # noqa: E731
                else:
                    fn = lambda: apply[who](tabs[who], b, 5)  # noqa: E731
                t.setdefault((who, name), []).append(_time_ms(fn))
            if fresh:
                ft = fresh_tabs[who]
                ft.zero_()  # outside the timed events
                if who == "library":
                    fn = lambda: [lib(ft, b) for b in fresh_in_range]  # noqa: E731
                else:
                    fn = lambda: [apply[who](ft, b, 5) for b in fresh]  # noqa: E731
                t.setdefault((who, "fresh"), []).append(_time_ms(fn, reps=1) / FRESH)
        # every table took the same batches in the same order
        check("after the timed batches")
        for who, ft in fresh_tabs.items():
            _check_equal(ft, fresh_tabs["plain"], op, f"after {FRESH} fresh batches ({who})")
        mean = {key: _mean(v) for key, v in t.items()}
        r = results[op] = {
            "max_abs_err": int((_as_int(tabs["kernel"]) - _as_int(tabs["plain"])).abs().max()),
            "ms": mean["kernel", "synthetic"], "plain_ms": mean["plain", "synthetic"],
            "library_ms": mean.get(("library", "synthetic")),
            "bound_ms": insert_bound_ms(op, idx, numel),
            "real_ms": mean["kernel", "real"], "real_plain_ms": mean["plain", "real"],
            "real_library_ms": mean.get(("library", "real")),
            "real_bound_ms": insert_bound_ms(op, real[op], numel),
            "variants": {v: {f"{name}_ms": mean[v, name] for name in ("synthetic", "real", "fresh")
                             if (v, name) in mean} for v in variants},
        }
        lib_txt = lambda x: "none" if x is None else f"{x:.4f} ms"  # noqa: E731
        print(
            f"cell_insert[{op}] ({what}): equal to plain on {len(SALTS)} salted synthetic batches "
            f"and the real-read batch; per batch, synthetic ({BATCH} indices): kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, one-call {lib_txt(r['library_ms'])}, bound {r['bound_ms']:.4f} ms; "
            f"real reads ({real[op].numel()} indices): kernel {r['real_ms']:.4f} ms, plain "
            f"{r['real_plain_ms']:.4f} ms, one-call {lib_txt(r['real_library_ms'])}, bound "
            f"{r['real_bound_ms']:.4f} ms [{card}]",
            flush=True,
        )
        if fresh:
            r.update({
                "fresh_ms": mean["kernel", "fresh"], "fresh_plain_ms": mean["plain", "fresh"],
                "fresh_library_ms": mean[("library", "fresh")],
                "fresh_bound_ms": _mean([insert_bound_ms(op, b, numel) for b in fresh]),
                "already_set": shares,
            })
            print(f"cell_insert[{op}]: equal to plain after {FRESH} fresh random {BATCH}-index batches applied in "
                  f"turn to a zeroed table; per batch: kernel {r['fresh_ms']:.4f} ms, plain "
                  f"{r['fresh_plain_ms']:.4f} ms, one-call {r['fresh_library_ms']:.4f} ms, bound "
                  f"{r['fresh_bound_ms']:.4f} ms [{card}]", flush=True)
            print(f"cell_insert[{op}]: share of each timed batch's in-range indices whose lane was already 1: "
                  f"synthetic {shares['synthetic']:.6f}, real {shares['real']:.6f}, fresh "
                  f"{', '.join(f'{x:.6f}' for x in shares['fresh'])}", flush=True)
        turns = lambda who: "; ".join(  # noqa: E731
            f"{name} " + ", ".join(f"{x:.4f}" for x in t[who, name])
            for name in ("synthetic", "real", "fresh") if (who, name) in t)
        print(f"cell_insert[{op}] per turn, ms: kernel {turns('kernel')}"
              + (f" | one-call {turns('library')}" if lib else "") + f" [{card}]", flush=True)
        for v in variants:
            print(f"insert variant {v} [{op}]: equal to plain on every batch; per turn, ms: {turns(v)} [{card}]",
                  flush=True)
        del tabs, apply, scratch, idx, batches, in_range, lib_tab, fresh, fresh_in_range, fresh_tabs
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


def run_cli(left: str, right: str, out: str, device: str, counter: str = "mf8", stage: int = 1,
            extend: bool = False):
    """The port's CLI with -savebf -f; ``-stage 3`` runs the nr pass."""
    return cli.run([
        "-left", left, "-right", right, "-revcomp-right", "-o", out, "-stage", str(stage),
        "-savebf", "-f", "-cnt", counter, "--device", device, *(["-extend"] if extend else []),
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


class CountedStore:
    """A fragment store whose ``iter_batches`` counts the batches and
    fragments it gave, and prints its progress every 50 batches."""

    def __init__(self, store: FragmentStore):
        self._store = store
        self.batches = self.fragments = 0

    def __getattr__(self, name):
        return getattr(self._store, name)

    def iter_batches(self, batch_size: int, width=None):
        t0 = time.time()
        for item in self._store.iter_batches(batch_size, width):
            if self.batches and self.batches % 50 == 0:
                print(f"  stage 3: {self.batches} batches, {self.fragments} fragments in {time.time() - t0:.1f} s",
                      flush=True)
            self.batches += 1
            self.fragments += int((item[1] > 0).sum())
            yield item


class Stage3Probe:
    """Stage 2b and stage 3 of a pipeline run, instrumented from outside the
    port: the wall time (card synchronised) and the insert and walk launches
    of ``rebuild_fragment_graph`` and of ``_run_stage3`` (its store counted,
    ``CountedStore``); the greedy walk launches attributed to their stage-3
    use (``GREEDY_USES``); and, with ``capture``, a copy of each stage-3
    greedy walk's inputs."""

    def __init__(self, capture: bool = False):
        self.capture = capture
        self.uses = {kind: 0 for kind in GREEDY_USES}
        self.captured = []  # (kind, state, graph, cfg, wcfg, min_cov, bound)
        self.times, self.launches, self.indices_before, self.store = {}, {}, {}, None
        self._kind = None

    def _counts(self) -> dict:
        return {**ci.launch_counts(), **walk.launch_counts()}

    def _timed(self, name: str, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            self.indices_before[name] = ci.index_counts()
            c0, t0 = self._counts(), time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.times[name] = time.time() - t0
            c1 = self._counts()
            self.launches[name] = {key: c1[key] - c0[key] for key in c1}
            return out
        return run

    @contextlib.contextmanager
    def installed(self):
        saved = (pipeline.rebuild_fragment_graph, pipeline._run_stage3, transcripts._gap_rewalk,
                 transcripts._depth_probe, engine.extend_walks)
        rebuild, run3, gap, depth, extend = saved

        def run_stage3(state, cfg, store, *args):
            store = self.store = CountedStore(store)
            return self._timed("stage3", run3)(state, cfg, store, *args)

        def gap_rewalk(*args, **kw):
            self._kind = ["gap_rewalk"]
            try:
                return gap(*args, **kw)
            finally:
                self._kind = None

        def depth_probe(graph, cfg, *args, **kw):
            self._kind = ["screen" if cfg.pkbf is None else "probe"]  # the screen as a graph has no pair keys
            try:
                return depth(graph, cfg, *args, **kw)
            finally:
                self._kind = None

        def extend_walks(st, graph, cfg, wcfg, min_cov, bound, mode="greedy"):
            if self._kind is None or mode != "greedy":
                return extend(st, graph, cfg, wcfg, min_cov, bound, mode=mode)
            kind = self._kind[0]
            self._kind[0] = "probe"  # a gap re-walk's second walk is its tip probe
            if self.capture:
                mc, bd = traverse.lane_args(st, min_cov, bound)
                g = dbg.GraphState(None, graph.cbf.clone(), None, None) if kind == "screen" else graph
                self.captured.append((kind, traverse.clone_state(st), g, cfg, wcfg, mc, bd))
            n0 = walk.LAUNCHES["walk_greedy"]
            out = extend(st, graph, cfg, wcfg, min_cov, bound, mode=mode)
            self.uses[kind] += walk.LAUNCHES["walk_greedy"] - n0
            return out

        pipeline.rebuild_fragment_graph = self._timed("rebuild", rebuild)
        pipeline._run_stage3 = run_stage3
        transcripts._gap_rewalk, transcripts._depth_probe = gap_rewalk, depth_probe
        engine.extend_walks = extend_walks
        try:
            yield self
        finally:
            (pipeline.rebuild_fragment_graph, pipeline._run_stage3, transcripts._gap_rewalk,
             transcripts._depth_probe, engine.extend_walks) = saved


def check_transcripts(out: str, report, k: int) -> dict:
    """The -stage 3 files: as many records as the report counts, upper-case
    ACGT bodies (a poly-A tail lower-cased), transcripts at least 200 bases
    and short ones under 200 but at least k; the nr pass's unitigs (ACGT,
    at least 200 bases, headers ``.nr.{j} l={length}``), no more of them
    than transcripts."""
    body = re.compile(r"^[ACGT]+[acgt]*$")
    lengths = {}
    for name, count, ok in (("transcripts.fa", report.num_transcripts, lambda n: n >= 200),
                            ("transcripts.short.fa", report.num_short, lambda n: k <= n < 200),
                            ("transcripts.nr.fa", report.num_nr, lambda n: n >= 200)):
        recs = list(fastx.read_fasta(os.path.join(out, f"rnabloom.{name}"), full_header=True))
        seqs = [s for _, s in recs]
        assert len(seqs) == count, (name, len(seqs), count)
        bad = [s for s in seqs if not body.match(s) or not ok(len(s))]
        assert not bad, f"{name}: {len(bad)} malformed records, e.g. {bad[0][:80]}"
        if name == "transcripts.nr.fa":
            assert all(h == f"rnabloom.nr.{j} l={len(s)}" for j, (h, s) in enumerate(recs)), recs[0][0]
        lengths[name] = [len(s) for s in seqs]
    assert 0 < report.num_nr <= report.num_transcripts, (report.num_nr, report.num_transcripts)
    return lengths


def main_path(left: str, right: str, out: str, counter: str, stage: int, n_pairs: int,
              codes: np.ndarray, card: str, dev):
    """One main-path run on the card with the launch counts and the peak
    device memory of that run alone; checks the saved graph, which stays
    on disk.  ``-stage 3`` (the nr pass included) is checked and reported
    (rates, spans, launches per stage and per greedy use)."""
    ci.reset_launch_counts()
    walk.reset_launch_counts()
    ci._batch_tables.clear()  # the run's own insert buffer only
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    probe = Stage3Probe()
    t0 = time.time()
    with probe.installed() if stage == 3 else contextlib.nullcontext(), launch_timer.recording() as rec:
        report = run_cli(left, right, out, "cuda", counter, stage)
    torch.cuda.synchronize()
    wall = time.time() - t0
    card_times = rec.times()
    launches = {**ci.launch_counts(), **walk.launch_counts()}
    # the saved graph is stage 2's: its rpkbf took the set indices of stages 1-2
    set_indices = (probe.indices_before["rebuild"] if stage == 3 else ci.index_counts())["set"]
    peak = torch.cuda.max_memory_allocated()
    buffer = ci.batch_table_bytes()
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
    if stage >= 2:
        print(f"{tag}: stage 2 {report.num_pairs / report.stage2_s:.1f} pairs/s ({report.num_pairs} pairs, "
              f"{report.stage2_batches} batches, {report.stage2_s:.2f} s); fragments stored "
              f"{report.num_fragments}; d_frag {report.fragment_pair_distance}; graph desc "
              f"fragment_pair_distance {cfg.fragment_pair_distance}; dispatches {report.stage2_dispatches} [{card}]")
        assert report.num_pairs == n_pairs and report.num_fragments > n_pairs // 2, report
        assert cfg.fragment_pair_distance == report.fragment_pair_distance > 0
    stage3 = None
    if stage == 3:
        stage3 = stage3_report(tag, report, probe, out, card)
        stage3["card_time"] = card_time_report(tag, card_times, report.stage3_spans["extend"], card)
    print(f"{tag}: peak device memory {peak} B ({peak / 2**30:.3f} GiB; {held} B held before "
          f"the run); insert buffer (add_mf8's batch table) after it: {buffer} B")
    # stage 1 gives every set index in range (an invalid window goes to the
    # trash lane); a resize rebuilds the filters, so its run's share is not
    # the saved rpkbf's
    if resized:
        print(f"{tag}: set indices {set_indices}; the FPR resize rebuilt the rpkbf, so no already-set share")
    else:
        lanes = filters._count_nonzero(state.rpkbf)
        print(f"{tag}: set indices {set_indices}, set lanes in the saved rpkbf {lanes}: share of set indices "
              f"whose lane was already set {1 - lanes / set_indices:.6f}")
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
    return launches, report, peak, buffer, stage3


def stage3_report(tag: str, report, probe: "Stage3Probe", out: str, card: str) -> dict:
    """Stage 2b's and stage 3's numbers of a -stage 3 main-path run, and the
    check of its transcripts."""
    store = probe.store
    lengths = check_transcripts(out, report, K)
    r = {
        "fragments": report.num_fragments, "rebuild_s": probe.times["rebuild"],
        "rebuild_fragments_per_s": report.num_fragments / probe.times["rebuild"],
        "stage3_batches": store.batches, "stage3_fragments": store.fragments, "stage3_s": probe.times["stage3"],
        "stage3_fragments_per_s": store.fragments / probe.times["stage3"],
        "transcripts": report.num_transcripts, "short": report.num_short, "spans": report.stage3_spans,
        "nr": report.num_nr, "nr_s": report.stage3_spans["nr"],
        "nr_fa_bytes": os.path.getsize(os.path.join(out, "rnabloom.transcripts.nr.fa")),
        "rebuild_launches": probe.launches["rebuild"], "stage3_launches": probe.launches["stage3"],
        "greedy_uses": dict(probe.uses),
    }
    print(f"{tag}: stage 2b {r['rebuild_fragments_per_s']:.1f} fragments/s ({report.num_fragments} fragments, "
          f"{r['rebuild_s']:.2f} s); stage 3 in batches of 2048: {store.batches} batches, "
          f"{store.fragments} fragments in {r['stage3_s']:.2f} s, {r['stage3_fragments_per_s']:.1f} fragments/s "
          f"[{card}]")
    spans = ", ".join(f"{name} {sec:.2f} s" for name, sec in sorted(report.stage3_spans.items()))
    print(f"{tag}: stage 3 wall time by span: {spans} (screen_rewalk is inside screen; stage3_s "
          f"{report.stage3_s:.2f} s includes the rebuild)")
    print(f"{tag}: transcripts {report.num_transcripts} (mean {np.mean(lengths['transcripts.fa'] or [0]):.1f} "
          f"bases), short {report.num_short}; all well-formed")
    print(f"{tag}: the nr pass (span nr) {r['nr_s']:.2f} s over {report.num_transcripts} transcripts: num_nr "
          f"{report.num_nr} (mean {np.mean(lengths['transcripts.nr.fa'] or [0]):.1f} bases), transcripts.nr.fa "
          f"{r['nr_fa_bytes']} B, well-formed [{card}]")
    print(f"{tag}: launches in stage 2b {r['rebuild_launches']}; in stage 3 {r['stage3_launches']} (set: the "
          f"screen's inserts); greedy walk launches by stage-3 use {r['greedy_uses']}", flush=True)
    assert report.num_transcripts > 0 and store.batches > 0
    s3 = r["stage3_launches"]
    assert s3["walk_pair"] > 0 and s3["walk_greedy"] > 0 and s3["set"] > 0, s3
    assert s3["walk_greedy"] == sum(r["greedy_uses"].values()), (s3, r["greedy_uses"])
    return r


def card_time_report(tag: str, times: list, extend_s: float, card: str) -> dict:
    """Launches and summed card time (CUDA events around each launch, read
    once after the run) per kernel of a main-path run, and a histogram of
    walk_pair's lane counts."""
    out = {}
    for name, size, ms in times:
        r = out.setdefault(name, {"launches": 0, "ms": 0.0, "sizes": {}})
        r["launches"] += 1
        r["ms"] += ms
        r["sizes"][size] = r["sizes"].get(size, 0) + 1
    for name, r in sorted(out.items()):
        print(f"{tag}: card time of {name}: {r['launches']} launches, {r['ms']:.2f} ms in all, "
              f"{r['ms'] / r['launches']:.4f} ms a launch [{card}]")
    pair = out.get("walk_pair", {"ms": 0.0, "sizes": {}})
    hist = ", ".join(f"{lanes} lanes x{n}" for lanes, n in sorted(pair["sizes"].items()))
    print(f"{tag}: walk_pair launches by lane count: {hist}; their card time {pair['ms']:.2f} ms of the "
          f"extend span's {extend_s * 1000:.1f} ms [{card}]", flush=True)
    return {name: {"launches": r["launches"], "ms": r["ms"], "sizes": {str(k): v for k, v in r["sizes"].items()}}
            for name, r in out.items()}


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


def _max_abs_diff(a, b, fields=WALK_FIELDS) -> float:
    """Largest |kernel - plain| over the walk state's fields (inf - inf,
    an unwalked lane's path_min, counts as 0)."""
    return max(
        float((getattr(a, f).double() - getattr(b, f).double()).abs().nan_to_num(0.0).max())
        for f in fields
    )


def _same_state(a, b) -> list:
    return [f for f in WALK_FIELDS if not torch.equal(getattr(a, f), getattr(b, f))]


def walk_tally(st, graph, cfg, wcfg, mc, bd, superstep_hops: int = 64, max_supersteps: int = 64) -> dict:
    """The plain lockstep loop (``extend_walks_plain``), replayed one hop
    at a time with the plain version's own steps, counting per lane what
    the kernel's schedule needs: hops tried, resolves, and cell reads (a
    hop reads 4 k-mers, unless a resolve that advanced came just before it,
    at lookahead >= 2: it read them at its depth 1; a resolve reuses the
    hop's 4 and reads, for each viable candidate, 4 k-mers at depth 1, 16
    at depth 2 and 64 per level past it; num_hash cells a k-mer).
    Dependent read rounds: one a hop that reads, lookahead - 1 a resolve.
    Returns the tallies and the final state."""
    from rnabloom_tpu_torch.graph import dbg

    state = traverse.clone_state(st)
    W, la, h = st.pos.shape[0], wcfg.lookahead, cfg.cbf.num_hash
    hops = torch.zeros(W, dtype=torch.int64, device=st.pos.device)
    resolves, reads, hop_rounds = hops.clone(), hops.clone(), hops.clone()
    reused = torch.zeros(W, dtype=torch.bool, device=st.pos.device)
    per_viable = (4 if la >= 2 else 0) + (16 if la >= 3 else 0) + 64 * max(la - 3, 0)
    floor = torch.clamp(mc, min=1.0)[:, None]
    for _ in range(max_supersteps):
        if not bool(((state.status == traverse.ACTIVE) | (state.status == traverse.BRANCH)).any()):
            break
        for _ in range(superstep_hops):
            active = state.status == traverse.ACTIVE
            if not bool(active.any()):
                break
            hops += active
            reading = active & ~reused
            reads += reading * 4 * h
            hop_rounds += reading
            reused &= ~active
            state = traverse.walk_superstep(state, graph, cfg, wcfg, mc, bd, 1)
        branch = state.status == traverse.BRANCH
        if bool(branch.any()):
            out = traverse._gather_out_codes(state.buf, state.pos, cfg.k)
            _, _, q4 = traverse._successors(cfg, wcfg, state.fh, state.rh, out)
            viable = dbg.get_counts(graph, cfg, q4) >= floor
            resolves += branch
            reads += branch * viable.sum(dim=1) * per_viable * h
            pos0 = state.pos
            state = traverse.resolve_branches(state, graph, cfg, wcfg, mc)
            # the choice is the candidate the lane advanced with: buf[pos0]
            chosen = state.buf.gather(1, torch.clamp(pos0, max=wcfg.max_len - 1).long()[:, None])[:, 0]
            chosen_viable = viable.gather(1, chosen.long()[:, None])[:, 0]
            advanced = branch & (state.pos > pos0)
            reused |= advanced & chosen_viable & (la > 1) & (cfg.k > 1)
    rounds = hop_rounds + resolves * (la - 1)
    return {"state": state, "hops": hops, "resolves": resolves, "reads": reads, "rounds": rounds}


def walk_bound_ms(st, mc, bd, reads: int) -> float:
    """Least time for a walk batch: its cell reads as random sectors, plus
    the walk state read and written once, at the card's memory rate.  The
    arithmetic (hash slides, minima) is far below the card's integer rate."""
    state_bytes = sum(t.numel() * t.element_size() for t in st if t is not None) * 2 + mc.numel() * 4 + bd.numel() * 4
    return (reads * SECTOR + state_bytes) / HBM_BYTES_PER_MS


def walk_vs_plain(graph_prefix: str, left: str, right: str, what: str, card: str, dev, variants: dict) -> dict:
    """Walk kernel (and each ``--walk-variant``) vs plain on the first
    stage-2 batch's bridge seeds."""
    graph, cfg = checkpoint.load_graph(graph_prefix, device=dev)
    seeds = stage2_walk_seeds(left, right, graph, cfg)
    wcfg, _ = fragments.bridge_walk_configs(cfg, fragments.FragmentParams())
    st = traverse.make_walks(cfg, wcfg, seeds, device=dev)
    mc, bd = traverse.lane_args(st, 1.0, fragments.FragmentParams().bound)
    kern = walk.walk_greedy(st, graph, cfg, wcfg, mc, bd)
    plain = None

    def plain_run():
        nonlocal plain
        plain = walk.walk_greedy_plain(st, graph, cfg, wcfg, mc, bd)

    # the plain loop's equality run is its first timing turn
    t = {"plain": [_time_ms(plain_run, reps=1)]}
    bad = _same_state(kern, plain)
    if bad:
        raise AssertionError(f"walk_greedy != plain on {what}: {bad} differ")
    tally = walk_tally(st, graph, cfg, wcfg, mc, bd)
    bad = _same_state(tally["state"], plain)
    if bad:
        raise AssertionError(f"the tallied replay of the plain loop differs on {what}: {bad}")
    # the lane with the most dependent read rounds, walked alone
    w = int(torch.argmax(tally["rounds"]))
    one = traverse.take_lanes(st, slice(w, w + 1))
    one_mc, one_bd = mc[w : w + 1].contiguous(), bd[w : w + 1].contiguous()
    alone = walk.walk_greedy(one, graph, cfg, wcfg, one_mc, one_bd)
    bad = [f for f in WALK_FIELDS if not torch.equal(getattr(alone, f), getattr(kern, f)[w : w + 1])]
    if bad:
        raise AssertionError(f"lane {w} walked alone differs from its batch run: {bad}")

    def call(name, state, lane_mc, lane_bd):
        with walk_library(variants[name]) if name in variants else contextlib.nullcontext():
            return walk.walk_greedy(state, graph, cfg, wcfg, lane_mc, lane_bd)

    for name in variants:
        bad = _same_state(call(name, st, mc, bd), plain)
        torch.cuda.synchronize()
        if bad:
            raise AssertionError(f"walk variant {name} != plain on {what}: {bad} differ")
    builds = ["kernel", *variants]
    t.update({who: [] for who in builds})
    lane_t = {who: [] for who in builds}
    for who in (*builds, *builds[::-1], "plain"):
        if who == "plain":
            t[who].append(_time_ms(lambda: walk.walk_greedy_plain(st, graph, cfg, wcfg, mc, bd), reps=1))
            continue
        t[who].append(_time_ms(lambda: call(who, st, mc, bd), reps=5))
        lane_t[who].append(_time_ms(lambda: call(who, one, one_mc, one_bd), reps=5))
    status = torch.bincount(kern.status.long(), minlength=7).tolist()
    reads = int(tally["reads"].sum())
    # the card's random-read rate: one gather of as many uniformly random
    # cells of the same table as the batch reads
    idx = torch.randint(0, graph.cbf.numel(), (reads,), device=dev)
    graph.cbf[idx]
    gather_ms = min(_time_ms(lambda: graph.cbf[idx], reps=3) for _ in range(3))
    del idx
    r = {
        "max_abs_err": _max_abs_diff(kern, plain), "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2,
        "lanes": int(st.pos.shape[0]), "seeds": int(seeds.shape[0]), "seed_rows": seeds,
        "hops": int(kern.hops.sum()), "max_hops": int(kern.hops.max()),
        "hops_tried": int(tally["hops"].sum()), "resolves": int(tally["resolves"].sum()),
        "cell_reads": reads, "bound_ms": walk_bound_ms(st, mc, bd, reads), "gather_ms": gather_ms,
        "longest_lane": w, "longest_lane_rounds": int(tally["rounds"][w]),
        "longest_lane_hops": int(tally["hops"][w]), "longest_lane_resolves": int(tally["resolves"][w]),
        "longest_lane_ms": min(lane_t["kernel"]),
        "variants": {name: {"ms": sum(t[name]) / 2, "longest_lane_ms": min(lane_t[name])} for name in variants},
    }
    print(f"walk_greedy ({what}): {r['seeds']} bridge seeds in {r['lanes']} lanes, max_len {wcfg.max_len}, "
          f"lookahead {wcfg.lookahead}; every WalkState field equal to plain; {r['hops']} hops (max "
          f"{r['max_hops']}), statuses {status}; per call: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms [{card}]", flush=True)
    print(f"walk_greedy ({what}): the batch needs {r['hops_tried']} hops tried, {r['resolves']} resolves, "
          f"{reads} cell reads ({reads * SECTOR} B as {SECTOR} B sectors): bound {r['bound_ms']:.4f} ms at "
          f"3.35 TB/s; one gather of as many random cells of the {graph.cbf.numel()}-cell table "
          f"{gather_ms:.4f} ms; longest lane {w}: {r['longest_lane_rounds']} dependent read rounds "
          f"({r['longest_lane_hops']} hops, {r['longest_lane_resolves']} resolves), walked alone "
          f"{r['longest_lane_ms']:.4f} ms [{card}]", flush=True)
    for name, v in r["variants"].items():
        print(f"walk variant {name} ({what}): every WalkState field equal to plain; per call "
              f"{v['ms']:.4f} ms ({', '.join(f'{x:.4f}' for x in t[name])}), the kernel's "
              f"{', '.join(f'{x:.4f}' for x in t['kernel'])}; longest lane alone {v['longest_lane_ms']:.4f} ms "
              f"[{card}]", flush=True)
    del graph, kern, plain, st, tally
    torch.cuda.empty_cache()
    return r


def rebuild_card_vs_cpu(gpu_out: str, cpu_out: str, counter: str) -> dict:
    """Stage 2b on a -stage 2 output on the card and on the CPU; the rebuilt
    filters, saved as checkpoints, must be byte-identical.  Returns the
    card's insert launches."""
    ci.reset_launch_counts()
    for out, dev in ((gpu_out, "cuda"), (cpu_out, "cpu")):
        state, cfg = checkpoint.load_graph(os.path.join(out, "rnabloom.graph"), device=dev)
        rebuilt = pipeline.rebuild_fragment_graph(state, cfg, FragmentStore.open(out), pipeline.PipelineParams())
        checkpoint.save_graph(os.path.join(out, "rebuilt"), engine.to_host_state(rebuilt, cfg), cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = ci.launch_counts()
    for f in REBUILT_FILES:
        if not filecmp.cmp(os.path.join(gpu_out, f), os.path.join(cpu_out, f), shallow=False):
            raise AssertionError(f"-cnt {counter}: stage 2b's {f} differs between card and CPU")
    assert launches["set"] > 0 and launches[{"mf8": "add_mf8", "u16": "add_u16"}[counter]] > 0, launches
    return launches


def sample_fragments(store: FragmentStore, n: int, width: int, seed: int) -> np.ndarray:
    """(n, width) codes of n fragments of the store drawn at random (seeded),
    read in priority order."""
    picks = np.sort(np.random.default_rng(seed).choice(store.count, min(n, store.count), replace=False))
    rows, i = [], 0
    for codes, lens, _, _ in store.iter_batches(4096, width=width):
        live = np.flatnonzero(lens > 0)
        hit = picks[(picks >= i) & (picks < i + len(live))] - i
        rows.append(codes[live[hit]])
        i += len(live)
    return np.concatenate(rows)


def rebuild_main_path(out: str, card: str, dev):
    """Stage 2b on phase 3's -stage 2 output, on the card: rate, batches,
    launches, insert buffer and peak device memory of that run alone, and
    the count-min check on the rebuilt cbf."""
    state, cfg = checkpoint.load_graph(os.path.join(out, "rnabloom.graph"), device=dev)
    store = FragmentStore.open(out)
    params = pipeline.PipelineParams()
    frag_L = int(min(max(store.max_len, 2 * cfg.k), params.max_walk_len))
    ci._batch_tables.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    d0 = engine.dispatch_counts()["build"]
    t0 = time.time()
    rebuilt = pipeline.rebuild_fragment_graph(state, cfg, store, params)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    batches = engine.dispatch_counts()["build"] - d0
    peak = torch.cuda.max_memory_allocated()
    table = ci.batch_table_bytes()
    nbytes = lambda t: 0 if t is None else t.numel() * t.element_size()  # noqa: E731
    r = {
        "fragments": store.count, "frag_L": frag_L, "batches": batches, "seconds": elapsed,
        "fragments_per_s": store.count / elapsed, "peak_bytes": peak, "held_bytes": held,
        "batch_table_bytes": table,
        "batch_indices": 1024 * (frag_L - cfg.k + 1) * cfg.cbf.num_hash,
    }
    print(f"stage 2b: {store.count} fragments (max length {store.max_len}, rows of {frag_L}) in {batches} batches "
          f"of 1024: {elapsed:.2f} s, {r['fragments_per_s']:.1f} fragments/s; fragment pairs added: "
          f"{frag_L - cfg.k + 1 > cfg.fragment_pair_distance} (d_frag {cfg.fragment_pair_distance}) [{card}]",
          flush=True)
    print(f"stage 2b: a batch is up to {r['batch_indices']} cbf indices (1024 x {frag_L - cfg.k + 1} k-mers x "
          f"{cfg.cbf.num_hash}); add_mf8's batch table {table} B ({table / 2**20:.1f} MiB; the L2 holds 50 MB)")
    print(f"stage 2b: peak device memory {peak} B ({peak / 2**30:.3f} GiB); held before: {held} B, the stage-2 "
          f"graph (cbf {nbytes(state.cbf)} B, rpkbf {nbytes(state.rpkbf)} B, and the decode/walk tables); the "
          f"rebuild adds the zeroed cbf ({nbytes(rebuilt.cbf)} B, held beside the stage-2 cbf, which the caller "
          f"still references), the fpkbf ({nbytes(rebuilt.fpkbf)} B), the batch table and one batch's hashes and "
          f"indices; rpkbf shared: {rebuilt.rpkbf is state.rpkbf}", flush=True)
    del state
    sample = sample_fragments(store, 10_000, frag_L, seed=2)
    counts, valid = engine.count_step(rebuilt, cfg, sample)
    counts, valid = counts.cpu(), valid.cpu()
    assert bool(valid.any()) and bool((counts[valid] >= 1).all()), "stage 2b: a k-mer of a stored fragment counts 0"
    print(f"stage 2b: count-min check: {int(valid.sum())} valid k-mers of {sample.shape[0]} sampled fragments all "
          f"count >= 1 (min {float(counts[valid].min())})", flush=True)
    return rebuilt, cfg, store, r


def stage3_batches(store: FragmentStore, n: int, width: int) -> list:
    """Stage 3's fragment batches in its own order (``iter_batches(n)``:
    one stratum at a time in priority order, each stratum's last batch
    padded), up to and including the first full one, as (stratum, codes
    (n, width), lens)."""
    keys = store._ordered_keys()
    assert sum(len(store._covs[key]) for key in keys) == store.count
    strata = [key for key in keys for _ in range(-(-len(store._covs[key]) // n))]
    out = []
    for key, (codes, lens, _, _) in zip(strata, store.iter_batches(n, width=width)):
        out.append((key, codes, lens))
        if bool((lens > 0).all()):
            return out
    raise AssertionError(f"no stratum holds {n} fragments")


def pair_tally(st, graph, cfg, wcfg, mc, bd) -> dict:
    """The plain pair loop replayed one hop at a time with the plain
    version's own steps, counting per lane what two schedules of the kernel
    read and how many dependent rounds they take.

    Both read num_hash cells a k-mer, and the pkbf lanes (pkbf num_hash a
    key) of every live probe depth whose partner is in the ring, plus the
    ring entry of each such partner.  Reads the plain loop needs (the
    bound): 4 k-mers a hop (not after a resolve that advanced: read at its
    probe step 1), the 4 successors of every live probe at each step.

    The one-step schedule (``old``): a hop that reads is a round; a resolve is D +
    1 rounds (the first partner, D - 1 steps, the last lookups).

    This schedule (``new``): a hop that reads also reads the candidates'
    16 children, and a hop that advances hands its choice's children to
    the next hop, which costs no round; a resolve takes step 1 from the
    children when it has them, then two steps a round (the 4 successors of
    each live probe and their 16 children), then a round of last lookups; a
    resolve that advances hands on step 1's counts, and the children of
    step 1 when its first round took steps 1 and 2.  Returns the tallies
    and the final state."""
    state = traverse.clone_state(st)
    h, k, D, R = cfg.cbf.num_hash, cfg.k, wcfg.pair_probe_depth, wcfg.pair_ring
    W, dev = st.pos.shape[0], st.pos.device
    zero = torch.zeros(W, dtype=torch.int64, device=dev)
    hops, resolves, cells, lanes, ring_reads = zero.clone(), zero.clone(), zero.clone(), zero.clone(), zero.clone()
    old_rounds, new_rounds, new_cells, free_hops, res_rounds = (zero.clone() for _ in range(5))
    reused = torch.zeros(W, dtype=torch.bool, device=dev)
    cached, kids = reused.clone(), reused.clone()
    classes = [d for d, t in ((cfg.read_pair_distance, graph.rpkbf), (cfg.fragment_pair_distance, graph.fpkbf))
               if t is not None and d > 0]
    j = torch.arange(D, device=dev)
    for _ in range(64):
        if not bool(((state.status == traverse.ACTIVE) | (state.status == traverse.BRANCH)).any()):
            break
        for _ in range(64):
            active = state.status == traverse.ACTIVE
            if not bool(active.any()):
                break
            hops += active
            cells += (active & ~reused) * 4 * h
            old_rounds += active & ~reused
            reused &= ~active
            read = active & ~cached
            new_rounds += read
            new_cells += read * 20 * h
            free_hops += active & cached
            kids |= read
            cached |= read
            pos0 = state.pos
            state = traverse.walk_superstep(state, graph, cfg, wcfg, mc, bd, 1)
            adv = active & (state.pos > pos0)
            cached = torch.where(adv, kids, cached)
            kids &= ~adv
        branch = state.status == traverse.BRANCH
        if bool(branch.any()):
            out = traverse._gather_out_codes(state.buf, state.pos, k)
            fh4, rh4, q4 = traverse._successors(cfg, wcfg, state.fh, state.rh, out)
            alive_p = traverse._probe_with_hashes(graph, cfg, wcfg, state.buf, state.pos, fh4, rh4, q4, mc)[3]
            resolves += branch
            cells += branch * alive_p[..., : D - 1].sum(dim=(1, 2)) * 4 * h
            old_rounds += branch * (D + 1)
            read = branch & ~cached
            new_rounds += read
            new_cells += read * 20 * h
            kids |= read
            entry_kids = kids.clone()
            # rounds of two steps from step 2 (step 1 from the children) or 1
            live = alive_p.sum(dim=1)  # (W, D): live probes at each depth
            for j0, lanes_of in ((1, entry_kids & (D > 1)), (0, ~(entry_kids & (D > 1)))):
                sel = branch & lanes_of
                steps = D - 1 - j0
                n_rounds = (steps + 1) // 2 + 1
                new_rounds += sel * n_rounds
                res_rounds += sel * n_rounds
                for jj in range(j0 + 1, D, 2):
                    new_cells += sel * live[:, jj - 1] * (20 if jj + 1 < D else 4) * h
            for dist in classes:
                end = state.pos.long()[:, None] - dist + j
                reach = (end >= k - 1) & (state.pos.long()[:, None] - end < R)  # (W, D)
                lanes += branch * (alive_p & reach[:, None, :]).sum(dim=(1, 2)) * cfg.pkbf.num_hash
                ring_reads += branch * reach.sum(dim=1) * 2
            pos0 = state.pos
            state = traverse.resolve_branches(state, graph, cfg, wcfg, mc, mode="pair")
            adv = branch & (state.pos > pos0)
            reused |= adv & (D > 1) & (k > 1)
            cached = torch.where(branch, adv & (entry_kids | (D > 1)), cached)
            kids = torch.where(branch, adv & ~entry_kids & (D > 2), kids)
    return {"state": state, "hops": hops, "resolves": resolves, "cells": cells, "lanes": lanes,
            "ring_reads": ring_reads, "old_rounds": old_rounds, "new_rounds": new_rounds, "new_cells": new_cells,
            "free_hops": free_hops, "resolve_rounds": res_rounds}


def dependent_read_ns(lib: ctypes.CDLL, table: torch.Tensor, cells: int = 0, threads: int = 1,
                      chains: int = 1) -> float:
    """The card's latency of a round of dependent random reads of the first
    ``cells`` bytes of ``table`` (a power of two; default: all of a
    power-of-two table plus its trash cell), ``threads`` x ``chains``
    reads in flight from one SM (``tools/dependent_read.cu``): the
    difference of a long and a short run over their difference in rounds,
    best of 3."""
    out = torch.zeros(1, dtype=torch.int64, device=table.device)
    stream = torch.cuda.current_stream().cuda_stream
    mask = (cells or 1 << (table.numel().bit_length() - 1)) - 1

    def run(steps):
        err = lib.dependent_read(table.data_ptr(), mask, steps, 12345, out.data_ptr(), threads, chains, stream)
        if err:
            raise RuntimeError(f"dependent_read launch failed: cudaError_t {err}")

    run(1000)
    long_ms = min(_time_ms(lambda: run(20_000), reps=1) for _ in range(3))
    short_ms = min(_time_ms(lambda: run(2_000), reps=1) for _ in range(3))
    return (long_ms - short_ms) * 1e6 / 18_000


def pair_vs_plain(graph, cfg, store: FragmentStore, card: str, dev, variants: dict, chase) -> dict:
    """The stage-3 extension on the rebuilt graph: ``extend_fragments_pair``
    on stage 3's batches in its order up to the first full one (the main
    path's launches).  On that full batch, each of its walks (right; left
    from the kernel's right walks) by the kernel and once by the plain
    loop, every field equal; on it and on the first batch the right walks
    by each ``--walk-variant`` too, equal to the plain loop, and the times
    of the kernel and the variants in turns (the plain loop's equality
    run is its turn); a replay of the plain loop (``pair_tally``, its
    reads, the bound, both schedules' rounds) that must end in the plain
    loop's state; the lane with the most rounds walked alone, beside the
    card's latency of one dependent read; the gather yardstick."""
    params, tparams = pipeline.PipelineParams(), transcripts.TranscriptParams()
    width = int(min(max(store.max_len, cfg.k), params.max_walk_len))
    batches = stage3_batches(store, params.stage3_batch, width)
    ext_len = None
    for i, (key, frags, lens) in enumerate(batches):
        t0 = time.time()
        _, ext_len, _, _ = transcripts.extend_fragments_pair(graph, cfg, frags, lens, tparams)
        live = lens > 0
        assert (ext_len[live] >= lens[live]).all()
        print(f"walk_pair: extend_fragments_pair on stage 3's batch {i} (stratum {key}, {int(live.sum())} "
              f"fragments in {frags.shape[0]} lanes, rows of {width}): {time.time() - t0:.3f} s; extended lengths "
              f"{int(ext_len[live].min())}-{int(ext_len[live].max())}, mean {float(ext_len[live].mean()):.1f} "
              f"[{card}]", flush=True)
    launches = walk.launch_counts()["walk_pair"]
    assert launches == 2 * len(batches), launches

    def wcfg(left):
        return traverse.WalkConfig(max_len=tparams.max_walk_len, pair_ring=tparams.pair_ring, left=left,
                                   lookahead=tparams.lookahead)

    def right_walks(frags, lens):
        st = traverse.make_walks(cfg, wcfg(False), frags, lens, device=dev)
        return (st, *traverse.lane_args(st, 1.0, tparams.bound))

    def call(who, st, lane_mc, lane_bd):
        with walk_library(variants[who]) if who in variants else contextlib.nullcontext():
            return walk.walk_pair(st, graph, cfg, wcfg(False), lane_mc, lane_bd)

    def check(who, got, want, what):
        torch.cuda.synchronize()
        bad = [f for f in PAIR_FIELDS if not torch.equal(getattr(got, f), getattr(want, f))]
        if bad:
            raise AssertionError(f"walk_pair ({who}) != plain on {what}: {bad} differ")

    first, first_mc, first_bd = right_walks(*batches[0][1:])
    live0 = batches[0][2] > 0
    small, small_mc, small_bd = right_walks(batches[0][1][live0], batches[0][2][live0])  # padded to 2^j >= 64
    key, frags, lens = batches[-1]
    right, mc, bd = right_walks(frags, lens)
    kern_r = walk.walk_pair(right, graph, cfg, wcfg(False), mc, bd)
    left = traverse.revcomp_reseed(cfg, wcfg(True), kern_r.buf, kern_r.pos)
    kern_l = walk.walk_pair(left, graph, cfg, wcfg(True), mc, bd)
    plain_r = None

    def plain_right():
        nonlocal plain_r
        plain_r = walk.walk_pair_plain(right, graph, cfg, wcfg(False), mc, bd)

    builds = ["kernel", *variants]
    t = {who: [] for who in builds}
    t_first = {who: [] for who in builds}
    t_small = {who: [] for who in builds}
    t["plain"] = [_time_ms(plain_right, reps=1)]
    t0 = time.time()
    plain_first = walk.walk_pair_plain(first, graph, cfg, wcfg(False), first_mc, first_bd)
    plain_first_s = time.time() - t0
    plain_small = walk.walk_pair_plain(small, graph, cfg, wcfg(False), small_mc, small_bd)
    for who in builds:
        check(who, call(who, right, mc, bd), plain_r, "the right walks of stage 3's first full batch")
        check(who, call(who, first, first_mc, first_bd), plain_first, "the right walks of stage 3's batch 0")
        check(who, call(who, small, small_mc, small_bd), plain_small, "batch 0's fragments alone")
    for who in (*builds, *builds[::-1]):
        t[who].append(_time_ms(lambda: call(who, right, mc, bd), reps=5))
        t_first[who].append(_time_ms(lambda: call(who, first, first_mc, first_bd), reps=5))
        t_small[who].append(_time_ms(lambda: call(who, small, small_mc, small_bd), reps=5))
    t0 = time.time()
    plain_l = walk.walk_pair_plain(left, graph, cfg, wcfg(True), mc, bd)
    torch.cuda.synchronize()
    plain_left_s = time.time() - t0
    for what, kern, plain in (("right", kern_r, plain_r), ("left", kern_l, plain_l)):
        check("kernel", kern, plain, f"the {what} walks of stage 3's first full batch")
    # the main path's extension of this batch equals what the separate walks give
    assert torch.equal(kern_l.pos.cpu()[: frags.shape[0]], torch.from_numpy(ext_len.astype(np.int32)))
    t0 = time.time()
    tally = pair_tally(right, graph, cfg, wcfg(False), mc, bd)
    tally_s = time.time() - t0
    bad = [f for f in PAIR_FIELDS if not torch.equal(getattr(tally["state"], f), getattr(plain_r, f))]
    if bad:
        raise AssertionError(f"the tallied replay of the plain pair loop differs: {bad}")
    # the lane with the most dependent rounds under this schedule, walked alone
    w = int(torch.argmax(tally["new_rounds"]))
    one = traverse.take_lanes(right, slice(w, w + 1))
    one_mc, one_bd = mc[w : w + 1].contiguous(), bd[w : w + 1].contiguous()
    lane_ms = {}
    for who in builds:
        alone = call(who, one, one_mc, one_bd)
        torch.cuda.synchronize()
        bad = [f for f in PAIR_FIELDS if not torch.equal(getattr(alone, f), getattr(plain_r, f)[w : w + 1])]
        if bad:
            raise AssertionError(f"walk_pair ({who}): lane {w} walked alone differs from the plain loop: {bad}")
    for who in (*builds, *builds[::-1]):
        lane_ms.setdefault(who, []).append(_time_ms(lambda: call(who, one, one_mc, one_bd), reps=5))
    read_ns = dependent_read_ns(chase, graph.cbf)
    cells, pk_lanes = int(tally["cells"].sum()), int(tally["lanes"].sum())
    state_bytes = sum(x.numel() * x.element_size() for x in right if x is not None) * 2 + 8 * mc.numel()
    bound_ms = ((cells + pk_lanes) * SECTOR + state_bytes) / HBM_BYTES_PER_MS
    idx_c = torch.randint(0, graph.cbf.numel(), (cells,), device=dev)
    idx_p = torch.randint(0, graph.fpkbf.numel(), (max(pk_lanes, 1),), device=dev)
    gather = lambda: (graph.cbf[idx_c], graph.fpkbf[idx_p])  # noqa: E731
    gather()
    gather_ms = min(_time_ms(gather, reps=3) for _ in range(3))
    del idx_c, idx_p
    status = torch.bincount(kern_r.status.long(), minlength=7).tolist()
    lane_rounds = {name: int(tally[f"{name}_rounds"][w]) for name in ("old", "new")}
    r = {
        "lanes": int(right.pos.shape[0]), "batches": len(batches), "batch": len(batches) - 1, "stratum": key,
        "plain_left_s": plain_left_s, "tally_s": tally_s, "plain_first_s": plain_first_s,
        "ms": _mean(t["kernel"]), "plain_ms": t["plain"][0], "bound_ms": bound_ms, "gather_ms": gather_ms,
        "cells": cells, "pkbf_lanes": pk_lanes, "ring_reads": int(tally["ring_reads"].sum()),
        "new_cells": int(tally["new_cells"].sum()),
        "hops": int(tally["hops"].sum()), "resolves": int(tally["resolves"].sum()),
        "free_hops": int(tally["free_hops"].sum()),
        "max_hops": int(kern_r.hops.max()), "launches": launches,
        "first_fragments": int(live0.sum()), "first_ms": _mean(t_first["kernel"]),
        "small_lanes": int(small.pos.shape[0]), "small_ms": _mean(t_small["kernel"]),
        "max_abs_err": max(_max_abs_diff(kern_r, plain_r, PAIR_FIELDS), _max_abs_diff(kern_l, plain_l, PAIR_FIELDS)),
        "rounds_old": int(tally["old_rounds"].sum()), "rounds_new": int(tally["new_rounds"].sum()),
        "longest_lane": w, "longest_lane_rounds": lane_rounds["new"], "longest_lane_rounds_old": lane_rounds["old"],
        "longest_lane_hops": int(tally["hops"][w]), "longest_lane_free_hops": int(tally["free_hops"][w]),
        "longest_lane_resolves": int(tally["resolves"][w]),
        "longest_lane_resolve_rounds": int(tally["resolve_rounds"][w]),
        "longest_lane_ms": min(lane_ms["kernel"]), "dependent_read_ns": read_ns,
        "round_ns": min(lane_ms["kernel"]) * 1e6 / max(lane_rounds["new"], 1),
        "variants": {who: {"ms": _mean(t[who]), "first_ms": _mean(t_first[who]), "small_ms": _mean(t_small[who]),
                           "longest_lane_ms": min(lane_ms[who]),
                           "round_ns_old_schedule": min(lane_ms[who]) * 1e6 / max(lane_rounds["old"], 1)}
                     for who in variants},
    }
    print(f"walk_pair: stage 3's batch {r['batch']}, the first full one ({r['lanes']} fragments of stratum {key}): "
          f"right and left walks (max_len {tparams.max_walk_len}, ring {tparams.pair_ring}, probe depth 24, bound "
          f"{tparams.bound}) equal to the plain loop in every field incl. the ring (plain left walks "
          f"{plain_left_s:.1f} s, replay {tally_s:.1f} s); right-walk statuses {status}", flush=True)
    print(f"walk_pair (right walks of that batch): kernel {r['ms']:.4f} ms ({', '.join(f'{x:.4f}' for x in t['kernel'])}), "
          f"plain {r['plain_ms']:.2f} ms; the batch needs {r['hops']} hops, {r['resolves']} pair resolves, {cells} cbf "
          f"cell reads, {pk_lanes} pkbf lane reads, {r['ring_reads']} ring entries: bound {bound_ms:.4f} ms "
          f"({SECTOR} B a cell or lane, state and ring {state_bytes} B, at 3.35 TB/s); this schedule reads "
          f"{r['new_cells']} cbf cells ({r['new_cells'] / max(cells, 1):.2f} times); one gather of as many random "
          f"cbf cells and fpkbf lanes as the bound counts {gather_ms:.4f} ms [{card}]", flush=True)
    print(f"walk_pair (right walks of stage 3's batch 0, stratum {batches[0][0]}, {r['first_fragments']} fragments in "
          f"{first.pos.shape[0]} lanes): kernel {r['first_ms']:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in t_first['kernel'])}); equal to the plain loop ({plain_first_s:.1f} s); "
          f"those fragments alone in {r['small_lanes']} lanes {r['small_ms']:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in t_small['kernel'])}) [{card}]", flush=True)
    print(f"walk_pair rounds: the batch's lanes take {r['rounds_old']} dependent rounds in all under the one-step schedule "
          f"(a hop that reads 1, a resolve D + 1) and {r['rounds_new']} under this one ({r['free_hops']} of "
          f"{r['hops']} hops cost no round); longest lane {w}: {r['longest_lane_hops']} hops "
          f"({r['longest_lane_free_hops']} free), {r['longest_lane_resolves']} resolves "
          f"({r['longest_lane_resolve_rounds']} rounds), {lane_rounds['new']} rounds (one-step schedule "
          f"{lane_rounds['old']}), walked alone {r['longest_lane_ms']:.4f} ms: {r['round_ns']:.1f} ns a round; one "
          f"dependent random read of the {graph.cbf.numel()}-cell cbf {read_ns:.1f} ns [{card}]", flush=True)
    for who, v in r["variants"].items():
        print(f"walk variant {who} (pair walks): equal to the plain loop on all three; full batch {v['ms']:.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in t[who])}), batch 0 {v['first_ms']:.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in t_first[who])}), its fragments alone {v['small_ms']:.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in t_small[who])}); longest lane alone {v['longest_lane_ms']:.4f} ms "
              f"({v['round_ns_old_schedule']:.1f} ns a round of the one-step schedule) [{card}]", flush=True)
    return r


def greedy_vs_plain(walks: list, what: str, card: str, dev, variants: dict) -> dict:
    """Each captured greedy walk (kind, state, graph, cfg, wcfg, min_cov,
    bound) by the kernel, by each ``--walk-variant`` and by the plain loop,
    every field equal; the largest one (lanes x max_len) timed in turns
    (kernel, variants, variants, kernel), replayed by ``walk_tally`` (which
    must end in the plain loop's state) for its reads and bound, and beside
    it one gather of as many random cells of its table."""
    builds = ["kernel", *variants]

    def call(who, st, graph, cfg, wcfg, mc, bd):
        with walk_library(variants[who]) if who in variants else contextlib.nullcontext():
            return walk.walk_greedy(st, graph, cfg, wcfg, mc, bd)

    err = 0.0
    for _, st, graph, cfg, wcfg, mc, bd in walks:
        plain = walk.walk_greedy_plain(st, graph, cfg, wcfg, mc, bd)
        for who in builds:
            kern = call(who, st, graph, cfg, wcfg, mc, bd)
            torch.cuda.synchronize()
            bad = _same_state(kern, plain)
            if bad:
                raise AssertionError(f"walk_greedy ({who}) != plain on {what}: {bad} differ")
            err = max(err, _max_abs_diff(kern, plain))
    _, st, graph, cfg, wcfg, mc, bd = max(walks, key=lambda w: w[1].pos.shape[0] * w[4].max_len)
    kernel = lambda: walk.walk_greedy(st, graph, cfg, wcfg, mc, bd)  # noqa: E731
    plain_fn = lambda: walk.walk_greedy_plain(st, graph, cfg, wcfg, mc, bd)  # noqa: E731
    t = {"plain": [_time_ms(plain_fn, reps=1)], **{who: [] for who in builds}}
    for who in (*builds, *builds[::-1]):
        t[who].append(_time_ms(lambda: call(who, st, graph, cfg, wcfg, mc, bd), reps=5))
    tally = walk_tally(st, graph, cfg, wcfg, mc, bd)
    plain = plain_fn()
    bad = _same_state(tally["state"], plain)
    if bad:
        raise AssertionError(f"the tallied replay of the plain loop differs on {what}: {bad}")
    reads = int(tally["reads"].sum())
    idx = torch.randint(0, graph.cbf.numel(), (max(reads, 1),), device=dev)
    graph.cbf[idx]
    gather_ms = min(_time_ms(lambda: graph.cbf[idx], reps=3) for _ in range(3))
    kern = kernel()
    r = {
        "walks": len(walks), "lanes": int(st.pos.shape[0]), "max_len": wcfg.max_len, "max_abs_err": err,
        "ms": sum(t["kernel"]) / 2, "plain_ms": t["plain"][0], "cell_reads": reads,
        "bound_ms": walk_bound_ms(st, mc, bd, reads), "gather_ms": gather_ms,
        "hops": int(kern.hops.sum()), "resolves": int(tally["resolves"].sum()),
        "table_cells": int(graph.cbf.numel()), "layout": cfg.cbf.dtype, "num_hash": cfg.cbf.num_hash,
        "variants": {who: {"ms": _mean(t[who])} for who in variants},
    }
    print(f"walk_greedy ({what}): {len(walks)} walk batches, every field equal to the plain loop; the largest, "
          f"{r['lanes']} lanes of max_len {r['max_len']} ({r['layout']} table of {r['table_cells']} cells, "
          f"{r['num_hash']} hashes): kernel {r['ms']:.4f} ms ({', '.join(f'{x:.4f}' for x in t['kernel'])}), plain "
          f"{r['plain_ms']:.2f} ms; {r['hops']} hops, {r['resolves']} resolves, {reads} cell reads: bound "
          f"{r['bound_ms']:.4f} ms at 3.35 TB/s; one gather of as many random cells {gather_ms:.4f} ms [{card}]",
          flush=True)
    for who in variants:
        print(f"walk variant {who} ({what}): equal to the plain loop on every batch; the largest {_mean(t[who]):.4f} "
              f"ms ({', '.join(f'{x:.4f}' for x in t[who])}) [{card}]", flush=True)
    return r


def stage3_walks_vs_plain(graph, cfg, store: FragmentStore, card: str, dev, variants: dict) -> dict:
    """Stage 3's greedy walks on the rebuilt phase-3 graph: stage 3's
    batches in its own order on a fresh screen (as the main path ran them),
    up to the first batch that issues gap re-walks; that batch's gap
    re-walks (and tip probes) by the kernel and the plain loop.  Then that
    batch and the next ones again, each from the screen it started with,
    with -maxclip, for the depth probes on the graph and on the screen as an
    mf8 graph, up to the first batch whose screen probe walks at least one
    hop (else the first whose screen probe ran at all)."""
    params = pipeline.PipelineParams()
    tparams = pipeline._transcript_params(cfg, params)
    clip = pipeline._transcript_params(cfg, pipeline.PipelineParams(max_edge_clip=MAXCLIP))
    scfg = filters.BloomConfig(cfg.pkbf.size_log2, cfg.pkbf.num_hash)
    screen = filters.make_bloom(scfg, device=dev)
    width = int(min(max(store.max_len, cfg.k), params.max_walk_len))
    probe = Stage3Probe(capture=True)
    found, first_screen = {}, None
    with probe.installed():
        for i, (sel, lens, covs, _) in enumerate(store.iter_batches(params.stage3_batch, width=width)):
            gate = pipeline._stratum_gate(params, covs, lens)
            before = screen.clone()
            probe.captured.clear()
            transcripts.assemble_transcripts_batch(graph, cfg, screen, scfg, sel, lens, tparams, gate)
            if "gap_rewalk" not in found and any(w[0] == "gap_rewalk" for w in probe.captured):
                found["gap_rewalk"] = (i, list(probe.captured))
            if "gap_rewalk" in found and "screen" not in found:
                probe.captured.clear()
                transcripts.assemble_transcripts_batch(graph, cfg, before, scfg, sel, lens, clip, gate)
                screens = [w[1:] for w in probe.captured if w[0] == "screen"]
                if screens:
                    first_screen = first_screen or (i, list(probe.captured))
                    if any(int(walk.walk_greedy(*w).hops.sum()) > 0 for w in screens):
                        found["screen"] = (i, list(probe.captured))
            del before
            if len(found) == 2:
                break
    if "screen" not in found and first_screen is not None:
        print("walk_greedy (the screen as a graph): no batch's screen probe walked a hop; checking the first that ran",
              flush=True)
        found["screen"] = first_screen
    assert set(found) == {"gap_rewalk", "screen"}, f"stage 3's batches reached only {sorted(found)}"
    (gi, gap), (si, probes) = found["gap_rewalk"], found["screen"]
    out = {"gap_batch": gi, "probe_batch": si}
    out["gap_rewalk"] = greedy_vs_plain([w for w in gap if w[0] == "gap_rewalk"],
                                        f"gap re-walks of stage 3's batch {gi}", card, dev, variants)
    tips = [w for w in gap + probes if w[0] == "probe"]
    out["probe"] = greedy_vs_plain(tips, f"tip and depth probes of stage 3's batches {gi}, {si} (-maxclip {MAXCLIP})",
                                   card, dev, variants)
    out["screen"] = greedy_vs_plain([w for w in probes if w[0] == "screen"],
                                    f"the screen as a graph, batch {si} with -maxclip {MAXCLIP}", card, dev, variants)
    return out


def golden_on_card(tmp: str, card: str) -> list:
    """The repo's golden dataset through the port's ``assemble_pe`` on the
    card, with the golden run's parameters: the strand-normalised sha1 set
    of transcripts.fa must equal ``tests/golden/pe_golden.json``."""
    import hashlib

    d = os.path.join(tmp, "golden")
    os.makedirs(d)
    left, right = pesim.write_golden_fastq(d)
    params = pipeline.PipelineParams(total_mem_bytes=1 << 22, batch_size=256, sample_size=100, no_reduce=True)
    report = pipeline.assemble_pe(left, right, os.path.join(d, "out"), params, device="cuda")
    rc = str.maketrans("ACGT", "TGCA")
    got = sorted(hashlib.sha1(min(s.upper(), s.upper().translate(rc)[::-1]).encode()).hexdigest()[:16]
                 for _, s in fastx.read_fasta(os.path.join(d, "out", "rnabloom.transcripts.fa")))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), GOLDEN)) as f:
        want = json.load(f)["transcript_sha1"]
    if got != want or report.num_transcripts != len(want):
        raise AssertionError(f"golden set on the card: {got} != {want}")
    print(f"golden dataset on the card: {len(got)} transcripts, sha1 set equal to {GOLDEN} [{card}]", flush=True)
    shutil.rmtree(d)
    return got


def stage3_card_vs_cpu(left: str, right: str, tmp: str) -> dict:
    """-stage 3 (the nr pass included) on the card and on the CPU: every
    output file byte-identical, report.json equal but for elapsed_s."""
    gpu_out, cpu_out = os.path.join(tmp, "gpu3"), os.path.join(tmp, "cpu3")
    walk.reset_launch_counts()
    t0 = time.time()
    rep = run_cli(left, right, gpu_out, "cuda", "mf8", 3)
    t_gpu = time.time() - t0
    n_walk = walk.launch_counts()
    t0 = time.time()
    run_cli(left, right, cpu_out, "cpu", "mf8", 3)
    t_cpu = time.time() - t0
    report_json = "rnabloom.report.json"
    with open(os.path.join(gpu_out, report_json)) as f, open(os.path.join(cpu_out, report_json)) as g:
        a, b = json.load(f), json.load(g)
    a.pop("elapsed_s"), b.pop("elapsed_s")
    if a != b:
        raise AssertionError(f"-stage 3 report.json differs between card and CPU: {a} != {b}")
    os.remove(os.path.join(gpu_out, report_json))
    os.remove(os.path.join(cpu_out, report_json))
    files = same_tree(gpu_out, cpu_out)
    check_transcripts(gpu_out, rep, K)
    assert rep.num_transcripts > 0 and n_walk["walk_pair"] > 0, (rep.num_transcripts, n_walk)
    assert "rnabloom.transcripts.nr.fa" in files
    print(f"-cnt mf8 -stage 3 on {rep.num_pairs} pairs: card and CPU outputs byte-identical ({len(files)} "
          f"files, transcripts.nr.fa included, report.json equal but elapsed_s); {rep.num_transcripts} "
          f"transcripts, {rep.num_short} short, {rep.num_nr} nr; card walk launches {n_walk}; CLI wall card "
          f"{t_gpu:.1f} s, CPU {t_cpu:.1f} s", flush=True)
    shutil.rmtree(gpu_out)
    shutil.rmtree(cpu_out)
    return {"transcripts": rep.num_transcripts, "nr": rep.num_nr, "walk_launches": n_walk}


def extend_card_vs_cpu(left: str, right: str, tmp: str) -> dict:
    """-stage 2 -extend on the card and on the CPU: every output file
    byte-identical; the naive walk kernel ran on the card."""
    gpu_out, cpu_out = os.path.join(tmp, "gpu2x"), os.path.join(tmp, "cpu2x")
    walk.reset_launch_counts()
    t0 = time.time()
    rep = run_cli(left, right, gpu_out, "cuda", "mf8", 2, extend=True)
    t_gpu = time.time() - t0
    n_walk = walk.launch_counts()
    t0 = time.time()
    run_cli(left, right, cpu_out, "cpu", "mf8", 2, extend=True)
    t_cpu = time.time() - t0
    files = same_tree(gpu_out, cpu_out)
    assert n_walk["walk_naive"] > 0 and rep.num_fragments > 0, (n_walk, rep.num_fragments)
    print(f"-cnt mf8 -stage 2 -extend on {rep.num_pairs} pairs: card and CPU outputs byte-identical ({len(files)} "
          f"files); {rep.num_fragments} fragments; card walk launches {n_walk}; CLI wall card {t_gpu:.1f} s, CPU "
          f"{t_cpu:.1f} s", flush=True)
    shutil.rmtree(gpu_out)
    shutil.rmtree(cpu_out)
    return {"fragments": rep.num_fragments, "walk_launches": n_walk}


def naive_tally(st, graph, cfg, wcfg, mc, bd, superstep_hops: int = 64, max_supersteps: int = 64) -> dict:
    """The plain loop in naive mode (``extend_walks_plain``), replayed one
    hop at a time with the plain version's own steps, counting per lane
    what two schedules of the kernel read and how many dependent rounds
    they take.  num_hash cells a k-mer.

    Reads of the plain loop (``reads``): a hop its 4
    candidates and, with back-branch checks, the left variants but the
    k-mer itself, and each step of the variant probe the 4 successors of
    every live variant; each step of a resolve's beam probe those of every
    live slot.  Reads it needs (``needed``, the bound): the same, but a
    variant probe's steps once: every live variant's first step departs
    its own base to the walk's own candidates (the rolling hash cancels
    the substituted base), so all variants follow one greedy descent from
    the candidates, whose step 0 needs no read.  The replay checks that
    rule against the plain loop's back-branch stops at every hop.

    The one-step schedule (``old_rounds``): a hop that reads is a
    round, and each step of its variant probe; a resolve a round a step.

    This schedule (``new_rounds``, ``new_reads``): a round that reads a
    k-mer's candidates also reads their 16 children and, with back-branch
    checks, the k-mer's left variants and each candidate's ("kids"); a hop
    that advances with kids hands the next hop its counts and variants: it
    costs no round.  A probe takes step 0 from the candidates (variant
    probe) or their children (resolve), first reading the kids when they
    are not known and step 1 needs them (variant probe: tip_probe_depth
    >= 3; resolve: >= 2); then two steps a round (the successors of each
    live slot and their children), a last single step when one is left.
    A resolve that advances hands the next hop its counts and variants.
    Returns the tallies and the final state."""
    from rnabloom_tpu_torch.graph import dbg

    state = traverse.clone_state(st)
    W, k, h, dev = st.pos.shape[0], cfg.k, cfg.cbf.num_hash, st.pos.device
    T, back = wcfg.tip_probe_depth, wcfg.check_back_branches
    zero = torch.zeros(W, dtype=torch.int64, device=dev)
    hops, resolves, reads, needed, new_reads, old_rounds, new_rounds, free_hops = (zero.clone() for _ in range(8))
    cached = torch.zeros(W, dtype=torch.bool, device=dev)
    kids = cached.clone()
    floor = torch.clamp(mc, min=1.0)[:, None]
    rows4 = torch.arange(W * 4, device=dev)
    base = torch.arange(4, device=dev)

    def counts(f, r):
        return dbg.get_counts(graph, cfg, traverse._query_hash(cfg, wcfg, f, r))

    def kid_kmers(out_next):
        """k-mers a kids read adds: 16 children, and with back-branch
        checks each candidate's left variants but itself."""
        return 16 + (4 * (4 - (out_next < 4).long()) if back else 0)

    def beam(fh, rh, alive, outc_of, width):
        """The plain version's beam probe (width 1: _variant_depth_probe,
        2: _tip_probe) from (W, 4 * width) slots; returns the live slots
        before each step, (W, 4 * width) each, T - 1 of them."""
        fh, rh, al = fh.reshape(-1), rh.reshape(-1), alive.reshape(-1)
        mcx = floor.expand(W, 4 * width).reshape(-1, 1)
        live = []
        for i in range(T - 1):
            live.append(al.reshape(W, 4 * width))
            if not bool(al.any()):
                continue
            f4, r4 = nthash.successor_hashes(fh, outc_of(i).reshape(-1), k, rh=rh)
            cc = counts(f4, r4)
            if width == 1:
                ok = cc >= mcx
                best = torch.argmax(torch.where(ok, cc, -1.0), dim=1)
                al = al & ok.any(dim=1)
                fh = torch.where(al, traverse._pick(f4, best), fh)
                rh = torch.where(al, traverse._pick(r4, best), rh)
                continue
            ok = (cc >= mcx) & al[:, None]
            score = torch.where(ok, cc, -1.0).reshape(W * 4, 8)
            top1 = torch.argmax(score, dim=1)
            s2 = score.clone()
            s2[rows4, top1] = -1.0
            pick = torch.stack([top1, torch.argmax(s2, dim=1)], dim=-1)
            al = ok.reshape(W * 4, 8).gather(1, pick).reshape(-1)
            fh = torch.where(al, f4.reshape(W * 4, 8).gather(1, pick).reshape(-1), fh)
            rh = torch.where(al, r4.reshape(W * 4, 8).gather(1, pick).reshape(-1), rh)
        return live

    def descent(fh4, rh4, cnt, buf, pos):
        """The variant probe's common greedy descent: alive after each of
        its T - 1 steps, (W, T - 1); step 0 picks among the candidates."""
        ok = cnt >= floor
        alive = ok.any(dim=1)
        best = torch.argmax(torch.where(ok, cnt, -1.0), dim=1)
        f, r = traverse._pick(fh4, best), traverse._pick(rh4, best)
        out = [alive]
        for i in range(1, T - 1):
            f4, r4 = nthash.successor_hashes(f, traverse._buf_at(buf, pos - k + i), k, rh=r)
            cc = counts(f4, r4)
            ok = cc >= floor
            best = torch.argmax(torch.where(ok, cc, -1.0), dim=1)
            alive = alive & ok.any(dim=1)
            f = torch.where(alive, traverse._pick(f4, best), f)
            r = torch.where(alive, traverse._pick(r4, best), r)
            out.append(alive)
        return torch.stack(out, dim=1) if T > 1 else torch.zeros((W, 0), dtype=torch.bool, device=dev)

    def read_round(lanes, out, out_next):
        """A round that reads the candidates, their variants and kids."""
        nonlocal new_rounds, new_reads
        own = 4 - (out < 4).long() if back else 0
        new_rounds += lanes
        new_reads += lanes * (4 + own + kid_kmers(out_next))
        cached.logical_or_(lanes)
        kids.logical_or_(lanes)

    def kids_round(lanes, out_next):
        nonlocal new_rounds, new_reads
        new_rounds += lanes
        new_reads += lanes * kid_kmers(out_next)
        kids.logical_or_(lanes)

    for _ in range(max_supersteps):
        if not bool(((state.status == traverse.ACTIVE) | (state.status == traverse.BRANCH)).any()):
            break
        for _ in range(superstep_hops):
            active = state.status == traverse.ACTIVE
            if not bool(active.any()):
                break
            buf, pos = state.buf, state.pos
            out = traverse._gather_out_codes(buf, pos, k)
            out_next = traverse._buf_at(buf, pos - k + 1)
            free_hops += active & cached
            read_round(active & ~cached, out, out_next)
            hops += active
            old_rounds += active
            reads += active * 4
            needed += active * 4
            stop = torch.zeros_like(active)
            if back:
                fh4, rh4, _ = traverse._successors(cfg, wcfg, state.fh, state.rh, out)
                cnt = counts(fh4, rh4)
                is_self = base[None, :] == out[:, None]
                reads += active * (~is_self).sum(dim=1)
                needed += active * (~is_self).sum(dim=1)
                flv, rlv = nthash.variant_hashes_left(state.fh, out, k, state.rh)
                valive = (counts(flv, rlv) >= floor) & ~is_self & active[:, None]
                for live in beam(flv, rlv, valive, lambda i: (base.repeat(W) if i == 0 else
                                                              traverse._buf_at(buf, pos - k + i)[:, None].expand(W, 4)), 1):
                    old_rounds += live.any(dim=1)
                    reads += live.sum(dim=1) * 4
                vany = valive.any(dim=1)
                A = descent(fh4, rh4, cnt, buf, pos)
                for i in range(1, T - 1):
                    needed += (vany & A[:, i - 1]) * 4
                if T >= 3:  # step 1 reads the kids; then two steps a round from step 2
                    probing = vany & A[:, 0]
                    kids_round(probing & ~kids, out_next)
                    for i in range(2, T - 1, 2):
                        go = probing & A[:, i - 1]
                        new_rounds += go
                        new_reads += go * (20 if i + 1 <= T - 2 else 4)
                stop = active & (torch.ones_like(vany) if T <= 0 else vany if T == 1 else vany & A[:, T - 2])
            pos0 = state.pos
            state = traverse.walk_superstep(state, graph, cfg, wcfg, mc, bd, 1)
            if not torch.equal(stop, active & (state.status == traverse.STOPPED_BRANCH)):
                raise AssertionError("the common-descent rule disagrees with the plain loop's back-branch stops")
            adv = active & (state.pos > pos0)
            cached = torch.where(adv, kids, cached)
            kids = kids & ~adv
        branch = state.status == traverse.BRANCH
        if bool(branch.any()):
            resolves += branch
            buf, pos = state.buf, state.pos
            out = traverse._gather_out_codes(buf, pos, k)
            out_next = traverse._buf_at(buf, pos - k + 1)
            old_rounds += branch & ~cached  # a lane that starts at a branch reads its candidates first
            needed += (branch & ~cached) * 4
            read_round(branch & ~cached, out, out_next)
            if T >= 2:
                kids_round(branch & ~kids, out_next)
            fh4, rh4, q4 = traverse._successors(cfg, wcfg, state.fh, state.rh, out)
            viable = (dbg.get_counts(graph, cfg, q4) >= floor) & branch[:, None]
            dup = lambda x: x.reshape(W * 4, 1).expand(W * 4, 2).reshape(W, 8)  # noqa: E731
            alive = torch.stack([viable, torch.zeros_like(viable)], dim=-1).reshape(W, 8)
            live = beam(dup(fh4), dup(rh4), alive,
                        lambda i: traverse._buf_at(buf, pos - k + 1 + i)[:, None].expand(W, 8), 2)
            for i, lv in enumerate(live):
                old_rounds += lv.any(dim=1)
                reads += lv.sum(dim=1) * 4
                needed += lv.sum(dim=1) * 4
                if i % 2 == 1:  # step 0 comes from the kids; steps i, i + 1 a round
                    new_rounds += lv.any(dim=1)
                    new_reads += lv.sum(dim=1) * (20 if i + 1 <= T - 2 else 4)
            pos0 = state.pos
            state = traverse.resolve_branches(state, graph, cfg, wcfg, mc, mode="naive")
            adv = branch & (state.pos > pos0)
            cached = torch.where(branch, adv & kids, cached)
            kids = kids & ~branch
    return {"state": state, "hops": hops, "resolves": resolves, "reads": reads * h, "needed": needed * h,
            "new_reads": new_reads * h, "old_rounds": old_rounds, "new_rounds": new_rounds, "free_hops": free_hops,
            "rounds": old_rounds}


def first_batch_naive_walks(graph_prefix, left: str, right: str, dev):
    """The -extend walks (right, then left) of the first stage-2 batch's
    fragments on a saved graph (or a (graph, cfg) pair), as stage 2 runs
    that batch: its pairs joined into fragments (EC, overlaps, bridges,
    validation), then the extension, whose two naive walks are captured
    (inputs and outputs)."""
    if isinstance(graph_prefix, tuple):
        graph, cfg = graph_prefix
    else:
        graph, cfg = checkpoint.load_graph(graph_prefix, device=dev)
    params = pipeline.PipelineParams(extend_fragments=True)
    fparams = fragments.FragmentParams(min_overlap=params.min_overlap, bound=params.bound,
                                       lookahead=params.lookahead, extend_fragments=True,
                                       ec_params=params.correct_params())
    batches = pipeline._iter_pair_batches(left, right, params, K, False, True, READ_LEN)
    lb, ll, rb, rl, multi = next(batches)
    batches.close()
    captured = []
    saved = engine.extend_walks

    def extend_walks(st, g, c, wcfg, min_cov, bound, mode="greedy"):
        out = saved(st, g, c, wcfg, min_cov, bound, mode=mode)
        if mode == "naive":
            mc, bd = traverse.lane_args(st, min_cov, bound)
            captured.append((traverse.clone_state(st), wcfg, mc, bd, out))
        return out

    engine.extend_walks = extend_walks
    try:
        pipeline._connect_multi_segments(graph, cfg, lb, ll, rb, rl, multi, fparams)
        frags = fragments.assemble_fragments_batch(graph, cfg, lb, ll, rb, rl, fparams)
    finally:
        engine.extend_walks = saved
    assert len(captured) == 2, len(captured)
    n_frags = sum(f is not None for f in frags)
    return graph, cfg, captured, n_frags


def naive_vs_plain(graph_prefix: str, left: str, right: str, card: str, dev, variants: dict) -> dict:
    """The naive walk kernel vs its plain version on the -extend walks of
    the first stage-2 batch (right, then left): every field equal, by the
    kernel and each ``--walk-variant`` too; times in turns (kernel,
    variants, variants, kernel); the replayed reads, bound and rounds
    (``naive_tally``); the lane with the most rounds walked alone; one
    random gather beside."""
    graph, cfg, captured, n_frags = first_batch_naive_walks(graph_prefix, left, right, dev)
    r = {"fragments": n_frags, "walks": {}, "right_start": captured[0][:4]}
    builds = ["kernel", *variants]

    def call(who, st, wcfg, mc, bd):
        with walk_library(variants[who]) if who in variants else contextlib.nullcontext():
            return walk.walk_naive(st, graph, cfg, wcfg, mc, bd)

    for side, (st, wcfg, mc, bd, run_out) in zip(("right", "left"), captured):
        kern = walk.walk_naive(st, graph, cfg, wcfg, mc, bd)
        plain = None

        def plain_run():
            nonlocal plain
            plain = walk.walk_naive_plain(st, graph, cfg, wcfg, mc, bd)

        t = {"plain": [_time_ms(plain_run, reps=1)], **{who: [] for who in builds}}
        for who, got in (("kernel", kern), ("the extension's own run", run_out),
                         *((who, call(who, st, wcfg, mc, bd)) for who in variants)):
            torch.cuda.synchronize()
            bad = _same_state(got, plain)
            if bad:
                raise AssertionError(f"walk_naive ({side}, {who}) != plain: {bad} differ")
        tally = naive_tally(st, graph, cfg, wcfg, mc, bd)
        bad = _same_state(tally["state"], plain)
        if bad:
            raise AssertionError(f"the tallied replay of the plain naive loop differs ({side}): {bad}")
        for who in (*builds, *builds[::-1]):
            t[who].append(_time_ms(lambda: call(who, st, wcfg, mc, bd), reps=5))
        t["plain"].append(_time_ms(lambda: walk.walk_naive_plain(st, graph, cfg, wcfg, mc, bd), reps=1))
        # the lane with the most dependent rounds under this schedule, walked alone
        w = int(torch.argmax(tally["new_rounds"]))
        one = traverse.take_lanes(st, slice(w, w + 1))
        one_mc, one_bd = mc[w : w + 1].contiguous(), bd[w : w + 1].contiguous()
        lane_ms = {who: [] for who in builds}
        for who in builds:
            bad = [f for f in WALK_FIELDS if not torch.equal(getattr(call(who, one, wcfg, one_mc, one_bd), f),
                                                             getattr(plain, f)[w : w + 1])]
            if bad:
                raise AssertionError(f"walk_naive ({who}): lane {w} walked alone differs from the plain loop: {bad}")
        for who in (*builds, *builds[::-1]):
            lane_ms[who].append(_time_ms(lambda: call(who, one, wcfg, one_mc, one_bd), reps=5))
        reads, needed = int(tally["reads"].sum()), int(tally["needed"].sum())
        idx = torch.randint(0, graph.cbf.numel(), (max(needed, 1),), device=dev)
        graph.cbf[idx]
        gather_ms = min(_time_ms(lambda: graph.cbf[idx], reps=3) for _ in range(3))
        del idx
        status = torch.bincount(kern.status.long(), minlength=7).tolist()
        rounds = {name: int(tally[f"{name}_rounds"][w]) for name in ("old", "new")}
        w_old = int(torch.argmax(tally["old_rounds"]))
        v = r["walks"][side] = {
            "max_abs_err": _max_abs_diff(kern, plain), "ms": _mean(t["kernel"]), "plain_ms": _mean(t["plain"]),
            "turns_ms": t["kernel"], "lanes": int(st.pos.shape[0]), "max_len": wcfg.max_len,
            "hops": int(kern.hops.sum()), "hops_tried": int(tally["hops"].sum()),
            "free_hops": int(tally["free_hops"].sum()), "resolves": int(tally["resolves"].sum()),
            "cell_reads": needed, "plain_loop_cell_reads": reads, "schedule_cell_reads": int(tally["new_reads"].sum()),
            "bound_ms": walk_bound_ms(st, mc, bd, needed), "plain_reads_bound_ms": walk_bound_ms(st, mc, bd, reads),
            "gather_ms": gather_ms, "rounds_old": int(tally["old_rounds"].sum()),
            "rounds_new": int(tally["new_rounds"].sum()), "max_rounds_old": int(tally["old_rounds"][w_old]),
            "longest_lane": w, "longest_lane_rounds": rounds["new"], "longest_lane_rounds_old": rounds["old"],
            "longest_lane_hops": int(tally["hops"][w]), "longest_lane_resolves": int(tally["resolves"][w]),
            "longest_lane_ms": min(lane_ms["kernel"]),
            "round_ns": min(lane_ms["kernel"]) * 1e6 / max(rounds["new"], 1), "statuses": status,
            "variants": {who: {"ms": _mean(t[who]), "longest_lane_ms": min(lane_ms[who]),
                               "round_ns_old_schedule": min(lane_ms[who]) * 1e6 / max(rounds["old"], 1)}
                         for who in variants},
        }
        print(f"walk_naive ({side} -extend walks of the first stage-2 batch, {n_frags} fragments in {v['lanes']} "
              f"lanes, max_len {v['max_len']}, back-branch checks, tip_probe_depth {wcfg.tip_probe_depth}): every "
              f"WalkState field equal to plain; {v['hops']} hops, statuses {status}; kernel {v['ms']:.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in t['kernel'])}), plain {v['plain_ms']:.2f} ms [{card}]", flush=True)
        print(f"walk_naive ({side}): {v['hops_tried']} hops tried ({v['free_hops']} cost no round), {v['resolves']} "
              f"resolves; cell reads: {needed} needed (bound {v['bound_ms']:.4f} ms by bytes at 3.35 TB/s), the plain "
              f"loop's {reads} (every live variant's probe apart: {v['plain_reads_bound_ms']:.4f} ms), this "
              f"schedule's {v['schedule_cell_reads']}; one gather of as many random cells as needed {gather_ms:.4f} "
              f"ms [{card}]", flush=True)
        print(f"walk_naive ({side}) rounds: {v['rounds_old']} in all under the one-step schedule (most "
              f"{v['max_rounds_old']}), {v['rounds_new']} under this one; longest lane {w}: {v['longest_lane_hops']} "
              f"hops, {v['longest_lane_resolves']} resolves, {rounds['new']} rounds (one-step schedule "
              f"{rounds['old']}), walked alone {v['longest_lane_ms']:.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in lane_ms['kernel'])}): {v['round_ns']:.1f} ns a round [{card}]",
              flush=True)
        for who, x in v["variants"].items():
            print(f"walk variant {who} (naive, {side}): equal to the plain loop; batch {x['ms']:.4f} ms "
                  f"({', '.join(f'{y:.4f}' for y in t[who])}); lane {w} alone {x['longest_lane_ms']:.4f} ms "
                  f"({', '.join(f'{y:.4f}' for y in lane_ms[who])}; {x['round_ns_old_schedule']:.1f} ns a round of "
                  f"the one-step schedule) [{card}]", flush=True)
        del kern, plain, tally
    del graph
    torch.cuda.empty_cache()
    return r


def extend_main_path(left: str, right: str, out: str, card: str) -> dict:
    """-stage 2 -extend on the card over the first EXTEND_BATCHES batches,
    every launch count set to 0 just before and read just after."""
    ci.reset_launch_counts()
    walk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rep = run_cli(left, right, out, "cuda", "mf8", 2, extend=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**ci.launch_counts(), **walk.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    assert launches["walk_naive"] > 0 and launches["walk_greedy"] > 0 and launches["add_mf8"] > 0, launches
    assert rep.stage2_batches == EXTEND_BATCHES and rep.num_fragments > 0, rep
    r = {"pairs": rep.num_pairs, "pairs_per_s": rep.num_pairs / rep.stage2_s, "stage2_s": rep.stage2_s,
         "fragments": rep.num_fragments, "launches": launches, "peak_bytes": peak, "wall_s": wall}
    print(f"-cnt mf8 -stage 2 -extend on the first {EXTEND_BATCHES} batches ({rep.num_pairs} pairs, a depth cut of "
          f"the {PAIRS_K}): stage 2 {r['pairs_per_s']:.1f} pairs/s ({rep.stage2_s:.2f} s), {rep.num_fragments} fragments; "
          f"launches {launches}; peak device memory {peak} B ({peak / 2**30:.3f} GiB); CLI wall {wall:.1f} s "
          f"[{card}]", flush=True)
    shutil.rmtree(out)
    return r


def slice_fastq(src: str, dst: str, first: int, n_records: int) -> None:
    with open(src) as f, open(dst, "w") as g:
        g.writelines(itertools.islice(f, 4 * first, 4 * (first + n_records)))


@contextlib.contextmanager
def recorded(module, name: str):
    """``module.name`` wrapped, for the span of the block, to append
    (args, result, seconds with the card synchronised) of every call to
    the list it yields."""
    fn, calls = getattr(module, name), []

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        calls.append((args, out, time.time() - t0))
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def entry_run(argv: list) -> tuple:
    """The port's CLI on the card with every launch count set to 0 just
    before and read just after: (result, launches, peak device bytes,
    wall s)."""
    reset_launch_counters()
    ci._batch_tables.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    result = cli.run(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    return result, launch_counters(), torch.cuda.max_memory_allocated(), time.time() - t0


def se_main_path(fwd: str, rev: str, out: str, card: str) -> dict:
    """Single-end -stage 3 on the card: rates, launches, peak memory, the
    transcript files; keeps stage 3's graph, config and store (the
    fragment graph without fpkbf) for the pair-walk check."""
    with recorded(pipeline, "_ingest_se_fragments") as s2, recorded(pipeline, "_run_stage3") as s3:
        rep, launches, peak, wall = entry_run(["-sef", fwd, "-ser", rev, "-o", out])
    assert launches["add_mf8"] > 0 and launches["set"] > 0 and launches["walk_pair"] > 0, launches
    (args3, _, stage3_s), = s3
    graph, cfg, store = args3[:3]
    assert graph.fpkbf is None and graph.rpkbf is not None and cfg.read_pair_distance > 0
    check_transcripts(out, rep, K)
    st1 = rep.stage1
    r = {"reads": rep.num_pairs, "fragments": rep.num_fragments, "transcripts": rep.num_transcripts,
         "short": rep.num_short, "nr": rep.num_nr, "launches": launches, "peak_bytes": peak, "wall_s": wall,
         "stage1_reads_per_s": st1.num_reads / st1.elapsed_s, "stage2_reads_per_s": rep.num_pairs / s2[0][2],
         "stage3_fragments_per_s": rep.num_fragments / stage3_s, "stage3_s": stage3_s,
         "stage2b_s": wall - st1.elapsed_s - s2[0][2] - stage3_s}
    print(f"-sef/-ser -stage 3 on the mates of the first {SE_PAIRS} pairs: {st1.num_reads} reads into stage 1 at "
          f"{r['stage1_reads_per_s']:.1f} reads/s; stage 2 {rep.num_pairs} reads kept at {r['stage2_reads_per_s']:.1f}"
          f" reads/s, {rep.num_fragments} fragments; stage 2b (and the rest) {r['stage2b_s']:.2f} s; stage 3 "
          f"{r['stage3_fragments_per_s']:.1f} fragments/s ({stage3_s:.2f} s), {rep.num_transcripts} transcripts, "
          f"{rep.num_short} short, {rep.num_nr} nr; launches {launches}; peak device memory {peak} B "
          f"({peak / 2**30:.3f} GiB); CLI wall {wall:.1f} s [{card}]", flush=True)
    return r, graph, cfg, store


def se_pair_walks(graph, cfg, store: FragmentStore, card: str, dev) -> dict:
    """The pair walks of the single-end run's first full stage-3 batch
    (read pairs only: the graph has no fpkbf, the kernel's null
    fragment-pair table): right walks, then left walks from the kernel's
    right walks, by the kernel and once by the plain loop, every field
    equal; the right walks timed in turns (kernel, kernel; the plain
    loop's equality run is its turn), replayed by ``pair_tally`` for the
    reads the plain loop needs (the bound), beside one gather of as many
    random cbf cells and rpkbf lanes."""
    params, tparams = pipeline.PipelineParams(), transcripts.TranscriptParams()
    width = int(min(max(store.max_len, cfg.k), params.max_walk_len))
    batches = stage3_batches(store, params.stage3_batch, width)
    key, frags, lens = batches[-1]

    def wcfg(left):
        return traverse.WalkConfig(max_len=tparams.max_walk_len, pair_ring=tparams.pair_ring, left=left,
                                   lookahead=tparams.lookahead)

    right = traverse.make_walks(cfg, wcfg(False), frags, lens, device=dev)
    mc, bd = traverse.lane_args(right, 1.0, tparams.bound)
    n0 = walk.launch_counts()["walk_pair"]
    kern_r = walk.walk_pair(right, graph, cfg, wcfg(False), mc, bd)
    left = traverse.revcomp_reseed(cfg, wcfg(True), kern_r.buf, kern_r.pos)
    kern_l = walk.walk_pair(left, graph, cfg, wcfg(True), mc, bd)
    assert walk.launch_counts()["walk_pair"] == n0 + 2
    plain = {}

    def plain_right():
        plain["right"] = walk.walk_pair_plain(right, graph, cfg, wcfg(False), mc, bd)

    plain_ms = _time_ms(plain_right, reps=1)
    plain["left"] = walk.walk_pair_plain(left, graph, cfg, wcfg(True), mc, bd)
    for what, kern in (("right", kern_r), ("left", kern_l)):
        torch.cuda.synchronize()
        bad = [f for f in PAIR_FIELDS if not torch.equal(getattr(kern, f), getattr(plain[what], f))]
        if bad:
            raise AssertionError(f"walk_pair != plain on the {what} walks of the single-end stage 3: {bad} differ")
    t = [_time_ms(lambda: walk.walk_pair(right, graph, cfg, wcfg(False), mc, bd), reps=5) for _ in range(2)]
    tally = pair_tally(right, graph, cfg, wcfg(False), mc, bd)
    bad = [f for f in PAIR_FIELDS if not torch.equal(getattr(tally["state"], f), getattr(plain["right"], f))]
    if bad:
        raise AssertionError(f"the tallied replay of the plain pair loop differs: {bad}")
    cells, pk_lanes = int(tally["cells"].sum()), int(tally["lanes"].sum())
    state_bytes = sum(x.numel() * x.element_size() for x in right if x is not None) * 2 + 8 * mc.numel()
    bound_ms = ((cells + pk_lanes) * SECTOR + state_bytes) / HBM_BYTES_PER_MS
    idx_c = torch.randint(0, graph.cbf.numel(), (cells,), device=dev)
    idx_p = torch.randint(0, graph.rpkbf.numel(), (max(pk_lanes, 1),), device=dev)
    gather = lambda: (graph.cbf[idx_c], graph.rpkbf[idx_p])  # noqa: E731
    gather()
    gather_ms = min(_time_ms(gather, reps=3) for _ in range(3))
    r = {"lanes": int(right.pos.shape[0]), "batch": len(batches) - 1, "stratum": key, "ms": _mean(t),
         "plain_ms": plain_ms, "bound_ms": bound_ms, "gather_ms": gather_ms, "cells": cells, "pkbf_lanes": pk_lanes,
         "hops": int(tally["hops"].sum()), "resolves": int(tally["resolves"].sum()),
         "max_abs_err": max(_max_abs_diff(kern_r, plain["right"], PAIR_FIELDS),
                            _max_abs_diff(kern_l, plain["left"], PAIR_FIELDS))}
    print(f"{SE_PAIR_NAME}: stage 3's batch {r['batch']}, the first full one ({r['lanes']} fragments of stratum {key}"
          f"): right and left walks equal to the plain loop in every field incl. the ring; right walks: kernel "
          f"{r['ms']:.4f} ms ({', '.join(f'{x:.4f}' for x in t)}), plain {plain_ms:.2f} ms; the batch needs "
          f"{r['hops']} hops, {r['resolves']} pair resolves, {cells} cbf cell reads, {pk_lanes} rpkbf lane reads: "
          f"bound {bound_ms:.4f} ms ({SECTOR} B a cell or lane, state and ring {state_bytes} B, at 3.35 TB/s); one "
          f"gather of as many random cbf cells and rpkbf lanes {gather_ms:.4f} ms [{card}]", flush=True)
    return r


def pool_main_path(pool_list: str, out: str, card: str) -> dict:
    """-pool of two samples with -mergepool on the card: each sample's
    stage 2-3 seconds, launches, peak memory (the shared graph, a sample's
    fragment graph over the shared rpkbf and the screen at once), its
    transcript files, and the merged set."""
    with recorded(pipeline, "_pool_sample") as samples, recorded(pipeline, "merge_pool") as merge:
        reports, launches, peak, wall = entry_run(["-pool", pool_list, "-mergepool", "-o", out])
    assert launches["add_mf8"] > 0 and launches["set"] > 0 and launches["walk_pair"] > 0, launches
    assert sorted(reports) == ["s0", "s1"], reports
    for name, rep in reports.items():
        check_transcripts(os.path.join(out, name), rep, K)
    merged = [s for _, s in fastx.read_fasta(os.path.join(out, "rnabloom.transcripts.merged.fa"))]
    assert len(merged) == merge[0][1] > 0 and all(re.match(r"^[ACGT]+[acgt]*$", s) for s in merged)
    st1 = reports["s0"].stage1
    r = {"samples": {name: {"pairs": rep.num_pairs, "fragments": rep.num_fragments, "transcripts": rep.num_transcripts,
                            "nr": rep.num_nr, "stage2_3_s": sec} for (name, rep), (_, _, sec)
                     in zip(sorted(reports.items()), samples)},
         "merged": len(merged), "merge_s": merge[0][2], "launches": launches, "peak_bytes": peak, "wall_s": wall,
         "stage1_reads_per_s": st1.num_reads / st1.elapsed_s}
    print(f"-pool of 2 samples ({POOL_PAIRS} pairs each) -mergepool: shared stage 1 {st1.num_reads} reads at "
          f"{r['stage1_reads_per_s']:.1f} reads/s; per sample {r['samples']}; {len(merged)} merged transcripts "
          f"({merge[0][2]:.2f} s); launches {launches}; peak device memory {peak} B ({peak / 2**30:.3f} GiB); CLI "
          f"wall {wall:.1f} s [{card}]", flush=True)
    return r


def rescue_main_path(left: str, right: str, out: str, card: str) -> dict:
    with recorded(pipeline, "_rescue_unconnected_pass") as rescue:
        rep, launches, peak, wall = entry_run(["-left", left, "-right", right, "-o", out, "-stage", "2", "-rescue",
                                               "-bound", "20"])
    (args, _, rescue_s), = rescue
    spill = len(args[2])
    assert rep.num_rescued >= 1 and launches["walk_greedy"] > 0 and launches["add_mf8"] > 0, (rep, launches)
    r = {"pairs": rep.num_pairs, "fragments": rep.num_fragments, "spill": spill, "rescued": rep.num_rescued,
         "rescue_s": rescue_s, "pairs_per_s": rep.num_pairs / rep.stage2_s, "launches": launches, "peak_bytes": peak,
         "wall_s": wall}
    print(f"-stage 2 -rescue -bound 20 on {rep.num_pairs} pairs: stage 2 {r['pairs_per_s']:.1f} pairs/s "
          f"({rep.stage2_s:.2f} s, the rescue pass {rescue_s:.2f} s of it); {spill} pairs spilled, "
          f"{rep.num_rescued} rescued; {rep.num_fragments} fragments; launches {launches}; peak device memory {peak} "
          f"B ({peak / 2**30:.3f} GiB; the read graph and the rescue graph) [{card}]", flush=True)
    shutil.rmtree(out)
    return r


def kselect_main_path(left: str, right: str, out: str, card: str, dev) -> dict:
    """-k 25,27 -ntcard -stage 1 on the card: the chosen k, the estimate,
    launches and peak memory.  Then the sketches against the CPU's plain
    inserts on the same reads: each k's (distinct, nonsingleton) cells and
    the estimate equal, and the first batch inserted into a sketch of each
    size (2^22 cells for k selection, 2^26 for -ntcard) leaves every cell
    of a zeroed sketch equal to the CPU's."""
    first = {}  # sketch size_log2 -> (ccfg, codes, k) of its first batch in this run
    insert = kselect._insert

    def keep_first(sketch, ccfg, codes, k):
        first.setdefault(ccfg.size_log2, (ccfg, codes.copy(), k))
        return insert(sketch, ccfg, codes, k)

    kselect._insert = keep_first
    try:
        with recorded(kselect, "select_k") as sel, recorded(kselect, "count_nonsingletons") as cns, \
                recorded(kselect, "estimate_num_unique_kmers") as est:
            rep, launches, peak, wall = entry_run(["-left", left, "-right", right, "-o", out, "-stage", "1",
                                                   "-k", "25,27", "-ntcard"])
    finally:
        kselect._insert = insert
    assert launches["add"] > 0 and launches["add_mf8"] > 0, launches
    assert sorted(first) == [22, 26] and len(cns) == 2 and len(est) == 1, (sorted(first), len(cns), len(est))
    cells = {}
    for args, card_pair, _ in cns:
        cpu_pair = kselect.count_nonsingletons(*args, device="cpu")
        assert cpu_pair == card_pair, (args[1], card_pair, cpu_pair)
        cells[args[1]] = card_pair
    est_cpu = kselect.estimate_num_unique_kmers(*est[0][0], device="cpu")
    assert est_cpu == est[0][1], (est[0][1], est_cpu)
    batches = {}
    for log2, (ccfg, codes, k) in sorted(first.items()):
        sk = {d: filters.make_counting(ccfg, device=d) for d in (dev, torch.device("cpu"))}
        for t in sk.values():
            kselect._insert(t, ccfg, codes, k)
        err = int((sk[dev].cpu().long() - sk[torch.device("cpu")].long()).abs().max())
        assert err == 0, (log2, err)
        batches[log2] = {"rows": codes.shape[0], "indices": codes.shape[0] * (codes.shape[1] - k + 1) * ccfg.num_hash,
                         "max_abs_err": err}
        del sk
    r = {"k": sel[0][1], "select_s": sel[0][2], "estimate": est[0][1], "estimate_s": est[0][2],
         "cells": cells, "sketch_batches": batches, "launches": launches, "peak_bytes": peak, "wall_s": wall,
         "stage1_reads_per_s": rep.stage1.num_reads / rep.stage1.elapsed_s}
    print(f"-k 25,27 -ntcard -stage 1 on {KSELECT_PAIRS} pairs: selected k={r['k']} ({r['select_s']:.2f} s), "
          f"-ntcard estimate {r['estimate']} distinct k-mers ({r['estimate_s']:.2f} s); stage 1 "
          f"{r['stage1_reads_per_s']:.1f} reads/s; launches {launches}; peak device memory {peak} B "
          f"({peak / 2**30:.3f} GiB) [{card}]", flush=True)
    print(f"-k sketches against the CPU's plain inserts on the same reads: (distinct, nonsingleton) cells by k "
          f"{cells} equal, the estimate {est_cpu} equal; first batch of each sketch size (size_log2: rows, "
          f"indices, max |err| over every cell) {batches}", flush=True)
    shutil.rmtree(out)
    return r


def new_paths_card_vs_cpu(tmp: str, left: str, right: str) -> dict:
    """Single-end -stage 3, mixed -stage 2, -pool -mergepool, -stage 2
    -rescue and -k 25,27 -ntcard -stage 1 on CHECK9 reads or pairs a case,
    on the card and on the CPU: every file byte-identical."""
    half = CHECK9 // 2
    files = {}
    for name, first, n in (("a", 0, half), ("b", half, half), ("c", 0, CHECK9), ("d", CHECK9, half)):
        for mate, src in (("1", left), ("2", right)):
            slice_fastq(src, os.path.join(tmp, f"c9{name}_{mate}.fq"), first, n)
    f = lambda name, mate: os.path.join(tmp, f"c9{name}_{mate}.fq")  # noqa: E731
    with open(os.path.join(tmp, "c9pool.txt"), "w") as g:
        g.write(f"s0 {f('a', 1)} {f('a', 2)}\ns1 {f('b', 1)} {f('b', 2)}\n")
    cases = {
        "single-end -stage 3": ["-sef", f("a", 1), "-ser", f("a", 2)],
        "mixed -stage 2": ["-left", f("a", 1), "-right", f("a", 2), "-sef", f("d", 1), "-stage", "2"],
        "-pool -mergepool": ["-pool", os.path.join(tmp, "c9pool.txt"), "-mergepool"],
        "-stage 2 -rescue": ["-left", f("c", 1), "-right", f("c", 2), "-stage", "2", "-rescue", "-bound", "20",
                             "-batch", "256", "-sample", "100"],
        "-k 25,27 -ntcard -stage 1": ["-left", f("c", 1), "-right", f("c", 2), "-k", "25,27", "-ntcard", "-stage",
                                      "1", "-savebf"],
    }
    for case, argv in cases.items():
        outs = {dev: os.path.join(tmp, f"c9_{dev}") for dev in ("cuda", "cpu")}
        walk.reset_launch_counts()
        ci.reset_launch_counts()
        t0 = time.time()
        rep = cli.run(argv + ["-o", outs["cuda"], "--device", "cuda"])
        t_gpu = time.time() - t0
        n_launch = {**ci.launch_counts(), **walk.launch_counts()}
        t0 = time.time()
        cli.run(argv + ["-o", outs["cpu"], "--device", "cpu"])
        t_cpu = time.time() - t0
        same = same_tree(outs["cuda"], outs["cpu"])
        if case == "-stage 2 -rescue":
            assert rep.num_rescued >= 1, rep
        files[case] = len(same)
        print(f"{case} on {CHECK9} reads or pairs: card and CPU outputs byte-identical ({len(same)} files); card "
              f"launches { {k: v for k, v in n_launch.items() if v} }; CLI wall card {t_gpu:.1f} s, CPU "
              f"{t_cpu:.1f} s", flush=True)
        for d in outs.values():
            shutil.rmtree(d)
    return files


def short_read_paths(tmp: str, left: str, right: str, card: str, dev) -> dict:
    """Phase 9: the single-end, pool, -rescue and -k entry points on the
    card, the single-end run's pair walks against the plain loop, and the
    card-vs-CPU checks."""
    se = [os.path.join(tmp, f"se_{m}.fq") for m in (1, 2)]
    pool = [os.path.join(tmp, f"pool{i}_{m}.fq") for i in (0, 1) for m in (1, 2)]
    for src, dst_se, dst0, dst1 in ((left, se[0], pool[0], pool[2]), (right, se[1], pool[1], pool[3])):
        slice_fastq(src, dst_se, 0, SE_PAIRS)
        slice_fastq(src, dst0, 0, POOL_PAIRS)
        slice_fastq(src, dst1, POOL_PAIRS, POOL_PAIRS)
    r = {}
    r["se"], graph, cfg, store = se_main_path(se[0], se[1], os.path.join(tmp, "out_se"), card)
    r["se_walks"] = se_pair_walks(graph, cfg, store, card, dev)
    del graph
    shutil.rmtree(os.path.join(tmp, "out_se"))
    with open(os.path.join(tmp, "pool.txt"), "w") as g:
        g.write(f"s0 {pool[0]} {pool[1]}\ns1 {pool[2]} {pool[3]}\n")
    r["pool"] = pool_main_path(os.path.join(tmp, "pool.txt"), os.path.join(tmp, "out_pool"), card)
    shutil.rmtree(os.path.join(tmp, "out_pool"))
    heads = {}
    for n in (RESCUE_PAIRS, KSELECT_PAIRS):
        heads[n] = [os.path.join(tmp, f"h9_{n}_{m}.fq") for m in (1, 2)]
        head_fastq(left, heads[n][0], n)
        head_fastq(right, heads[n][1], n)
    r["rescue"] = rescue_main_path(*heads[RESCUE_PAIRS], os.path.join(tmp, "out_rescue"), card)
    r["kselect"] = kselect_main_path(*heads[KSELECT_PAIRS], os.path.join(tmp, "out_k"), card, dev)
    r["card_vs_cpu"] = new_paths_card_vs_cpu(tmp, left, right)
    return r


# -------------------------------------------------------------------------
# phase 10: the long-read path (-long)
# -------------------------------------------------------------------------

LR_SOURCE = "rnabloom_tpu_torch/csrc/lr_kernels.cu"
LR_REPLACES = {
    "lr_kmer_keys": "rnabloom_tpu/assembly/longreads.py:337",  # _base_key_fn via _device_hash_buckets
    "lr_randstrobe_keys": "rnabloom_tpu/ops/strobemer.py:33",  # strobemer_hashes
    "consensus_vote": "rnabloom_tpu/olc/consensus.py:88",  # _vote_kernel
}
# lrsim transcripts of 500-4,000 bases (seed 0), a depth cut of the 1,000
# the phase was specified with: 200 at coverage 10 (2,000 reads) took
# 116.7-119.6 s of phase 10 on one H100 80GB HBM3 at 700 W, the host's
# correction and banded realignment nearly all of it (so 1,000 would take
# about 600 s), and the whole smoke 1080.1 s, over its 1,050 s mark; 150
# took 86-108 s of a 965-1148 s smoke with phase 12, and were halved.
# The coverage stays: it decides which k-mers are solid
LR_TRANSCRIPTS = 75
LR_COVERAGE = 10
LR_ERR = 0.07
LR_CHECK = 200  # reads of the card-vs-CPU runs (cut from 400 for the smoke's time)
LR_K, LR_N, LR_WMIN, LR_WMAX = 25, 3, 11, 50  # run (ii)'s strobemers: -lrsub 5,11,0,50 at k=25
# the runs after (i), each resumed from a copy of (i)'s corrected reads and stamps
LR_RESUMED = {"strobemer": ["-lrsub", "5,11,0,50"], "kmer": ["-lrsub", "5,25,0"], "paf": ["-paf"]}
# phase 10's kernel cells at the size the phase was specified with.  K1
# and K2: its 750 raw lrsim reads, 14 times (10,500 reads; with 150
# transcripts, 1,500 reads 7 times: 16.3 M positions), keys held to the
# plain version on every 7th read: 7 is prime to the 750 reads of a
# repeat, so every raw read is checked twice, at other tile alignments.
# K3: run (i)'s unitigs and placements 14 times over (about what the
# specified 1,000 transcripts would give)
LR_REPEATS = 14
LR_VOTE_BATCH = 2048  # polish's reads a batch (its default), so a full batch of the vote
LR_CHECK_EVERY = 7
LR_HOST_REPS = 5  # host-timed calls of the key path, for its spread
# The least 32-bit integer instructions of the work, by the pipe that runs
# them.  K1 a position: the forward and reverse roll, each a 64-bit rotate
# by 1 (2 funnel shifts) and a 3-way xor (2 LOP3), and the signed min
# (compare 2, select 2), all on the ALU pipe.  K2 a valid candidate in a
# window it must scan, with T_b and C_a hoisted: the xor (2 LOP3), the
# unsigned compare (2 ISETP) and the select (2 SEL) on the ALU pipe, the
# 64-bit add T_b + C_a (2), which can run as IMAD.WIDE.U32 and IMAD on the
# FMA pipe.  An H100 SXM SM runs 64 lanes a clock on either pipe and issues
# 128 instructions a clock in all; the busiest of the three binds.
K1_OPS = {"alu": 12, "fma": 0}
K2_OPS = {"alu": 6, "fma": 2}
SMS, PIPE_LANES, DISPATCH_LANES = 132, 64, 128
LR_SPANS = ("olc_subsample", "olc_paf", "olc_overlaps", "olc_unique", "olc_unitigs", "olc_placement", "olc_polish",
            "olc_layout", "reduce_redundancy")


def launch_counters() -> dict:
    """Every kernel's launch count."""
    return {**ci.launch_counts(), **walk.launch_counts(), **lr_keys.launch_counts(), **strobemer.launch_counts(),
            **consensus_vote.launch_counts()}


def reset_launch_counters() -> None:
    for module in (ci, walk, lr_keys, strobemer, consensus_vote):
        module.reset_launch_counts()


def copy_corrected(src: str, dst: str) -> None:
    """The stamps and corrected reads of a -long run (what a resume reads)."""
    os.makedirs(dst)
    for f in os.listdir(src):
        if ".longreads." in f or f in ("DBG.DONE", "LONGREADS.CORRECTED"):
            shutil.copy2(os.path.join(src, f), dst)


def long_run(argv: list, out: str, truth: list, card: str, tag: str) -> dict:
    """One -long run on the card through entry_run: rates, spans, counts,
    lrsim's scores against the truth, peak memory, launches."""
    rep, launches, peak, wall = entry_run(argv + ["-o", out, "-mem", "1"])
    asm = [s for _, s in fastx.read_fasta(os.path.join(out, "rnabloom.transcripts.fa"))]
    assert rep.num_transcripts == len(asm) > 0, (rep, len(asm))
    score = lrsim.evaluate(asm, truth)
    r = {"reads": rep.num_pairs, "corrected": rep.num_fragments, "transcripts": rep.num_transcripts,
         "short": rep.num_short, "wall_s": wall, "olc_s": rep.stage3_s, "peak_bytes": peak,
         "launches": {k: v for k, v in launches.items() if v}, "recall": score["lr_recall"],
         "precision": score["lr_precision"], "spans": {k: rep.stage3_spans.get(k, 0.0) for k in LR_SPANS}}
    if rep.stage1 is not None:
        r["stage1_reads_per_s"] = rep.stage1.num_reads / rep.stage1.elapsed_s
        r["correction_reads_per_s"] = rep.num_pairs / rep.stage2_s
        r["correction_s"] = rep.stage2_s
    print(f"-long {tag}: {r['corrected']} corrected reads -> {r['transcripts']} transcripts, {r['short']} short; "
          + (f"stage 1 {r['stage1_reads_per_s']:.1f} reads/s, correction {r['correction_reads_per_s']:.1f} reads/s "
             f"({r['correction_s']:.2f} s); " if "correction_s" in r else "")
          + f"OLC {r['olc_s']:.2f} s: " + ", ".join(f"{k} {v:.2f}" for k, v in r["spans"].items())
          + f" s; wall {wall:.2f} s; lrsim recall {r['recall']} precision {r['precision']}; launches {r['launches']}; "
            f"peak device memory {peak} B ({peak / 2**30:.3f} GiB) [{card}]", flush=True)
    return r


def lr_layout(reads: list, dev) -> dict:
    """The ragged layout of K1 and K2 at run (ii)'s parameters: codes,
    offsets and anchor offsets on ``dev``, and their counts."""
    codes, offsets, lens = lr_keys.pack(reads, dev)
    m = np.where(lens >= lr_keys.strobemer_min_len(LR_K, LR_N, LR_WMIN, LR_WMAX),
                 strobemer.num_anchors(lens, LR_K, LR_N, LR_WMIN, LR_WMAX), 0)
    aoff = torch.from_numpy(np.concatenate([[0], np.cumsum(m)]).astype(np.int64)).to(dev)
    return {"codes": codes, "offsets": offsets, "aoff": aoff, "reads": len(reads),
            "positions": codes.numel(), "anchors": int(m.sum())}


def lr_calls(lib: ctypes.CDLL, lay: dict, kmers: dict = None) -> tuple:
    """K1 and K2 of ``lib`` (the port's or an ``--lr-variant`` build) on
    ``lay`` through their C entry points, into buffers of their own: (k1,
    k2, outputs).  K2 reads ``kmers``' k-mer hashes where given, else its
    own K1's.  Launches made to time and compare a kernel, outside the
    launch counts."""
    dev = lay["codes"].device
    total, n_reads, n_anchors = lay["positions"], lay["reads"], lay["anchors"]
    out = {"h": torch.empty(total, dtype=torch.int64, device=dev), "v": torch.empty(total, dtype=torch.uint8, device=dev),
           "sh": torch.empty(n_anchors, dtype=torch.int64, device=dev),
           "ok": torch.empty(n_anchors, dtype=torch.uint8, device=dev)}
    src = kmers or out
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k1():
        err = lib.lr_kmer_keys(lay["codes"].data_ptr(), lay["offsets"].data_ptr(), n_reads, total, LR_K, 0,
                               out["h"].data_ptr(), out["v"].data_ptr(), stream)
        assert err == 0, f"lr_kmer_keys: cudaError_t {err}"

    def k2():
        err = lib.lr_randstrobe_keys(src["h"].data_ptr(), src["v"].data_ptr(), lay["offsets"].data_ptr(),
                                     lay["aoff"].data_ptr(), n_reads, n_anchors, LR_K, LR_N, LR_WMIN, LR_WMAX,
                                     out["sh"].data_ptr(), out["ok"].data_ptr(), stream)
        assert err == 0, f"lr_randstrobe_keys: cudaError_t {err}"

    return k1, k2, out


def sm_clocks_mhz(fn, reps: int) -> tuple:
    """The SM clock and the card's highest SM clock (nvidia-smi), read while
    the card runs ``fn`` ``reps`` times."""
    torch.cuda.synchronize()
    for _ in range(reps):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    torch.cuda.synchronize()
    now, top = (float(v) for v in out.split(","))
    return now, top


def ops_bound_ms(ops: dict, units: int, mhz: float) -> float:
    """The least ms of ``units`` times ``ops`` 32-bit integer instructions
    (by pipe) on SMS SMs at ``mhz``: the busier pipe, or the issue."""
    clocks = max(ops["alu"] / PIPE_LANES, ops["fma"] / PIPE_LANES, (ops["alu"] + ops["fma"]) / DISPATCH_LANES)
    return clocks * units / (SMS * mhz * 1e3)


def strobe_candidates(lay: dict, v: torch.Tensor) -> int:
    """The window candidates K2 must combine on this data: the valid ones
    of every strobe window an anchor reaches (its k-mer valid, and every
    earlier window holding a valid candidate), below its read's last
    k-mer."""
    dev = v.device
    offsets, aoff = lay["offsets"], lay["aoff"]
    m = aoff.diff()
    read = torch.repeat_interleave(torch.arange(m.numel(), device=dev), m)
    x = offsets[read] + torch.arange(lay["anchors"], device=dev) - aoff[read]
    lim = offsets[read + 1] - LR_K + 1
    cum = torch.nn.functional.pad(torch.cumsum(v.long(), 0), (1, 0))
    reached = v[x] != 0
    work = 0
    for s in range(LR_N - 1):
        lo = x + s * LR_WMAX + LR_WMIN
        hi = torch.minimum(x + s * LR_WMAX + LR_WMAX, lim)
        cnt = torch.where(hi > lo, cum[hi.clamp(max=v.numel())] - cum[lo.clamp(max=v.numel())], 0)
        work += int(cnt[reached].sum())
        reached &= cnt > 0
    return work


def lr_bounds(lay: dict, v: torch.Tensor, mhz: float) -> dict:
    """K1's and K2's bounds on ``lay``, by bytes (each input read once, each
    output written once, over 3.35 TB/s) and by 32-bit integer
    instructions (``ops_bound_ms`` at ``mhz``); the larger binds."""
    total, reads, anchors = lay["positions"], lay["reads"], lay["anchors"]
    cand = strobe_candidates(lay, v)
    out = {}
    for name, nbytes, ops, units in (
        # codes and offsets read, a hash and a flag written a position
        ("lr_kmer_keys", total + (reads + 1) * 8 + total * 9, K1_OPS, total),
        # k-mer hashes and flags read, offsets and anchor offsets, a hash and a flag written an anchor
        ("lr_randstrobe_keys", total * 9 + (reads + 1) * 16 + anchors * 9, K2_OPS, cand),
    ):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_MS, ops_bound_ms(ops, units, mhz)
        out[name] = {"bytes_bound_ms": b_ms, "ops_bound_ms": o_ms, "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms >= o_ms else "operations", "bytes": nbytes,
                     "alu_ops": ops["alu"] * units, "fma_ops": ops["fma"] * units}
    out["lr_randstrobe_keys"]["candidates"] = cand
    return out


def lr_turns(lay: dict, variants: dict, what: str, card: str, clocks: tuple = None) -> dict:
    """K1 and K2 of the port and of each ``--lr-variant`` on ``lay``, timed
    with CUDA events in turns (kernel, variants, variants, kernel); every
    variant's outputs equal the port's in every value (every K2 on the
    port's k-mer hashes).  ``clocks``: the SM clock and the highest SM clock
    (``sm_clocks_mhz``), read during a run of K2 when not given; the bounds
    are at the highest, which the published peak rates assume."""
    k1, k2, port = lr_calls(_build.lr_kernels(), lay)
    k1()
    calls = {who: lr_calls(lib, lay, port) for who, lib in variants.items()}
    calls["kernel"] = (k1, k2, port)
    for c1, c2, _ in calls.values():  # warm
        c1()
        c2()
    order = ["kernel", *variants, *reversed(variants), "kernel"]
    t = {}
    for who in order:
        c1, c2, _ = calls[who]
        t.setdefault((who, 1), []).append(_time_ms(c1))
        t.setdefault((who, 2), []).append(_time_ms(c2))
    torch.cuda.synchronize()
    for who in variants:
        got = calls[who][2]
        for key in ("h", "v", "sh", "ok"):
            assert torch.equal(got[key], port[key]), f"lr variant {who} differs from the kernel in {key} ({what})"
    if clocks is None:  # about 0.4 s of K2 on the card while nvidia-smi reads the clocks
        clocks = sm_clocks_mhz(k2, min(1000, max(50, int(400 / _mean(t["kernel", 2])))))
    now, mhz = clocks
    bounds = lr_bounds(lay, port["v"], mhz)
    r = {"sm_clocks_mhz": clocks, "sm_clock_mhz": now, "sm_clock_max_mhz": mhz,
         "work": f"{lay['reads']} reads, {lay['positions']} positions, {lay['anchors']} anchors"}
    for i, name in ((1, "lr_kmer_keys"), (2, "lr_randstrobe_keys")):
        b = bounds[name]
        r[name] = {"ms": _mean(t["kernel", i]), "turns_ms": t["kernel", i],
                   "variant_ms": {who: _mean(t[who, i]) for who in variants}, **b}
        print(f"{name} ({what}: {r['work']}): kernel {r[name]['ms']:.4f} ms (turns {t['kernel', i]}), "
              + "".join(f"variant {who} {ms:.4f} ms, " for who, ms in r[name]["variant_ms"].items())
              + f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} (bytes {b['bytes_bound_ms']:.4f} ms for {b['bytes']} "
              f"B, integer instructions {b['ops_bound_ms']:.4f} ms for {b['alu_ops']} on the ALU pipe and "
              f"{b['fma_ops']} on the FMA pipe at the highest SM clock, {mhz:.0f} MHz; {now:.0f} MHz read under K2"
              + (f", {b['candidates']} valid candidates" if "candidates" in b else "")
              + f"), {b['bound_ms'] / r[name]['ms']:.1%} of it [{card}]", flush=True)
    for who in variants:
        print(f"lr variant {who} ({what}): K1 and K2 outputs equal the kernel's in every value", flush=True)
    return r


def host_ms(fn, reps: int) -> list:
    """Host-clock ms of each of ``reps`` calls of ``fn``, the card
    synchronised before and after each."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def lr_keys_vs_plain(reads: list, card: str, dev, variants: dict, clocks: tuple) -> dict:
    """K1 (k-mer keys) and K2 (randstrobes) on every corrected read of run
    (i): the per-read keys through the wrappers equal the plain versions'
    on the card (the reads padded into the JAX package's buckets).  On the
    host's clock (card synchronised), LR_HOST_REPS calls each of the key
    path end to end (packing and the split included), of the wrapper alone
    and of its bare C entry point, and the plain version once.  The
    kernels, and each ``--lr-variant``, timed in turns (``lr_turns``) at
    the full-size cell's SM ``clocks``."""
    lay = lr_layout(reads, dev)
    k1, k2, _ = lr_calls(_build.lr_kernels(), lay)
    kh = lr_keys.kmer_hashes(lay["codes"], lay["offsets"], LR_K, False)
    out = {}
    for name, keys, plain, wrapper, entry in (
        ("lr_kmer_keys", lambda: lr_keys.kmer_keys(reads, LR_K, False, device=dev),
         lambda: lr_keys.kmer_keys_plain(reads, LR_K, False, device=dev),
         lambda: lr_keys.kmer_hashes(lay["codes"], lay["offsets"], LR_K, False), k1),
        ("lr_randstrobe_keys", lambda: lr_keys.strobemer_keys(reads, LR_K, LR_N, LR_WMIN, LR_WMAX, False, device=dev),
         lambda: lr_keys.strobemer_keys_plain(reads, LR_K, LR_N, LR_WMIN, LR_WMAX, False, device=dev),
         lambda: strobemer.randstrobe_hashes(*kh, lay["offsets"], lay["aoff"], LR_K, LR_N, LR_WMIN, LR_WMAX), k2),
    ):
        got = keys()
        t0 = time.time()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        assert len(got) == len(want) == len(reads)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if not np.array_equal(g, w)]
        assert not bad, f"{name}: {len(bad)} reads differ from the plain version, the first {bad[:5]}"
        wrapper()
        host = {"keys_ms": host_ms(keys, LR_HOST_REPS), "wrapper_ms": host_ms(wrapper, LR_HOST_REPS),
                "entry_ms": host_ms(entry, LR_HOST_REPS)}
        out[name] = {"max_abs_err": 0, "plain_ms": plain_ms, "keys": sum(g.size for g in got), **host}
        print(f"{name} vs plain on the card, every corrected read of run (i) ({len(reads)} reads): "
              f"{out[name]['keys']} keys equal; the plain version (padded buckets) {plain_ms:.1f} ms; on the host's "
              f"clock, {LR_HOST_REPS} calls each (min / median / max ms): "
              + ", ".join(f"{what} {min(v):.3f} / {statistics.median(v):.3f} / {max(v):.3f}"
                          for what, v in (("the keys end to end", host["keys_ms"]), ("the wrapper", host["wrapper_ms"]),
                                          ("its C entry", host["entry_ms"])))
              + f" [{card}]", flush=True)
    turns = lr_turns(lay, variants, "every corrected read of run (i)", card, clocks)
    for name in out:
        out[name].update(turns[name], work=turns["work"], sm_clock_mhz=turns["sm_clock_mhz"],
                         sm_clock_max_mhz=turns["sm_clock_max_mhz"])
    return out


def lr_keys_full_size(raw: list, card: str, dev, variants: dict) -> dict:
    """K1 and K2 at the size phase 10 was specified with: its raw reads
    LR_REPEATS times, in one launch each.  A read's keys do not depend on
    the other reads of a launch, so every LR_CHECK_EVERY-th read's keys
    equal the plain versions' run on those reads alone; the kernels and
    each ``--lr-variant`` timed in turns (``lr_turns``)."""
    reads = [sequtils.encode(r) for r in raw] * LR_REPEATS
    lay = lr_layout(reads, dev)
    k1, _, kmers = lr_calls(_build.lr_kernels(), lay)
    k1()
    _, k2, strobes = lr_calls(_build.lr_kernels(), lay, kmers)
    k2()
    picks = range(0, len(reads), LR_CHECK_EVERY)
    sub = [reads[i] for i in picks]
    got = lr_keys._split(kmers["h"], kmers["v"], lay["offsets"].cpu().numpy())
    want = lr_keys.kmer_keys_plain(sub, LR_K, False, device=dev)
    assert all(np.array_equal(got[i], w) for i, w in zip(picks, want)), "lr_kmer_keys differs at the full size"
    got = lr_keys._split(strobes["sh"], strobes["ok"], lay["aoff"].cpu().numpy())
    want = lr_keys.strobemer_keys_plain(sub, LR_K, LR_N, LR_WMIN, LR_WMAX, False, device=dev)
    assert all(np.array_equal(got[i], w) for i, w in zip(picks, want)), "lr_randstrobe_keys differs at the full size"
    print(f"K1 and K2 at the full size ({len(reads)} reads, {lay['positions']} positions, {lay['anchors']} "
          f"anchors): the keys of every {LR_CHECK_EVERY}th read ({len(sub)}) equal the plain versions' on those "
          f"reads alone [{card}]", flush=True)
    r = lr_turns(lay, variants, f"phase 10's {len(raw)} raw reads x {LR_REPEATS}", card)
    r.update(reads=len(reads), positions=lay["positions"], anchors=lay["anchors"], checked_reads=len(sub))
    return r


def vote_entry(lib: ctypes.CDLL, args: tuple):
    """A call of ``lib``'s C entry ``consensus_vote`` (an ``--lr-variant``
    build) on a batch's ``args``, into outputs of its own: (polished,
    depth).  Where ``lib``'s source scatters into a vote table (an older
    source, which defines ``vote_scatter_kernel``), a zeroed U * L * 4
    int32 table is allocated inside the call, as that source's wrapper
    allocated it; a one-pass source gets null, as the port's wrapper
    passes."""
    u_t, r_t, tgt, start, min_depth = args
    (U, L), (R, Lr) = u_t.shape, r_t.shape
    dev = u_t.device
    with open(lib.source) as f:
        table = "vote_scatter_kernel" in f.read()

    def call():
        votes = torch.zeros(U * L * 4, dtype=torch.int32, device=dev) if table else None
        polished = torch.empty_like(u_t)
        depth = torch.empty((U, L), dtype=torch.int32, device=dev)
        err = lib.consensus_vote(u_t.data_ptr(), U, L, r_t.data_ptr(), R, Lr, tgt.data_ptr(), start.data_ptr(),
                                 int(min_depth), None if votes is None else votes.data_ptr(), polished.data_ptr(),
                                 depth.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        assert err == 0, f"consensus_vote: cudaError_t {err}"
        return polished, depth

    return call


def vote_turns(args: tuple, variants: dict, what: str, card: str) -> dict:
    """K3 on one batch's ``args``: the kernel (through its wrapper) and each
    ``--lr-variant`` (``vote_entry``) timed with CUDA events in turns
    (kernel, variants, variants, kernel), every variant's polished codes and
    depths equal to the kernel's; the plain version, the scatter_add_ +
    argmax composite (the library yardstick, equal to the kernel's polished
    codes) and the byte bound."""
    u_t, r_t, tgt, start, min_depth = args
    (U, L), (R, Lr) = u_t.shape, r_t.shape
    dev = u_t.device
    calls = {"kernel": lambda: consensus_vote.consensus_vote(*args),
             **{who: vote_entry(lib, args) for who, lib in variants.items()}}
    want = calls["kernel"]()
    # the wrapper allocates its outputs in every call: one call, timed alone,
    # with the allocator's cache emptied first (it waits on cudaMalloc), so
    # that every call after it finds their blocks cached
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cold_ms = _time_ms(calls["kernel"], reps=1)
    for who in variants:
        got = calls[who]()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            f"lr variant {who}'s consensus_vote differs from the kernel ({what})"
    t = {}
    for who in ["kernel", *variants, *reversed(variants), "kernel"]:
        t.setdefault(who, []).append(_time_ms(calls[who]))
    plain_ms = _time_ms(lambda: consensus_vote.consensus_vote_plain(*args))
    # what holds the kernel: the same call with no read (the scans and the
    # writes alone), and with the reads spread evenly over the unitigs
    no_reads = (u_t, r_t[:0], tgt[:0], start[:0], min_depth)
    spread = (u_t, r_t, torch.arange(R, device=dev, dtype=torch.int32) % U, start, min_depth)
    empty_ms = _time_ms(lambda: consensus_vote.consensus_vote(*no_reads))
    spread_ms = _time_ms(lambda: consensus_vote.consensus_vote(*spread))
    most = int(torch.bincount(tgt.long(), minlength=U).max())
    pos = start.long()[:, None] + torch.arange(Lr, device=dev)[None, :]
    ok = (r_t < 4) & (pos >= 0) & (pos < L)
    flat = ((tgt.long()[:, None] * L + pos.clamp(0, L - 1)) * 4 + torch.where(ok, r_t, 0).long()).reshape(-1)
    val = ok.reshape(-1).to(torch.int32)
    del pos, ok

    def library():
        votes = torch.zeros(U * L * 4, dtype=torch.int32, device=dev).scatter_add_(0, flat, val).view(U, L, 4)
        return torch.where((votes.sum(-1) >= min_depth) & (u_t < 4), votes.argmax(-1).to(torch.uint8), u_t)

    assert torch.equal(library(), want[0])
    library_ms = _time_ms(library)
    # unitigs, tgt and start read once, of each read the bases that fall on
    # its unitig's columns (its row's bytes past either end of the unitig
    # the function never needs); polished and depth written
    first = start.long()
    read_bytes = int((torch.clamp(first + Lr, max=L) - torch.clamp(first, min=0)).clamp(min=0).sum())
    nbytes = U * L + read_bytes + 8 * R + U * L * 5
    r = {"max_abs_err": 0, "ms": _mean(t["kernel"]), "turns_ms": t["kernel"],
         "variant_ms": {who: _mean(t[who]) for who in variants}, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": nbytes / HBM_BYTES_PER_MS, "bytes": nbytes, "read_bytes": read_bytes, "padded_read_bytes": R * Lr,
         "unitigs": U, "unitig_len": L, "batch_reads": R, "read_len": Lr, "cold_ms": cold_ms, "no_reads_ms": empty_ms,
         "spread_ms": spread_ms, "most_reads_on_a_unitig": most}
    print(f"consensus_vote ({what}: {R} reads of up to {Lr} bases on {U} x {L}, at most {most} on one unitig): "
          f"kernel {r['ms']:.4f} ms (turns {t['kernel']}; one call after the allocator's cache was emptied "
          f"{cold_ms:.4f} ms), "
          + "".join(f"variant {who} {ms:.4f} ms, " for who, ms in r["variant_ms"].items())
          + f"plain {plain_ms:.4f} ms, scatter_add_ + argmax {library_ms:.4f} ms, bound {r['bound_ms']:.4f} ms by "
          f"bytes ({nbytes} B, {read_bytes} of the {R * Lr} B of padded reads), {r['bound_ms'] / r['ms']:.1%} of "
          f"it; the kernel with no read {empty_ms:.4f} ms, "
          f"with the reads spread evenly over the unitigs {spread_ms:.4f} ms [{card}]", flush=True)
    return r


def vote_vs_plain(captured: dict, card: str, dev, variants: dict) -> dict:
    """K3 through ``polish(..., indel_band=0)`` on run (i)'s unitigs and
    placements: the kernel's polished unitigs equal the plain version's on
    the card and on the CPU; the first batch timed (``vote_turns``)."""
    unitigs, reads, placements = captured["unitigs"], captured["reads"], captured["placements"]
    calls = []
    vote = olc_consensus.consensus_vote

    def record(*args):
        calls.append(args)
        return vote(*args)

    olc_consensus.consensus_vote = record
    try:
        consensus_vote.reset_launch_counts()
        got = olc_consensus.polish(unitigs, reads, placements, indel_band=0, device=dev)
        launches = consensus_vote.launch_counts()["consensus_vote"]
    finally:
        olc_consensus.consensus_vote = vote
    olc_consensus.consensus_vote = consensus_vote.consensus_vote_plain
    try:
        plain = olc_consensus.polish(unitigs, reads, placements, indel_band=0, device=dev)
    finally:
        olc_consensus.consensus_vote = vote
    cpu = olc_consensus.polish(unitigs, reads, placements, indel_band=0, device="cpu")
    for a, b, c in zip(got, plain, cpu):
        assert np.array_equal(a, b) and np.array_equal(a, c), "consensus_vote differs from the plain version"
    changed = sum(not np.array_equal(a, u) for a, u in zip(got, unitigs))
    assert launches == len(calls) >= 1 and changed > 0, (launches, len(calls), changed)
    print(f"consensus_vote vs plain through polish(indel_band=0) on run (i)'s {len(unitigs)} unitigs and "
          f"{len(placements)} placements ({launches} batches): polished unitigs equal on the card (kernel, plain) "
          f"and the CPU, {changed} changed [{card}]", flush=True)
    r = vote_turns(calls[0], variants, "run (i)'s first batch", card)
    r.update(check_launches=launches, placements=len(placements), changed_unitigs=changed)
    return r


def vote_full_size(captured: dict, card: str, dev, variants: dict) -> dict:
    """K3 at the size phase 10 was specified with: run (i)'s unitigs and
    placements LR_REPEATS times over (copy c places its reads on unitigs
    c U .. c U + U - 1), through ``polish(..., indel_band=0)`` on the card.
    Every batch's polished codes and depths equal the plain version's on
    that batch's inputs; one call's peak device memory above its inputs
    stays under 6 B a cell (its outputs take 5: no vote table); the first
    batch, a full one, timed (``vote_turns``)."""
    unitigs, reads, placements = captured["unitigs"], captured["reads"], captured["placements"]
    U = len(unitigs)
    placed = [dataclasses.replace(p, target=p.target + c * U) for c in range(LR_REPEATS) for p in placements]
    calls = []
    vote = olc_consensus.consensus_vote

    def checked(*args):
        got = vote(*args)
        want = consensus_vote.consensus_vote_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            f"consensus_vote differs from the plain version in batch {len(calls)} at the full size"
        calls.append(args if not calls else None)  # keep the first batch's inputs
        return got

    olc_consensus.consensus_vote = checked
    try:
        consensus_vote.reset_launch_counts()
        olc_consensus.polish(unitigs * LR_REPEATS, reads, placed, indel_band=0, device=dev)
        launches = consensus_vote.launch_counts()["consensus_vote"]
    finally:
        olc_consensus.consensus_vote = vote
    args = calls[0]
    (UU, L), R = args[0].shape, args[1].shape[0]
    assert launches == len(calls) > 1 and R == LR_VOTE_BATCH, (launches, len(calls), R)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    consensus_vote.consensus_vote(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert peak < UU * L * 6, f"consensus_vote took {peak} B above its inputs on {UU} x {L}"
    print(f"consensus_vote at the full size (run (i)'s {U} unitigs and {len(placements)} placements x "
          f"{LR_REPEATS}: {UU} x {L}, {len(placed)} placements, {launches} batches): every batch's polished codes "
          f"and depths equal the plain version's; a call's peak device memory above its inputs {peak} B "
          f"({peak / (UU * L):.2f} B a cell) [{card}]", flush=True)
    r = vote_turns(args, variants, "the full size's first batch", card)
    r.update(check_launches=launches, placements=len(placed), call_peak_bytes=peak)
    return r


def long_card_vs_cpu(fasta: str, tmp: str) -> dict:
    """Runs (i)-(iv) on the first LR_CHECK reads on the card and on the
    CPU, (ii)-(iv) resumed from each device's own (i): every file
    byte-identical."""
    files = {}
    outs = {dev: os.path.join(tmp, f"lrc_{dev}") for dev in ("cuda", "cpu")}
    for dev, out in outs.items():
        cli.run(["-long", fasta, "-o", out, "-mem", "1", "--device", dev])
    files["default"] = len(same_tree(outs["cuda"], outs["cpu"]))
    for tag, extra in LR_RESUMED.items():
        res = {dev: os.path.join(tmp, f"lrc_{tag}_{dev}") for dev in outs}
        for dev, out in res.items():
            copy_corrected(outs[dev], out)
            cli.run(["-long", fasta, "-o", out, "-mem", "1", "--device", dev] + extra)
        files[tag] = len(same_tree(res["cuda"], res["cpu"]))
        for out in res.values():
            shutil.rmtree(out)
    for out in outs.values():
        shutil.rmtree(out)
    print(f"-long on the first {LR_CHECK} reads, card against CPU: every file byte-identical (files per run "
          f"{files})", flush=True)
    return files


def captured_run(fasta: str, out: str, truth: list, card: str) -> tuple:
    """Run (i), ``-long`` on the card (``long_run``), keeping what its
    polish step was given: (the run's results, {unitigs, reads,
    placements})."""
    captured = {}
    polish = olc_consensus.polish

    def keep(unitigs, reads, placements, **kw):
        captured.update(unitigs=list(unitigs), placements=list(placements),
                        reads=[np.array(reads[i]) for i in range(len(reads))])
        return polish(unitigs, reads, placements, **kw)

    olc_consensus.polish = keep
    try:
        run = long_run(["-long", fasta], out, truth, card, "(i) default")
    finally:
        olc_consensus.polish = polish
    return run, captured


def long_read_path(tmp: str, card: str, dev, transcripts: int = LR_TRANSCRIPTS, coverage: int = LR_COVERAGE,
                   variants: dict = None) -> dict:
    """Phase 10: -long four ways on the card (each with every launch count
    set to 0 before it), the three long-read kernels against their plain
    versions on the runs' own data, K1 and K2 (and each ``--lr-variant``)
    also at the phase's specified size, card against CPU."""
    variants = variants or {}
    t0 = time.time()
    rng = np.random.default_rng(0)
    truth = lrsim.simulate_transcriptome(rng, transcripts, (500, 4000))
    reads = lrsim.simulate_reads(rng, truth, coverage=coverage, err=LR_ERR)
    fasta, head = os.path.join(tmp, "long.fa"), os.path.join(tmp, "long_head.fa")
    with open(fasta, "w") as f, open(head, "w") as g:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
            if i < LR_CHECK:
                g.write(f">r{i}\n{r}\n")
    n_bases = sum(len(r) for r in reads)
    print(f"simulated {len(reads)} ONT-like cDNA reads, {n_bases} bases ({transcripts} transcripts of 500-4,000 "
          f"bases, coverage {coverage}, {LR_ERR:.0%} error, seed 0) in {time.time() - t0:.1f} s", flush=True)

    out_a = os.path.join(tmp, "long_a")
    run, captured = captured_run(fasta, out_a, truth, card)
    runs = {"default": run}
    launches = runs["default"]["launches"]
    assert launches.get("add_mf8", 0) > 0 and launches.get("walk_greedy", 0) > 0 and launches.get("set", 0) > 0, \
        launches
    for tag, extra in LR_RESUMED.items():
        out = os.path.join(tmp, f"long_{tag}")
        copy_corrected(out_a, out)
        runs[tag] = long_run(["-long", fasta] + extra, out, truth, card, f"{' '.join(extra)} (resumed from (i))")
        if tag == "paf":
            assert os.path.getsize(os.path.join(out, "rnabloom.ava.paf")) > 0
        shutil.rmtree(out)
    assert runs["strobemer"]["launches"].get("lr_kmer_keys", 0) > 0, runs["strobemer"]["launches"]
    assert runs["strobemer"]["launches"].get("lr_randstrobe_keys", 0) > 0, runs["strobemer"]["launches"]
    assert runs["kmer"]["launches"].get("lr_kmer_keys", 0) > 0, runs["kmer"]["launches"]
    corrected = [sequtils.encode(s) for _, s in fastx.read_fasta(
        os.path.join(out_a, "rnabloom.longreads.corrected.long.fa"))]
    shutil.rmtree(out_a)
    full = lr_keys_full_size(reads, card, dev, variants)
    r = {"reads": len(reads), "bases": n_bases, "transcripts_simulated": transcripts, "coverage": coverage,
         "runs": runs, "keys": lr_keys_vs_plain(corrected, card, dev, variants, full["sm_clocks_mhz"]),
         "full_size": full, "vote": vote_vs_plain(captured, card, dev, variants),
         "vote_full_size": vote_full_size(captured, card, dev, variants), "card_vs_cpu": long_card_vs_cpu(head, tmp)}
    return r


# ---- phase 11: the decision oracle, exact counts and terminators ----

EXACT_PAIRS = PAIRS  # phase 11: the exact-count build's pairs (250,000 of 500,000 before the pairs were cut)
EXACT_BATCH = 4096  # reads a build batch, as stage 1 takes them
MAX_REPLACES = "rnabloom_tpu/bloom/filters.py:378"  # counting_increment's .at[].max (XLA, no Pallas kernel)
CONSERVATIVE_REPLACES = "rnabloom_tpu/bloom/filters.py:322"  # counting_increment (XLA, no Pallas kernel)
GOLDEN_ORACLE = "tests/golden/oracle_divergence.json"
TERM_CFG = filters.BloomConfig(27, 2)  # phase 11's terminator filter
EXACT_NAME = "exact-count graph"


def head_codes(path: str, n: int) -> np.ndarray:
    """(n, READ_LEN) codes of the first ``n`` reads of a FASTQ file."""
    rows = []
    for _, seq, _ in fastx.read_seqs(path):
        rows.append(sequtils.encode(seq))
        if len(rows) == n:
            break
    codes, _ = sequtils.pack_batch(rows, len(rows), READ_LEN)
    return codes


@contextlib.contextmanager
def plain_inserts():
    """Route the filters' inserts and conservative update to the plain
    versions (on the card too)."""
    saved = filters.cell_insert, filters.conservative_update
    filters.cell_insert = lambda t, i, op, salt=0, values=None: ci.cell_insert_plain(t, i, op, salt, values)
    filters.conservative_update = ci.conservative_update_plain
    try:
        yield
    finally:
        filters.cell_insert, filters.conservative_update = saved


def composed_update(lib=None):
    """The conservative update composed of plain-torch gathers, min and
    encode (``ci.conservative_values``) and the ``max`` insert: the port's
    kernel, or ``lib``'s (an ``--insert-variant`` build)."""
    def update(counts, scratch, hashes, size_log2, scratch_log2, valid=None, dec_first=None, salt=0):
        idx, upd = ci.conservative_values(counts, scratch, hashes, size_log2, scratch_log2, valid, dec_first, salt)
        with insert_library(lib) if lib is not None else contextlib.nullcontext():
            return ci.cell_insert(counts, idx, "max", values=upd)
    return update


@contextlib.contextmanager
def conservative_as(update):
    """Route the filters' conservative update to ``update``."""
    saved = filters.conservative_update
    filters.conservative_update = update
    try:
        yield
    finally:
        filters.conservative_update = saved


@contextlib.contextmanager
def first_conservative_call(store: dict):
    """Record the first conservative update the filters make: its table as
    it was before and its arguments (copies)."""
    saved = filters.conservative_update

    def recording(counts, scratch, hashes, size_log2, scratch_log2, valid=None, dec_first=None, salt=0):
        if "table" not in store:
            store.update(table=counts.clone(), args=(scratch.clone(), hashes.clone(), size_log2, scratch_log2,
                                                     None if valid is None else valid.clone(),
                                                     None if dec_first is None else dec_first.clone(), salt))
        return saved(counts, scratch, hashes, size_log2, scratch_log2, valid, dec_first, salt)

    filters.conservative_update = recording
    try:
        yield
    finally:
        filters.conservative_update = saved


def oracle_on_card(card: str) -> dict:
    """``oracle.divergence.measure_all`` on the card (every launch count set
    to 0 before it) against the CPU's and the golden dict."""
    from rnabloom_tpu_torch.oracle import divergence

    reset_launch_counters()
    t0 = time.time()
    got = divergence.measure_all(device="cuda")
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {op: n for op, n in launch_counters().items() if n}
    cpu = divergence.measure_all(device="cpu")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), GOLDEN_ORACLE)) as f:
        golden = json.load(f)
    got, cpu = json.loads(json.dumps(got)), json.loads(json.dumps(cpu))
    if got != cpu or got != golden:
        diff = sorted(key for key in golden if got.get(key) != golden[key] or cpu.get(key) != golden[key])
        raise AssertionError(f"the oracle's dict on the card or the CPU differs from the golden in {diff}")
    assert all(launches.get(op, 0) > 0 for op in ("set", "add", *ci.CONSERVATIVE_OPS, "walk_greedy")), launches
    print(f"oracle.divergence.measure_all on the card: equal to the CPU's and to {GOLDEN_ORACLE} ({len(got)} keys; "
          f"greedy_agreement {got['greedy_agreement']}, tip_probe_agreement {got['tip_probe_agreement']}, "
          f"ec_output_agreement {got['ec_output_agreement']}, mf8_count_rel_err {got['mf8_count_rel_err']}); "
          f"{seconds:.2f} s; launches by op {launches} [{card}]", flush=True)
    return {"seconds": seconds, "launches": launches}


def exact_config(counter: str, exact: bool = True) -> dbg.GraphConfig:
    """``default_graph_config`` at -mem 1, k=25, in the conservative
    update's flat layout, with exact counts (or count-min)."""
    d_read, _ = stage1.read_length_params(np.full(16, READ_LEN), K, pipeline.PipelineParams().min_num_kmer_pairs)
    cfg = stage1.default_graph_config(K, False, 1 << 30, read_pair_distance=d_read, counter=counter)
    return dataclasses.replace(cfg, cbf=dataclasses.replace(cfg.cbf, blocked=False), exact_counts=exact)


def exact_build(cfg: dbg.GraphConfig, batches: list, dev):
    """Stage 1's build steps over ``batches`` into a fresh graph on the
    card (read pairs included): (graph, seconds)."""
    graph = engine.make_graph(cfg, with_rpkbf=True, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    for salt, codes in enumerate(batches):
        engine.build_step(graph, cfg, codes, add_read_pairs=True, salt=salt)
    torch.cuda.synchronize()
    return graph, time.time() - t0


def _same_graphs(a, b, what: str) -> None:
    for name in ("dbgbf", "cbf", "rpkbf"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what}: {name} differs from the fused kernel's build")


def exact_builds(left: str, right: str, card: str, dev, variants: dict) -> dict:
    """The exact-count stage-1 build at -mem 1 (int32: 2^27 dbgbf lanes,
    2^27 int32 cells, 2^27 rpkbf lanes; mf8: 2^29 cells) over the first
    EXACT_PAIRS pairs, in batches of EXACT_BATCH reads: with the kernels
    (the fused conservative update; every launch count set to 0 before),
    with the update composed of plain-torch gathers and the ``max`` kernel
    (the port's, and each ``--insert-variant``'s), and with the plain
    inserts, on the card: every table byte-identical; each build again in
    reverse order for the times in turns.  Then the first batch of the
    -cnt u16 build, fused against plain.  Also the count-min int32 graph of
    the same reads (flat layout), phase 11's walks' yardstick."""
    codes = np.concatenate([head_codes(left, EXACT_PAIRS), head_codes(right, EXACT_PAIRS)])
    batches = [codes[i : i + EXACT_BATCH] for i in range(0, len(codes), EXACT_BATCH)]
    out = {"reads": int(len(codes)), "batches": len(batches), "first": {}}
    ways = {"composition": composed_update()}
    ways.update({f"composition[{name}]": composed_update(lib) for name, lib in variants.items()
                 if hasattr(lib, "cell_max_i32")})
    for counter in ("int32", "mf8"):
        cfg = exact_config(counter)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counters()
        first = {}
        with first_conservative_call(first):
            kern, t_kern = exact_build(cfg, batches, dev)
        launches = {op: n for op, n in launch_counters().items() if n}
        peak = torch.cuda.max_memory_allocated()
        assert all(launches.get(op, 0) == len(batches) for op in ("add", *ci.CONSERVATIVE_OPS)), launches
        assert "max" not in launches, launches
        # each way once to check it, then the timed turns: fused, the
        # compositions, plain, then in reverse (the first build of a
        # process also loads the kernels)
        seconds = {}
        turns = ["fused", *ways, "plain"]
        for i, who in enumerate(turns[1:] + turns + turns[::-1]):
            ctx = plain_inserts() if who == "plain" else (
                contextlib.nullcontext() if who == "fused" else conservative_as(ways[who]))
            with ctx:
                other, t = exact_build(cfg, batches, dev)
            _same_graphs(other, kern, f"exact -cnt {counter} build, {who}")
            if i >= len(turns) - 1:
                seconds.setdefault(who, []).append(t)
            del other
        step_ms = {who: _mean(t) * 1e3 / len(batches) for who, t in seconds.items()}
        member = float((kern.dbgbf[: cfg.dbgbf.size] != 0).double().mean())
        out[counter] = {"launches": launches, "seconds": t_kern, "plain_seconds": _mean(seconds["plain"]),
                        "step_ms": step_ms, "peak_bytes": peak, "dbgbf_log2": cfg.dbgbf.size_log2,
                        "cbf_log2": cfg.cbf.size_log2, "rpkbf_log2": cfg.pkbf.size_log2,
                        "dbgbf_set_share": member, "fprs": engine.fprs(kern, cfg)}
        print(f"exact-count build -cnt {counter} (dbgbf 2^{cfg.dbgbf.size_log2} lanes, cbf 2^{cfg.cbf.size_log2} "
              f"{counter} cells, rpkbf 2^{cfg.pkbf.size_log2}; {out['reads']} reads of the first {EXACT_PAIRS} "
              f"pairs in {len(batches)} batches): dbgbf, cbf and rpkbf byte-identical between the fused kernel, "
              f"{', '.join(ways)} and the plain inserts; ms a build step (turns "
              f"{', '.join(f'{who} ' + '/'.join(f'{x * 1e3 / len(batches):.4f}' for x in t) for who, t in seconds.items())}"
              f"): {', '.join(f'{who} {ms:.4f}' for who, ms in step_ms.items())}; launches {launches}; peak device "
              f"memory {peak} B ({peak / 2**30:.3f} GiB); dbgbf lanes set {member:.4f}, FPRs {out[counter]['fprs']} "
              f"[{card}]", flush=True)
        out["first"][counter] = first
        if counter == "int32":
            out["graph"], out["cfg"] = kern, cfg
        del kern
    # -cnt u16: the first batch, fused against the plain inserts
    cfg = exact_config("u16")
    reset_launch_counters()
    first = {}
    with first_conservative_call(first):
        kern, _ = exact_build(cfg, batches[:1], dev)
    launches = {op: n for op, n in launch_counters().items() if n}
    with plain_inserts():
        plain, _ = exact_build(cfg, batches[:1], dev)
    _same_graphs(plain, kern, "exact -cnt u16 build's first batch, plain inserts")
    assert all(launches.get(op, 0) == 1 for op in ci.CONSERVATIVE_OPS), launches
    out["u16"] = {"launches": launches, "cbf_log2": cfg.cbf.size_log2}
    out["first"]["u16"] = first
    print(f"exact-count build -cnt u16, the first batch (cbf 2^{cfg.cbf.size_log2} u16 cells): byte-identical to the "
          f"plain inserts; launches {launches} [{card}]", flush=True)
    del kern, plain
    cm_cfg = exact_config("int32", exact=False)
    out["cm_graph"], _ = exact_build(cm_cfg, batches, dev)
    out["cm_cfg"] = cm_cfg
    return out


def _per_launch_ms(fn, reset, reps: int = 10) -> list:
    """Card time of ``fn`` per call, each call after ``reset()`` (outside
    its events; the reset and a sleep of the card keep it busy while the
    host enqueues the call)."""
    events = []
    for _ in range(reps):
        reset()
        torch.cuda._sleep(PAD_CYCLES)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def _sectors(cells: torch.Tensor, table: torch.Tensor) -> int:
    """Distinct 32 B sectors that ``cells`` (in range) of ``table`` lie in."""
    return torch.unique(cells * table.element_size() // SECTOR).numel()


def _raised_sectors(before: torch.Tensor, after: torch.Tensor) -> int:
    return _sectors(torch.nonzero(before != after).reshape(-1), before)


def max_bound_ms(idx: torch.Tensor, values: torch.Tensor, before: torch.Tensor, after: torch.Tensor) -> tuple:
    """Least time of a max launch, by bytes over the card's memory rate: its
    indices and values read once, a 32 B sector read a distinct in-range
    cell's sector and written a raised one's; and the bound without the
    writes, one sector a distinct cell (the row's earlier formula)."""
    cells = idx[(idx >= 0) & (idx < before.numel())]
    inputs = idx.numel() * idx.element_size() + values.numel() * values.element_size()
    reads = _sectors(cells, before) * SECTOR
    return ((inputs + reads + _raised_sectors(before, after) * SECTOR) / HBM_BYTES_PER_MS,
            (inputs + torch.unique(cells).numel() * SECTOR) / HBM_BYTES_PER_MS)


def _turns(fns: dict, reset, order: list) -> dict:
    """Per-launch times of each function in ``fns``, in the turns of
    ``order`` then its reverse, 5 calls a turn, each after ``reset()``."""
    t = {who: [] for who in fns}
    for who in order + order[::-1]:
        t[who] += _per_launch_ms(fns[who], reset, reps=5)
    return {who: _mean(v) for who, v in t.items()}


def max_cell(table0: torch.Tensor, idx: torch.Tensor, values: torch.Tensor, what: str, card: str,
             variants: dict) -> dict:
    """The max kernel against its plain version, ``scatter_reduce_`` (amax;
    none for uint16 cells, which torch would compare signed) and each
    ``--insert-variant`` on one batch: equal tables; per-launch times in
    turns (plain, library, variants, kernel, then in reverse), every call on
    a fresh copy of ``table0``."""
    work = torch.empty_like(table0)
    keep = (idx >= 0) & (idx < table0.numel())
    idx_in, values_in = idx[keep], values[keep]
    fns = {
        "kernel": lambda: ci.cell_insert(work, idx, "max", values=values),
        "plain": lambda: ci.cell_insert_plain(work, idx, "max", values=values),
    }
    if table0.dtype != torch.int16:
        fns["library"] = lambda: work.scatter_reduce_(0, idx_in, values_in, "amax")

    def variant(lib):
        def call():
            with insert_library(lib):
                ci.cell_insert(work, idx, "max", values=values)
        return call

    fns.update({name: variant(lib) for name, lib in variants.items() if hasattr(lib, "cell_max_i32")})
    outs = {}
    for who, fn in fns.items():
        work.copy_(table0)
        fn()
        outs[who] = work.clone()
    torch.cuda.synchronize()
    for who in fns:
        if not torch.equal(outs["kernel"], outs[who]):
            raise AssertionError(f"cell_insert[max] != {who} on {what}: "
                                 f"{int((outs['kernel'] != outs[who]).sum())} cells differ")
    after = outs["kernel"]
    del outs
    raised = int((after != table0).sum())
    bound, read_bound = max_bound_ms(idx, values, table0, after)
    del after
    order = ["plain", *(["library"] if "library" in fns else []), *[w for w in fns if w not in ("kernel", "plain",
                                                                                                 "library")], "kernel"]
    t = _turns(fns, lambda: work.copy_(table0), order)
    r = {"ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t.get("library"),
         "variant_ms": {w: t[w] for w in fns if w not in ("kernel", "plain", "library")},
         "bound_ms": bound, "read_bound_ms": read_bound, "indices": int(idx.numel()), "raised_cells": raised,
         "max_abs_err": 0.0}
    library = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    print(f"cell_insert[max] ({what}, {idx.numel()} indices into {table0.numel()} {table0.dtype} cells, {raised} "
          f"cells raised): equal to {', '.join(w for w in fns if w != 'kernel')}; per launch kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {library}"
          + "".join(f", {w} {ms:.4f} ms" for w, ms in r["variant_ms"].items())
          + f"; bound {bound:.4f} ms by bytes at 3.35 TB/s ({read_bound:.4f} without the writes) [{card}]",
          flush=True)
    return r


MAX_DTYPE_OF = {"int32": torch.int32, "u16": torch.int16, "mf8": torch.uint8}
MAX_HIGH = {"int32": 1 << 20, "u16": 1 << 16, "mf8": 128}  # the synthetic batch's values and cells
MAX_SYNTH_CELLS = (1 << 27) + 1  # the synthetic batch's table


def max_cells(first: dict, card: str, dev, variants: dict) -> dict:
    """The max rows, for int32, u16 and mf8 cells: the exact builds' first
    batch (the table before it, the indices and values the composed update
    gives its max) and a synthetic 2^20-index batch (a prefilled
    2^27-cell table, a 10^5-fold cell, the trash cell, dropped indices)."""
    out = {}
    for counter in ("int32", "u16", "mf8"):
        f = first[counter]
        idx, values = ci.conservative_values(f["table"], *f["args"])
        real = max_cell(f["table"], idx, values, f"the exact -cnt {counter} build's first batch", card, variants)
        del idx, values
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        numel = MAX_SYNTH_CELLS
        hi = MAX_HIGH[counter]
        table0 = torch.randint(0, hi, (numel,), generator=gen, device=dev).to(torch.int32)
        table0 = torch.where(table0 >= 32768, table0 - 65536, table0) if counter == "u16" else table0
        table0 = table0.to(MAX_DTYPE_OF[counter])
        idx = _batch(numel, gen, dev)
        values = torch.randint(0, hi, (idx.numel(),), generator=gen, device=dev).to(torch.int32)
        values = (torch.where(values >= 32768, values - 65536, values) if counter == "u16" else values).to(
            MAX_DTYPE_OF[counter])
        synth = max_cell(table0, idx, values, f"synthetic, {counter} cells", card, variants)
        del table0, idx, values
        out[counter] = {"real": real, "synthetic": synth}
    return out


def conservative_bounds_ms(before: torch.Tensor, after: torch.Tensor, args: tuple, words: torch.Tensor) -> dict:
    """Least times by bytes over the card's memory rate, a 32 B sector a
    distinct cell read or a raised cell written: ``update`` (the keys read
    once: hashes, valid, dec_first; the distinct scratch and count cells
    read; the raised cells written), its first launch ``values`` (the keys
    and the cells read, an 8 B word a key written) and its second ``raise``
    (the words and the masked lanes' hashes and valid bytes read, the
    distinct masked cells read, the raised cells written)."""
    scratch, hashes, size_log2, scratch_log2, valid, dec_first, _ = args
    keys = sum(t.numel() * t.element_size() for t in (hashes, valid, dec_first) if t is not None)
    lanes = filters._bcast_valid(valid, hashes)
    cells = filters.bloom_indices(hashes, size_log2, lanes).reshape(-1, hashes.shape[-1])
    scratch_cells = filters.bloom_indices(hashes, scratch_log2, lanes).reshape(-1)
    reads = (_sectors(cells.reshape(-1), before) + _sectors(scratch_cells, scratch)) * SECTOR
    writes = _raised_sectors(before, after) * SECTOR
    mask = _word_masks(words, hashes.shape[-1])
    lane_bytes = hashes.element_size() + (0 if valid is None else 1)  # a masked lane's hash and valid byte
    raise_reads = (words.numel() * words.element_size() + int(mask.sum()) * lane_bytes
                   + _sectors(cells[mask], before) * SECTOR)
    return {"update": (keys + reads + writes) / HBM_BYTES_PER_MS,
            "values": (keys + reads + words.numel() * words.element_size()) / HBM_BYTES_PER_MS,
            "raise": (raise_reads + writes) / HBM_BYTES_PER_MS}


def _word_masks(words: torch.Tensor, h: int) -> torch.Tensor:
    """The lanes (n, h) that the first launch's words send to the raise."""
    return ((words[:, None] >> (32 + torch.arange(h, device=words.device))) & 1).bool()


def words_plain(table0: torch.Tensor, args: tuple) -> torch.Tensor:
    """The first launch's words by plain PyTorch: a key's encoded value
    (low 32 bits) and the lanes whose pre-batch cell is below it, compared
    as the cells are ordered (uint16 unsigned)."""
    scratch, hashes, size_log2, scratch_log2, valid, dec_first, salt = args
    idx, upd = ci.conservative_values(table0, *args)
    h = hashes.shape[-1]
    idx, upd = idx.reshape(-1, h), upd.reshape(-1, h)[:, 0]
    bits = {torch.int32: 0xFFFFFFFF, torch.int16: 0xFFFF, torch.uint8: 0xFF}[table0.dtype]
    low = upd.to(torch.int64) & bits  # the value's bits as the kernel writes them
    if table0.dtype == torch.int32:  # int32 cells compare signed, the others unsigned
        value, cells = upd.to(torch.int64), table0[idx].to(torch.int64)
    else:
        value, cells = low, table0[idx].to(torch.int64) & bits
    below = (cells < value[:, None]).to(torch.int64) << (32 + torch.arange(h, device=table0.device))
    return below.sum(dim=1) | low


def conservative_cell(table0: torch.Tensor, args: tuple, what: str, card: str, variants: dict,
                      timed: bool = True) -> dict:
    """The conservative update (its two launches) against its plain
    version and the composed update (plain-torch gathers and the port's
    max kernel, and each ``--insert-variant``'s), and each
    ``--insert-variant``'s own update, on one batch: equal tables, the
    first launch's words equal to their plain version's.  Per-call times
    in turns (plain, compositions, variants, each launch alone, the
    update, then in reverse), every call on a fresh copy of ``table0``:
    the first launch alone against the plain gathers and encode
    (``ci.conservative_values``); the second alone, from the pre-batch
    words, against the plain max and ``scatter_reduce_`` (amax; none for
    uint16 cells) on its masked lanes."""
    scratch, hashes, size_log2, scratch_log2, valid, dec_first, salt = args
    h = hashes.shape[-1]
    work = torch.empty_like(table0)
    words = ci.conservative_words(table0, *args)
    expect = words_plain(table0, args)
    if not torch.equal(words, expect):
        raise AssertionError(f"conservative update's words != plain on {what}: "
                             f"{int((words != expect).sum())} keys differ")
    del expect
    mask = _word_masks(words, h)
    cells = filters.bloom_indices(hashes, size_log2, filters._bcast_valid(valid, hashes)).reshape(-1, h)[mask]
    value = (words[:, None].expand(-1, h)[mask] & 0xFFFFFFFF)
    value = (torch.where(value >= 1 << 31, value - (1 << 32), value) if table0.dtype == torch.int32 else
             torch.where(value >= 32768, value - 65536, value) if table0.dtype == torch.int16 else value).to(table0.dtype)

    def variant(lib, fn):
        def call():
            with insert_library(lib):
                fn()
        return call

    fns = {
        "kernel": lambda: ci.conservative_update(work, *args),
        "plain": lambda: ci.conservative_update_plain(work, *args),
        "composition": lambda: composed_update()(work, *args),
        "values": lambda: ci.conservative_words(work, *args),
        "values_plain": lambda: ci.conservative_values(work, *args),
        "raise": lambda: ci.conservative_raise(work, words, hashes, size_log2, valid),
        "raise_plain": lambda: ci.cell_insert_plain(work, cells, "max", values=value),
    }
    if table0.dtype != torch.int16:
        fns["raise_library"] = lambda: work.scatter_reduce_(0, cells, value, "amax")
    for name, lib in variants.items():
        if hasattr(lib, "cell_max_i32"):
            fns[f"composition[{name}]"] = (lambda lib: lambda: composed_update(lib)(work, *args))(lib)
        if hasattr(lib, "cell_conservative_values_i32"):
            fns[f"kernel[{name}]"] = variant(lib, fns["kernel"])
            fns[f"values[{name}]"] = variant(lib, fns["values"])
    tables = [w for w in fns if not w.startswith("values")]
    outs = {}
    for who in tables:
        work.copy_(table0)
        fns[who]()
        outs[who] = work.clone()
    torch.cuda.synchronize()
    for who in tables:
        if not torch.equal(outs["kernel"], outs[who]):
            raise AssertionError(f"conservative update != {who} on {what}: "
                                 f"{int((outs['kernel'] != outs[who]).sum())} cells differ")
    after = outs["kernel"]
    del outs
    raised = int((after != table0).sum())
    bounds = conservative_bounds_ms(table0, after, args, words)
    r = {"keys": int(hashes.numel() // h), "hashes": int(h), "raised_cells": raised, "raise_lanes": int(mask.sum()),
         "bound_ms": bounds["update"], "values_bound_ms": bounds["values"], "raise_bound_ms": bounds["raise"],
         "max_abs_err": 0.0}
    del after
    if timed:
        order = ["plain", "values_plain", "raise_plain", *(["raise_library"] if "raise_library" in fns else []),
                 *[w for w in fns if w.startswith("composition")], *[w for w in fns if "[" in w and
                                                                    not w.startswith("composition")],
                 "values", "raise", "kernel"]
        t = _turns(fns, lambda: work.copy_(table0), order)
        r.update(ms=t["kernel"], plain_ms=t["plain"], composition_ms=t["composition"],
                 values_ms=t["values"], values_plain_ms=t["values_plain"], raise_ms=t["raise"],
                 raise_plain_ms=t["raise_plain"], raise_library_ms=t.get("raise_library"),
                 variant_ms={w: t[w] for w in fns if "[" in w})
    library = "none" if r.get("raise_library_ms") is None else f"{r['raise_library_ms']:.4f} ms"
    print(f"conservative update ({what}, {r['keys']} keys of {h} hashes into {table0.numel()} {table0.dtype} "
          f"cells, {r['raise_lanes']} lanes raised in launch 2, {raised} cells raised): equal to "
          f"{', '.join(w for w in tables if w != 'kernel')}, launch 1's words equal to plain"
          + (f"; per call the update {r['ms']:.4f} ms (launch 1 alone {r['values_ms']:.4f} ms, launch 2 alone "
             f"{r['raise_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, composition {r['composition_ms']:.4f} ms, "
             f"launch 1's plain gathers and encode {r['values_plain_ms']:.4f} ms, launch 2's plain max "
             f"{r['raise_plain_ms']:.4f} ms and library {library}"
             + "".join(f", {w} {ms:.4f} ms" for w, ms in r["variant_ms"].items())
             + f"; bounds by bytes at 3.35 TB/s: update {r['bound_ms']:.4f} ms, launch 1 {r['values_bound_ms']:.4f}"
             f" ms, launch 2 {r['raise_bound_ms']:.4f} ms" if timed else "")
          + f" [{card}]", flush=True)
    return r


def collision_args(counter: str, dev) -> tuple:
    """A prefilled 2^10-cell table and a batch whose keys collide heavily
    on it (200,000 keys of 3 hashes: one key 40,000 times, 1,000 keys 60
    times each, invalid keys and dec_first), after its scratch sketch."""
    rng = np.random.default_rng(17)
    size_log2, scratch_log2, h, n = 10, 10, 3, 200_000
    table = rng.integers(0, MAX_HIGH[counter], (1 << size_log2) + 1).astype(np.int64)
    if counter == "u16":
        table = np.where(table >= 32768, table - 65536, table)
    vals = rng.integers(-(2**63), 2**63 - 1, size=(n, h), dtype=np.int64)
    vals[: n // 5] = vals[0]
    vals[n // 5 : n // 2] = vals[n // 5 : n // 5 + 1000][rng.integers(0, 1000, n // 2 - n // 5)]
    rng.shuffle(vals)
    hashes = torch.from_numpy(vals).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    dec = torch.from_numpy(rng.random(n) < 0.3).to(dev) & valid
    scratch = torch.zeros((1 << scratch_log2) + 1, dtype=torch.int32, device=dev)
    ci.cell_insert_plain(scratch, filters.bloom_indices(hashes, scratch_log2, filters._bcast_valid(valid, hashes))
                         .reshape(-1), "add")
    table = torch.from_numpy(table).to(MAX_DTYPE_OF[counter]).to(dev)
    return table, (scratch, hashes, size_log2, scratch_log2, valid, dec, 977)


def conservative_cells(first: dict, card: str, dev, variants: dict) -> dict:
    """The fused update's rows: on each exact build's first batch (timed)
    and on the collision table, for int32, u16 and mf8 cells."""
    out = {}
    for counter in ("int32", "u16", "mf8"):
        f = first[counter]
        real = conservative_cell(f["table"], f["args"], f"the exact -cnt {counter} build's first batch", card,
                                 variants)
        table, args = collision_args(counter, dev)
        collide = conservative_cell(table, args, f"a 2^10-cell {counter} table where keys collide", card, variants,
                                    timed=False)
        out[counter] = {"real": real, "collision": collide}
    return out


def gated_walk_cell(what: str, run, plain_run, yardstick, card: str, st) -> dict:
    """A walk cell of phase 11: the kernel against the plain loop in every
    field, and the kernel's time in turns with ``yardstick`` (the same
    seeds with the count-min graph, or without terminators): kernel,
    yardstick, yardstick, kernel.  The two take different paths, so each
    time is also given per hop.  (The replays that counted the cells for
    a bound were cut for the smoke's time: PERF.md keeps the bounds.)"""
    kern = run()
    yard = yardstick()
    torch.cuda.synchronize()
    t0 = time.time()
    plain = plain_run()
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    fields = WALK_FIELDS
    bad = [f for f in fields if not torch.equal(getattr(kern, f), getattr(plain, f))]
    if bad:
        raise AssertionError(f"{what}: the kernel differs from the plain loop in {bad}")
    t = {"kernel": [], "yardstick": []}
    for who in ("kernel", "yardstick", "yardstick", "kernel"):
        t[who].append(_time_ms(run if who == "kernel" else yardstick, reps=5))
    status = torch.bincount(kern.status.long(), minlength=7).tolist()
    r = {"ms": _mean(t["kernel"]), "yardstick_ms": _mean(t["yardstick"]), "plain_ms": plain_ms,
         "lanes": int(st.pos.shape[0]), "hops": int(kern.hops.sum()), "statuses": status,
         "yardstick_hops": int(yard.hops.sum()),
         "yardstick_statuses": torch.bincount(yard.status.long(), minlength=7).tolist(),
         "max_abs_err": _max_abs_diff(kern, plain)}
    r["ns_per_hop"] = r["ms"] * 1e6 / max(r["hops"], 1)
    r["yardstick_ns_per_hop"] = r["yardstick_ms"] * 1e6 / max(r["yardstick_hops"], 1)
    print(f"{what}: {r['lanes']} lanes, every WalkState field equal to the plain loop; {r['hops']} hops, statuses "
          f"{status}; kernel {r['ms']:.4f} ms ({', '.join(f'{x:.4f}' for x in t['kernel'])}), yardstick "
          f"{r['yardstick_ms']:.4f} ms ({', '.join(f'{x:.4f}' for x in t['yardstick'])}; {r['yardstick_hops']} hops, "
          f"statuses {r['yardstick_statuses']}); per hop {r['ns_per_hop']:.3f} ns against {r['yardstick_ns_per_hop']:.3f} "
          f"ns; plain {plain_ms:.1f} ms [{card}]", flush=True)
    return r


def exact_walks(built: dict, seeds: np.ndarray, naive_start: tuple, truth, card: str, dev) -> dict:
    """Phase 11's walk cells on the exact int32 graph, each against the
    plain loop and timed in turns with the count-min int32 graph of the
    same reads: greedy on phase 4's bridge seeds, naive on phase 8's right
    walks; then terminators (the k-mers of every other simulated
    transcript, by ``screen_add``) on the greedy lanes over the count-min
    graph, timed in turns with the same walks without them."""
    ex, ecfg, cm, ccfg = built["graph"], built["cfg"], built["cm_graph"], built["cm_cfg"]
    wcfg, _ = fragments.bridge_walk_configs(ecfg, fragments.FragmentParams())
    st = traverse.make_walks(ecfg, wcfg, seeds, device=dev)
    mc, bd = traverse.lane_args(st, 1.0, fragments.FragmentParams().bound)
    greedy = gated_walk_cell(
        f"walk_greedy over the {EXACT_NAME} (phase 4's bridge seeds)",
        lambda: walk.walk_greedy(st, ex, ecfg, wcfg, mc, bd), lambda: walk.walk_greedy_plain(st, ex, ecfg, wcfg, mc, bd),
        lambda: walk.walk_greedy(st, cm, ccfg, wcfg, mc, bd), card, st)
    nst, nwcfg, nmc, nbd = naive_start
    naive = gated_walk_cell(
        f"walk_naive over the {EXACT_NAME} (phase 8's right -extend walks)",
        lambda: walk.walk_naive(nst, ex, ecfg, nwcfg, nmc, nbd),
        lambda: walk.walk_naive_plain(nst, ex, ecfg, nwcfg, nmc, nbd),
        lambda: walk.walk_naive(nst, cm, ccfg, nwcfg, nmc, nbd), card, nst)
    bases, offsets, lengths = truth
    rows = [bases[offsets[i] : offsets[i] + lengths[i]] for i in range(0, len(lengths), 2)]
    tx_codes, _ = sequtils.pack_batch(rows, len(rows), int(lengths.max()))
    lanes = filters.make_bloom(TERM_CFG, device=dev)
    transcripts.screen_add(lanes, TERM_CFG, ccfg, tx_codes)
    twcfg = dataclasses.replace(wcfg, use_terminators=True, term_cfg=TERM_CFG)
    term = gated_walk_cell(
        "walk_greedy with terminators over the count-min int32 graph (phase 4's bridge seeds; the k-mers of "
        f"{len(rows)} of the {len(lengths)} simulated transcripts)",
        lambda: walk.walk_greedy(st, cm, ccfg, twcfg, mc, bd, terminators=lanes),
        lambda: walk.walk_greedy_plain(st, cm, ccfg, twcfg, mc, bd, terminators=lanes),
        lambda: walk.walk_greedy(st, cm, ccfg, wcfg, mc, bd), card, st)
    n_term = term["statuses"][traverse.TERM]
    live = int((st.status == traverse.ACTIVE).sum())
    assert 0 < n_term < live, (n_term, live)
    print(f"terminators: {n_term} of the {live} live lanes ended TERM [{card}]", flush=True)
    return {"greedy": greedy, "naive": naive, "term": {**term, "term_lanes": n_term, "live_lanes": live}}


# ---- phase 12: the sharded graph engine (-sharded on) ----

MESH_PAIRS = 100_000  # phase 12: both mates of these pairs (49 batches of 4096 reads) into each mesh build
MESH_SHARDS = (2, 8)  # phase 12's meshes on one card
MESH_STAGE3_PAIRS = 20_000  # phase 12's -stage 3 run on the 8-shard mesh and on one device
MESH_FILES = ("rnabloom.graph.cbf.npy", "rnabloom.graph.rpkbf.npy")  # checkpoints: the mesh zeroes the trash cells


@contextlib.contextmanager
def routing_events(dev, store: list):
    """Record a pair of CUDA events on ``dev``'s stream around every routed
    call of the sharded engine (``sharded._routed_rounds``)."""
    saved = sharded._routed_rounds

    def timed(*args, **kw):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        out = saved(*args, **kw)
        stop.record(torch.cuda.current_stream(dev))
        store.append((start, stop))
        return out

    sharded._routed_rounds = timed
    try:
        yield
    finally:
        sharded._routed_rounds = saved


@contextlib.contextmanager
def mesh_env(walk_env: str):
    """RNB_MESH_WALK set to ``walk_env`` inside the block."""
    saved = os.environ.get("RNB_MESH_WALK")
    os.environ["RNB_MESH_WALK"] = walk_env
    try:
        yield
    finally:
        if saved is None:
            del os.environ["RNB_MESH_WALK"]
        else:
            os.environ["RNB_MESH_WALK"] = saved


@contextlib.contextmanager
def mesh_as_visible(mesh):
    """``engine.make_mesh_if_multi`` gives ``mesh``: the pipeline's
    -sharded on runs on it."""
    saved = engine.make_mesh_if_multi
    engine.make_mesh_if_multi = lambda device="cuda", min_devices=2: mesh
    try:
        yield
    finally:
        engine.make_mesh_if_multi = saved


def _devices_of(mesh, dev) -> tuple:
    return mesh.distinct if mesh is not None else (sharded.make_mesh([dev]).devices[0],)


def mesh_build(cfg: dbg.GraphConfig, batches: list, dev, mesh=None):
    """Stage 1's build steps over ``batches`` (read pairs included) into a
    fresh graph on ``dev`` or sharded over ``mesh``: (graph, stats), each
    step timed by CUDA events on ``dev``'s stream, and on a mesh its routed
    calls too; the collectives and bytes from ``comm_accounting``, the
    routed calls that took a second round, peak device memory above what
    was allocated before (the graph included) and launches (every launch
    count set to 0 before)."""
    ci._batch_tables.clear()
    torch.cuda.empty_cache()
    devices = _devices_of(mesh, dev)
    held = {}
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
        held[d] = torch.cuda.memory_allocated(d)
    graph = engine.make_graph(cfg, with_rpkbf=True, device=dev, mesh=mesh)
    sharded.reset_routing_counts()
    reset_launch_counters()
    steps, routes = [], []
    for d in devices:
        torch.cuda.synchronize(d)
    t0 = time.time()
    with sharded.comm_accounting() as comm, routing_events(dev, routes):
        for salt, codes in enumerate(batches):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            engine.build_step(graph, cfg, codes, add_read_pairs=True, salt=salt)
            stop.record(torch.cuda.current_stream(dev))
            steps.append((start, stop))
    for d in devices:
        torch.cuda.synchronize(d)
    wall = time.time() - t0
    step_ms = [a.elapsed_time(b) for a, b in steps]
    return graph, {
        "steps": len(steps), "step_ms": statistics.median(step_ms), "steps_ms": sum(step_ms),
        "routing_ms": sum(a.elapsed_time(b) for a, b in routes), "wall_s": wall,
        "a2a_per_step": comm["all_to_all"] / len(steps), "psum_per_step": comm["psum"] / len(steps),
        "a2a_bytes_per_shard_per_step": comm["a2a_bytes_per_shard"] / len(steps),
        "routed_calls": sharded.ROUTING["calls"], "second_rounds": sharded.ROUTING["second_rounds"],
        "peak_bytes": {str(d): torch.cuda.max_memory_allocated(d) - held[d] for d in devices},
        "launches": {op: n for op, n in launch_counters().items() if n},
    }


def mesh_equals_single(mg, single, cfg: dbg.GraphConfig, what: str) -> None:
    """Every lane of every shard outside its trash equals the single-device
    table's, compared on the card."""
    for name in ("dbgbf", "cbf", "rpkbf"):
        table, shards = getattr(single, name), getattr(mg.state, name)
        assert (table is None) == (shards is None), (what, name)
        if table is None:
            continue
        local = table.numel() - (cfg.cbf.trash if name == "cbf" else 1)
        local //= len(shards)
        for s, shard in enumerate(shards):
            if not torch.equal(shard[:local], table[s * local : (s + 1) * local].to(shard.device)):
                raise AssertionError(f"{what}: {name} shard {s} differs from the single-device build")


def mesh_counts_equal(mg, single, cfg: dbg.GraphConfig, codes: np.ndarray, what: str) -> None:
    """Counts of ``codes`` on the mesh, from the replica and routed to the
    shards, equal the single-device counts."""
    want = engine.count_step(single, cfg, codes)
    for walk_env in ("replicated", "routed"):
        with mesh_env(walk_env):
            got = engine.count_step(mg, cfg, codes)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{what}: {walk_env} counts differ from the single-device counts")


def _mesh_line(what: str, st: dict, one: dict, cfg: dbg.GraphConfig, card: str) -> str:
    return (f"{what}: every lane outside the trash equal to the single-device kernel build (cbf 2^{cfg.cbf.size_log2} "
            f"{cfg.cbf.dtype}{' blocked' if cfg.cbf.blocked else ''}{', exact' if cfg.exact_counts else ''}, rpkbf "
            f"2^{cfg.pkbf.size_log2}; {st['steps']} steps); a step {st['step_ms']:.3f} ms median, {st['steps_ms']:.1f} "
            f"ms in all (single device {one['step_ms']:.3f} / {one['steps_ms']:.1f}); routing "
            f"{st['routing_ms']:.1f} ms, {st['routing_ms'] / st['steps_ms']:.1%} of the steps' card time; "
            f"{st['a2a_per_step']:.2f} all-to-alls and {st['psum_per_step']:.2f} all-reduces a step, "
            f"{st['a2a_bytes_per_shard_per_step']:.0f} all-to-all B a shard a step; {st['second_rounds']} of "
            f"{st['routed_calls']} routed calls took a second round; peak device memory {st['peak_bytes']} B "
            f"(single device {one['peak_bytes']}); launches {st['launches']}; host wall {st['wall_s']:.2f} s [{card}]")


MESH_WALK_HEAD = 256  # lanes of each mesh walk cell that the plain routed loop walks on the card
MESH_WALK_REPLACES = "rnabloom_tpu/parallel/sharded.py:815"  # sharded_extend_walks (grouped: :914)
MESH_PAIR_LANES = 2048  # the pair cell's lanes: the first reads as fragments (read pairs only: no fpkbf)


def mesh_walk_lanes(left: str, right: str, single, cfg: dbg.GraphConfig, dev) -> dict:
    """Phase 12's walk cells' lanes, from the single-device build of its
    reads: mode -> (walks, WalkConfig at the mesh walks' speculative depth,
    min_cov, bound).  Greedy: the first stage-2 batch's bridge seeds (as
    phase 4 derives them); naive: its right -extend walks (as phase 8);
    pair: the first MESH_PAIR_LANES reads as stage-3 fragments."""
    seeds = stage2_walk_seeds(left, right, single, cfg)
    gw, _ = fragments.bridge_walk_configs(cfg, fragments.FragmentParams())
    g = traverse.make_walks(cfg, gw, seeds, device=dev)
    _, _, captured, _ = first_batch_naive_walks((single, cfg), left, right, dev)
    nst, nw, nmc, nbd, _ = captured[0]
    tparams = transcripts.TranscriptParams()
    pw = traverse.WalkConfig(max_len=tparams.max_walk_len, pair_ring=tparams.pair_ring, lookahead=tparams.lookahead)
    rows = head_codes(left, MESH_PAIR_LANES)
    p = traverse.make_walks(cfg, pw, rows, np.full(len(rows), READ_LEN), device=dev)
    return {
        "greedy": (g, sharded._with_spec_default(gw), *traverse.lane_args(g, 1.0, fragments.FragmentParams().bound)),
        "naive": (nst, sharded._with_spec_default(nw), nmc, nbd),
        "pair": (p, sharded._with_spec_default(pw), *traverse.lane_args(p, 1.0, tparams.bound)),
    }


def mesh_walk_cells(mg, mesh, cfg: dbg.GraphConfig, lanes: dict, what: str, card: str) -> dict:
    """The sharded walk kernel on ``mesh`` in each mode, on the lanes of
    ``mesh_walk_lanes``: every field equal to the single-device kernel on
    the mesh's replica at the full lane count, and on the first
    MESH_WALK_HEAD lanes to the plain routed loop on the card (routed
    reads, the lanes split over the shards); both kernels timed in turns
    (sharded, single, single, sharded).  The bound: the state read and
    written once and the 4 candidates' cells of every hop taken, a sector
    each (a hop reads at least those)."""
    rep = engine._replicated_graph(mg, cfg)
    out = {}
    for mode, (st, wcfg, mc, bd) in lanes.items():
        name = f"walk_{mode}_sharded"
        fields = PAIR_FIELDS if mode == "pair" else WALK_FIELDS
        n0 = walk.launch_counts()[name]
        devices = mesh.distinct
        for d in devices:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        held = {d: torch.cuda.memory_allocated(d) for d in devices}
        kern = walk.walk_mesh(mode, st, mg.state, mesh, cfg, wcfg, mc, bd)
        for d in devices:
            torch.cuda.synchronize(d)
        walk_peak = max(torch.cuda.max_memory_allocated(d) - held[d] for d in devices)
        assert walk.launch_counts()[name] == n0 + len(mesh.distinct)
        one_device = getattr(walk, f"walk_{mode}")
        one = one_device(st, rep, cfg, wcfg, mc, bd)
        torch.cuda.synchronize()
        bad = [f for f in fields if not torch.equal(getattr(kern, f), getattr(one, f))]
        if bad:
            raise AssertionError(f"{name} on {what}: differs from the single-device kernel on the replica in {bad}")
        h = MESH_WALK_HEAD
        head = traverse.take_lanes(st, slice(0, h))
        t0 = time.time()
        plain = walk.walk_mesh_plain(mode, head, mg.state, mesh, cfg, wcfg, mc[:h].contiguous(), bd[:h].contiguous())
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        bad = [f for f in fields if not torch.equal(getattr(plain, f), getattr(kern, f)[:h])]
        if bad:
            raise AssertionError(f"{name} on {what}: differs from the plain routed loop on its first {h} lanes in {bad}")
        t = {"sharded": [], "single": []}
        for who in ("sharded", "single", "single", "sharded"):
            run = ((lambda: walk.walk_mesh(mode, st, mg.state, mesh, cfg, wcfg, mc, bd)) if who == "sharded"
                   else (lambda: one_device(st, rep, cfg, wcfg, mc, bd)))
            t[who].append(_time_ms(run, reps=3))
        hops = int(kern.hops.sum())
        reads = hops * 4 * cfg.cbf.num_hash * (2 if cfg.exact_counts else 1)
        status = torch.bincount(kern.status.long(), minlength=7).tolist()
        state_bytes = sum(x.numel() * x.element_size() for x in st if x is not None)
        r = out[mode] = {
            "peak_bytes": walk_peak, "state_bytes": state_bytes,
            "lanes": int(st.pos.shape[0]), "max_len": wcfg.max_len, "spec_hops": wcfg.spec_hops, "ms": _mean(t["sharded"]),
            "single_ms": _mean(t["single"]), "turns_ms": t, "plain_ms": plain_ms, "plain_lanes": h, "hops": hops,
            "max_hops": int(kern.hops.max()), "statuses": status, "bound_ms": walk_bound_ms(st, mc, bd, reads),
            "max_abs_err": max(_max_abs_diff(kern, one, fields), _max_abs_diff(traverse.take_lanes(kern, slice(0, h)),
                                                                              plain, fields)),
        }
        print(f"{name}, {what}: {r['lanes']} lanes (max_len {r['max_len']}, spec_hops {r['spec_hops']}), every field "
              f"equal to the single-device kernel on the replica, and on the first {h} to the plain routed loop; "
              f"{hops} hops (most {r['max_hops']}), statuses {status}; sharded kernel {r['ms']:.4f} ms a launch "
              f"({', '.join(f'{x:.4f}' for x in t['sharded'])}), single-device kernel {r['single_ms']:.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in t['single'])}); bound {r['bound_ms']:.4f} ms ({reads} cells at "
              f"least); plain routed loop {plain_ms:.1f} ms on {h} lanes; the sharded call's peak device memory "
              f"{walk_peak} B above its inputs (the walk state {state_bytes} B) [{card}]", flush=True)
        del kern, one, plain
    return out


def mesh_builds(left: str, right: str, card: str, dev) -> dict:
    """The stage-1 build at -mem 1 (mf8: 2^29 cells, 2^27 rpkbf lanes) over
    both mates of the first MESH_PAIRS pairs on meshes of 2 and 8 shards on
    one card, and over the distinct cards where more than one is visible,
    each against the single-device kernel build; then one batch each of
    -cnt u16, the blocked int32 cbf and the exact int32 path (max) on 8
    shards (and 2, where the layout allows it)."""
    codes = np.concatenate([head_codes(left, MESH_PAIRS), head_codes(right, MESH_PAIRS)])
    batches = [codes[i : i + EXACT_BATCH] for i in range(0, len(codes), EXACT_BATCH)]
    cards = torch.cuda.device_count()
    print(f"visible cards: {cards}; {len(codes)} reads in {len(batches)} batches of {EXACT_BATCH}", flush=True)
    cfg = exact_config("mf8", exact=False)
    single, one = mesh_build(cfg, batches, dev)
    out = {"reads": int(len(codes)), "batches": len(batches), "cards": cards, "single": one, "meshes": {},
           "walks": {}}
    lanes = mesh_walk_lanes(left, right, single, cfg, dev)
    meshes = {f"{n} shards on one card": sharded.make_mesh([dev] * n) for n in MESH_SHARDS}
    multi = engine.make_mesh_if_multi(dev)
    if multi is not None:
        meshes[f"{multi.size} shards, one a card"] = multi
    for what, mesh in meshes.items():
        mg, st = mesh_build(cfg, batches, dev, mesh)
        mesh_equals_single(mg, single, cfg, what)
        mesh_counts_equal(mg, single, cfg, codes[:2000], what)
        assert st["launches"].get("add_mf8", 0) == mesh.size * len(batches), st["launches"]
        out["meshes"][what] = st
        print(_mesh_line(f"stage-1 build, {what}", st, one, cfg, card), flush=True)
        out["walks"][what] = mesh_walk_cells(mg, mesh, cfg, lanes, what, card)
        del mg
    del single, lanes
    torch.cuda.empty_cache()
    d_read = cfg.read_pair_distance
    for name, ccfg, sizes in (
        ("-cnt u16", exact_config("u16", exact=False), MESH_SHARDS),
        ("-cnt int32 (blocked)", stage1.default_graph_config(K, False, 1 << 30, read_pair_distance=d_read,
                                                             counter="int32"), (8,)),
        ("-cnt int32, exact counts (max)", exact_config("int32"), MESH_SHARDS),
    ):
        single, one = mesh_build(ccfg, batches[:1], dev)
        for n in sizes:
            mg, st = mesh_build(ccfg, batches[:1], dev, sharded.make_mesh([dev] * n))
            mesh_equals_single(mg, single, ccfg, f"{name} on {n} shards")
            op = "max" if ccfg.exact_counts else ("add_u16" if ccfg.cbf.dtype == "u16" else "add")
            assert st["launches"].get(op, 0) == n, st["launches"]
            out["meshes"][f"{name}, {n} shards, one batch"] = st
            print(_mesh_line(f"{name}, the first batch, {n} shards on one card", st, one, ccfg, card), flush=True)
            del mg
        del single
    return out


def _distinct_kmers(cbf: np.ndarray, size: int, num_hash: int, sharded_arith: bool) -> int:
    """Stage 1's distinct-k-mer estimate (``stage1.build_graph``) from a
    saved cbf, its FPR by the mesh's arithmetic (float64 power) or one
    device's (float32)."""
    nonzero = int(np.count_nonzero(cbf[:size]))
    if sharded_arith:
        fpr = float(torch.tensor(float(nonzero), dtype=torch.float32) / size) ** num_hash
    else:
        fpr = filters._fpr(nonzero, size, num_hash)
    fill = min(fpr ** (1.0 / num_hash), 0.999999)
    return int(-size / num_hash * math.log1p(-fill)) if fill > 0 else 0


def mesh_vs_single_tree(mesh_out: str, single_out: str) -> dict:
    """Every file of the mesh run equals the single-device run's but for
    what the JAX package's mesh run differs in (``tests/test_torch_mesh.py``):
    the checkpoint's trash cells, which the mesh zeroes, report.json's
    elapsed_s, and the read statistics' distinct-k-mer estimate, which a
    mesh takes from its FPRs in float64 (each run's must equal its own
    engine's estimate from its saved cbf)."""
    rel = sorted(os.path.relpath(os.path.join(d, f), mesh_out) for d, _, fs in os.walk(mesh_out) for f in fs)
    rel_b = sorted(os.path.relpath(os.path.join(d, f), single_out) for d, _, fs in os.walk(single_out) for f in fs)
    if rel != rel_b:
        raise AssertionError(f"file sets differ: {sorted(set(rel) ^ set(rel_b))}")
    with open(os.path.join(mesh_out, "rnabloom.graph.graph.json")) as f:
        desc = json.load(f)
    notes = {}
    for f in rel:
        a, b = os.path.join(mesh_out, f), os.path.join(single_out, f)
        if filecmp.cmp(a, b, shallow=False):
            continue
        if f in MESH_FILES:
            x, y = np.load(a), np.load(b)
            trash = 128 if "cbf" in f and desc["cbf"].get("blocked") else 1
            if not (np.array_equal(x[:-trash], y[:-trash]) and not x[-trash:].any()):
                raise AssertionError(f"{f}: the mesh run's checkpoint differs outside the trash cells")
            notes[f] = "trash cells"
        elif f == "rnabloom.report.json":
            with open(a) as g, open(b) as h:
                x, y = json.load(g), json.load(h)
            x.pop("elapsed_s"), y.pop("elapsed_s")
            if x != y:
                raise AssertionError(f"report.json differs: {x} != {y}")
        elif f == "rnabloom.readstats":
            with open(a) as g, open(b) as h:
                x, y = json.load(g), json.load(h)
            cbf = np.load(os.path.join(single_out, "rnabloom.graph.cbf.npy"))
            size, h_ = 1 << desc["cbf"]["size_log2"], desc["cbf"]["num_hash"]
            if ({k: v for k, v in x.items() if k != "distinct_kmers"} != {k: v for k, v in y.items()
                                                                           if k != "distinct_kmers"}
                    or x["distinct_kmers"] != _distinct_kmers(cbf, size, h_, True)
                    or y["distinct_kmers"] != _distinct_kmers(cbf, size, h_, False)):
                raise AssertionError("readstats differ beyond the FPR arithmetic")
            notes[f] = f"distinct_kmers {x['distinct_kmers']} / {y['distinct_kmers']}"
        else:
            raise AssertionError(f"{f} differs between the mesh run and the single-device run")
    return {"files": len(rel), "allowed": notes}


ENGINE_CALLS = ("build_step", "rebuild_step", "count_step", "pair_support_both", "counts_and_read_support",
                "variant_exists", "extend_walks")


@contextlib.contextmanager
def peak_by_call(store: dict):
    """The largest device-memory peak above its start of each engine call
    (``ENGINE_CALLS``) inside the block, in ``store``; ``store["run"]``
    keeps the peak over the block, which the calls' own resets would hide."""
    saved = {name: getattr(engine, name) for name in ENGINE_CALLS}

    def wrapped(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            store["run"] = max(store.get("run", 0), torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            store[name] = max(store.get(name, 0), peak - held)
            store["run"] = max(store["run"], peak)
            return out
        return call

    for name, fn in saved.items():
        setattr(engine, name, wrapped(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(engine, name, fn)
        store["run"] = max(store.get("run", 0), torch.cuda.max_memory_allocated())


@contextlib.contextmanager
def counted_replicas(store: list):
    """Append the device of every replica of a mesh graph that the engine
    gathers for its queries and walks inside the block."""
    saved = engine._replicated_graph

    def counted(graph, cfg, device=None):
        store.append(device)
        return saved(graph, cfg, device)

    engine._replicated_graph = counted
    try:
        yield
    finally:
        engine._replicated_graph = saved


def same_mesh_run(a: str, b: str, tag: str) -> list:
    """Every file of two mesh runs byte-identical, report.json but its
    elapsed_s; returns the files compared."""
    with open(os.path.join(a, "rnabloom.report.json")) as f, open(os.path.join(b, "rnabloom.report.json")) as g:
        x, y = json.load(f), json.load(g)
    x.pop("elapsed_s"), y.pop("elapsed_s")
    if x != y:
        raise AssertionError(f"{tag} mesh -stage 3 report.json differs from the replicated run's: {x} != {y}")
    rel = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    rel_b = sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b) for f in fs)
    if rel != rel_b:
        raise AssertionError(f"{tag}: file sets differ: {sorted(set(rel) ^ set(rel_b))}")
    for f in rel:
        if f != "rnabloom.report.json" and not filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False):
            raise AssertionError(f"{tag}: {f} differs from the replicated mesh run's")
    return rel


def mesh_pipeline(left: str, right: str, small: tuple, tmp: str, card: str, dev) -> dict:
    """-stage 3 (the nr pass included, -savebf) through pipeline.assemble_pe
    at -mem 1 on MESH_STAGE3_PAIRS pairs with -sharded on over 8 shards on
    the card (every launch count set to 0 before it), against the
    single-device run of the same pairs; then the mesh run on the first
    STAGE3_PAIRS pairs on the card and on 8 CPU shards, byte-identical."""
    mesh = sharded.make_mesh([dev] * 8)
    runs = {}
    for tag, sharding, walk_env in (("mesh", "on", "replicated"), ("single", "off", "replicated"),
                                    ("routed", "on", "routed"), ("grouped", "on", "grouped")):
        out = os.path.join(tmp, f"mesh_{tag}")
        ci._batch_tables.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launch_counters()
        sharded.reset_routing_counts()
        replicas, calls = [], {}
        t0 = time.time()
        with mesh_as_visible(mesh), mesh_env(walk_env), counted_replicas(replicas), \
                (peak_by_call(calls) if tag == "routed" else contextlib.nullcontext()):
            rep = pipeline.assemble_pe(left, right, out, pipeline.PipelineParams(sharded=sharding), save_graph=True,
                                       device="cuda")
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(), calls.pop("run", 0))
        runs[tag] = {"wall_s": time.time() - t0, "stage1_s": rep.stage1.elapsed_s, "stage2_s": rep.stage2_s,
                     "stage3_s": rep.stage3_s, "transcripts": rep.num_transcripts, "nr": rep.num_nr,
                     "fragments": rep.num_fragments, "peak_bytes": peak - held, "call_peak_bytes": calls,
                     "launches": {op: n for op, n in launch_counters().items() if n},
                     "routed_calls": sharded.ROUTING["calls"], "replicas": len(replicas)}
        check_transcripts(out, rep, K)
    launches = runs["mesh"]["launches"]
    assert all(launches.get(op, 0) > 0 for op in ("add_mf8", "set", "walk_greedy", "walk_pair")), launches
    assert runs["mesh"]["routed_calls"] > 0 and runs["single"]["routed_calls"] == 0
    same = mesh_vs_single_tree(os.path.join(tmp, "mesh_mesh"), os.path.join(tmp, "mesh_single"))
    # the routed and grouped runs: every file byte-identical to the replicated run's (report.json but elapsed_s)
    for tag in ("routed", "grouped"):
        got = runs[tag]["launches"]
        assert all(got.get(op, 0) > 0 for op in ("add_mf8", "set", "walk_greedy_sharded", "walk_pair_sharded")), got
        assert got.get("walk_greedy", 0) == 0 and got.get("walk_pair", 0) == 0, got
        runs[tag]["files"] = len(same_mesh_run(os.path.join(tmp, f"mesh_{tag}"), os.path.join(tmp, "mesh_mesh"), tag))
    assert runs["routed"]["replicas"] == 0 and runs["routed"]["routed_calls"] > 0
    for tag in runs:
        shutil.rmtree(os.path.join(tmp, f"mesh_{tag}"))
    m, s1 = runs["mesh"], runs["single"]
    print(f"-stage 3 -savebf on {MESH_STAGE3_PAIRS} pairs, -sharded on over 8 shards on the card against one device: "
          f"{same['files']} files, equal but for {same['allowed'] or 'nothing'} (and report.json's elapsed_s); "
          f"{m['transcripts']} transcripts, {m['nr']} nr, {m['fragments']} fragments; wall mesh {m['wall_s']:.1f} s "
          f"(stage 1 {m['stage1_s']:.2f}, stage 2 {m['stage2_s']:.2f}, 2b and 3 {m['stage3_s']:.2f}), one device "
          f"{s1['wall_s']:.1f} s ({s1['stage1_s']:.2f}, {s1['stage2_s']:.2f}, {s1['stage3_s']:.2f}); peak device "
          f"memory {m['peak_bytes']} / {s1['peak_bytes']} B; mesh launches {launches}, {m['routed_calls']} routed "
          f"calls [{card}]", flush=True)
    for tag in ("routed", "grouped"):
        x = runs[tag]
        print(f"-stage 3 -savebf -sharded on over 8 shards, RNB_MESH_WALK={tag}{' (R = 2)' if tag == 'grouped' else ''}"
              f": {x['files']} files byte-identical to the replicated run's (report.json but elapsed_s); wall "
              f"{x['wall_s']:.1f} s (stage 1 {x['stage1_s']:.2f}, stage 2 {x['stage2_s']:.2f}, 2b and 3 "
              f"{x['stage3_s']:.2f}); peak device memory {x['peak_bytes']} B, {x['peak_bytes'] / s1['peak_bytes']:.3f} "
              f"times one device's, {x['peak_bytes'] / m['peak_bytes']:.3f} times the replicated run's; "
              f"{x['replicas']} replicas of the graph; launches {x['launches']}, {x['routed_calls']} routed calls"
              + (f"; the largest peak above its start by engine call, B: {x['call_peak_bytes']}"
                 if x["call_peak_bytes"] else "") + f" [{card}]", flush=True)

    # -stage 2 -extend on the first STAGE3_PAIRS pairs, routed against replicated: the naive sharded kernel's path
    for tag, walk_env in (("extend_replicated", "replicated"), ("extend_routed", "routed")):
        out = os.path.join(tmp, f"mesh_{tag}")
        reset_launch_counters()
        t0 = time.time()
        with mesh_as_visible(mesh), mesh_env(walk_env):
            pipeline.assemble_pe(*small, out, pipeline.PipelineParams(sharded="on", stop_stage=2,
                                                                      extend_fragments=True),
                                 save_graph=True, device="cuda")
        torch.cuda.synchronize()
        runs[tag] = {"wall_s": time.time() - t0, "launches": {op: n for op, n in launch_counters().items() if n}}
    got = runs["extend_routed"]["launches"]
    assert got.get("walk_naive_sharded", 0) > 0 and got.get("walk_greedy_sharded", 0) > 0, got
    assert got.get("walk_naive", 0) == 0, got
    runs["extend_routed"]["files"] = len(same_tree(os.path.join(tmp, "mesh_extend_routed"),
                                                   os.path.join(tmp, "mesh_extend_replicated")))
    print(f"-stage 2 -extend -sharded on over 8 shards on the first {STAGE3_PAIRS} pairs, RNB_MESH_WALK=routed: "
          f"{runs['extend_routed']['files']} files byte-identical to the replicated run's; wall "
          f"{runs['extend_routed']['wall_s']:.1f} s (replicated {runs['extend_replicated']['wall_s']:.1f}); launches "
          f"{got} [{card}]", flush=True)
    for tag in ("extend_replicated", "extend_routed"):
        shutil.rmtree(os.path.join(tmp, f"mesh_{tag}"))

    # the same mesh run on the card and on 8 CPU shards
    outs = {}
    for device, mesh_ in (("cuda", mesh), ("cpu", sharded.make_mesh(["cpu"] * 8))):
        outs[device] = os.path.join(tmp, f"mesh_small_{device}")
        t0 = time.time()
        with mesh_as_visible(mesh_):
            rep = pipeline.assemble_pe(*small, outs[device], pipeline.PipelineParams(sharded="on"), save_graph=True,
                                       device=device)
        runs[f"small_{device}_s"] = time.time() - t0
    report_json = "rnabloom.report.json"
    with open(os.path.join(outs["cuda"], report_json)) as f, open(os.path.join(outs["cpu"], report_json)) as g:
        a, b = json.load(f), json.load(g)
    a.pop("elapsed_s"), b.pop("elapsed_s")
    if a != b:
        raise AssertionError(f"mesh -stage 3 report.json differs between card and CPU: {a} != {b}")
    for out in outs.values():
        os.remove(os.path.join(out, report_json))
    files = same_tree(outs["cuda"], outs["cpu"])
    print(f"-stage 3 -savebf -sharded on over 8 shards on the first {rep.num_pairs} pairs: card and CPU outputs "
          f"byte-identical ({len(files)} files, report.json equal but elapsed_s); {rep.num_transcripts} transcripts; "
          f"wall card {runs['small_cuda_s']:.1f} s, CPU {runs['small_cpu_s']:.1f} s", flush=True)
    for out in outs.values():
        shutil.rmtree(out)
    runs["card_vs_cpu_files"] = len(files)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walk-variant", action="append", default=[], metavar="NAME=PATH",
                    help="another walk kernel source (same C entry points) to check and time in phases 4, 6, 7 and 8")
    ap.add_argument("--insert-variant", action="append", default=[], metavar="NAME=PATH",
                    help="another insert kernel source (same C entry points) to check and time in phase 2")
    ap.add_argument("--lr-variant", action="append", default=[], metavar="NAME=PATH",
                    help="another long-read kernel source (same C entry points) to check and time in phase 10")
    args = ap.parse_args(argv)
    variant_srcs = dict(v.split("=", 1) for v in args.walk_variant)
    insert_srcs = dict(v.split("=", 1) for v in args.insert_variant)
    lr_srcs = dict(v.split("=", 1) for v in args.lr_variant)
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
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    left, right = os.path.join(tmp, "reads_1.fq"), os.path.join(tmp, "reads_2.fq")
    t0 = time.time()
    try:
        with ThreadPoolExecutor(2 + len(variant_srcs) + len(insert_srcs) + len(lr_srcs)) as pool:
            port_build = pool.submit(_build.build_all)
            chase_build = pool.submit(build_chase)
            variant_builds = {name: pool.submit(build_variant, "walk", i, src)
                              for i, (name, src) in enumerate(variant_srcs.items())}
            insert_builds = {name: pool.submit(build_variant, "insert", i, src)
                             for i, (name, src) in enumerate(insert_srcs.items())}
            lr_builds = {name: pool.submit(build_variant, "lr", i, src)
                         for i, (name, src) in enumerate(lr_srcs.items())}
            # the reads are simulated while nvcc compiles
            t_sim = time.time()
            truth = pesim.write_pe_fastq(
                left, right, seed=0, num_transcripts=2000, tx_len=(1000, 4000),
                num_pairs=PAIRS, read_len=READ_LEN, frag_range=(250, 400), sub_rate=0.003,
            )
            sim_s = time.time() - t_sim
            built = port_build.result()
            chase = chase_build.result()
            variants = {name: f.result() for name, f in variant_builds.items()}
            insert_variants = {name: f.result() for name, f in insert_builds.items()}
            lr_variants = {name: f.result() for name, f in lr_builds.items()}
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    print(f"kernels built in parallel in {time.time() - t0:.2f} s: "
          + (", ".join(f"{os.path.relpath(src, os.path.dirname(os.path.abspath(__file__)))} "
                       f"{sec:.2f} s" for src, sec in built.items()) or "all up to date")
          + "".join(f"; walk variant {name} from {src}" for name, src in variant_srcs.items())
          + "".join(f"; insert variant {name} from {src}" for name, src in insert_srcs.items())
          + "".join(f"; long-read variant {name} from {src}" for name, src in lr_srcs.items()))
    logs = [_build.build_logs.get(lib)
            for lib in (*_build.WALK_COUNT_MIN_LIBS, _build.WALK_EXACT_LIB, _build.WALK_TERM_LIB)]
    if None in logs:
        print("walk kernel libraries not rebuilt in this run (up to date): no ptxas report")
    else:
        print("nvcc -Xptxas -v, walk kernel instantiations <layout, num_hash (0: any), past depth 3, mode> (the "
              "count-min greedy, count-min pair and naive, exact-count, and terminator libraries):")
        for line in ptxas_report("\n".join(logs)):
            print("  " + line)
    log = _build.build_logs.get(_build.KERNEL_LIB)
    if log is not None:
        print("nvcc -Xptxas -v, insert kernels: " + "; ".join(insert_ptxas(log)))
    log = _build.build_logs.get(_build.LR_LIB)
    if log is not None:
        print("nvcc -Xptxas -v, long-read kernels: "
              + "; ".join(insert_ptxas(log, "kmer_keys|randstrobe|vote"))
              + "; randstrobe_kernel's dynamic shared memory at -lrsub 5,11,0,50: "
                f"{_build.lr_kernels().lr_randstrobe_smem(LR_N, LR_WMAX)} B")
    print(f"native FASTX reader in use: {native.available()}", flush=True)

    try:
        print(f"simulated {PAIRS:,} pairs (2000 transcripts, seed 0) in {sim_s:.1f} s while the kernels built",
              flush=True)
        heads = {}
        for n in (STAGE2_PAIRS, STAGE1_PAIRS, MESH_STAGE3_PAIRS, STAGE3_PAIRS, EXTEND_BATCHES * BATCH2):
            heads[n] = (os.path.join(tmp, f"head{n}_1.fq"), os.path.join(tmp, f"head{n}_2.fq"))
            head_fastq(left, heads[n][0], n)
            head_fastq(right, heads[n][1], n)

        phase("2 insert kernel vs plain PyTorch on the card (stage-1 shapes at -mem 1)")
        real = real_batches(sample_reads(left, set(range(REAL_READS)), READ_LEN), dev)
        timing = kernel_vs_plain(dev, card, real, insert_variants)
        real_indices = {op: b.numel() for op, b in real.items()}
        del real

        phase("3 main path: -stage 3 -savebf -cnt mf8 (the nr pass included) and -stage 1 -savebf -cnt u16 on "
              f"{PAIRS:,} pairs, --device cuda, -mem 1")
        rng = np.random.default_rng(1)
        picks = set(rng.choice(PAIRS, 5_000, replace=False).tolist())
        codes = np.concatenate([sample_reads(p, picks, READ_LEN) for p in (left, right)])
        out_mf8 = os.path.join(tmp, "out_mf8")
        launches, s2_report, s2_peak, s2_buffer, s3 = main_path(left, right, out_mf8, "mf8", 3, PAIRS, codes, card, dev)
        assert launches["add_mf8"] > 0 and launches["set"] > 0 and launches["walk_greedy"] > 0, launches
        assert launches["walk_pair"] > 0, launches
        assert 0 < s2_buffer <= 64 << 20, f"the -cnt mf8 run's insert buffer is {s2_buffer} B"
        out_u16 = os.path.join(tmp, "out_u16")
        u16_launches, _, _, u16_buffer, _ = main_path(left, right, out_u16, "u16", 1, PAIRS, codes, card, dev)
        assert u16_launches["add_u16"] > 0 and u16_launches["set"] > 0, u16_launches
        assert u16_buffer == 0, "the -cnt u16 run allocated an insert buffer"

        phase("4 walk kernel vs plain PyTorch on the card (bridge seeds of the first stage-2 batch)")
        walk_t = {
            "mf8": walk_vs_plain(os.path.join(out_mf8, "rnabloom.graph"), left, right,
                                 f"{PAIRS_K}-pair graph, -cnt mf8, 2^29 cells", card, dev, variants),
            "u16": walk_vs_plain(os.path.join(out_u16, "rnabloom.graph"), left, right,
                                 f"{PAIRS_K}-pair graph, -cnt u16, 2^28 cells", card, dev, variants),
        }
        shutil.rmtree(out_u16)

        phase(f"5 card vs CPU: -stage 1 on {STAGE1_PAIRS:,} pairs, -stage 2 on {STAGE2_PAIRS} pairs, -stage 3 and "
              f"-stage 2 -extend on {STAGE3_PAIRS} pairs, byte-identical outputs; the golden dataset on the card")
        run_launches = {"add_mf8": launches["add_mf8"], "set": launches["set"],
                        "add_u16": u16_launches["add_u16"]}
        mf8_run = f"main path, -cnt mf8 -stage 3, {PAIRS:,} pairs"
        run_of = {"add_mf8": mf8_run, "set": mf8_run, "add_u16": f"main path, -cnt u16 -stage 1, {PAIRS:,} pairs"}
        for counter, op in (("mf8", "add_mf8"), ("u16", "add_u16"), ("int32", "add")):
            ci.reset_launch_counts()
            ci._batch_tables.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            gpu_out, cpu_out = os.path.join(tmp, f"gpu_{counter}"), os.path.join(tmp, f"cpu_{counter}")
            run_cli(*heads[STAGE1_PAIRS], gpu_out, "cuda", counter)
            torch.cuda.synchronize()
            n_launch = ci.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            run_cli(*heads[STAGE1_PAIRS], cpu_out, "cpu", counter)
            for f in CKPT_FILES:
                if not filecmp.cmp(os.path.join(gpu_out, f), os.path.join(cpu_out, f), shallow=False):
                    raise AssertionError(f"-cnt {counter}: {f} differs between card and CPU")
            assert n_launch[op] > 0, n_launch
            if op not in run_launches:
                run_launches[op] = n_launch[op]
                run_of[op] = f"main path, -cnt {counter}, {STAGE1_PAIRS // 1000}k pairs"
            print(f"-cnt {counter} -stage 1: card and CPU checkpoints byte-identical ({', '.join(CKPT_FILES)}); "
                  f"card launches {n_launch}; card peak device memory {peak} B ({peak / 2**30:.3f} GiB, the "
                  f"-mem 1 filters) [{card}]", flush=True)
            shutil.rmtree(gpu_out)
            shutil.rmtree(cpu_out)
        for counter in ("mf8", "u16"):
            gpu_out, cpu_out = os.path.join(tmp, f"gpu2_{counter}"), os.path.join(tmp, f"cpu2_{counter}")
            walk.reset_launch_counts()
            t0 = time.time()
            rep = run_cli(*heads[STAGE2_PAIRS], gpu_out, "cuda", counter, 2)
            t_gpu = time.time() - t0
            n_walk = walk.launch_counts()["walk_greedy"]
            t0 = time.time()
            run_cli(*heads[STAGE2_PAIRS], cpu_out, "cpu", counter, 2)
            t_cpu = time.time() - t0
            files = same_tree(gpu_out, cpu_out)
            assert n_walk > 0 and rep.num_fragments > 0 and any(f.endswith(".nbits") for f in files)
            print(f"-cnt {counter} -stage 2: card and CPU outputs byte-identical, {len(files)} files "
                  f"({', '.join(files)}); {rep.num_fragments} fragments of {rep.num_pairs} pairs, d_frag "
                  f"{rep.fragment_pair_distance}; walk launches {n_walk}; CLI wall card {t_gpu:.1f} s, "
                  f"CPU {t_cpu:.1f} s", flush=True)
            n_rebuild = rebuild_card_vs_cpu(gpu_out, cpu_out, counter)
            print(f"-cnt {counter} stage 2b on that output: card and CPU rebuilt filters byte-identical "
                  f"({', '.join(REBUILT_FILES)}); card launches {n_rebuild}", flush=True)
            shutil.rmtree(gpu_out)
            shutil.rmtree(cpu_out)
        card_cpu3 = stage3_card_vs_cpu(*heads[STAGE3_PAIRS], tmp)
        extend_cpu = extend_card_vs_cpu(*heads[STAGE3_PAIRS], tmp)
        golden_on_card(tmp, card)

        phase(f"6 stage 2b and the stage-3 extension walks on the {PAIRS_K}-pair -cnt mf8 -stage 2 output, on the card")
        # the main path of this slice: the rebuild, then the extension of
        # stage 3's first batches, with every launch count set to 0 before
        ci.reset_launch_counts()
        walk.reset_launch_counts()
        rebuilt, cfg6, store6, rebuild = rebuild_main_path(out_mf8, card, dev)
        rebuild_launches = ci.launch_counts()
        pair_variants = {name: lib for name, lib in variants.items() if hasattr(lib, "walk_pair")}
        pair = pair_vs_plain(rebuilt, cfg6, store6, card, dev, pair_variants, chase)
        assert walk.launch_counts()["walk_greedy"] == 0
        assert rebuild_launches["add_mf8"] > 0 and rebuild_launches["set"] > 0, rebuild_launches
        print(f"phase 6 main-path launches: rebuild {rebuild_launches}, extension walk_pair {pair['launches']}",
              flush=True)

        phase("7 stage 3's greedy walks (gap re-walks, tip and depth probes, the screen as a graph) vs plain PyTorch "
              f"on the rebuilt {PAIRS_K}-pair graph")
        greedy3 = stage3_walks_vs_plain(rebuilt, cfg6, store6, card, dev, variants)
        del rebuilt
        torch.cuda.empty_cache()

        phase(f"8 naive walk kernel vs plain PyTorch (-extend walks of the first stage-2 batch on the {PAIRS_K}-pair mf8 "
              f"graph), then -stage 2 -extend on the first {EXTEND_BATCHES} batches, on the card")
        naive_variants = {name: lib for name, lib in variants.items() if hasattr(lib, "walk_naive")}
        naive = naive_vs_plain(os.path.join(out_mf8, "rnabloom.graph"), left, right, card, dev, naive_variants)
        shutil.rmtree(out_mf8)
        extend_run = extend_main_path(*heads[EXTEND_BATCHES * BATCH2], os.path.join(tmp, "out_extend"), card)

        phase(f"9 single-end -stage 3, -pool -mergepool, -stage 2 -rescue and -k 25,27 -ntcard on slices of the {PAIRS_K} "
              "pairs, the single-end pair walks vs plain PyTorch, card vs CPU on each, on the card")
        short = short_read_paths(tmp, left, right, card, dev)

        phase("10 -long (default, -lrsub strobemers, -lrsub k-mers, -paf) on simulated ONT cDNA reads, the long-read "
              "kernels vs plain PyTorch on the runs' own data, card vs CPU, on the card")
        lr = long_read_path(tmp, card, dev, variants=lr_variants)

        phase("11 the decision oracle on the card; the exact-count stage-1 build at -mem 1 on the first "
              f"{EXACT_PAIRS} pairs, the fused conservative update vs the composed update and the plain inserts; "
              "the max insert and the fused update on the builds' first batches; walks over the exact-count graph "
              "and with terminators, vs plain PyTorch, on the card")
        oracle = oracle_on_card(card)
        built = exact_builds(left, right, card, dev, insert_variants)
        cons_launches = {op: oracle["launches"][op] + sum(built[c]["launches"][op] for c in ("int32", "mf8", "u16"))
                         for op in ci.CONSERVATIVE_OPS}
        first = built.pop("first")
        maxc = max_cells(first, card, dev, insert_variants)
        consc = conservative_cells(first, card, dev, insert_variants)
        del first
        gated = exact_walks(built, walk_t["mf8"]["seed_rows"], naive["right_start"], truth, card, dev)
        exact_runs = {c: built[c] for c in ("int32", "mf8", "u16")}
        del built
        torch.cuda.empty_cache()

        phase("12 the sharded graph engine (-sharded on) and its routed and grouped walks: the stage-1 build at -mem 1 "
              "on meshes of 2 and 8 shards on "
              f"the card (and one shard a card where several are visible) against one device, on both mates of the "
              f"first {MESH_PAIRS} pairs; -stage 3 on the 8-shard mesh against one device on {MESH_STAGE3_PAIRS} pairs "
              f"and against the CPU on {STAGE3_PAIRS}; the sharded walk kernel on both meshes; -stage 3 under "
              f"RNB_MESH_WALK=routed and grouped, -stage 2 -extend routed")
        mesh = mesh_builds(left, right, card, dev)
        mesh_runs = mesh_pipeline(*heads[MESH_STAGE3_PAIRS], heads[STAGE3_PAIRS], tmp, card, dev)
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
            "bound_ms": timing[op]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": timing[op]["library_ms"],
            "real_batch_indices": real_indices[op],
            "real_ms": timing[op]["real_ms"],
            "real_plain_ms": timing[op]["real_plain_ms"],
            "real_bound_ms": timing[op]["real_bound_ms"],
            "real_library_ms": timing[op]["real_library_ms"],
            **{key: timing[op][key] for key in ("fresh_ms", "fresh_plain_ms", "fresh_library_ms",
                                                "fresh_bound_ms", "already_set") if key in timing[op]},
            "variants": timing[op]["variants"],
        }
        for op in ("add_mf8", "set", "add_u16", "add")
    ]
    kernels[0]["run_insert_buffer_bytes"] = s2_buffer
    for row in kernels:  # launches on phase 9's runs, each with its counts set to 0 before it
        op = row["name"][len("cell_insert["):-1]
        row["phase9_launches"] = {run: short[run]["launches"][op] for run in ("se", "pool", "rescue", "kselect")}
    kernels[3]["k_select_run"] = {key: short["kselect"][key]
                                  for key in ("k", "estimate", "sketch_batches", "launches", "peak_bytes")}
    kernels[1]["stage3_screen_launches"] = s3["stage3_launches"]["set"]
    kernels[1]["stage2b_launches"] = s3["rebuild_launches"]["set"]
    wm, wu = walk_t["mf8"], walk_t["u16"]
    kernels.append({
        "name": "walk_greedy",
        "route": "cuda",
        "source": WALK_SOURCE,
        "replaces": WALK_REPLACES,
        "launches": launches["walk_greedy"],
        "run": mf8_run,
        "max_abs_err": max(w["max_abs_err"] for w in walk_t.values()),
        "ms": wm["ms"],
        "plain_ms": wm["plain_ms"],
        "bound_ms": wm["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "lanes": wm["lanes"],
        "resolves": wm["resolves"],
        "cell_reads": wm["cell_reads"],
        "gather_ms": wm["gather_ms"],
        "longest_lane_ms": wm["longest_lane_ms"],
        "longest_lane_rounds": wm["longest_lane_rounds"],
        "u16_ms": wu["ms"],
        "u16_plain_ms": wu["plain_ms"],
        "u16_bound_ms": wu["bound_ms"],
        "u16_longest_lane_ms": wu["longest_lane_ms"],
        "u16_gather_ms": wu["gather_ms"],
        "variants": {name: {"ms": wm["variants"][name]["ms"], "u16_ms": wu["variants"][name]["ms"],
                            "longest_lane_ms": wm["variants"][name]["longest_lane_ms"]} for name in variants},
        "stage2_pairs_per_s": s2_report.num_pairs / s2_report.stage2_s,
        "stage2_pairs": s2_report.num_pairs,
        "stage1_reads_per_s": s2_report.stage1.num_reads / s2_report.stage1.elapsed_s,
        "run_peak_device_bytes": s2_peak,
        "stage3_launches": s3["stage3_launches"]["walk_greedy"],
    })
    kernels.append({
        "name": "walk_pair",
        "route": "cuda",
        "source": WALK_SOURCE,
        "replaces": WALK_REPLACES,
        "launches": launches["walk_pair"],
        "run": f"{mf8_run}; times, bound and plain on phase 6's walks (extend_fragments_pair on stage 3's first "
               f"{pair['batches']} batches of the rebuilt {PAIRS_K}-pair graph, {pair['launches']} launches; batch "
               f"{pair['batch']}, the first full one, stratum {pair['stratum']})",
        "max_abs_err": pair["max_abs_err"],
        "ms": pair["ms"],
        "plain_ms": pair["plain_ms"],
        "bound_ms": pair["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "lanes": pair["lanes"],
        "first_batch_fragments": pair["first_fragments"],
        "first_batch_ms": pair["first_ms"],
        "first_batch_alone_lanes": pair["small_lanes"],
        "first_batch_alone_ms": pair["small_ms"],
        "resolves": pair["resolves"],
        "cell_reads": pair["cells"],
        "schedule_cell_reads": pair["new_cells"],
        "pkbf_lane_reads": pair["pkbf_lanes"],
        "gather_ms": pair["gather_ms"],
        **{key: pair[key] for key in ("rounds_old", "rounds_new", "free_hops", "hops", "longest_lane_rounds",
                                      "longest_lane_rounds_old", "longest_lane_ms", "round_ns",
                                      "dependent_read_ns")},
        "variants": pair["variants"],
        "stage3_card_time": s3["card_time"],
        "rebuild_fragments_per_s": rebuild["fragments_per_s"],
        "rebuild_batches": rebuild["batches"],
        "rebuild_launches": rebuild_launches,
        "rebuild_peak_device_bytes": rebuild["peak_bytes"],
        "rebuild_batch_table_bytes": rebuild["batch_table_bytes"],
        "stage3": {key: s3[key] for key in ("rebuild_fragments_per_s", "stage3_batches", "stage3_fragments",
                                            "stage3_s", "stage3_fragments_per_s", "transcripts", "short", "spans",
                                            "nr", "nr_s", "nr_fa_bytes")},
        "stage3_card_vs_cpu_transcripts": card_cpu3["transcripts"],
    })
    for kind, name in GREEDY_USES.items():
        g = greedy3[kind]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": WALK_SOURCE,
            "replaces": WALK_REPLACES,
            "launches": s3["greedy_uses"][kind],
            "run": f"{mf8_run}; times, bound and plain on phase 7's walks (stage 3's batch "
                   f"{greedy3['gap_batch' if kind == 'gap_rewalk' else 'probe_batch']}"
                   f"{'' if kind == 'gap_rewalk' else f', -maxclip {MAXCLIP}'})",
            "max_abs_err": g["max_abs_err"],
            "ms": g["ms"],
            "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "lanes": g["lanes"],
            "max_len": g["max_len"],
            "walks_checked": g["walks"],
            "cell_reads": g["cell_reads"],
            "gather_ms": g["gather_ms"],
            "variants": g["variants"],
        })
    nr, nl = naive["walks"]["right"], naive["walks"]["left"]
    kernels.append({
        "name": "walk_naive",
        "route": "cuda",
        "source": WALK_SOURCE,
        "replaces": WALK_REPLACES,
        "launches": extend_run["launches"]["walk_naive"],
        "run": f"main path of phase 8, -cnt mf8 -stage 2 -extend on the first {EXTEND_BATCHES} batches "
               f"({extend_run['pairs']} pairs); times, bound and plain on the right -extend walks of the first "
               f"stage-2 batch's {naive['fragments']} fragments on phase 3's {PAIRS_K}-pair graph",
        "max_abs_err": max(nr["max_abs_err"], nl["max_abs_err"]),
        "ms": nr["ms"],
        "plain_ms": nr["plain_ms"],
        "bound_ms": nr["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "lanes": nr["lanes"],
        "resolves": nr["resolves"],
        **{key: nr[key] for key in ("cell_reads", "plain_loop_cell_reads", "schedule_cell_reads", "plain_reads_bound_ms",
                                    "gather_ms", "free_hops", "hops_tried", "rounds_old", "rounds_new",
                                    "longest_lane_rounds", "longest_lane_rounds_old", "longest_lane_ms", "round_ns")},
        **{f"left_{key}": nl[key] for key in ("ms", "plain_ms", "bound_ms", "gather_ms", "longest_lane_rounds",
                                              "longest_lane_rounds_old", "longest_lane_ms", "round_ns")},
        "variants": {who: {"ms": x["ms"], "longest_lane_ms": x["longest_lane_ms"],
                           "left_ms": nl["variants"][who]["ms"],
                           "left_longest_lane_ms": nl["variants"][who]["longest_lane_ms"]}
                     for who, x in nr["variants"].items()},
        "extend_stage2_pairs_per_s": extend_run["pairs_per_s"],
        "extend_stage2_pairs": extend_run["pairs"],
        "extend_run_launches": extend_run["launches"],
        "extend_card_vs_cpu_fragments": extend_cpu["fragments"],
        "extend_card_vs_cpu_launches": extend_cpu["walk_launches"]["walk_naive"],
    })
    sw = short["se_walks"]
    kernels.append({
        "name": SE_PAIR_NAME,
        "route": "cuda",
        "source": WALK_SOURCE,
        "replaces": WALK_REPLACES,
        "launches": short["se"]["launches"]["walk_pair"],
        "run": f"phase 9, -sef/-ser -stage 3 on the mates of the first {SE_PAIRS} pairs; times, bound and plain on "
               f"the right walks of its stage 3's batch {sw['batch']}, the first full one (stratum {sw['stratum']}), "
               f"on the fragment graph without fpkbf",
        "max_abs_err": sw["max_abs_err"],
        "ms": sw["ms"],
        "plain_ms": sw["plain_ms"],
        "bound_ms": sw["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "lanes": sw["lanes"],
        "hops": sw["hops"],
        "resolves": sw["resolves"],
        "cell_reads": sw["cells"],
        "rpkbf_lane_reads": sw["pkbf_lanes"],
        "gather_ms": sw["gather_ms"],
        "pool_run_launches": short["pool"]["launches"]["walk_pair"],
        "short_read_runs": {run: {key: v for key, v in short[run].items() if key != "launches"}
                            for run in ("se", "pool", "rescue", "kselect")},
        "card_vs_cpu_files": short["card_vs_cpu"],
    })
    lr_runs = {tag: {key: v for key, v in run.items() if key != "launches"} for tag, run in lr["runs"].items()}
    for name, row, tag in (("lr_kmer_keys", lr["keys"]["lr_kmer_keys"], "kmer"),
                           ("lr_randstrobe_keys", lr["keys"]["lr_randstrobe_keys"], "strobemer")):
        full = lr["full_size"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": LR_SOURCE, "replaces": LR_REPLACES[name],
            "launches": lr["runs"][tag]["launches"][name],
            "run": f"phase 10, -long {' '.join(LR_RESUMED[tag])} on {lr['reads']} reads (resumed from run (i)); "
                   f"times, bounds and plain on every corrected read of run (i) ({row['work']}); full_size: "
                   f"phase 10's raw reads x {LR_REPEATS} ({lr['full_size']['work']})",
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "bytes_bound_ms": row["bytes_bound_ms"], "ops_bound_ms": row["ops_bound_ms"],
            "variant_ms": row["variant_ms"], "sm_clock_mhz": row["sm_clock_mhz"],
            "sm_clock_max_mhz": row["sm_clock_max_mhz"], "keys": row["keys"],
            "keys_end_to_end_ms": row["keys_ms"], "wrapper_ms": row["wrapper_ms"], "entry_ms": row["entry_ms"],
            "full_size": {key: full[key] for key in ("ms", "bound_ms", "bound_by", "bytes_bound_ms", "ops_bound_ms",
                                                     "variant_ms")},
            "launches_by_run": {t: run["launches"].get(name, 0) for t, run in lr["runs"].items()},
        })
    vote, vote_full = lr["vote"], lr["vote_full_size"]
    kernels.append({
        "name": "consensus_vote", "route": "cuda", "source": LR_SOURCE, "replaces": LR_REPLACES["consensus_vote"],
        "launches": lr["runs"]["default"]["launches"].get("consensus_vote", 0),
        "run": f"phase 10: no -long run reaches it (polish realigns with indel_band 16 by default); checked through "
               f"polish(indel_band=0) on run (i)'s {vote['unitigs']} unitigs and {vote['placements']} placements "
               f"({vote['check_launches']} launches), timed on its first batch (the cut cell); full_size: run (i)'s "
               f"unitigs and placements x {LR_REPEATS} ({vote_full['unitigs']} x {vote_full['unitig_len']}, "
               f"{vote_full['placements']} placements, {vote_full['check_launches']} launches, each batch held to "
               f"the plain version), timed on its first batch",
        "max_abs_err": vote["max_abs_err"], "ms": vote["ms"], "plain_ms": vote["plain_ms"],
        "bound_ms": vote["bound_ms"], "bound_by": "bytes", "library_ms": vote["library_ms"],
        "variant_ms": vote["variant_ms"], "check_launches": vote["check_launches"],
        **{key: vote[key] for key in ("unitigs", "unitig_len", "batch_reads", "read_len", "changed_unitigs")},
        "full_size": {key: vote_full[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms", "variant_ms",
                                                      "max_abs_err", "unitigs", "unitig_len", "batch_reads",
                                                      "read_len", "placements", "check_launches",
                                                      "call_peak_bytes")},
        "long_read_runs": lr_runs, "long_reads": lr["reads"], "long_bases": lr["bases"],
        "card_vs_cpu_files": lr["card_vs_cpu"],
    })
    # max: launches on phase 12's exact-count mesh batches (its routed max
    # reducer), every count set to 0 before each; the exact builds and the
    # oracle run max_kernel as the conservative update's second launch,
    # counted in its own row (cell_insert[conservative_raise])
    max_runs = {what: st["launches"].get("max", 0) for what, st in mesh["meshes"].items() if "exact counts" in what}
    assert all(max_runs.values()), max_runs
    mi, mr = maxc["int32"]["synthetic"], maxc["int32"]["real"]
    kernels.append({
        "name": "cell_insert[max]",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": MAX_REPLACES,
        "launches": sum(max_runs.values()),
        "run": f"phase 12: the exact-count int32 batch on meshes of {' and '.join(map(str, MESH_SHARDS))} shards "
               f"(the mesh's max reducer); times on a synthetic 2^20-index batch and on the exact -cnt int32 "
               f"build's first batch (its composed update's indices and values), int32 cells; u16 and mf8 beside; "
               f"its kernel also runs on phase 11's path as cell_insert[conservative_raise]",
        "max_abs_err": max(maxc[c][b]["max_abs_err"] for c in maxc for b in ("real", "synthetic")),
        "ms": mi["ms"],
        "plain_ms": mi["plain_ms"],
        "bound_ms": mi["bound_ms"],
        "bound_by": "bytes",
        "library_ms": mi["library_ms"],
        "read_bound_ms": mi["read_bound_ms"],
        "variant_ms": mi["variant_ms"],
        "real_batch_indices": mr["indices"],
        "real_ms": mr["ms"],
        "real_plain_ms": mr["plain_ms"],
        "real_bound_ms": mr["bound_ms"],
        "real_read_bound_ms": mr["read_bound_ms"],
        "real_library_ms": mr["library_ms"],
        "real_variant_ms": mr["variant_ms"],
        "real_raised_cells": mr["raised_cells"],
        "mesh_launches": max_runs,
        **{c: maxc[c] for c in ("u16", "mf8")},
    })
    cr = consc
    ci_ = cr["int32"]["real"]
    cons_err = max(cr[c][b]["max_abs_err"] for c in cr for b in ("real", "collision"))
    kernels.append({
        "name": "cell_insert[conservative]",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": CONSERVATIVE_REPLACES,
        "launches": cons_launches["conservative"],
        "run": f"phase 11: the decision oracle on the card ({oracle['launches']['conservative']} launches), the "
               f"exact-count stage-1 builds at -mem 1 (-cnt int32 and mf8, flat layout) of the first {EXACT_PAIRS} "
               f"pairs and the -cnt u16 build's first batch; the conservative update's first launch (a key's value "
               f"and the lanes below it); times on each build's first batch (int32 here), the launch alone against "
               f"the plain gathers and encode; update_* the whole update (both launches) against its plain version "
               f"and the composition of plain-torch gathers and the max kernel",
        "max_abs_err": cons_err,
        "ms": ci_["values_ms"],
        "plain_ms": ci_["values_plain_ms"],
        "bound_ms": ci_["values_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "update_ms": ci_["ms"],
        "update_plain_ms": ci_["plain_ms"],
        "update_bound_ms": ci_["bound_ms"],
        "composition_ms": ci_["composition_ms"],
        "variant_ms": ci_["variant_ms"],
        "keys": ci_["keys"],
        "raised_cells": ci_["raised_cells"],
        "collision": cr["int32"]["collision"],
        **{c: cr[c] for c in ("u16", "mf8")},
        "exact_builds": exact_runs,
        "oracle": oracle,
    })
    kernels.append({
        "name": "cell_insert[conservative_raise]",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": MAX_REPLACES,
        "launches": cons_launches["conservative_raise"],
        "run": f"phase 11, as cell_insert[conservative]: the update's second launch, max_kernel over the lanes the "
               f"first launch sends it ({ci_['raise_lanes']} of {ci_['keys'] * ci_['hashes']} on the int32 build's "
               f"first batch), alone from the pre-batch words, against the plain max and scatter_reduce_ on those "
               f"lanes; u16 and mf8 in cell_insert[conservative]",
        "max_abs_err": cons_err,
        "ms": ci_["raise_ms"],
        "plain_ms": ci_["raise_plain_ms"],
        "bound_ms": ci_["raise_bound_ms"],
        "bound_by": "bytes",
        "library_ms": ci_["raise_library_ms"],
        "raise_lanes": ci_["raise_lanes"],
    })
    # phase 12: launches on the -sharded on -stage 3 run (every count set to 0
    # before it) and on the 8-shard mesh build of the pairs' head
    mesh8 = mesh["meshes"]["8 shards on one card"]
    for row in kernels:
        op = row["name"][len("cell_insert["):-1] if row["name"].startswith("cell_insert[") else row["name"]
        if op in mesh_runs["mesh"]["launches"] or op in ("add_mf8", "set", "walk_greedy", "walk_pair"):
            row["phase12_launches"] = {"sharded_stage3": mesh_runs["mesh"]["launches"].get(op, 0),
                                       "sharded_build_8": mesh8["launches"].get(op, 0)}
    kernels[0]["phase12"] = {
        "reads": mesh["reads"], "cards": mesh["cards"], "single_step_ms": mesh["single"]["step_ms"],
        "single_peak_bytes": mesh["single"]["peak_bytes"],
        "meshes": {what: {key: st[key] for key in ("step_ms", "steps_ms", "routing_ms", "a2a_bytes_per_shard_per_step",
                                                   "second_rounds", "routed_calls", "peak_bytes")}
                   for what, st in mesh["meshes"].items()},
        "stage3": {tag: {key: v for key, v in mesh_runs[tag].items() if key != "launches"}
                   for tag in ("mesh", "single", "routed", "grouped", "extend_routed", "extend_replicated")},
        "card_vs_cpu_files": mesh_runs["card_vs_cpu_files"],
    }
    # the sharded walk layouts: launches on the routed -stage 3 run (greedy,
    # pair) and the routed -stage 2 -extend run (naive), each with every
    # count set to 0 before it; times on phase 12's walk cells, 8 shards
    walks8, walks2 = mesh["walks"]["8 shards on one card"], mesh["walks"]["2 shards on one card"]
    for mode in ("greedy", "pair", "naive"):
        name = f"walk_{mode}_sharded"
        run = mesh_runs["extend_routed" if mode == "naive" else "routed"]
        w8, w2 = walks8[mode], walks2[mode]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": WALK_SOURCE,
            "replaces": MESH_WALK_REPLACES,
            "launches": run["launches"].get(name, 0),
            "run": (f"phase 12, RNB_MESH_WALK=routed -sharded on over 8 shards of the card, "
                    + (f"-stage 2 -extend on {STAGE3_PAIRS} pairs" if mode == "naive"
                       else f"-stage 3 on {MESH_STAGE3_PAIRS} pairs")
                    + f"; times and bound on phase 12's {w8['lanes']} {mode} lanes over its 8-shard mf8 graph of "
                    f"{MESH_PAIRS} pairs, plain (the routed lockstep loop on the card) on the first {w8['plain_lanes']}"),
            "max_abs_err": max(w8["max_abs_err"], w2["max_abs_err"]),
            "ms": w8["ms"],
            "plain_ms": w8["plain_ms"],
            "bound_ms": w8["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "lanes": w8["lanes"],
            "single_device_ms": w8["single_ms"],
            "two_shards": {key: w2[key] for key in ("ms", "single_ms", "plain_ms", "bound_ms", "max_abs_err")},
            **{key: w8[key] for key in ("plain_lanes", "hops", "max_hops", "statuses", "spec_hops", "turns_ms")},
        })
    cell_keys = ("ms", "yardstick_ms", "plain_ms", "lanes", "hops", "statuses",
                 "yardstick_hops", "yardstick_statuses", "ns_per_hop", "yardstick_ns_per_hop", "max_abs_err")
    for row in kernels:
        if row["name"] == "walk_greedy":
            row["exact_graph"] = {key: gated["greedy"][key] for key in cell_keys}
            row["terminators"] = {key: gated["term"][key] for key in (*cell_keys, "term_lanes", "live_lanes")}
        elif row["name"] == "walk_naive":
            row["exact_graph"] = {key: gated["naive"][key] for key in cell_keys}
    print(f"\nsmoke wall time {time.time() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
