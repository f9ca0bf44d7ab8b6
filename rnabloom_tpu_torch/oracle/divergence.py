"""Differential measurement: the port's pipeline decisions vs the scalar
reference-semantics oracle (oracle/refsim.py).

Port of ``rnabloom_tpu/oracle/divergence.py`` on torch filters, on the card
unless the caller asks for the CPU.  Builds small adversarial fixture
graphs (bubbles, tips, repeats, skewed coverage) twice — once as the
oracle's exact dict, once as a real ``GraphState`` with oversized int32
filters in ``exact_counts`` mode so both sides see identical counts — then
replays the reference's decision points through both and reports
per-decision agreement rates:

  * ``count_agreement``       stage-1 counts (precondition; 1.0 by design)
  * ``greedy_agreement``      branch base chosen by greedy lookahead
                              (resolve_branches mode="greedy" vs
                              GraphUtils.greedyExtendRightOnce :501-525)
  * ``tip_probe_agreement``   depth verdict of the width-2 beam probe vs an
                              exhaustive DFS
  * ``naive_advance_rate_vs_reference_stop``  how often depth-filtered
                              naive resolution advances where the
                              reference's actual code stops
  * ``ec_output_agreement``   corrected read equality, correct_batch vs
                              correctErrorsSE (GraphUtils.java:3997-4048)
  * ``ec_verdict_agreement``  changed/unchanged agreement of the same
  * ``represented_agreement`` redundancy-screen verdicts, screen_represented
                              (its gap re-walks are walk-kernel launches on
                              the card) vs GraphUtils.represented (:711-824)
  * ``mf8_count_rel_err``     mf8 quantization: mean relative count error
                              of the shipping counter vs exact int32
  * ``mf8_greedy_agreement``  greedy branch choices under mf8 counts

The names are the JAX package's (``tpu_counts`` included), so a reader finds
each counterpart.  Every value is a ratio of integer counts or a mean over
the same float32 counts, so the card, the CPU and the JAX package give the
same dict (``tests/golden/oracle_divergence.json``).

    python -m rnabloom_tpu_torch.oracle.divergence [--device cpu]

prints it as one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..assembly import correct, transcripts as txmod
from ..bloom import filters
from ..bloom.filters import BloomConfig, CountingConfig
from ..graph import dbg, engine, traverse
from ..graph.dbg import GraphConfig
from ..utils import seq as sequtils
from . import refsim

BASES = "ACGT"


def _rand_seq(rng: np.random.Generator, n: int) -> str:
    return "".join(rng.choice(list(BASES), size=n))


def _mutate(rng: np.random.Generator, seq: str, pos: int) -> str:
    alt = rng.choice([c for c in BASES if c != seq[pos]])
    return seq[:pos] + alt + seq[pos + 1 :]


# ---------------------------------------------------------------------------
# twin graph construction
# ---------------------------------------------------------------------------


def _encode_batch(seqs: Sequence[str], width: Optional[int] = None) -> np.ndarray:
    w = width or max(len(s) for s in seqs)
    out = np.full((len(seqs), w), 4, np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = sequtils.encode(s)
    return out


def build_twin_graphs(
    seqs: Sequence[str],
    k: int,
    counter: str = "int32",
    size_log2: int = 18,
    read_pair_dist: int = 0,
    *,
    device="cuda",
):
    """(oracle ExactGraph, graph state, GraphConfig) over the same reads,
    the graph on ``device`` (the card unless the caller asks for the CPU;
    raises without one).  Stranded mode so the oracle's string keys match
    k-mer identity 1:1; int32 + exact_counts makes the counts exact
    (conservative increment-min over collision-free filters ==
    multiplicity, bloom/filters.py counting_increment)."""
    dev = engine.require_device(device)
    g = refsim.ExactGraph(k, read_pair_dist=read_pair_dist)
    for s in seqs:
        g.add_seq(s, read_pairs=read_pair_dist > 0)

    cfg = GraphConfig(
        k=k,
        stranded=True,
        dbgbf=BloomConfig(size_log2, 2),
        cbf=CountingConfig(size_log2, 2, dtype=counter),
        pkbf=BloomConfig(size_log2, 2),
        read_pair_distance=read_pair_dist if read_pair_dist > 0 else -1,
        exact_counts=True,
    )
    state = engine.make_graph(cfg, with_rpkbf=read_pair_dist > 0, device=dev)
    state = engine.build_step(state, cfg, _encode_batch(seqs), add_read_pairs=read_pair_dist > 0)
    return g, state, cfg


def tpu_counts(state, cfg: GraphConfig, kmers: Sequence[str]) -> np.ndarray:
    """Batched getCount over a k-mer list (the JAX package's name)."""
    codes = torch.from_numpy(_encode_batch(kmers, width=cfg.k)).to(state.cbf.device)
    _, _, base, _ = dbg.seq_hashes(cfg, codes)
    return dbg.get_counts(state, cfg, base)[:, 0].cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


def make_fixture(seed: int = 0, k: int = 17) -> Tuple[List[str], List[str], dict]:
    """(reads, transcripts, meta) — bubbles, tips, a repeat, skewed coverage."""
    rng = np.random.default_rng(seed)
    t_main = _rand_seq(rng, 220)
    # SNV bubble: variant at mid, minority coverage
    t_var = _mutate(rng, t_main, 110)
    # shared-path repeat: two transcripts sharing a 40 bp interior segment
    shared = _rand_seq(rng, 40)
    t_rep1 = _rand_seq(rng, 80) + shared + _rand_seq(rng, 80)
    t_rep2 = _rand_seq(rng, 80) + shared + _rand_seq(rng, 80)
    # skewed-coverage transcript
    t_skew = _rand_seq(rng, 200)

    reads: List[str] = []
    L = 50

    def tile(t: str, cov: int, step: int = 5):
        for _ in range(cov):
            for s0 in range(0, len(t) - L + 1, step):
                reads.append(t[s0 : s0 + L])

    tile(t_main, 3)
    tile(t_var, 1, step=10)
    tile(t_rep1, 2)
    tile(t_rep2, 2)
    # coverage gradient: dense at the 5' end, sparse at the 3' end
    for s0 in range(0, len(t_skew) - L + 1, 5):
        depth = 4 if s0 < 60 else (2 if s0 < 120 else 1)
        for _ in range(depth):
            reads.append(t_skew[s0 : s0 + L])
    # tips: error-tailed reads hanging off t_main
    for i in range(6):
        s0 = 20 * i
        base = t_main[s0 : s0 + L]
        reads.append(base[: L - 8] + _rand_seq(rng, 8))
    # beam traps: a branch whose two HIGHEST-coverage candidates dead-end
    # shallowly while a low-coverage third path runs deep — the width-2
    # beam probe (traverse._tip_probe) follows the top-2 by count and can
    # miss the deep path the exhaustive DFS finds
    for _ in range(4):
        stem = _rand_seq(rng, k)
        junk = stem + _rand_seq(rng, 3)  # makes the stem end a branch point
        cand = stem + _rand_seq(rng, 3)  # probed candidate's path...
        deep = cand + _rand_seq(rng, 30)  # ...with a cov-1 deep continuation
        reads.append(junk)
        reads.append(deep)
        tail_a, tail_b = _rand_seq(rng, 4), _rand_seq(rng, 4)
        for _ in range(5):  # and two high-coverage shallow dead ends that
            reads.append(cand + tail_a)  # the width-2 beam prefers
            reads.append(cand + tail_b)
    rng.shuffle(reads)
    return reads, [t_main, t_var, t_rep1, t_rep2, t_skew], {"k": k}


def branch_kmers(g: refsim.ExactGraph, cap: int = 192) -> List[str]:
    out = [km for km in sorted(g.counts) if len(refsim.successors(g, km)) >= 2]
    return out[:cap]


# ---------------------------------------------------------------------------
# decision measurements
# ---------------------------------------------------------------------------


def measure_counts(g: refsim.ExactGraph, state, cfg: GraphConfig) -> Dict[str, float]:
    kmers = sorted(g.counts)
    got = tpu_counts(state, cfg, kmers)
    want = np.array([g.counts[km] for km in kmers])
    agree = float(np.mean(got == want)) if len(kmers) else 1.0
    rel = float(np.mean(np.abs(got - want) / np.maximum(want, 1)))
    return {"count_agreement": agree, "count_rel_err": rel, "n_kmers": len(kmers)}


def _branch_walk_state(
    cfg: GraphConfig, wcfg: traverse.WalkConfig, kmers: Sequence[str], dev
) -> traverse.WalkState:
    seeds = _encode_batch(kmers, width=cfg.k)
    st = traverse.make_walks(cfg, wcfg, seeds, device=dev)
    n = len(kmers)
    W = st.status.shape[0]
    status = np.full(W, traverse.DEAD, np.int32)
    status[:n] = traverse.BRANCH
    return st._replace(status=torch.from_numpy(status).to(dev))


def _greedy_choices(state, cfg: GraphConfig, bks: Sequence[str], lookahead: int) -> np.ndarray:
    """The base each branch k-mer's greedy resolve appends."""
    dev = state.cbf.device
    wcfg = traverse.WalkConfig(max_len=cfg.k + 8, lookahead=lookahead)
    st = _branch_walk_state(cfg, wcfg, bks, dev)
    W = st.status.shape[0]
    st2 = traverse.resolve_branches(
        st, state, cfg, wcfg, torch.ones(W, dtype=torch.float32, device=dev), mode="greedy"
    )
    return st2.buf[:, cfg.k].cpu().numpy()


def measure_greedy(
    g: refsim.ExactGraph, state, cfg: GraphConfig, lookahead: int = 3
) -> Dict[str, float]:
    """Branch-choice agreement: resolve_branches(mode="greedy") vs
    greedyExtendRightOnce.  Exact agreement expected at lookahead <= 3
    (the expansion is exhaustive there, traverse._expand_scores)."""
    bks = branch_kmers(g)
    if not bks:
        return {"greedy_agreement": 1.0, "n_branches": 0}
    got = _greedy_choices(state, cfg, bks, lookahead)
    agree = 0
    for i, km in enumerate(bks):
        want = refsim.greedy_extend_right_once(
            g, refsim.successors(g, km), lookahead
        )
        if want is not None and want[-1] == BASES[int(got[i])]:
            agree += 1
    return {"greedy_agreement": agree / len(bks), "n_branches": len(bks)}


def _oracle_max_depth(g: refsim.ExactGraph, kmer: str, cap: int) -> int:
    """Longest successor-chain length starting at ``kmer`` (inclusive),
    capped — the clean semantics the beam probe approximates."""
    best = 0
    stack = [(kmer, 1)]
    seen_at: Dict[str, int] = {}
    while stack:
        km, d = stack.pop()
        if d > best:
            best = d
            if best >= cap:
                return cap
        if seen_at.get(km, 0) >= d:
            continue
        seen_at[km] = d
        for s in refsim.successors(g, km):
            stack.append((s, d + 1))
    return best


def measure_tip_probe(
    g: refsim.ExactGraph, state, cfg: GraphConfig
) -> Dict[str, float]:
    bks = branch_kmers(g)
    if not bks:
        return {"tip_probe_agreement": 1.0, "n_probes": 0}
    dev = state.cbf.device
    wcfg = traverse.WalkConfig(max_len=cfg.k + 8, lookahead=3, tip_probe_depth=8)
    st = _branch_walk_state(cfg, wcfg, bks, dev)
    W = st.status.shape[0]
    ones = torch.ones(W, dtype=torch.float32, device=dev)
    out_codes = traverse._gather_out_codes(st.buf, st.pos, cfg.k)
    fh4, rh4, q4 = traverse._successors(cfg, wcfg, st.fh, st.rh, out_codes)
    viable0 = dbg.get_counts(state, cfg, q4) >= 1.0
    depth = traverse._tip_probe(state, cfg, wcfg, st.buf, st.pos, fh4, rh4, viable0, ones).cpu().numpy()
    agree = total = 0
    naive_adv = 0
    D = wcfg.tip_probe_depth
    for i, km in enumerate(bks):
        succs = refsim.successors(g, km)
        deep_flags = []
        for s in succs:
            c = BASES.index(s[-1])
            got_deep = bool(depth[i, c] >= D)
            want_deep = _oracle_max_depth(g, s, D) >= D
            agree += got_deep == want_deep
            total += 1
            deep_flags.append(got_deep)
        # reference-actual naive resolution stops at any >= 2-way branch;
        # ours advances when exactly one candidate is deep
        if sum(deep_flags) == 1:
            naive_adv += 1
    return {
        "tip_probe_agreement": agree / max(total, 1),
        "n_probes": total,
        "naive_advance_rate_vs_reference_stop": naive_adv / len(bks),
    }


def measure_ec(
    g: refsim.ExactGraph,
    state,
    cfg: GraphConfig,
    transcripts: Sequence[str],
    seed: int = 1,
) -> Dict[str, float]:
    rng = np.random.default_rng(seed)
    reads: List[Tuple[str, str, str]] = []  # (kind, read, truth)
    for t in transcripts[:2]:
        for s0 in range(0, len(t) - 60 + 1, 15):
            r = t[s0 : s0 + 60]
            reads.append(("sub", _mutate(rng, r, int(rng.integers(5, 55))), r))
            reads.append(("clean", r, r))
            p = int(rng.integers(20, 40))
            reads.append(("del", r[:p] + r[p + 1 :], r))
            reads.append(("ins", r[:p] + rng.choice(list(BASES)) + r[p:], r))

    params = correct.CorrectParams(
        max_cov_gradient=0.5, cov_fpr=0.01, rounds=1, max_indel=1,
        percent_identity=0.9, min_kmer_cov=1.0,
    )
    codes = _encode_batch([x[1] for x in reads], width=64)
    lens = np.array([len(x[1]) for x in reads], np.int32)
    out_codes, out_lens, changed = correct.correct_batch(
        state, cfg, codes, lens, params
    )

    same = verdict_same = tpu_truth = oracle_truth = 0
    by_kind: Dict[str, List[int]] = {}
    for i, (kind, r, truth) in enumerate(reads):
        want = refsim.correct_errors_se(
            r, g, lookahead=3, max_indel=1, max_cov_gradient=0.5,
            cov_fpr=0.01, percent_identity=0.9, min_cov=1.0,
        )
        want_seq = want if want is not None else r
        got_seq = sequtils.decode(out_codes[i, : out_lens[i]])
        ok = got_seq == want_seq
        same += ok
        by_kind.setdefault(kind, []).append(ok)
        verdict_same += (want is not None) == bool(changed[i])
        tpu_truth += got_seq == truth
        oracle_truth += want_seq == truth
    n = len(reads)
    return {
        "ec_output_agreement": same / n,
        "ec_verdict_agreement": verdict_same / n,
        "ec_agreement_by_kind": {
            kk: sum(v) / len(v) for kk, v in sorted(by_kind.items())
        },
        # accuracy vs the planted truth: disagreements where the port
        # recovers the truth and the oracle does not are quality wins, not
        # fidelity losses (reference-semantics EC leaves most 1-base
        # insertions uncorrected; the indel repair fixes them)
        "ec_tpu_truth_rate": tpu_truth / n,
        "ec_oracle_truth_rate": oracle_truth / n,
        "n_ec_reads": n,
    }


def measure_represented(
    g: refsim.ExactGraph,
    state,
    cfg: GraphConfig,
    transcripts: Sequence[str],
    seed: int = 2,
) -> Dict[str, float]:
    rng = np.random.default_rng(seed)
    assembled = transcripts[0]
    screen_set: Set[str] = set(g.get_kmers(assembled))

    scfg = BloomConfig(16, 2)
    screen = filters.make_bloom(scfg, device=state.cbf.device)
    screen = txmod.screen_add(screen, scfg, cfg, _encode_batch([assembled]))

    cases: List[str] = [
        assembled,                                    # exact duplicate
        assembled[10:-10],                            # contained
        _mutate(rng, assembled, len(assembled) // 2),  # interior SNV bubble
        _rand_seq(rng, 150),                          # novel
        assembled[: len(assembled) // 2] + _rand_seq(rng, 80),  # half novel
        assembled + _rand_seq(rng, 4),                # short novel edge
        _mutate(rng, _mutate(rng, assembled, 60), 150),  # two bubbles
    ]
    params = txmod.TranscriptParams(
        screen_min_frac=0.95, max_indel=1, percent_identity=0.9,
        screen_max_edge_clip=8, lookahead=3,
    )
    codes = _encode_batch(cases)
    lens = np.array([len(c) for c in cases], np.int32)
    got = txmod.screen_represented(
        screen, scfg, cfg, codes, lens, params, graph=state
    )
    agree = 0
    wants = []
    for i, s in enumerate(cases):
        want = refsim.represented(
            g.get_kmers(s), g, screen_set, lookahead=3, max_indel=1,
            max_edge_clip=8, percent_identity=0.9,
        )
        wants.append(want)
        agree += bool(got[i]) == want
    return {
        "represented_agreement": agree / len(cases),
        "n_screen_cases": len(cases),
        "represented_verdicts_oracle": wants,
        "represented_verdicts_tpu": [bool(x) for x in got],
    }


def measure_mf8(
    g: refsim.ExactGraph, reads: Sequence[str], k: int, lookahead: int = 3, *, device="cuda"
) -> Dict[str, float]:
    """Quantization of the shipping mf8 counter: count error vs exact, and
    how often it flips a greedy branch decision."""
    _, state8, cfg8 = build_twin_graphs(reads, k, counter="mf8", device=device)
    kmers = sorted(g.counts)
    got = tpu_counts(state8, cfg8, kmers)
    want = np.array([g.counts[km] for km in kmers])
    rel = float(np.mean(np.abs(got - want) / np.maximum(want, 1)))

    bks = branch_kmers(g)
    agree = 1.0
    if bks:
        choice = _greedy_choices(state8, cfg8, bks, lookahead)
        n_ok = 0
        for i, km in enumerate(bks):
            want_km = refsim.greedy_extend_right_once(
                g, refsim.successors(g, km), lookahead
            )
            if want_km is not None and want_km[-1] == BASES[int(choice[i])]:
                n_ok += 1
        agree = n_ok / len(bks)
    return {"mf8_count_rel_err": rel, "mf8_greedy_agreement": agree}


def measure_all(seed: int = 0, k: int = 17, with_mf8: bool = True, *, device="cuda") -> dict:
    """Every measurement on one fixture, the graphs on ``device`` (the card
    unless the caller asks for the CPU; raises without one)."""
    dev = engine.require_device(device)
    reads, transcripts, _ = make_fixture(seed, k)
    g, state, cfg = build_twin_graphs(reads, k, device=dev)
    out: dict = {"k": k, "n_reads": len(reads)}
    out.update(measure_counts(g, state, cfg))
    out.update(measure_greedy(g, state, cfg))
    out.update(measure_tip_probe(g, state, cfg))
    out.update(measure_ec(g, state, cfg, transcripts))
    out.update(measure_represented(g, state, cfg, transcripts))
    if with_mf8:
        out.update(measure_mf8(g, reads, k, device=dev))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-k", type=int, default=17)
    args = ap.parse_args(argv)
    print(json.dumps(measure_all(seed=args.seed, k=args.k, device=args.device)))


if __name__ == "__main__":
    main()
