"""The replay of the naive walk loop that chip_smoke.py phase 8 rests on
(``chip_smoke.naive_tally``): its bound (the reads the plain loop needs)
and each lane's dependent rounds under the one-step schedule and the
walk kernel's naive schedule (kids read with the candidates, hand-offs,
two probe steps a round).  On the CPU, on the naive cases' graphs of
``tests/stage3_common.py`` and on small graphs counted by hand.  Also the
smoke's loader of walk sources from before the exact-count gate and
terminators (``chip_smoke.GatelessWalks``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from rnabloom_tpu_torch.bloom.filters import BloomConfig, CountingConfig
from rnabloom_tpu_torch.graph import dbg, traverse
from rnabloom_tpu_torch.ops import walk
from stage3_common import NAIVE_CASES, WALK_DATA, WALK_K, naive_lane_args, naive_walk_rows

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("buf", "pos", "status", "hops", "path_min", "fh", "rh", "hist")
_graphs = {}


def _graph(data, dtype="mf8", blocked=False, stranded=False, num_hash=2):
    key = (data, dtype, blocked, stranded, num_hash)
    if key not in _graphs:
        reads, seeds = WALK_DATA[data]()
        cfg = dbg.GraphConfig(k=WALK_K, stranded=stranded, dbgbf=BloomConfig(18, 2),
                              cbf=CountingConfig(18, num_hash, blocked=blocked, dtype=dtype),
                              pkbf=BloomConfig(18, 2), read_pair_distance=40)
        graph = dbg.build_step(dbg.make_graph(cfg, device="cpu"), cfg, torch.from_numpy(reads))
        _graphs[key] = (cfg, graph, reads, seeds)
    return _graphs[key]


def _tally_and_plain(graph, cfg, wcfg, st, min_cov, bound):
    plain = walk.walk_naive_plain(st, graph, cfg, wcfg, min_cov, bound)
    tally = chip_smoke.naive_tally(st, graph, cfg, wcfg, min_cov, bound)
    for f in FIELDS:
        assert torch.equal(getattr(tally["state"], f), getattr(plain, f)), f
    return tally


@pytest.mark.parametrize("case", list(NAIVE_CASES))
@pytest.mark.parametrize("tip_probe_depth", [None, 2, 3])
def test_naive_tally_replays_the_plain_loop(case, tip_probe_depth):
    """The replay ends in the plain loop's state; this schedule reads at
    least what the plain loop needs (which is at most what the plain loop
    reads) and takes no more rounds than the one-step schedule, lane by
    lane; its hops and resolves are the plain loop's."""
    data, dtype, blocked, stranded, nh, left, back, tpd, max_len = NAIVE_CASES[case][:9]
    cfg, graph, reads, seeds = _graph(data, dtype, blocked, stranded, nh)
    rows = naive_walk_rows(data, reads, seeds, stranded, left)
    wcfg = traverse.WalkConfig(max_len=max_len, left=left, check_back_branches=back,
                               tip_probe_depth=tip_probe_depth or tpd)
    st = traverse.make_walks(cfg, wcfg, rows, device="cpu")
    min_cov, bound = traverse.lane_args(st, *naive_lane_args(case, st.pos.shape[0]))
    t = _tally_and_plain(graph, cfg, wcfg, st, min_cov, bound)
    assert bool((t["new_reads"] >= t["needed"]).all())
    assert bool((t["needed"] <= t["reads"]).all())
    assert bool((t["new_rounds"] <= t["old_rounds"]).all())
    assert int(t["hops"].sum()) >= int(t["state"].hops.sum()) > 0
    assert int(t["new_rounds"].sum()) < int(t["old_rounds"].sum())
    if back:  # variants deep enough to probe: the variants read once cut the needed reads
        assert int(t["needed"].sum()) < int(t["reads"].sum())


def _line_graph(seqs, num_hash=2):
    """A graph of error-free reads tiling each sequence in ``seqs`` (3
    copies of every 60-base window at a stride of 5)."""
    cfg = dbg.GraphConfig(k=WALK_K, stranded=False, dbgbf=BloomConfig(18, 2),
                          cbf=CountingConfig(18, num_hash, dtype="mf8"), pkbf=BloomConfig(18, 2))
    reads = [s[i : i + 60] for s in seqs for i in range(0, len(s) - 59, 5) for _ in range(3)]
    reads += [s[-60:] for s in seqs for _ in range(3)]
    return cfg, dbg.build_step(dbg.make_graph(cfg, device="cpu"), cfg, torch.from_numpy(np.stack(reads)))


def _hand_walk(cfg, graph, seed, tpd):
    wcfg = traverse.WalkConfig(max_len=512, check_back_branches=True, tip_probe_depth=tpd)
    st = traverse.make_walks(cfg, wcfg, seed[None, :], device="cpu")
    min_cov, bound = traverse.lane_args(st, 1.0, 400)
    t = _tally_and_plain(graph, cfg, wcfg, st, min_cov, bound)
    return {key: int(v[0]) for key, v in t.items() if key != "state"}, t["state"]


def test_naive_tally_counts_a_line_by_hand():
    """A 120-base sequence walked from its first k-mer with back-branch
    checks: 95 hops advance and the 96th finds no successor (DEAD); no
    left variant is in the graph, so no probe runs.  The plain loop reads
    7 k-mers a hop (4 candidates, 3 variants); the one-step schedule takes
    a round a hop; this schedule reads on every other hop (35 k-mers: the
    candidates, 3 variants, 16 children, 12 variants of the children) and
    hands the next hop its counts."""
    rng = np.random.default_rng(5)
    line = rng.integers(0, 4, 120, dtype=np.uint8)
    cfg, graph = _line_graph([line])
    t, state = _hand_walk(cfg, graph, line[:WALK_K], 8)
    assert int(state.status[0]) == traverse.DEAD and int(state.hops[0]) == 95
    assert (t["hops"], t["resolves"], t["free_hops"]) == (96, 0, 48)
    assert (t["old_rounds"], t["new_rounds"]) == (96, 48)
    assert (t["reads"], t["needed"], t["new_reads"]) == (2 * 96 * 7, 2 * 96 * 7, 2 * 48 * 35)


def test_naive_tally_counts_a_branch_by_hand():
    """A 60-base prefix shared by two sequences (suffixes of 60 bases from
    C, G, T only, so no probe's second pick falls back on base A): 35 hops
    advance and the 36th is a branch; tip_probe_depth 4 probes both
    candidates 3 steps (one live slot each), both are deep and the lane
    stops.  The one-step schedule: 36 hop rounds and 3 probe rounds.
    This schedule: 18 hop rounds, the 36th hop free, a round for its kids,
    step 0 from them and steps 1-2 in one round of 2 x 20 k-mers."""
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, 4, 60, dtype=np.uint8)
    a, b = rng.integers(1, 4, (2, 60), dtype=np.uint8)
    b[0] = 1 + (a[0] % 3)  # the two suffixes start with different bases
    cfg, graph = _line_graph([np.concatenate([prefix, a]), np.concatenate([prefix, b])])
    t, state = _hand_walk(cfg, graph, prefix[:WALK_K], 4)
    assert int(state.status[0]) == traverse.STOPPED_BRANCH and int(state.hops[0]) == 35
    assert (t["hops"], t["resolves"], t["free_hops"]) == (36, 1, 18)
    assert (t["old_rounds"], t["new_rounds"]) == (36 + 3, 18 + 1 + 1)
    plain = 36 * 7 + 3 * 2 * 4
    assert (t["reads"], t["needed"], t["new_reads"]) == (2 * plain, 2 * plain, 2 * (18 * 35 + 28 + 2 * 20))


def test_gateless_walk_library_drops_the_gate_arguments():
    """A walk source from before the exact-count gate and terminators is
    called with the port's argument list: its old signatures are the port's
    without the six gate arguments, the gates are dropped when null, and a
    call that sets one (an exact graph, terminators) is refused."""
    import ctypes

    from rnabloom_tpu_torch.ops import _build

    old = chip_smoke.WALK_SIGNATURES_BEFORE_GATES
    common = _build._WALK_COMMON
    assert len(common) == 25 and chip_smoke.WALK_GATE_ARGS == slice(len(common), len(common) + 6)
    assert old["walk_greedy"] == common + [ctypes.c_void_p]
    assert old["walk_pair"] == common + _build._WALK_PAIR + [ctypes.c_void_p]
    assert old["walk_naive"] == common + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    calls = []

    class Old:  # a greedy-only source
        source = "old_walk_greedy.cu"

        def walk_greedy(self, *args):
            calls.append(args)
            return 0

    shim = chip_smoke.GatelessWalks(Old())
    head, stream = list(range(25)), "stream"
    assert shim.walk_greedy(*head, None, 0, 0, None, 0, 0, stream) == 0
    assert calls == [(*head, stream)]
    for gates in ((1234, 18, 2, None, 0, 0), (None, 0, 0, 1234, 16, 2)):
        with pytest.raises(ValueError, match="no exact-count gate or terminators"):
            shim.walk_greedy(*head, *gates, stream)
    assert len(calls) == 1 and not hasattr(shim, "walk_pair") and shim.source == "old_walk_greedy.cu"
