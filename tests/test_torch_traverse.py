"""The port's greedy walk (rnabloom_tpu_torch/graph/traverse.py) vs the JAX
package's ``traverse.extend_walks``, and an emulation of the CUDA kernel's
schedule (a tile of G threads per lane, each lookahead level read as one
batch, tile reductions through shuffles, first-maximum tie keys) vs the
same JAX walks.

Graphs: the ``tests/test_traverse.py`` shapes (a linear transcript, a
high/low-coverage branch, a repeat unit) and a graph of simulated reads
with planted substitutions (tips and bubbles), built by both packages from
the same codes (the tables are asserted equal), with 2 hashes and, for
one case, 3.  Every WalkState field
must be equal, bit for bit: the JAX package's (lo, hi) uint32 hash limbs
are turned into int64 by ``traverse.walk_state_from_limbs``.
"""

import functools
import operator

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rnabloom_tpu.bloom import filters as jf
from rnabloom_tpu.graph import dbg as jdbg, traverse as jtr
from rnabloom_tpu.ops import nthash_ref
from rnabloom_tpu_torch.bloom import filters as tf
from rnabloom_tpu_torch.graph import dbg as tdbg, traverse as ttr
from rnabloom_tpu_torch.ops import minifloat, nthash
from stage3_common import NAIVE_CASES, WALK_DATA, naive_lane_args, naive_walk_rows, pair_walk_rows
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)

K = 25
FIELDS = ("buf", "pos", "status", "hops", "path_min", "fh", "rh", "hist")


def _cfgs(dtype="mf8", blocked=False, stranded=False, hashes=2):
    kw = dict(k=K, stranded=stranded, read_pair_distance=40)
    return (
        jdbg.GraphConfig(dbgbf=jf.BloomConfig(18, 2),
                         cbf=jf.CountingConfig(18, hashes, blocked=blocked, dtype=dtype),
                         pkbf=jf.BloomConfig(18, 2), **kw),
        tdbg.GraphConfig(dbgbf=tf.BloomConfig(18, 2),
                         cbf=tf.CountingConfig(18, hashes, blocked=blocked, dtype=dtype),
                         pkbf=tf.BloomConfig(18, 2), **kw),
    )


_DATA = WALK_DATA


@pytest.fixture(scope="module")
def graphs():
    """(data, dtype, blocked, stranded, hashes) -> (cfg_j, graph_j, cfg_t, graph_t, seeds)."""
    cache = {}

    def get(data, dtype="mf8", blocked=False, stranded=False, hashes=2):
        key = (data, dtype, blocked, stranded, hashes)
        if key not in cache:
            reads, seeds = _DATA[data]()
            cj, ct = _cfgs(dtype, blocked, stranded, hashes)
            gj = jdbg.build_step(jdbg.make_graph(cj), cj, jnp.asarray(reads))
            gt = tdbg.build_step(tdbg.make_graph(ct, device="cpu"), ct, torch.from_numpy(reads))
            want = np.asarray(gj.cbf)
            np.testing.assert_array_equal(gt.cbf.numpy().view(want.dtype), want)
            cache[key] = (cj, gj, ct, gt, seeds)
        return cache[key]

    return get


# case -> (data, dtype, blocked, stranded, left, lookahead, max_len, per-lane
#          args, superstep_hops, max_supersteps, cycle_window, num_hash)
CASES = {
    "canonical_la3_lane_args": ("sim", "mf8", False, False, False, 3, K + 700, True, 64, 64, 64, 2),
    "canonical_la1": ("sim", "mf8", False, False, False, 1, K + 700, False, 64, 64, 64, 2),
    "canonical_la2": ("sim", "mf8", False, False, False, 2, K + 700, False, 64, 64, 64, 2),
    "canonical_la4": ("sim", "mf8", False, False, False, 4, K + 700, True, 64, 64, 64, 2),
    "canonical_la5": ("sim", "mf8", False, False, False, 5, K + 700, True, 64, 64, 64, 2),
    "canonical_left": ("sim", "mf8", False, False, True, 3, K + 700, False, 64, 64, 64, 2),
    "u16": ("sim", "u16", False, False, False, 3, K + 700, True, 64, 64, 64, 2),
    "int32_blocked": ("sim", "int32", True, False, False, 3, K + 700, True, 64, 64, 64, 2),
    "hash3": ("sim", "int32", True, False, True, 2, K + 700, True, 64, 64, 64, 3),
    "stranded_right": ("sim", "mf8", False, True, False, 3, K + 700, False, 64, 64, 64, 2),
    "stranded_left": ("sim", "mf8", False, True, True, 3, K + 700, True, 64, 64, 64, 2),
    "superstep_cap": ("sim", "mf8", False, False, False, 3, K + 700, False, 4, 5, 64, 2),
    "traverse_graphs": ("traverse", "mf8", False, False, False, 3, 512, False, 64, 64, 128, 2),
    "traverse_graphs_short_buffer": ("traverse", "mf8", False, False, False, 3, 150, False, 64, 64, 64, 2),
}


@pytest.fixture(scope="module")
def jax_walks(graphs):
    """case -> (JAX initial state, JAX result, min_cov, bound), one JAX
    run per case shared by the tests."""
    cache = {}

    def get(case):
        if case not in cache:
            data, dtype, blocked, stranded, left, la, max_len, lane_args, hops, steps, cw, nh = CASES[case]
            cj, gj, ct, gt, seeds = graphs(data, dtype, blocked, stranded, nh)
            wcfg = jtr.WalkConfig(max_len=max_len, lookahead=la, left=left, cycle_window=cw)
            s0 = jtr.make_walks(cj, wcfg, seeds)
            W = s0.pos.shape[0]
            rng = np.random.default_rng(len(case))
            if lane_args:
                min_cov = rng.choice([1.0, 2.0, 3.5, 0.5], size=W).astype(np.float32)
                bound = rng.integers(50, 700, size=W).astype(np.int32)
            else:
                min_cov, bound = np.float32(1.0), np.int32(500)
            out = jtr.extend_walks(s0, gj, cj, wcfg, min_cov, bound, superstep_hops=hops, max_supersteps=steps)
            cache[case] = (jax.device_get(s0), jax.device_get(out), min_cov, bound)
        return cache[case]

    return get


def _port_cfg(case):
    data, dtype, blocked, stranded, left, la, max_len, _, hops, steps, cw, _ = CASES[case]
    return ttr.WalkConfig(max_len=max_len, lookahead=la, left=left, cycle_window=cw), hops, steps


def _assert_states_equal(got, want, what, fields=FIELDS):
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f"{what}: {f} differs"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_walk_equals_jax(graphs, jax_walks, case):
    data, dtype, blocked, stranded = CASES[case][:4]
    _, _, ct, gt, seeds = graphs(data, dtype, blocked, stranded, CASES[case][11])
    j0, jout, min_cov, bound = jax_walks(case)
    wcfg, hops, steps = _port_cfg(case)
    s0 = ttr.make_walks(ct, wcfg, seeds, device="cpu")
    _assert_states_equal(s0, ttr.walk_state_from_limbs(j0), "make_walks")
    out = ttr.extend_walks(s0, gt, ct, wcfg, min_cov, bound, superstep_hops=hops, max_supersteps=steps)
    _assert_states_equal(out, ttr.walk_state_from_limbs(jout), "extend_walks")
    _assert_states_equal(s0, ttr.walk_state_from_limbs(j0), "input state left unchanged")
    # the cases reach the statuses they are meant to reach
    status = set(out.status.tolist())
    assert ttr.DEAD in status
    if case == "superstep_cap":
        assert ttr.ACTIVE in status or ttr.BRANCH in status
    if case == "traverse_graphs_short_buffer":
        assert ttr.FULL in status


# ---- emulation of csrc/walk_greedy.cu: a tile of G threads per lane ----

M64 = (1 << 64) - 1
SEEDS = nthash_ref.SEEDS[:4]
INF = np.float32(np.inf)


def _rotl(x, s):
    s %= 64
    return ((x << s) | (x >> (64 - s))) & M64 if s else x


def _signed(x):
    return x - (1 << 64) if x >> 63 else x


def _argmax4(v):
    """First index of the maximum (strict >), as the kernel's argmax4 and
    jnp.argmax."""
    best = 0
    for c in range(1, 4):
        if v[c] > v[best]:
            best = c
    return best


class TileEmulation:
    """The walk kernel's schedule in Python integers, for one tile of G
    threads per lane.  Each thread's registers are a list indexed by rank;
    every level of a resolve is read as one batch (thread r owns k-mers
    j = r + G*m and reads all their cells before any count is used); values
    cross threads only through ``shfl`` and the butterfly ``tile_max``;
    the cycle ring is split by slot ownership (slot j belongs to rank
    j % G); a hop's counts serve the resolve at the same k-mer, and a
    resolve's level-1 counts under its choice serve the next hop.
    ``reads`` and ``rounds`` count cell reads and dependent read rounds,
    per lane."""

    def __init__(self, cfg, cbf: np.ndarray, wcfg, hops, steps, G=8):
        self.k, self.stranded, self.left = cfg.k, cfg.stranded, wcfg.left
        self.c = cfg.cbf
        self.max_len, self.cw, self.la = wcfg.max_len, wcfg.cycle_window, wcfg.lookahead
        self.hops_per_step, self.steps, self.G = hops, steps, G
        self.M1, self.M2 = -(-16 // G), 64 // G
        self.kms = (cfg.k * nthash.MULTI_SEED) & M64
        self.rs = [_rotl(SEEDS[3 - n], self.k - 1) for n in range(4)]
        if self.c.dtype == "mf8":
            dec = minifloat.decode(torch.arange(256, dtype=torch.uint8)).numpy()
            self.cells = dec[cbf]
        elif self.c.dtype == "u16":
            self.cells = cbf.view(np.uint16).astype(np.float32)
        else:
            self.cells = cbf.astype(np.int64)

    # -- one thread's arithmetic --

    def multi(self, q, i):
        if i == 0:
            return q
        t = (q * (i ^ self.kms)) & M64
        return t ^ (t >> 27)

    def cell(self, q, i):
        c = self.c
        if c.blocked:
            row = ((q >> 1) & ((1 << min(c.size_log2 - 7, 32)) - 1)) * 128
            lane0 = (q >> 40) & 127
            lane = lane0 if i == 0 else (lane0 + ((self.multi(q, i) & 0xFFFFFFFF) % 127 + 1) * i) & 127
            return np.float32(self.cells[row + lane])
        return np.float32(self.cells[(self.multi(q, i) >> 1) & ((1 << c.size_log2) - 1)])

    def count_many(self, qs, on):
        """count_many: every cell of every key issued, then the mins; keys
        that are off are not read and count +inf."""
        cells = [[self.cell(q, i) for i in range(self.c.num_hash)] if o else [] for q, o in zip(qs, on)]
        self.reads += sum(len(x) for x in cells)
        return [min(x) if x else INF for x in cells]

    def slide(self, f, r, out):
        seed = lambda c: SEEDS[c] if c < 4 else 0  # noqa: E731
        return _rotl(f, 1) ^ _rotl(seed(out), self.k), _rotl(r, 63) ^ _rotl(seed(3 - out if out < 4 else out), 63)

    def child(self, sl, n):
        return sl[0] ^ SEEDS[n], sl[1] ^ self.rs[n]

    def query(self, f, r):
        if self.stranded:
            return r if self.left else f
        return f if _signed(f) < _signed(r) else r

    # -- tile collectives --

    def tile_max(self, vals):
        vals = list(vals)
        o = self.G // 2
        while o:
            vals = [max(vals[r], vals[r ^ o]) for r in range(self.G)]
            o //= 2
        assert len(set(vals)) == 1
        return vals

    # -- the lane --

    def run(self, lane):
        G, k = self.G, self.k
        buf, ring = lane["buf"], lane["hist"]
        self.reads = self.rounds = 0
        st = {"cached": False}

        def at(i):
            return int(buf[min(max(i, 0), self.max_len - 1)])

        def check_ring():
            """Bit c: candidate c is in the ring; rank r scans slots r mod G,
            the bits are ORed across the tile."""
            owned = [set(ring[r : self.cw : G]) for r in range(G)]
            hits = [sum(1 << c for c in range(4) if st["q4"][c] in owned[r]) for r in range(G)]
            st["seen"] = functools.reduce(operator.or_, hits)

        def slide_candidates():
            sl = self.slide(lane["fh"], lane["rh"], at(lane["pos"] - k))
            st["f4"], st["r4"] = zip(*(self.child(sl, c) for c in range(4)))
            st["q4"] = [self.query(f, r) for f, r in zip(st["f4"], st["r4"])]

        def read_candidates():
            slide_candidates()
            got = self.count_many(st["q4"], [True] * 4)  # rank c reads candidate c
            check_ring()  # while the reads are in flight
            self.rounds += 1
            st["cnt"] = got  # shfl from ranks 0-3
            st["cached"] = True

        def advance(c):
            buf[min(lane["pos"], self.max_len - 1)] = c
            slot = (lane["hops"] + 1) % self.cw
            ring[slot] = st["q4"][c]  # written by rank slot % G, its owner
            lane["fh"], lane["rh"] = st["f4"][c], st["r4"][c]
            lane["path_min"] = min(lane["path_min"], st["cnt"][c])
            lane["pos"] += 1
            lane["hops"] += 1
            st["cached"] = False

        def scores(viable):
            f4, r4, cnt = st["f4"], st["r4"], st["cnt"]
            best = [[-INF] * 4 for _ in range(G)]
            out1 = at(lane["pos"] - k + 1)
            c1 = []
            for r in range(G):  # level 1: k-mer j = 4c + n1, all read in one round
                js = [r + G * m for m in range(self.M1)]
                kms = [self.child(self.slide(f4[(j >> 2) & 3], r4[(j >> 2) & 3], out1), j & 3) for j in js]
                c1.append(self.count_many([self.query(*x) for x in kms],
                                          [j < 16 and viable[(j >> 2) & 3] for j in js]))
            self.rounds += 1
            if self.la == 2:
                for r in range(G):
                    for m in range(self.M1):
                        j = r + G * m
                        c = (j >> 2) & 3
                        if j < 16 and viable[c]:
                            best[r][c] = max(best[r][c], min(cnt[c], c1[r][m]))
            else:
                out2 = at(lane["pos"] - k + 2)
                leaves = []  # per rank: (f, r, pm, on) of its M2 leaves
                for r in range(G):
                    mine = []
                    for m in range(self.M2):
                        j = r + G * m
                        c, j1 = j >> 4, j >> 2
                        f1, r1 = self.child(self.slide(f4[c], r4[c], out1), j1 & 3)
                        fl, rl = self.child(self.slide(f1, r1, out2), j & 3)
                        up = c1[j1 % G][j1 // G]  # shfl of slot j1 // G from rank j1 % G
                        mine.append([fl, rl, min(cnt[c], up), viable[c]])
                    c2 = self.count_many([self.query(x[0], x[1]) for x in mine], [x[3] for x in mine])
                    for x, v in zip(mine, c2):
                        x[2] = min(x[2], v)
                    leaves.append(mine)
                self.rounds += 1
                for i in range(self.la - 3):  # the descents, one level per round
                    outc = at(lane["pos"] - k + 3 + i)
                    for mine in leaves:
                        sls = [self.slide(x[0], x[1], outc) for x in mine]
                        kids = [[self.child(s, n) for n in range(4)] for s in sls]
                        c3 = self.count_many([self.query(*kid) for ks in kids for kid in ks],
                                             [x[3] for x in mine for _ in range(4)])
                        for m, x in enumerate(mine):
                            v = c3[4 * m : 4 * m + 4]
                            b = _argmax4(v)
                            x[0], x[1] = self.child(sls[m], b)
                            x[2] = min(x[2], v[b])
                    self.rounds += 1
                for r, mine in enumerate(leaves):
                    for m, x in enumerate(mine):
                        c = (r + G * m) >> 4
                        if x[3]:
                            best[r][c] = max(best[r][c], x[2])
            return [self.tile_max([best[r][c] for r in range(G)])[0] for c in range(4)], c1

        floor = max(lane["min_cov"], np.float32(1.0))
        for _ in range(self.steps):
            if lane["status"] not in (ttr.ACTIVE, ttr.BRANCH):
                break
            for _ in range(self.hops_per_step):
                if lane["status"] != ttr.ACTIVE:
                    break
                if not st["cached"]:
                    read_candidates()
                cnt = st["cnt"]
                viable = [c for c in range(4) if cnt[c] >= floor]
                code = viable[0] if viable else 0
                if not viable:
                    lane["status"] = ttr.DEAD
                elif len(viable) > 1:
                    lane["status"] = ttr.BRANCH
                elif st["seen"] >> code & 1:
                    lane["status"] = ttr.CYCLE
                elif lane["pos"] >= self.max_len - 1 or lane["hops"] >= lane["bound"]:
                    lane["status"] = ttr.FULL
                else:
                    advance(code)
            if lane["status"] == ttr.BRANCH:
                if not st["cached"]:
                    read_candidates()
                cnt = st["cnt"]
                viable = [cnt[c] >= floor for c in range(4)]
                s, c1 = (list(cnt), None) if self.la == 1 else scores(viable)
                s = [s[c] if viable[c] else np.float32(-1.0) for c in range(4)]
                key = [cnt[c] if s[c] >= max(s) and viable[c] else np.float32(-1.0) for c in range(4)]
                best = _argmax4(key)
                if st["seen"] >> best & 1:
                    lane["status"] = ttr.CYCLE
                elif lane["pos"] >= self.max_len - 1:
                    lane["status"] = ttr.FULL
                else:
                    lane["status"] = ttr.ACTIVE
                    # the choice's children, read at level 1, are the next
                    # hop's candidates: shuffled from their ranks, not read
                    reuse = self.la > 1 and viable[best] and k > 1
                    kids = [c1[(4 * best + n) % G][(4 * best + n) // G] for n in range(4)] if reuse else None
                    advance(best)
                    if reuse:
                        slide_candidates()
                        check_ring()
                        st["cnt"], st["cached"] = kids, True
        return lane


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_emulation_equals_jax(graphs, jax_walks, case):
    data, dtype, blocked, stranded, hashes = CASES[case][:4] + (CASES[case][11],)
    _, _, ct, gt, _ = graphs(data, dtype, blocked, stranded, hashes)
    j0, jout, min_cov, bound = jax_walks(case)
    wcfg, hops, steps = _port_cfg(case)
    s0, want = ttr.walk_state_from_limbs(j0), ttr.walk_state_from_limbs(jout)
    # the shipped tile (8) on every case; 16 and 32 too on one case
    for G in {"hash3": (8, 16, 32)}.get(case, (8,)):
        emu = TileEmulation(ct, gt.cbf.numpy(), wcfg, hops, steps, G)
        W = s0.pos.shape[0]
        mc = np.broadcast_to(np.asarray(min_cov, np.float32), (W,))
        bd = np.broadcast_to(np.asarray(bound, np.int32), (W,))
        u64 = lambda t: t.numpy().view(np.uint64)  # noqa: E731
        for w in range(W):
            lane = emu.run({
                "buf": s0.buf[w].numpy().copy(), "hist": [int(x) for x in u64(s0.hist[w])],
                "pos": int(s0.pos[w]), "hops": int(s0.hops[w]), "status": int(s0.status[w]),
                "fh": int(u64(s0.fh)[w]), "rh": int(u64(s0.rh)[w]), "path_min": np.float32(s0.path_min[w]),
                "min_cov": np.float32(mc[w]), "bound": int(bd[w]),
            })
            assert np.array_equal(lane["buf"], want.buf[w].numpy()), f"G={G} lane {w}: buf"
            got = (lane["pos"], lane["hops"], lane["status"], lane["fh"], lane["rh"], lane["hist"])
            ref = (int(want.pos[w]), int(want.hops[w]), int(want.status[w]), int(u64(want.fh)[w]),
                   int(u64(want.rh)[w]), [int(x) for x in u64(want.hist[w])])
            assert got == ref, f"G={G} lane {w}"
            assert np.float32(lane["path_min"]).tobytes() == want.path_min[w].numpy().tobytes(), \
                f"G={G} lane {w}: path_min"


@pytest.mark.parametrize("what", ["back_branches"])
def test_unported_walk_modes_raise(graphs, what):
    """Back-branch checks are ported in naive mode only, the one mode the
    JAX package runs them in."""
    _, _, ct, gt, seeds = graphs("traverse")
    for mode, ring in (("greedy", 0), ("pair", 64)):
        wcfg = ttr.WalkConfig(max_len=200, check_back_branches=True, pair_ring=ring)
        st = ttr.make_walks(ct, wcfg, seeds, device="cpu")
        with pytest.raises(ValueError, match="only naive walks"):
            ttr.extend_walks(st, gt, ct, wcfg, 1.0, 100, mode=mode)


# ---- naive mode (-extend): depth-probed resolves and back-branch stops ----


def naive_stops(st, graph, cfg, wcfg, min_cov) -> set:
    """The kinds of stop among the finished walks ``st``: a lane stops
    where it froze, so its final state is the state of the stop.  A
    STOPPED_BRANCH lane whose k-mer has a deep left variant stopped on a
    back branch (a hop checks it before any other status); any other one
    at a resolve with no deep candidate or with several."""
    W = st.pos.shape[0]
    mc = torch.as_tensor(min_cov, dtype=torch.float32).expand(W).contiguous()
    floor = torch.clamp(mc, min=1.0)[:, None]
    out = ttr._gather_out_codes(st.buf, st.pos, cfg.k)
    back = torch.zeros(W, dtype=torch.bool)
    if wcfg.check_back_branches:
        flv, rlv = nthash.variant_hashes_left(st.fh, out, cfg.k, st.rh)
        cv = tdbg.get_counts(graph, cfg, ttr._query_hash(cfg, wcfg, flv, rlv))
        viable_v = (cv >= floor) & (torch.arange(4)[None, :] != out[:, None])
        back = (ttr._variant_depth_probe(graph, cfg, wcfg, st.buf, st.pos, flv, rlv, viable_v, mc)
                >= wcfg.tip_probe_depth).any(dim=1)
    fh4, rh4, q4 = ttr._successors(cfg, wcfg, st.fh, st.rh, out)
    viable = tdbg.get_counts(graph, cfg, q4) >= floor
    ndeep = (ttr._tip_probe(graph, cfg, wcfg, st.buf, st.pos, fh4, rh4, viable, mc) >= wcfg.tip_probe_depth).sum(1)
    stopped = st.status == ttr.STOPPED_BRANCH
    kinds = {
        "back": stopped & back, "none_deep": stopped & ~back & (ndeep == 0),
        "several_deep": stopped & ~back & (ndeep >= 2), "full": st.status == ttr.FULL,
        "cycle": st.status == ttr.CYCLE,
    }
    assert not bool((stopped & ~back & (ndeep == 1)).any()), "a stop that neither rule explains"
    return {name for name, m in kinds.items() if bool(m.any())}


@pytest.mark.parametrize("case", list(NAIVE_CASES))
def test_naive_walk_equals_jax(graphs, case):
    """extend_walks(mode="naive") on the port's plain loop against the JAX
    package's, every field equal; each case shows the stops it names."""
    data, dtype, blocked, stranded, nh, left, back, tpd, max_len, _, stops = NAIVE_CASES[case]
    cj, gj, ct, gt, seeds = graphs(data, dtype, blocked, stranded, nh)
    rows = naive_walk_rows(data, _DATA[data]()[0], seeds, stranded, left)
    kw = dict(max_len=max_len, left=left, check_back_branches=back, tip_probe_depth=tpd)
    wj, wt = jtr.WalkConfig(**kw), ttr.WalkConfig(**kw)
    j0 = jtr.make_walks(cj, wj, rows)
    s0 = ttr.make_walks(ct, wt, rows, device="cpu")
    _assert_states_equal(s0, ttr.walk_state_from_limbs(jax.device_get(j0)), "make_walks")
    min_cov, bound = naive_lane_args(case, s0.pos.shape[0])
    want = ttr.walk_state_from_limbs(jax.device_get(jtr.extend_walks(j0, gj, cj, wj, min_cov, bound, mode="naive")))
    got = ttr.extend_walks(s0, gt, ct, wt, min_cov, bound, mode="naive")
    _assert_states_equal(got, want, "extend_walks(mode='naive')")
    assert int(got.hops.sum()) > 0
    assert naive_stops(got, gt, ct, wt, min_cov) >= stops


# ---- pair mode: branches resolved by read/fragment pair support ----

PAIR_FIELDS = FIELDS + ("ring_fh", "ring_rh")


@pytest.fixture(scope="module")
def pair_graphs():
    """(data, dtype, blocked, stranded, pkbf hashes, with fpkbf) -> (cfg_j,
    graph_j, cfg_t, graph_t, reads, seeds): the cbf and the read-pair keys
    from the reads (read pair distance 40), and, with an fpkbf, the
    fragment-pair keys from the same reads (distance 60), as stage 2b
    inserts them; tables asserted equal."""
    cache = {}

    def get(data, dtype="mf8", blocked=False, stranded=False, pk_hashes=2, frag=True):
        key = (data, dtype, blocked, stranded, pk_hashes, frag)
        if key not in cache:
            reads, seeds = _DATA[data]()
            kw = dict(k=K, stranded=stranded, read_pair_distance=40, fragment_pair_distance=60 if frag else -1)
            cj = jdbg.GraphConfig(dbgbf=jf.BloomConfig(18, 2), cbf=jf.CountingConfig(18, 2, blocked=blocked, dtype=dtype),
                                  pkbf=jf.BloomConfig(18, pk_hashes), **kw)
            ct = tdbg.GraphConfig(dbgbf=tf.BloomConfig(18, 2), cbf=tf.CountingConfig(18, 2, blocked=blocked, dtype=dtype),
                                  pkbf=tf.BloomConfig(18, pk_hashes), **kw)
            gj = jdbg.build_step(jdbg.make_graph(cj, with_rpkbf=True, with_fpkbf=frag), cj, jnp.asarray(reads),
                                 add_read_pairs=True)
            gt = tdbg.build_step(tdbg.make_graph(ct, with_rpkbf=True, with_fpkbf=frag, device="cpu"), ct, torch.from_numpy(reads),
                                 add_read_pairs=True)
            if frag:
                gj = jdbg.rebuild_step(gj, cj, jnp.asarray(reads), salt=1)
                gt = tdbg.rebuild_step(gt, ct, torch.from_numpy(reads), salt=1)
            for name in ("cbf", "rpkbf", "fpkbf"):
                if getattr(gj, name) is not None:
                    want = np.asarray(getattr(gj, name))
                    np.testing.assert_array_equal(getattr(gt, name).numpy().view(want.dtype), want, err_msg=name)
            cache[key] = (cj, gj, ct, gt, reads, seeds)
        return cache[key]

    return get


# case -> (data, dtype, blocked, stranded, left, pkbf hashes, fpkbf, ring, max_len, per-lane args)
PAIR_CASES = {
    "right": ("sim", "mf8", False, False, False, 2, True, 64, K + 400, False),
    "left": ("sim", "mf8", False, False, True, 2, True, 64, K + 400, True),
    "stranded_right": ("sim", "mf8", False, True, False, 2, True, 64, K + 400, False),
    "stranded_left": ("sim", "mf8", False, True, True, 2, True, 64, K + 400, False),
    "u16_pk_hash3": ("sim", "u16", False, False, False, 3, True, 64, K + 400, True),
    "int32_blocked": ("sim", "int32", True, False, True, 2, True, 64, K + 400, False),
    "short_ring": ("sim", "mf8", False, False, False, 2, True, 48, K + 400, False),
    "ring_exactly_read_distance": ("sim", "mf8", False, False, False, 2, True, 40, K + 400, False),
    "rpkbf_only_traverse_graphs": ("traverse", "mf8", False, False, False, 2, False, 128, 512, False),
}


def _pair_args(case, W):
    lane_args = PAIR_CASES[case][9]
    if not lane_args:
        return np.float32(1.0), np.int32(300)
    rng = np.random.default_rng(len(case))
    return (rng.choice([1.0, 2.0, 3.5, 0.5], size=W).astype(np.float32),
            rng.integers(50, 400, size=W).astype(np.int32))


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_walk_equals_jax(pair_graphs, case):
    data, dtype, blocked, stranded, left, pkh, frag, ring, max_len, _ = PAIR_CASES[case]
    cj, gj, ct, gt, reads, seeds = pair_graphs(data, dtype, blocked, stranded, pkh, frag)
    rows, lens = pair_walk_rows(data, reads, seeds, left)
    wj = jtr.WalkConfig(max_len=max_len, pair_ring=ring, left=left)
    wt = ttr.WalkConfig(max_len=max_len, pair_ring=ring, left=left)
    j0 = jtr.make_walks(cj, wj, rows, lens)
    s0 = ttr.make_walks(ct, wt, rows, lens, device="cpu")
    _assert_states_equal(s0, ttr.walk_state_from_limbs(jax.device_get(j0)), "make_walks", PAIR_FIELDS)
    min_cov, bound = _pair_args(case, s0.pos.shape[0])
    want = ttr.walk_state_from_limbs(jax.device_get(jtr.extend_walks(j0, gj, cj, wj, min_cov, bound, mode="pair")))
    got = ttr.extend_walks(s0, gt, ct, wt, min_cov, bound, mode="pair")
    _assert_states_equal(got, want, "extend_walks(mode='pair')", PAIR_FIELDS)
    status = set(got.status.tolist())
    assert ttr.DEAD in status and int(got.hops.sum()) > 0
    assert ttr.STOPPED_BRANCH in status or case not in ("right", "left")


@pytest.mark.parametrize("stranded", [False, True])
def test_pair_walk_revcomp_reseed_equals_jax(pair_graphs, stranded):
    """Right pair walks, the reverse-complement hand-off (a seed of up to
    max_len bases: far more k-mers than the ring holds), then left pair
    walks."""
    cj, gj, ct, gt, reads, seeds = pair_graphs("sim", stranded=stranded)
    rows, lens = pair_walk_rows("sim", reads, seeds)
    wj, wt = jtr.WalkConfig(max_len=K + 400, pair_ring=64), ttr.WalkConfig(max_len=K + 400, pair_ring=64)
    wjl = jtr.WalkConfig(max_len=K + 400, pair_ring=64, left=True)
    wtl = ttr.WalkConfig(max_len=K + 400, pair_ring=64, left=True)
    jr = jtr.extend_walks(jtr.make_walks(cj, wj, rows, lens), gj, cj, wj, 1.0, 400, mode="pair")
    tr = ttr.extend_walks(ttr.make_walks(ct, wt, rows, lens, device="cpu"), gt, ct, wt, 1.0, 400, mode="pair")
    _assert_states_equal(tr, ttr.walk_state_from_limbs(jax.device_get(jr)), "right walks", PAIR_FIELDS)
    assert int(tr.pos.max()) - K + 1 > 64
    jl0 = jtr.revcomp_reseed(cj, wjl, jr.buf, jr.pos)
    tl0 = ttr.revcomp_reseed(ct, wtl, tr.buf, tr.pos)
    _assert_states_equal(tl0, ttr.walk_state_from_limbs(jax.device_get(jl0)), "revcomp_reseed", PAIR_FIELDS)
    jl = jtr.extend_walks(jl0, gj, cj, wjl, 1.0, 400, mode="pair")
    tl = ttr.extend_walks(tl0, gt, ct, wtl, 1.0, 400, mode="pair")
    _assert_states_equal(tl, ttr.walk_state_from_limbs(jax.device_get(jl)), "left walks", PAIR_FIELDS)


def test_pair_walks_refuse_what_they_cannot_do(pair_graphs):
    _, _, ct, gt, reads, seeds = pair_graphs("sim")
    st = ttr.make_walks(ct, ttr.WalkConfig(max_len=200), seeds, device="cpu")
    with pytest.raises(ValueError, match="pair ring"):
        ttr.extend_walks(st, gt, ct, ttr.WalkConfig(max_len=200), 1.0, 100, mode="pair")
    wcfg = ttr.WalkConfig(max_len=200, pair_ring=64, pair_probe_depth=K)
    st = ttr.make_walks(ct, wcfg, reads[:4, :100], device="cpu")
    with pytest.raises(AssertionError, match="below k"):
        ttr.extend_walks(st, gt, ct, wcfg, 1.0, 100, mode="pair")
