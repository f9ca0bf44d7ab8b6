"""The port's greedy walk (rnabloom_tpu_torch/graph/traverse.py) vs the JAX
package's ``traverse.extend_walks``, and a per-lane emulation of the CUDA
kernel's loop vs the same JAX walks.

Graphs: the ``tests/test_traverse.py`` shapes (a linear transcript, a
high/low-coverage branch, a repeat unit) and a graph of simulated reads
with planted substitutions (tips and bubbles), built by both packages from
the same codes (the tables are asserted equal).  Every WalkState field
must be equal, bit for bit: the JAX package's (lo, hi) uint32 hash limbs
are turned into int64 by ``traverse.walk_state_from_limbs``.
"""

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

torch.set_num_threads(2)

K = 25
FIELDS = ("buf", "pos", "status", "hops", "path_min", "fh", "rh", "hist")


def _cfgs(dtype="mf8", blocked=False, stranded=False):
    kw = dict(k=K, stranded=stranded, read_pair_distance=40)
    return (
        jdbg.GraphConfig(dbgbf=jf.BloomConfig(18, 2), cbf=jf.CountingConfig(18, 2, blocked=blocked, dtype=dtype),
                         pkbf=jf.BloomConfig(18, 2), **kw),
        tdbg.GraphConfig(dbgbf=tf.BloomConfig(18, 2), cbf=tf.CountingConfig(18, 2, blocked=blocked, dtype=dtype),
                         pkbf=tf.BloomConfig(18, 2), **kw),
    )


def _sim_data():
    """Simulated reads of 16 transcripts at uneven depth, 30% with one
    substitution; two transcripts share a 200-base prefix.  Seeds: head,
    middle and reverse-complemented tail k-mers, and one with an N."""
    rng = np.random.default_rng(7)
    tx = rng.integers(0, 4, size=(16, 600), dtype=np.uint8)
    tx[1, :200] = tx[0, :200]
    reads = []
    for t, depth in zip(tx, rng.integers(1, 9, size=16)):
        for _ in range(depth):
            for s in range(0, 500, 20):
                r = t[s : s + 100].copy()
                if rng.random() < 0.3:
                    r[rng.integers(100)] = rng.integers(4)
                reads.append(r)
    seeds = np.concatenate([tx[:, :K], tx[:, 300 : 300 + K], 3 - tx[:, -K:][:, ::-1]])
    seeds[5, 10] = 4
    return np.stack(reads), seeds


def _traverse_data():
    """The tests/test_traverse.py graphs in one read set: a linear
    transcript, a branch at 8x against 2x, and a unit repeated three
    times; seeds at the head of each."""
    rng = np.random.default_rng(2024)
    rand = lambda n: rng.integers(0, 4, size=n, dtype=np.uint8)  # noqa: E731
    linear = rand(300)
    prefix = rand(100)
    high, low = np.concatenate([prefix, rand(150)]), np.concatenate([prefix, rand(150)])
    unit = rand(60)
    cyc = np.concatenate([rand(80), unit, unit, unit])
    L = 260
    reads = []
    for seq, copies in ((linear, 2), (high, 8), (low, 2), (cyc, 2)):
        for s in range(0, max(len(seq) - L, 0) + 1, 20):
            chunk = np.full(L, 4, np.uint8)
            piece = seq[s : s + L]
            chunk[: len(piece)] = piece
            reads += [chunk] * copies
    seeds = np.stack([linear[:K], prefix[:K], cyc[:K], linear[100 : 100 + K]])
    return np.stack(reads), seeds


_DATA = {"sim": _sim_data, "traverse": _traverse_data}


@pytest.fixture(scope="module")
def graphs():
    """(data, dtype, blocked, stranded) -> (cfg_j, graph_j, cfg_t, graph_t, seeds)."""
    cache = {}

    def get(data, dtype="mf8", blocked=False, stranded=False):
        key = (data, dtype, blocked, stranded)
        if key not in cache:
            reads, seeds = _DATA[data]()
            cj, ct = _cfgs(dtype, blocked, stranded)
            gj = jdbg.build_step(jdbg.make_graph(cj), cj, jnp.asarray(reads))
            gt = tdbg.build_step(tdbg.make_graph(ct), ct, torch.from_numpy(reads))
            want = np.asarray(gj.cbf)
            np.testing.assert_array_equal(gt.cbf.numpy().view(want.dtype), want)
            cache[key] = (cj, gj, ct, gt, seeds)
        return cache[key]

    return get


# case -> (data, dtype, blocked, stranded, left, lookahead, max_len, per-lane
#          args, superstep_hops, max_supersteps, cycle_window)
CASES = {
    "canonical_la3_lane_args": ("sim", "mf8", False, False, False, 3, K + 700, True, 64, 64, 64),
    "canonical_la1": ("sim", "mf8", False, False, False, 1, K + 700, False, 64, 64, 64),
    "canonical_la2": ("sim", "mf8", False, False, False, 2, K + 700, False, 64, 64, 64),
    "canonical_la4": ("sim", "mf8", False, False, False, 4, K + 700, True, 64, 64, 64),
    "canonical_left": ("sim", "mf8", False, False, True, 3, K + 700, False, 64, 64, 64),
    "u16": ("sim", "u16", False, False, False, 3, K + 700, True, 64, 64, 64),
    "int32_blocked": ("sim", "int32", True, False, False, 3, K + 700, True, 64, 64, 64),
    "stranded_right": ("sim", "mf8", False, True, False, 3, K + 700, False, 64, 64, 64),
    "stranded_left": ("sim", "mf8", False, True, True, 3, K + 700, True, 64, 64, 64),
    "superstep_cap": ("sim", "mf8", False, False, False, 3, K + 700, False, 4, 5, 64),
    "traverse_graphs": ("traverse", "mf8", False, False, False, 3, 512, False, 64, 64, 128),
    "traverse_graphs_short_buffer": ("traverse", "mf8", False, False, False, 3, 150, False, 64, 64, 64),
}


@pytest.fixture(scope="module")
def jax_walks(graphs):
    """case -> (JAX initial state, JAX result, min_cov, bound), one JAX
    run per case shared by the tests."""
    cache = {}

    def get(case):
        if case not in cache:
            data, dtype, blocked, stranded, left, la, max_len, lane_args, hops, steps, cw = CASES[case]
            cj, gj, ct, gt, seeds = graphs(data, dtype, blocked, stranded)
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
    data, dtype, blocked, stranded, left, la, max_len, _, hops, steps, cw = CASES[case]
    return ttr.WalkConfig(max_len=max_len, lookahead=la, left=left, cycle_window=cw), hops, steps


def _assert_states_equal(got, want, what):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f"{what}: {f} differs"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_walk_equals_jax(graphs, jax_walks, case):
    data, dtype, blocked, stranded = CASES[case][:4]
    _, _, ct, gt, seeds = graphs(data, dtype, blocked, stranded)
    j0, jout, min_cov, bound = jax_walks(case)
    wcfg, hops, steps = _port_cfg(case)
    s0 = ttr.make_walks(ct, wcfg, seeds)
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


# ---- per-lane emulation of csrc/walk_greedy.cu ----

M64 = (1 << 64) - 1
SEEDS = nthash_ref.SEEDS[:4]


def _rotl(x, s):
    s %= 64
    return ((x << s) | (x >> (64 - s))) & M64 if s else x


def _signed(x):
    return x - (1 << 64) if x >> 63 else x


class KernelEmulation:
    """One thread of the walk kernel in Python integers: the lane-local
    loop (up to superstep_hops hops while ACTIVE, then one greedy resolve
    if BRANCH, for at most max_supersteps supersteps)."""

    def __init__(self, cfg, cbf: np.ndarray, wcfg, hops, steps):
        self.k, self.stranded, self.left = cfg.k, cfg.stranded, wcfg.left
        self.c = cfg.cbf
        self.max_len, self.cw, self.la = wcfg.max_len, wcfg.cycle_window, wcfg.lookahead
        self.hops_per_step, self.steps = hops, steps
        self.kms = (cfg.k * nthash.MULTI_SEED) & M64
        if self.c.dtype == "mf8":
            dec = minifloat.decode(torch.arange(256, dtype=torch.uint8)).numpy()
            self.cells = dec[cbf]
        elif self.c.dtype == "u16":
            self.cells = cbf.view(np.uint16).astype(np.float32)
        else:
            self.cells = cbf.astype(np.int64)

    def multi(self, q, i):
        if i == 0:
            return q
        t = (q * (i ^ self.kms)) & M64
        return t ^ (t >> 27)

    def count(self, q):
        c = self.c
        if c.blocked:
            rmask = (1 << min(c.size_log2 - 7, 32)) - 1
            row = ((q >> 1) & rmask) * 128
            lane0 = (q >> 40) & 127
            m = self.cells[row + lane0]
            for i in range(1, c.num_hash):
                step = (self.multi(q, i) & 0xFFFFFFFF) % 127 + 1
                m = min(m, self.cells[row + ((lane0 + step * i) & 127)])
            return np.float32(m)
        mask = (1 << c.size_log2) - 1
        return min(np.float32(self.cells[(self.multi(q, i) >> 1) & mask]) for i in range(c.num_hash))

    def candidates(self, fh, rh, out):
        t = _rotl(fh, 1) ^ _rotl(SEEDS[out] if out < 4 else 0, self.k)
        tr = _rotl(rh, 63) ^ _rotl(SEEDS[3 - out] if out < 4 else 0, 63)
        f4 = [t ^ SEEDS[c] for c in range(4)]
        r4 = [tr ^ _rotl(SEEDS[3 - c], self.k - 1) for c in range(4)]
        if self.stranded:
            q4 = r4 if self.left else f4
        else:
            q4 = [f if _signed(f) < _signed(r) else r for f, r in zip(f4, r4)]
        return f4, r4, q4, [self.count(q) for q in q4]

    def run(self, lane):
        k = self.k
        buf, hist = lane["buf"], lane["hist"]

        def at(i):
            return int(buf[min(max(i, 0), self.max_len - 1)])

        def advance(c, f4, r4, q4, cnt):
            buf[min(lane["pos"], self.max_len - 1)] = c
            hist[(lane["hops"] + 1) % self.cw] = q4[c]
            lane["fh"], lane["rh"] = f4[c], r4[c]
            lane["path_min"] = min(lane["path_min"], cnt[c])
            lane["pos"] += 1
            lane["hops"] += 1

        def score(f, r, c0):
            if self.la == 1:
                return c0
            f1, r1, _, c1 = self.candidates(f, r, at(lane["pos"] - k + 1))
            if self.la == 2:
                return max(min(c0, x) for x in c1)
            best = -np.inf
            for n1 in range(4):
                f2, r2, _, c2 = self.candidates(f1[n1], r1[n1], at(lane["pos"] - k + 2))
                for n2 in range(4):
                    pm, fl, rl = min(c0, c1[n1], c2[n2]), f2[n2], r2[n2]
                    for i in range(self.la - 3):
                        f3, r3, _, c3 = self.candidates(fl, rl, at(lane["pos"] - k + 3 + i))
                        b = int(np.argmax(c3))
                        fl, rl, pm = f3[b], r3[b], min(pm, c3[b])
                    best = max(best, pm)
            return best

        floor = max(lane["min_cov"], np.float32(1.0))
        for _ in range(self.steps):
            if lane["status"] not in (ttr.ACTIVE, ttr.BRANCH):
                break
            for _ in range(self.hops_per_step):
                if lane["status"] != ttr.ACTIVE:
                    break
                f4, r4, q4, cnt = self.candidates(lane["fh"], lane["rh"], at(lane["pos"] - k))
                viable = [c for c in range(4) if cnt[c] >= floor]
                code = viable[0] if viable else 0
                cyc = q4[code] in hist
                full = lane["pos"] >= self.max_len - 1 or lane["hops"] >= lane["bound"]
                if not viable:
                    lane["status"] = ttr.DEAD
                elif len(viable) > 1:
                    lane["status"] = ttr.BRANCH
                elif cyc:
                    lane["status"] = ttr.CYCLE
                elif full:
                    lane["status"] = ttr.FULL
                else:
                    advance(code, f4, r4, q4, cnt)
            if lane["status"] == ttr.BRANCH:
                f4, r4, q4, cnt = self.candidates(lane["fh"], lane["rh"], at(lane["pos"] - k))
                s = [score(f4[c], r4[c], cnt[c]) if cnt[c] >= floor else -1.0 for c in range(4)]
                key = [cnt[c] if s[c] >= max(s) and cnt[c] >= floor else -1.0 for c in range(4)]
                best = int(np.argmax(key))
                if q4[best] in hist:
                    lane["status"] = ttr.CYCLE
                elif lane["pos"] >= self.max_len - 1:
                    lane["status"] = ttr.FULL
                else:
                    lane["status"] = ttr.ACTIVE
                    advance(best, f4, r4, q4, cnt)
        return lane


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_emulation_equals_jax(graphs, jax_walks, case):
    data, dtype, blocked, stranded = CASES[case][:4]
    _, _, ct, gt, _ = graphs(data, dtype, blocked, stranded)
    j0, jout, min_cov, bound = jax_walks(case)
    wcfg, hops, steps = _port_cfg(case)
    s0, want = ttr.walk_state_from_limbs(j0), ttr.walk_state_from_limbs(jout)
    emu = KernelEmulation(ct, gt.cbf.numpy(), wcfg, hops, steps)
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
        assert np.array_equal(lane["buf"], want.buf[w].numpy()), f"lane {w}: buf"
        got = (lane["pos"], lane["hops"], lane["status"], lane["fh"], lane["rh"], lane["hist"])
        ref = (int(want.pos[w]), int(want.hops[w]), int(want.status[w]), int(u64(want.fh)[w]),
               int(u64(want.rh)[w]), [int(x) for x in u64(want.hist[w])])
        assert got == ref, f"lane {w}"
        assert np.float32(lane["path_min"]).tobytes() == want.path_min[w].numpy().tobytes(), f"lane {w}: path_min"


@pytest.mark.parametrize("what", ["naive", "pair", "back_branches", "terminators", "pair_ring", "reseed"])
def test_unported_walk_modes_raise(graphs, what):
    _, _, ct, gt, seeds = graphs("traverse")
    kw = {"back_branches": {"check_back_branches": True}, "terminators": {"use_terminators": True},
          "pair_ring": {"pair_ring": 64}}.get(what, {})
    with pytest.raises(NotImplementedError, match="ROADMAP queue-1 item"):
        wcfg = ttr.WalkConfig(max_len=200, **kw)
        st = ttr.make_walks(ct, wcfg, seeds)
        if what == "reseed":
            ttr.revcomp_reseed(ct, wcfg, st.buf, st.pos)
        ttr.extend_walks(st, gt, ct, wcfg, 1.0, 100, mode=what if what in ("naive", "pair") else "greedy")
