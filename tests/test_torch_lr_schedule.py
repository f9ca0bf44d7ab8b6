"""A numpy model of the long-read kernels' schedules
(``rnabloom_tpu_torch/csrc/lr_kernels.cu``: ``kmer_keys_kernel``,
``randstrobe_kernel`` and ``vote_kernel``) against the plain versions and,
through ``tests/test_torch_lr_keys.py``'s helpers, against the JAX package.

The model follows the kernels step for step, with their tile sizes read
from the source: the 32-way warp search of the offsets; for the k-mer
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)
keys the staged codes (min(code, 4), the read starts marked), each
thread's run of rolled forward and reverse hashes (seed 0 for codes 4 and
255) and its validity as the least position that may start a valid k-mer;
for the randstrobes the staged T_b = b + (b >> 2), invalid mask and
validity bitmask, each position's read from the start marks and a block
prefix max, C_a = (cur << 6) + 0x9E3779B9, a window's two chains (its
first and last halves, an invalid candidate ~0) and their merge, its
validity from the bitmask 32 candidates at a time, and the device-memory
path past the staged positions.  Reads of every edge
length (k - 1 up to the strobemer minimum + 1), runs and windows that
cross a read's end, reads longer than several tiles, tiles of reads too
short for any key, empty reads, and codes 4 and 255 on tile edges and in
halos.  For the consensus vote: the blocks a unitig and their tiles, the
read list filled window by window (and kept across tiles when one window
holds the batch), each warp's columns and the reads that overlap them,
and every cell written once, on ``lr_common.vote_case``'s edge cases,
unitigs of several tiles, more reads on one unitig than a window holds,
and an empty batch.
"""

import numpy as np
import pytest
import torch

from rnabloom_tpu.assembly import longreads as jlr, stage1 as js1
from rnabloom_tpu_torch.ops import lr_keys, nthash, strobemer as tstrobe
from rnabloom_tpu_torch.utils import lrsim, seq as sequtils
from lr_common import VOTE_CASES, kernel_constants, ragged_plain, vote_case
from rnabloom_tpu_torch.ops import consensus_vote as cv
from test_torch_lr_keys import _assert_same_keys, _emulated_kmer_hashes, _emulated_randstrobe, _jax_strobemer_fn

torch.set_num_threads(2)

U64 = np.uint64
ALL = U64((1 << 64) - 1)
C = kernel_constants()


def _shl(x, s):
    return np.left_shift(x, U64(s))


def _shr(x, s):
    return np.right_shift(x, U64(s))


def _rotl(x, s):
    s %= 64
    return x if s == 0 else _shl(x, s) | _shr(x, 64 - s)


def warp_upper_bound(a: np.ndarray, n: int, x: int):
    """The kernels' 32-way search: (first i in [0, n] with a[i] > x, or
    n + 1; its rounds)."""
    lo, hi, rounds = -1, n + 1, 0
    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        gt = [p >= hi or a[p] > x for p in (lo + (lane + 1) * step for lane in range(32))]
        f = gt.index(True)
        hi, lo, rounds = min(lo + (f + 1) * step, hi), lo + f * step, rounds + 1
    return hi, rounds


def model_kmer_hashes(codes: np.ndarray, offsets: np.ndarray, k: int, stranded: bool):
    """``kmer_keys_kernel``: (hash uint64, valid uint8) at every position."""
    tile, run, threads, stage = C["kKmerTile"], C["kKmerRun"], C["kKmerThreads"], C["kKmerStage"]
    brk = C["kStageBreak"]
    total, n_reads = len(codes), len(offsets) - 1
    seeds = np.array(nthash.SEEDS[:4] + [0], U64)
    comp = np.array(nthash.SEEDS[3::-1] + [0], U64)
    tab = np.stack([seeds, _rotl(seeds, k), _rotl(comp, 63), _rotl(comp, k - 1)])
    stop = min(total, int(offsets[-1]))
    n_tiles = -(-total // tile)
    x0 = np.arange(n_tiles)[:, None] * tile
    pos = x0 + np.arange(stage)[None, :]
    staged = np.where(pos < stop, np.minimum(codes[np.minimum(pos, total - 1)], 4), 4).astype(np.uint8)
    for t in range(n_tiles):
        i0 = max(warp_upper_bound(offsets, n_reads, t * tile)[0], 1)
        o = offsets[i0:]
        o = o[o < t * tile + tile + k - 1]
        staged[t, o - t * tile] |= brk
    rows = np.arange(n_tiles)[:, None]
    r = np.arange(threads)[None, :] * run
    fh = np.zeros((n_tiles, threads), U64)
    rh = np.zeros_like(fh)
    lim = np.zeros((n_tiles, threads), np.int64)

    def roll_in(q, out_code):
        nonlocal fh, rh, lim
        v = staged[rows, q]
        c = v & 7
        fh = _rotl(fh, 1) ^ tab[1][out_code] ^ tab[0][c]
        if not stranded:
            rh = _rotl(rh, 63) ^ tab[2][out_code] ^ tab[3][c]
        lim = np.maximum(lim, np.where(c == 4, q + 1, np.where(v & brk, q, 0)))

    for t in range(k - 1):
        roll_in(r + t, 4)
    hs = np.zeros((n_tiles, tile), U64)
    vs = np.zeros((n_tiles, tile), np.uint8)
    for j in range(run):
        roll_in(r + j + k - 1, staged[rows, r + j - 1] & 7 if j else 4)
        ok = r + j >= lim
        h = fh if stranded else np.where(fh.view(np.int64) < rh.view(np.int64), fh, rh)
        hs[rows, r + j] = np.where(ok, h, U64(0))
        vs[rows, r + j] = ok
    return hs.reshape(-1)[:total], vs.reshape(-1)[:total]


def _prefix_max_block(rd: np.ndarray) -> np.ndarray:
    """``prefix_max``: a thread's kStrobePer entries, a warp's shuffle
    scan, the warps' tops."""
    threads, per = C["kStrobeThreads"], C["kStrobePer"]
    v = np.maximum.accumulate(rd.reshape(threads, per), axis=1)
    incl = v[:, -1].reshape(-1, 32)
    incl = np.maximum.accumulate(incl, axis=1)
    tops = incl[:, -1]
    before = np.concatenate([np.full((incl.shape[0], 1), -1), incl[:, :-1]], axis=1)
    before = np.maximum(before, np.concatenate([[-1], np.maximum.accumulate(tops)[:-1]])[:, None])
    return np.maximum(before.reshape(-1, 1), v).reshape(-1)


def funnel_r(lo, hi, sh):
    """``__funnelshift_r``: the low word of (hi:lo) >> sh."""
    return (_shl(hi.astype(U64), 32) | lo.astype(U64)) >> sh.astype(U64) & U64(0xFFFFFFFF)


def model_randstrobe(hash_: np.ndarray, valid: np.ndarray, offsets: np.ndarray, aoff: np.ndarray, k: int, n: int,
                     w_min: int, w_max: int, stage_max: int = None, stats: dict = None):
    """``randstrobe_kernel`` on the kernel's tiles: (hash uint64, ok uint8)
    per anchor.  ``stage_max`` stands in for kStrobeStageMax (to reach the
    device-memory path with small windows); ``stats["device_windows"]``
    counts the windows read from device memory."""
    tile = C["kStrobeTile"]
    stage_max = C["kStrobeStageMax"] if stage_max is None else stage_max
    total, n_reads, n_anchors = int(offsets[-1]), len(offsets) - 1, int(aoff[-1])
    reach = (n - 1) * w_max
    S = min((tile + reach + 31) // 32 * 32, stage_max)
    hu = hash_.view(U64)
    out = np.zeros(n_anchors, U64)
    out_ok = np.zeros(n_anchors, np.uint8)
    written = np.zeros(n_anchors, np.int64)
    for x0 in range(0, total, tile):
        r0 = warp_upper_bound(offsets, n_reads, x0)[0] - 1
        pos = x0 + np.arange(S)
        inb = pos < total
        b = np.where(inb, hu[np.minimum(pos, total - 1)], U64(0))
        T = b + _shr(b, 2)
        ok_s = inb & (valid[np.minimum(pos, total - 1)] != 0)
        inv = np.where(ok_s, U64(0), ALL)  # the 4-byte mask, as both words of a 64-bit one
        vm = (ok_s.reshape(-1, 32).astype(U64) << np.arange(32, dtype=U64)).sum(1).astype(U64)
        vm = np.concatenate([vm, np.zeros(2, U64)])
        rd = np.full(tile, -1, np.int64)
        rd[0] = r0
        idx = np.arange(r0 + 1, n_reads)
        o = offsets[idx]
        sel = o < x0 + tile
        np.maximum.at(rd, o[sel] - x0, idx[sel])
        rd = _prefix_max_block(rd)
        assert np.array_equal(rd, np.maximum.accumulate(rd))

        p = np.arange(tile)
        x = x0 + p
        i = rd
        a = x - offsets[i]
        anchor = (x < total) & (a < aoff[i + 1] - aoff[i])
        lim = offsets[i + 1] - k + 1 - x0
        ok = ((vm[p >> 5] >> (p & 31).astype(U64)) & U64(1)).astype(bool) & anchor
        cur = np.where(ok, hu[np.minimum(x, total - 1)], U64(0))
        for s in range(n - 1):
            q0 = p + s * w_max + w_min
            length = np.minimum(q0 + (w_max - w_min), lim) - q0
            c_a = _shl(cur, 6) + U64(0x9E3779B9)
            staged = ok & (length > 0) & (q0 + length <= S)
            device = ok & (length > 0) & ~staged
            # window_any: the bitmask, 32 candidates a funnel shift
            any_ = np.zeros(tile, bool)
            for c in range(0, int(length[staged].max(initial=0)), 32):
                act = staged & (c < length)
                q = np.where(act, q0 + c, 0)
                bits = funnel_r(vm[q >> 5], vm[(q >> 5) + 1], q & 31)
                rem = np.clip(length - c, 0, 32)
                bits &= np.where(rem >= 32, U64(0xFFFFFFFF), (U64(1) << rem.astype(U64)) - U64(1))
                any_ |= act & (bits != 0)
            # window_min: the first and last h = ceil(len / 2), an invalid candidate ~0
            h = (length + 1) // 2
            b0, b1 = np.full(tile, ALL), np.full(tile, ALL)
            for j in range(int(h[staged].max(initial=0))):
                act = staged & (j < h)
                for base, best in ((q0, b0), (q0 + length - h, b1)):
                    c = np.where(act, base + j, 0)
                    v = ((T[c] + c_a) ^ cur) | inv[c]
                    np.copyto(best, v, where=act & (v < best))
            best = np.minimum(b0, b1)
            # device memory past the staged positions
            if stats is not None:
                stats["device_windows"] = stats.get("device_windows", 0) + int(device.sum())
            bd, ad = np.full(tile, ALL), np.zeros(tile, bool)
            for c in range(int(length[device].max(initial=0))):
                act = device & (c < length)
                xg = np.where(act, x0 + q0 + c, 0)
                act &= valid[xg] != 0
                v = ((hu[xg] + _shr(hu[xg], 2)) + c_a) ^ cur
                np.copyto(bd, v, where=act & (v < bd))
                ad |= act
            cur = np.where(staged, best, np.where(device, bd, cur))
            ok = np.where(staged, any_, np.where(device, ad, False))
        at = (aoff[i] + a)[anchor]
        out[at] = np.where(ok, cur, U64(0))[anchor]
        out_ok[at] = ok[anchor]
        written[at] += 1
    assert (written == 1).all()  # every anchor written once
    return out, out_ok


def vote_grid(U: int, L: int) -> tuple:
    """The vote kernel's tiles a unitig and blocks a unitig (each taking as
    many of its tiles as the others, the last fewer)."""
    tiles = -(-L // C["kVoteTile"])
    per = -(-tiles // min(-(-C["kVoteBlocks"] // U), 65535))
    return tiles, -(-tiles // per)


def model_vote(unitigs: np.ndarray, reads: np.ndarray, tgt: np.ndarray, start: np.ndarray, min_depth: int):
    """``vote_kernel`` as its blocks, warps and lanes run it: (polished,
    depth, the most reads a list held, the list fills)."""
    U, L = unitigs.shape
    R, Lr = reads.shape
    span, tile_w, window = C["kVoteSpan"], C["kVoteTile"], C["kVoteList"]
    warps = C["kVoteThreads"] // 32
    tiles, splits = vote_grid(U, L)
    flat = reads.reshape(-1)
    polished = np.zeros((U, L), np.uint8)
    depth = np.zeros((U, L), np.int32)
    written = np.zeros((U, L), np.int32)
    most, fills = 0, 0
    lanes = np.arange(span)  # a warp's offsets lane + 32 k
    for u in range(U):
        for s in range(splits):  # block (u, s)
            listed, whole = [], False
            for tile in range(s, tiles, splits):
                votes = np.zeros((warps, span, 4), np.int32)  # a lane's registers
                seg = tile * tile_w + np.arange(warps) * span
                width = np.clip(L - seg, 0, span)
                p = 0
                while True:
                    if not whole:
                        end = min(R, p + window)
                        listed = [(int(i), int(start[i])) for i in p + np.flatnonzero(tgt[p:end] == u)]
                        most, fills = max(most, len(listed)), fills + 1
                        whole = p == 0 and end == R
                    for i, st in listed:
                        lo = np.maximum(0, st - seg)[:, None]  # every warp at once
                        hi = np.minimum(width, st + Lr - seg)[:, None]
                        on = (lanes >= lo) & (lanes < hi)
                        b = np.full((warps, span), 4)
                        b[on] = flat[((i * Lr + seg - st)[:, None] + lanes)[on]]
                        votes += b[..., None] == np.arange(4)
                    p += window
                    if p >= R:
                        break
                for w in range(warps):
                    cols = seg[w] + np.arange(width[w])
                    v = votes[w, : width[w]]
                    d = v.sum(-1)
                    c = unitigs[u, cols]
                    polished[u, cols] = np.where((d >= min_depth) & (c < 4), v.argmax(-1), c)
                    depth[u, cols] = d
                    written[u, cols] += 1
    assert (written == 1).all()
    return polished, depth, most, fills


def _reads(k: int, min_len: int, seed: int = 7) -> list:
    """Every edge length, lrsim reads with N and 255, a read longer than
    two k-mer tiles, empty reads, a run of reads shorter than k longer than
    a k-mer tile, one of reads shorter than min_len longer than a
    randstrobe tile, then codes 4 and 255 on tile edges and in halos."""
    rng = np.random.default_rng(seed)
    tx = lrsim.simulate_transcriptome(rng, 3, (500, 900))
    reads = [sequtils.encode(r) for r in lrsim.simulate_reads(rng, tx, coverage=2, err=0.07)]
    long = rng.integers(0, 4, 2 * C["kKmerTile"] + 517).astype(np.uint8)
    reads = [long, np.empty(0, np.uint8)] + reads
    reads += [rng.integers(0, 4, n).astype(np.uint8) for n in range(max(k - 1, 0), min_len + 2)]
    reads += [rng.integers(0, 4, rng.integers(1, k)).astype(np.uint8) for _ in range(2 * C["kKmerTile"] // max(k // 2, 1))]
    reads += [np.empty(0, np.uint8)] * 3
    reads += [rng.integers(0, 4, rng.integers(k, min_len)).astype(np.uint8)
              for _ in range(2 * C["kStrobeTile"] // max((k + min_len) // 2, 1))]
    reads += [rng.integers(0, 4, n).astype(np.uint8) for n in (C["kStrobeTile"] - 1, C["kStrobeTile"] + 1, 1500)]
    for i, r in enumerate(reads[2:8]):
        r[rng.choice(len(r), 4, replace=False)] = 4 if i % 2 else 255
    bounds = np.concatenate([[0], np.cumsum([len(r) for r in reads])])
    total = int(bounds[-1])
    marks = []
    for t, halo in ((C["kKmerTile"], k // 2), (C["kStrobeTile"], 60)):
        for edge in range(t, total, t):
            marks += [edge - 1, edge, edge + halo]
    for j, g in enumerate(m for m in marks if m < total):
        i = int(np.searchsorted(bounds, g, side="right")) - 1
        reads[i][g - bounds[i]] = (4, 255)[j % 2]
    return reads


def _pack(reads):
    codes, offsets, lens = lr_keys.pack(reads, "cpu")
    return codes.numpy(), offsets.numpy(), lens


def _aoff(lens, k, n, w_min, w_max):
    m = np.where(lens >= lr_keys.strobemer_min_len(k, n, w_min, w_max), tstrobe.num_anchors(lens, k, n, w_min, w_max),
                 0)
    return np.concatenate([[0], np.cumsum(m)]).astype(np.int64)


def _keys(h, ok, seg):
    return lr_keys._split(torch.from_numpy(h.view(np.int64)), torch.from_numpy(ok), seg)


def test_kernel_constants():
    """The model reads the tiles it models; their layout rules hold."""
    assert C["kKmerTile"] == C["kKmerThreads"] * C["kKmerRun"] and C["kKmerTile"] % 16 == 0
    assert C["kKmerRun"] % 2 == 1 and C["kKmerStage"] >= C["kKmerTile"] + C["kMaxK"] - 1
    assert C["kStrobeTile"] % C["kStrobeThreads"] == 0 and C["kStrobePer"] * C["kStrobeThreads"] == C["kStrobeTile"]
    assert C["kStrobeStageMax"] >= C["kStrobeTile"] + 32 and C["kStrobeStageMax"] % 32 == 0
    assert C["kVoteSpan"] == 32 * C["kVotePer"] and C["kVoteTile"] == C["kVoteThreads"] // 32 * C["kVoteSpan"]
    assert C["kVoteList"] % (C["kVoteThreads"] * C["kVoteScan"]) == 0
    assert vote_grid(2200, 4200) == (3, 1) and vote_grid(600, 4200) == (3, 2) and vote_grid(3, 5000) == (3, 3)


@pytest.mark.parametrize("shape,case,min_depth", [
    ((6, 300, 80, 120), case, d) for case in VOTE_CASES for d in (0, 2)
] + [
    ((3, 5000, 700, 2300), "overhang", 1),  # unitigs of several tiles, the last partial, a block a tile
    ((2, 2100, 5000, 300), "one_unitig", 2),  # two windows of reads on one unitig
    ((2200, 4200, 5000, 300), "one_unitig", 1),  # a block a unitig over three tiles, each refilling two windows
    ((2200, 4200, 2000, 300), "untouched", 0),  # a block a unitig, one window's list kept over its three tiles
    ((600, 4200, 2000, 300), "overhang", 2),  # two blocks a unitig, over two tiles and one
    ((1, 4096, 0, 50), "overhang", 0),  # no read: every cell on a base becomes A
])
def test_vote_model_equals_plain(shape, case, min_depth):
    """The vote kernel's schedule gives the plain version's polished codes
    and depths, every cell written once."""
    U, L, R, Lr = shape
    args = vote_case(case, U, L, R, Lr, seed=U + R)
    got_p, got_d, most, fills = model_vote(*args, min_depth)
    want_p, want_d = cv.consensus_vote_plain(*(torch.from_numpy(a) for a in args), min_depth)
    assert np.array_equal(got_p, want_p.numpy()) and np.array_equal(got_d, want_d.numpy())
    assert most <= C["kVoteList"]
    tiles, splits = vote_grid(U, L)
    windows = -(-R // C["kVoteList"])
    assert fills == (U * splits if windows <= 1 else U * tiles * windows)
    if case == "one_unitig":
        assert most == min(R, C["kVoteList"])


@pytest.mark.parametrize("n", [0, 1, 2, 31, 32, 33, 1500, 10_500])
def test_warp_search_is_upper_bound(n):
    """The 32-way search finds np.searchsorted's right bound (duplicates
    and all), in at most 3 rounds for 10,500 reads."""
    rng = np.random.default_rng(n)
    a = np.concatenate([[0], np.cumsum(rng.integers(0, 5, n))]).astype(np.int64)
    for x in sorted({0, 1, int(a[-1]), int(a[-1]) - 1, *rng.integers(0, a[-1] + 2, 50).tolist()}):
        got, rounds = warp_upper_bound(a, n, x)
        assert got == np.searchsorted(a, x, side="right")
        assert rounds <= (3 if n <= 32 ** 3 else 4)


def test_hoisted_combine_is_combine():
    """cur ^ (T_b + C_a) with T_b = b + (b >> 2), C_a = (a << 6) +
    0x9E3779B9 is combine(a, b) mod 2^64, wrap-arounds included."""
    rng = np.random.default_rng(1)
    edge = np.array([0, 1, 3, 0x9E3779B9, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, (1 << 64) - 0x9E3779B9], U64)
    a = np.concatenate([edge, rng.integers(0, 1 << 64, 4000, dtype=U64)])
    b = np.concatenate([edge[::-1], rng.integers(0, 1 << 64, 4000, dtype=U64)])
    want = nthash.combine(torch.from_numpy(a.view(np.int64)), torch.from_numpy(b.view(np.int64))).numpy().view(U64)
    t_b = b + _shr(b, 2)
    c_a = _shl(a, 6) + U64(0x9E3779B9)
    assert np.array_equal(a ^ (t_b + c_a), want)


def test_two_chains_give_the_serial_min():
    """The minima of a window's first and last ceil(len / 2) candidates,
    an invalid one counted as ~0, merge into the value and validity of the
    reference's serial chain (the later offset on a tie, an invalid
    candidate never): only the value is kept, so the tie rule decides no
    output.  Windows full of ties, sparse validity, lengths 1 to 80."""
    rng = np.random.default_rng(2)
    for trial in range(3000):
        w = int(rng.integers(1, 81))
        vals = rng.integers(0, 4 if trial % 2 else 1 << 63, w).astype(U64)
        if trial % 7 == 0:
            vals[rng.integers(0, w)] = ALL  # a valid candidate of value ~0
        ok = rng.random(w) < (0.05, 0.5, 1.0)[trial % 3]
        best, seen = ALL, False
        for v, o in zip(vals, ok):
            if o and v <= best:
                best, seen = v, True
        h = (w + 1) // 2
        masked = np.where(ok, vals, ALL)
        chains = min(masked[:h].min(), masked[w - h:].min())
        assert ok.any() == seen
        if seen:
            assert chains == best


@pytest.mark.parametrize("k,stranded", [(25, False), (25, True), (11, False), (64, True)])
def test_kmer_model_equals_plain(k, stranded):
    """The k-mer kernel's schedule gives the plain hash's full 64-bit value
    and flag at every position (the old kernel's rules), and so the plain
    version's keys."""
    reads = _reads(k, lr_keys.strobemer_min_len(k, 3, 11, 50))
    codes, offsets, _ = _pack(reads)
    assert len(codes) > 3 * C["kKmerTile"]
    h, v = model_kmer_hashes(codes, offsets, k, stranded)
    want_h, want_v = _emulated_kmer_hashes(torch.from_numpy(codes), torch.from_numpy(offsets), k, stranded)
    assert np.array_equal(v, want_v.numpy())
    assert np.array_equal(h, want_h.numpy().view(U64))
    assert 0 < v.sum() < len(v) - 1000
    if (k, stranded) == (25, False):  # the key path, once (the plain version pads the longest read to 16,384)
        _assert_same_keys(_keys(h, v, offsets), lr_keys.kmer_keys_plain(reads, k, stranded, device="cpu"))


@pytest.mark.parametrize("k,n,w_min,w_max,stranded,stage_max", [
    (25, 3, 11, 50, False, None), (25, 3, 11, 50, True, None), (11, 4, 3, 8, False, None),
    (15, 2, 5, 9, True, None), (25, 3, 11, 50, False, 1056),
])
def test_randstrobe_model_equals_plain(k, n, w_min, w_max, stranded, stage_max):
    """The randstrobe kernel's schedule gives the plain version's full
    64-bit hash and flag at every anchor (and so its keys); with a smaller
    stage cap its windows reach past the staged positions."""
    min_len = lr_keys.strobemer_min_len(k, n, w_min, w_max)
    reads = _reads(k, min_len)
    codes, offsets, lens = _pack(reads)
    kh, kv = model_kmer_hashes(codes, offsets, k, stranded)
    aoff = _aoff(lens, k, n, w_min, w_max)
    stats = {}
    h, ok = model_randstrobe(kh.view(np.int64), kv, offsets, aoff, k, n, w_min, w_max, stage_max, stats)
    assert (stats.get("device_windows", 0) > 0) == (stage_max is not None)
    want_h, want_ok = (t.numpy() for t in ragged_plain(reads, k, stranded, "cpu", (n, w_min, w_max)))
    want_h = want_h.view(U64)
    assert np.array_equal(ok, want_ok)
    assert np.array_equal(h[ok.astype(bool)], want_h[ok.astype(bool)]) and not h[~ok.astype(bool)].any()
    assert 1000 < ok.sum() < len(ok)
    if (k, n, stranded, stage_max) == (25, 3, False, None):  # the key path, once
        _assert_same_keys(_keys(h, ok, aoff),
                          lr_keys.strobemer_keys_plain(reads, k, n, w_min, w_max, stranded, device="cpu"))


def test_models_equal_the_old_kernels_and_jax():
    """On reads of one bucket of the JAX package (65-128 bases, so it
    compiles each hasher once): the models equal the old kernels' rules
    (one anchor a thread) and, as 32-bit keys, the JAX package's k-mer and
    strobemer hashers (n = 4, w 3-8: a small program to compile)."""
    rng = np.random.default_rng(5)
    reads = [rng.integers(0, 4, m).astype(np.uint8) for m in range(65, 129, 3)]
    for i, r in enumerate(reads[::4]):
        r[rng.integers(0, len(r))] = (4, 255)[i % 2]
    codes, offsets, lens = _pack(reads)
    for k, n, w_min, w_max in ((25, 3, 11, 50), (11, 4, 3, 8)):
        kh, kv = model_kmer_hashes(codes, offsets, k, False)
        aoff = _aoff(lens, k, n, w_min, w_max)
        h, ok = model_randstrobe(kh.view(np.int64), kv, offsets, aoff, k, n, w_min, w_max)
        old_h, old_ok = _emulated_randstrobe(torch.from_numpy(kh.view(np.int64)), torch.from_numpy(kv),
                                             torch.from_numpy(offsets), torch.from_numpy(aoff), k, n, w_min, w_max)
        assert np.array_equal(ok, old_ok.numpy()) and np.array_equal(h, old_h.numpy().view(U64))
        assert 100 < ok.sum() < len(ok)
    cfg = js1.default_graph_config(k, False, 1 << 20)
    _assert_same_keys(_keys(kh, kv, offsets), jlr._device_hash_buckets(reads, jlr._base_key_fn(cfg), k))
    min_len = lr_keys.strobemer_min_len(k, n, w_min, w_max)
    _assert_same_keys(_keys(h, ok, aoff),
                      jlr._device_hash_buckets(reads, _jax_strobemer_fn(k, n, w_min, w_max, False), min_len))
