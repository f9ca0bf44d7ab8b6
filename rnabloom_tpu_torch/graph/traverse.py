"""Frontier-batched de Bruijn graph walks: greedy, pair and naive modes.

Port of ``rnabloom_tpu/graph/traverse.py`` for ``mode="greedy"``,
``mode="pair"`` (with the pair ring) and ``mode="naive"``, with the
back-branch check, without terminators or speculative hops; asking for
terminators raises ``NotImplementedError`` naming its ROADMAP item.  W
walks advance as lanes of one batch:

  * a superstep advances every ACTIVE lane while it has exactly one viable
    successor, for up to ``superstep_hops`` hops; a lane freezes at a dead
    end (DEAD), a branch (BRANCH), a recent k-mer (CYCLE) or its buffer or
    hop bound (FULL), and with ``check_back_branches`` where a left variant
    of its k-mer is deep (an incoming branch merges: STOPPED_BRANCH);
  * BRANCH lanes are then resolved, by greedy lookahead scoring, (pair
    mode) by read- and fragment-pair support of naive probes against the
    walk's ring of recent k-mer hashes, or (naive mode) by a depth probe of
    each candidate that lets exactly one deep candidate continue, and
    resume;
  * supersteps repeat while any lane is ACTIVE or BRANCH, at most
    ``max_supersteps`` times.

``extend_walks`` goes through ``ops.walk.walk_greedy``, ``walk_pair`` or
``walk_naive``: the CUDA kernel ``csrc/walk_greedy.cu`` (a tile of threads
per lane, the whole loop on the card) for a CUDA graph, and
``extend_walks_plain`` for a CPU graph.
``extend_walks_plain`` is the lockstep loop of the JAX package, op for op
on whole lanes; it is what the CPU tests hold against JAX and what the
kernel is held against on the card.

Walks always extend to the right in walk coordinates: a left extension is
a right extension of the reverse complement.  Hashes are int64 bit
patterns (``ops/nthash.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import nthash
from . import dbg
from .dbg import GraphConfig, GraphState

# status codes
ACTIVE = 0
BRANCH = 1  # frozen at a branch, waiting for resolution
DEAD = 2  # no viable successor
CYCLE = 3  # revisited a recent k-mer
TERM = 4  # hit a terminator (screening BF)
FULL = 5  # reached max buffer length / bound
STOPPED_BRANCH = 6  # naive mode: not one deep branch, or a deep back branch; pair mode: no viable one

_TERM = "terminators (the screening filter as walk stops) are ROADMAP queue-1 item 14, with the oracle that uses them"


@dataclass(frozen=True)
class WalkConfig:
    """Static traversal parameters (the JAX package's fields that the
    ported modes read, and ``use_terminators``, which selects an unported
    one)."""

    max_len: int  # output buffer length (incl. seed)
    lookahead: int = 3
    tip_probe_depth: int = 8  # naive and back-branch probe depth (< k: probes read the buffer)
    cycle_window: int = 64
    left: bool = False  # walk is the reverse complement of the sequence
    # stop where the current k-mer has a DEEP left SNV variant, an incoming
    # branch (naiveExtendRight's back-branch check, GraphUtils.java:
    # 6846-6851), depth-qualified by a probe of tip_probe_depth steps
    check_back_branches: bool = False
    use_terminators: bool = False
    pair_ring: int = 0  # > 0: a ring of the last k-mer hashes for pair lookups
    pair_probe_depth: int = 24  # naive probe length per candidate (< k)

    def __post_init__(self):
        if self.use_terminators:
            raise NotImplementedError(_TERM)


class WalkState(NamedTuple):
    buf: torch.Tensor  # (W, max_len) uint8 codes, seed at [0, pos)
    pos: torch.Tensor  # (W,) int32
    fh: torch.Tensor  # (W,) int64 forward hash of the current walk k-mer
    rh: torch.Tensor  # (W,) int64 reverse hash
    hist: torch.Tensor  # (W, cycle_window) int64 recent query hashes (ring)
    status: torch.Tensor  # (W,) int32
    hops: torch.Tensor  # (W,) int32 total appended bases
    path_min: torch.Tensor  # (W,) float32 running min coverage along the path
    # (fh, rh) of the k-mer ending at buffer position p, in slot p % R
    ring_fh: Optional[torch.Tensor] = None  # (W, R) int64
    ring_rh: Optional[torch.Tensor] = None  # (W, R) int64


def _make(cfg: GraphConfig, wcfg: WalkConfig, seeds_t: torch.Tensor, lens: torch.Tensor) -> WalkState:
    """Walks from (W, Ls) uint8 seeds on their device, seed lengths ``lens``."""
    W, Ls = seeds_t.shape
    k, device = cfg.k, seeds_t.device
    fh_all, rh_all, valid_all = nthash.rolling_hash(seeds_t, k, stranded=False)
    P = Ls - k + 1
    rows = torch.arange(W, device=device)
    last = torch.clamp(lens - k, min=0)
    fh, rh = fh_all[rows, last], rh_all[rows, last]
    n_kmers = lens - k + 1
    i = torch.arange(P, device=device)[None, :]
    in_seed = i < n_kmers[:, None]
    valid = torch.all(torch.where(in_seed, valid_all, True), dim=1) & (n_kmers >= 1)
    buf = torch.zeros((W, wcfg.max_len), dtype=torch.uint8, device=device)
    buf[:, :Ls] = seeds_t
    hist = torch.zeros((W, wcfg.cycle_window), dtype=torch.int64, device=device)
    hist[:, 0] = _query_hash(cfg, wcfg, fh, rh)
    ring_fh = ring_rh = None
    if wcfg.pair_ring > 0:
        # k-mer i of a seed ends at position i + k - 1, slot (i + k - 1) % R.
        # Of a seed longer than R k-mers only the last R land: the JAX
        # package's scatter writes in index order, so a later k-mer
        # overwrites the one R positions before it
        R = wcfg.pair_ring
        lane, col = torch.nonzero(in_seed & (i >= n_kmers[:, None] - R), as_tuple=True)
        slot = (col + k - 1) % R
        ring_fh = torch.zeros((W, R), dtype=torch.int64, device=device)
        ring_rh = torch.zeros((W, R), dtype=torch.int64, device=device)
        ring_fh[lane, slot] = fh_all[lane, col]
        ring_rh[lane, slot] = rh_all[lane, col]
    return WalkState(
        buf=buf,
        pos=lens.to(torch.int32),
        fh=fh,
        rh=rh,
        hist=hist,
        status=torch.where(valid, ACTIVE, DEAD).to(torch.int32),
        hops=torch.zeros(W, dtype=torch.int32, device=device),
        path_min=torch.full((W,), float("inf"), dtype=torch.float32, device=device),
        ring_fh=ring_fh,
        ring_rh=ring_rh,
    )


def make_walks(
    cfg: GraphConfig,
    wcfg: WalkConfig,
    seeds: np.ndarray,
    seed_lens: Optional[np.ndarray] = None,
    *,
    device,
) -> WalkState:
    """Walks from seed sequences (k-mers or whole fragments) on ``device``.

    seeds: (W, Ls) uint8 codes, Ls >= k, padded with 4 beyond each row's
    seed_lens (default: full rows).  The walk continues from each seed's
    LAST k-mer; with ``wcfg.pair_ring > 0`` the seed's k-mer hashes fill
    the pair ring.  The lane count pads to a power of two (at least 64) as
    in the JAX package; padded lanes start DEAD."""
    W0, Ls = seeds.shape
    k = cfg.k
    assert k <= Ls <= wcfg.max_len
    if seed_lens is None:
        seed_lens = np.full(W0, Ls, np.int64)
    seed_lens = np.asarray(seed_lens)
    W = 1 << max(6, (W0 - 1).bit_length())
    if W != W0:
        seeds = np.concatenate([seeds, np.full((W - W0, Ls), 4, seeds.dtype)], axis=0)
        seed_lens = np.concatenate([seed_lens, np.full(W - W0, k, np.int64)])
    seeds_t = torch.from_numpy(np.ascontiguousarray(seeds, np.uint8)).to(device)
    return _make(cfg, wcfg, seeds_t, torch.from_numpy(seed_lens.astype(np.int64)).to(device))


def revcomp_reseed(cfg: GraphConfig, wcfg: WalkConfig, buf: torch.Tensor, pos: torch.Tensor) -> WalkState:
    """Walks seeded with the reverse complement of finished walk buffers
    (each row's first ``pos`` codes), on their device: the right-to-left
    hand-off of the stage-3 extension.  No lane padding."""
    L = buf.shape[1]
    j = torch.arange(L, device=buf.device)[None, :]
    p = pos.long()[:, None]
    vals = buf.gather(1, torch.clamp(p - 1 - j, 0, L - 1))
    rc = torch.where(j < p, torch.where(vals < 4, 3 - vals, 4), 4).to(torch.uint8)
    return _make(cfg, wcfg, rc, pos.long())


def _query_hash(cfg: GraphConfig, wcfg: WalkConfig, fh: torch.Tensor, rh: torch.Tensor) -> torch.Tensor:
    """Filter-query hash of a walk k-mer: the signed min of both strands,
    or in stranded mode the forward strand's hash (``rh`` for left walks)."""
    if cfg.stranded:
        return rh if wcfg.left else fh
    return torch.minimum(fh, rh)


def _successors(cfg: GraphConfig, wcfg: WalkConfig, fh, rh, out_codes):
    """(fh4, rh4, query4) for the 4 candidate next walk k-mers."""
    fh4, rh4 = nthash.successor_hashes(fh, out_codes, cfg.k, rh=rh)
    return fh4, rh4, _query_hash(cfg, wcfg, fh4, rh4)


def _buf_at(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """buf[row, idx[row]], idx clipped into the buffer."""
    col = torch.clamp(idx, 0, buf.shape[1] - 1).long()
    return buf.gather(1, col[:, None])[:, 0]


def _gather_out_codes(buf: torch.Tensor, pos: torch.Tensor, k: int) -> torch.Tensor:
    """First base of each lane's current k-mer: buf[pos - k]."""
    return _buf_at(buf, pos - k)


def _in_hist(hist: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return (hist == q[:, None]).any(dim=1)


def _push_hist(hist: torch.Tensor, q: torch.Tensor, hops: torch.Tensor, wcfg: WalkConfig, advance) -> None:
    """Write ``q`` at ring slot (hops + 1) % cycle_window of advancing lanes
    (in place)."""
    rows = torch.arange(hist.shape[0], device=hist.device)
    slot = ((hops + 1) % wcfg.cycle_window).long()
    hist[rows, slot] = torch.where(advance, q, hist[rows, slot])


def _pick(x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    return x.gather(1, code.long()[:, None])[:, 0]


def _apply_advance(
    state: WalkState, wcfg: WalkConfig, advance, code, fh4, rh4, q4, counts4
) -> WalkState:
    """Append ``code`` to advancing lanes.  ``buf``, ``hist`` and the pair
    ring (slot ``pos % R``: the new k-mer ends at the old ``pos``) are
    updated in place; the other fields are new tensors."""
    rows = torch.arange(state.pos.shape[0], device=state.pos.device)
    col = torch.clamp(state.pos, max=wcfg.max_len - 1).long()
    state.buf[rows, col] = torch.where(advance, code.to(torch.uint8), state.buf[rows, col])
    _push_hist(state.hist, _pick(q4, code), state.hops, wcfg, advance)
    fh_new, rh_new = _pick(fh4, code), _pick(rh4, code)
    if state.ring_fh is not None:
        slot = (state.pos % wcfg.pair_ring).long()
        state.ring_fh[rows, slot] = torch.where(advance, fh_new, state.ring_fh[rows, slot])
        state.ring_rh[rows, slot] = torch.where(advance, rh_new, state.ring_rh[rows, slot])
    return state._replace(
        pos=torch.where(advance, state.pos + 1, state.pos),
        fh=torch.where(advance, fh_new, state.fh),
        rh=torch.where(advance, rh_new, state.rh),
        hops=torch.where(advance, state.hops + 1, state.hops),
        path_min=torch.where(advance, torch.minimum(state.path_min, _pick(counts4, code)), state.path_min),
    )


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), as
    ``jnp.argmax`` over a bool array; torch's argmax takes no bool."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def walk_superstep(
    state: WalkState,
    graph: GraphState,
    cfg: GraphConfig,
    wcfg: WalkConfig,
    min_cov: torch.Tensor,  # (W,) float32 per-lane coverage floor
    bound: torch.Tensor,  # (W,) int32 max hops per lane
    max_hops: int,
) -> WalkState:
    """Advance every ACTIVE lane while it has exactly one viable successor,
    for up to ``max_hops`` hops."""
    floor = torch.clamp(min_cov, min=1.0)[:, None]
    for _ in range(max_hops):
        active = state.status == ACTIVE
        if not bool(active.any()):
            break
        out_codes = _gather_out_codes(state.buf, state.pos, cfg.k)
        fh4, rh4, q4 = _successors(cfg, wcfg, state.fh, state.rh, out_codes)
        counts = dbg.get_counts(graph, cfg, q4)  # (W, 4)
        viable = counts >= floor
        nviable = viable.sum(dim=1)
        code = _first_true(viable)  # the single viable candidate when nviable == 1
        cyc = _in_hist(state.hist, _pick(q4, code))
        full = (state.pos >= wcfg.max_len - 1) | (state.hops >= bound)
        back = torch.zeros_like(cyc)
        if wcfg.check_back_branches:
            # an incoming branch merges here when a left variant of the
            # k-mer (not the k-mer itself) is viable and deep
            flv, rlv = nthash.variant_hashes_left(state.fh, out_codes, cfg.k, state.rh)
            cv = dbg.get_counts(graph, cfg, _query_hash(cfg, wcfg, flv, rlv))
            is_self = torch.arange(4, device=out_codes.device)[None, :] == out_codes[:, None]
            viable_v = (cv >= floor) & ~is_self & active[:, None]  # other lanes' depths are not read
            depth_v = _variant_depth_probe(graph, cfg, wcfg, state.buf, state.pos, flv, rlv, viable_v, min_cov)
            back = (depth_v >= wcfg.tip_probe_depth).any(dim=1)
        advance = active & (nviable == 1) & ~cyc & ~full & ~back
        status = torch.where(
            back, STOPPED_BRANCH,
            torch.where(nviable == 0, DEAD,
                        torch.where(nviable > 1, BRANCH,
                                    torch.where(cyc, CYCLE, torch.where(full, FULL, ACTIVE)))),
        )
        new_status = torch.where(active, status, state.status).to(torch.int32)
        state = _apply_advance(state, wcfg, advance, code, fh4, rh4, q4, counts)
        state = state._replace(status=new_status)
    return state


def _expand_scores(
    graph: GraphState, cfg: GraphConfig, wcfg: WalkConfig, buf, pos, fh4, rh4, q4
) -> torch.Tensor:
    """Greedy lookahead scores per candidate (W, 4): the max over
    depth-(lookahead-1) expansions of the minimum coverage along the path;
    lookahead 1 scores count(c).  Past depth 3 each of the 64 depth-3
    leaves continues by a greedy max-count descent."""
    W, k = pos.shape[0], cfg.k
    cand = dbg.get_counts(graph, cfg, q4)
    if wcfg.lookahead == 1:
        return cand
    out1 = _buf_at(buf, pos - k + 1)[:, None].expand(W, 4)
    fh_l1, rh_l1 = nthash.successor_hashes(fh4, out1, k, rh=rh4)  # (W, 4, 4)
    c_l1 = dbg.get_counts(graph, cfg, _query_hash(cfg, wcfg, fh_l1, rh_l1))
    if wcfg.lookahead == 2:
        return torch.minimum(cand[:, :, None], c_l1).amax(dim=-1)

    out2 = _buf_at(buf, pos - k + 2)[:, None, None].expand(W, 4, 4)
    fh_l2, rh_l2 = nthash.successor_hashes(fh_l1, out2, k, rh=rh_l1)  # (W, 4, 4, 4)
    c_l2 = dbg.get_counts(graph, cfg, _query_hash(cfg, wcfg, fh_l2, rh_l2))
    path_min = torch.minimum(torch.minimum(cand[:, :, None, None], c_l1[:, :, :, None]), c_l2)
    if wcfg.lookahead == 3:
        return path_min.amax(dim=(-2, -1))

    leaves = W * 64
    fh_c, rh_c, pmin = fh_l2.reshape(leaves), rh_l2.reshape(leaves), path_min.reshape(leaves)
    for i in range(wcfg.lookahead - 3):
        outc = _buf_at(buf, pos - k + 3 + i)[:, None].expand(W, 64).reshape(leaves)
        f4, r4 = nthash.successor_hashes(fh_c, outc, k, rh=rh_c)
        cc = dbg.get_counts(graph, cfg, _query_hash(cfg, wcfg, f4, r4))  # (leaves, 4)
        best = torch.argmax(cc, dim=1)  # first maximum, as jnp.argmax
        fh_c, rh_c = _pick(f4, best), _pick(r4, best)
        pmin = torch.minimum(pmin, _pick(cc, best))
    return pmin.reshape(W, 4, 16).amax(dim=-1)


def _variant_depth_probe(graph: GraphState, cfg: GraphConfig, wcfg: WalkConfig, buf, pos, flv, rlv, viable0, min_cov):
    """Greedy forward depth (W, 4) of each left variant of the current
    k-mer (the variant itself is depth 1 when viable0): ``tip_probe_depth
    - 1`` steps, each to the first max-count successor that reaches the
    coverage floor.  The first step departs the variant's own base, later
    ones the walk buffer (the variant path rejoins the walk's suffix)."""
    W, k = pos.shape[0], cfg.k
    depth = viable0.to(torch.int32)
    fh_c, rh_c = flv.reshape(W * 4), rlv.reshape(W * 4)
    alive = viable0.reshape(W * 4)
    var_base = torch.arange(4, device=pos.device).repeat(W)
    mc = torch.clamp(min_cov, min=1.0)[:, None].expand(W, 4).reshape(W * 4, 1)
    for i in range(wcfg.tip_probe_depth - 1):
        if not bool(alive.any()):
            break  # nothing moves any more
        outc = var_base if i == 0 else _buf_at(buf, pos - k + i)[:, None].expand(W, 4).reshape(W * 4)
        f4, r4 = nthash.successor_hashes(fh_c, outc, k, rh=rh_c)
        cc = dbg.get_counts(graph, cfg, _query_hash(cfg, wcfg, f4, r4))  # (W*4, 4)
        ok = cc >= mc
        best = torch.argmax(torch.where(ok, cc, -1.0), dim=1)  # first maximum
        alive = alive & ok.any(dim=1)
        fh_c = torch.where(alive, _pick(f4, best), fh_c)
        rh_c = torch.where(alive, _pick(r4, best), rh_c)
        depth = depth + alive.reshape(W, 4).to(torch.int32)
    return depth


def _tip_probe(graph: GraphState, cfg: GraphConfig, wcfg: WalkConfig, buf, pos, fh4, rh4, viable0, min_cov):
    """Beam-2 depth probe per candidate (W, 4) (the candidate is depth 1
    when viable0): ``tip_probe_depth - 1`` steps following the two best
    viable successor paths.  Slot 1 of a candidate's beam starts dead;
    each step reads the successors of both slots and keeps the top 2 of
    the 8 by count in slot-major order (index slot * 4 + base, first
    maximum first; a successor that is not viable scores -1, so the second
    pick may be dead; when every other score is -1 the second pick is
    index 0, which may be the first pick, and slot 1 then follows the same
    k-mer, alive).  Out codes come from the walk buffer."""
    W, k = pos.shape[0], cfg.k
    depth = viable0.to(torch.int32)
    fh_c = fh4.reshape(W * 4, 1).expand(W * 4, 2).reshape(W * 8)
    rh_c = rh4.reshape(W * 4, 1).expand(W * 4, 2).reshape(W * 8)
    alive = torch.stack([viable0.reshape(W * 4), torch.zeros_like(viable0.reshape(W * 4))], dim=-1).reshape(W * 8)
    mc = torch.clamp(min_cov, min=1.0)[:, None].expand(W, 8).reshape(W * 8, 1)
    rows = torch.arange(W * 4, device=pos.device)
    for i in range(wcfg.tip_probe_depth - 1):
        if not bool(alive.any()):
            break  # nothing moves any more
        outc = _buf_at(buf, pos - k + 1 + i)[:, None].expand(W, 8).reshape(W * 8)
        f4, r4 = nthash.successor_hashes(fh_c, outc, k, rh=rh_c)  # (W*8, 4)
        cc = dbg.get_counts(graph, cfg, _query_hash(cfg, wcfg, f4, r4))
        ok = (cc >= mc) & alive[:, None]
        score = torch.where(ok, cc, -1.0).reshape(W * 4, 8)
        top1 = torch.argmax(score, dim=1)
        s2 = score.clone()
        s2[rows, top1] = -1.0
        pick = torch.stack([top1, torch.argmax(s2, dim=1)], dim=-1)  # (W*4, 2)
        alive = ok.reshape(W * 4, 8).gather(1, pick).reshape(W * 8)
        fh_c = torch.where(alive, f4.reshape(W * 4, 8).gather(1, pick).reshape(W * 8), fh_c)
        rh_c = torch.where(alive, r4.reshape(W * 4, 8).gather(1, pick).reshape(W * 8), rh_c)
        depth = depth + alive.reshape(W, 4, 2).any(dim=-1).to(torch.int32)
    return depth


def _probe_with_hashes(graph: GraphState, cfg: GraphConfig, wcfg: WalkConfig, buf, pos, fh4, rh4, q4, min_cov):
    """Greedy naive descent of ``pair_probe_depth`` k-mers per candidate
    (probe 0 is the candidate), each step to the max-count successor that
    reaches the coverage floor.  Returns (fh_p, rh_p, counts_p, alive_p),
    each (W, 4, D); a probe stays dead once no successor reaches the floor.
    Exact while D < k: the departing base comes from the walk buffer."""
    W, k, D = pos.shape[0], cfg.k, wcfg.pair_probe_depth
    assert D <= k - 1, "pair_probe_depth must stay below k"
    floor = torch.clamp(min_cov, min=1.0)[:, None]
    counts0 = dbg.get_counts(graph, cfg, q4)
    alive = (counts0 >= floor).reshape(W * 4)
    fh_c, rh_c = fh4.reshape(W * 4), rh4.reshape(W * 4)
    mc = floor.expand(W, 4).reshape(W * 4, 1)
    fhs, rhs, cs, als = [fh_c], [rh_c], [counts0.reshape(W * 4)], [alive]
    for j in range(1, D):
        outc = _buf_at(buf, pos - k + j)[:, None].expand(W, 4).reshape(W * 4)
        f4, r4 = nthash.successor_hashes(fh_c, outc, k, rh=rh_c)
        cc = dbg.get_counts(graph, cfg, _query_hash(cfg, wcfg, f4, r4))  # (W*4, 4)
        ok = cc >= mc
        best = torch.argmax(torch.where(ok, cc, -1.0), dim=1)  # first maximum
        alive = alive & ok.any(dim=1)
        fh_c = torch.where(alive, _pick(f4, best), fh_c)
        rh_c = torch.where(alive, _pick(r4, best), rh_c)
        fhs.append(fh_c)
        rhs.append(rh_c)
        cs.append(torch.where(alive, _pick(cc, best), 0.0))
        als.append(alive)
    return tuple(torch.stack(x, dim=-1).reshape(W, 4, D) for x in (fhs, rhs, cs, als))


def _pair_scores(state: WalkState, graph: GraphState, cfg: GraphConfig, wcfg: WalkConfig, fh_p, rh_p, counts_p,
                 alive_p):
    """extendRightPE scores per candidate (W, 4), its median probe coverage
    and whether it is viable:

      score = min(path_min, median) * (n_read + n_frag) / (last + 1)

    n_read / n_frag count the probe k-mers whose pair with the ring's
    partner (read / fragment pair distance back) is in rpkbf / fpkbf,
    ``last`` is the deepest supported probe.  A candidate is viable when
    every pair class with a reachable partner has support, and some class
    has one (GraphUtils.extendRightPE :6206-6309)."""
    W, _, D = counts_p.shape
    R, k = wcfg.pair_ring, cfg.k
    j = torch.arange(D, device=counts_p.device)
    pos = state.pos.long()[:, None, None]

    def class_support(dist: int, lanes):
        # the partner of probe j ends at buffer position pos - dist + j; a
        # ring slot is live for the last R - 1 positions (a distance of
        # exactly R aliases the newest slot)
        end_pos = pos - dist + j
        reachable = (end_pos >= k - 1) & (pos - end_pos < R)
        slot = torch.where(reachable, end_pos % R, 0)
        rows = torch.arange(W, device=pos.device)[:, None, None]
        pf, pr = state.ring_fh[rows, slot], state.ring_rh[rows, slot]
        if cfg.stranded:
            ph = nthash.combine(rh_p, pr) if wcfg.left else nthash.combine(pf, fh_p)
        elif wcfg.left:
            ph = nthash.combine_canonical(rh_p, fh_p, pr, pf)
        else:
            ph = nthash.combine_canonical(pf, pr, fh_p, rh_p)
        sup = dbg.lookup_pair(lanes, cfg, ph) & reachable & alive_p
        return sup, (reachable & alive_p).any(dim=-1)

    none = (torch.zeros_like(alive_p), torch.zeros_like(alive_p[..., 0]))
    rp = graph.rpkbf is not None and cfg.read_pair_distance > 0
    fp = graph.fpkbf is not None and cfg.fragment_pair_distance > 0
    sup_r, reach_r = class_support(cfg.read_pair_distance, graph.rpkbf) if rp else none
    sup_f, reach_f = class_support(cfg.fragment_pair_distance, graph.fpkbf) if fp else none
    n_r, n_f = sup_r.sum(dim=-1), sup_f.sum(dim=-1)
    last = torch.where(sup_r | sup_f, j, -1).amax(dim=-1)

    # median probe coverage over the alive probes (dead ones sort last)
    s = torch.sort(torch.where(alive_p, counts_p, float("inf")), dim=-1).values
    nv = alive_p.sum(dim=-1)
    half = torch.clamp(nv // 2, min=0)
    lo = torch.clamp(torch.where(nv % 2 == 0, half - 1, half), min=0)
    med = (s.gather(-1, lo[..., None])[..., 0] + s.gather(-1, half[..., None])[..., 0]) / 2.0
    med = torch.where(nv > 0, med, 0.0)

    ok = (last >= 0) & (~reach_r | (n_r > 0)) & (~reach_f | (n_f > 0)) & (reach_r | reach_f)
    score = (
        torch.minimum(state.path_min[:, None], med) * (n_r + n_f).to(torch.float32)
        / torch.clamp(last + 1, min=1).to(torch.float32)
    )
    return torch.where(ok, score, -1.0), med, ok


def resolve_branches(
    state: WalkState, graph: GraphState, cfg: GraphConfig, wcfg: WalkConfig, min_cov: torch.Tensor,
    mode: str = "greedy",
) -> WalkState:
    """Resolve BRANCH lanes.

    greedy: the candidate with the best lookahead score wins (ties: higher
      candidate count, then smaller base code, the reference's first-wins
      order); the lane resumes ACTIVE.
    pair: candidates are probed naively and scored by pair support against
      the walk's pair ring (``_pair_scores``); the best score wins (ties:
      higher median, then smaller base); no viable candidate stops the lane
      (STOPPED_BRANCH).
    naive: each candidate's beam-2 depth probe (``_tip_probe``) must reach
      ``tip_probe_depth``; exactly one deep candidate resumes the walk (the
      first of the highest count among the deep ones), none or several stop
      the lane (STOPPED_BRANCH).
    In every mode the chosen k-mer in the cycle ring stops the lane (CYCLE),
    before a full buffer does (FULL)."""
    at_branch = state.status == BRANCH
    out_codes = _gather_out_codes(state.buf, state.pos, cfg.k)
    fh4, rh4, q4 = _successors(cfg, wcfg, state.fh, state.rh, out_codes)
    counts = dbg.get_counts(graph, cfg, q4)
    viable = counts >= torch.clamp(min_cov, min=1.0)[:, None]
    if mode == "pair":
        probes = _probe_with_hashes(graph, cfg, wcfg, state.buf, state.pos, fh4, rh4, q4, min_cov)
        scores, med, _ = _pair_scores(state, graph, cfg, wcfg, *probes)
        scores = torch.where(viable, scores, -1.0)
        any_ok = (scores >= 0.0).any(dim=1)
        is_best = scores >= scores.amax(dim=1, keepdim=True)
        best = torch.argmax(torch.where(is_best, med, -1.0), dim=1)
        advance = at_branch & any_ok
        resumed = torch.where(any_ok, ACTIVE, STOPPED_BRANCH)
    elif mode == "naive":
        depth = _tip_probe(graph, cfg, wcfg, state.buf, state.pos, fh4, rh4, viable & at_branch[:, None], min_cov)
        deep = depth >= wcfg.tip_probe_depth
        ndeep = deep.sum(dim=1)
        best = torch.argmax(torch.where(deep, counts, -1.0), dim=1)
        advance = at_branch & (ndeep == 1)
        resumed = torch.where(ndeep == 1, ACTIVE, STOPPED_BRANCH)
    else:
        scores = _expand_scores(graph, cfg, wcfg, state.buf, state.pos, fh4, rh4, q4)
        scores = torch.where(viable, scores, -1.0)
        is_best = scores >= scores.amax(dim=1, keepdim=True)
        best = torch.argmax(torch.where(is_best & viable, counts, -1.0), dim=1)
        advance = at_branch
        resumed = torch.full_like(state.status, ACTIVE)

    cyc = _in_hist(state.hist, _pick(q4, best))
    full = state.pos >= wcfg.max_len - 1
    advance = advance & ~cyc & ~full
    new_status = torch.where(
        at_branch & cyc, CYCLE,
        torch.where(at_branch & full, FULL, torch.where(at_branch, resumed, state.status)),
    ).to(torch.int32)
    state = _apply_advance(state, wcfg, advance, best, fh4, rh4, q4, counts)
    return state._replace(status=new_status)


def lane_args(state: WalkState, min_cov, bound) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane (min_cov float32, bound int32) on the walks' device from
    scalars or arrays."""
    W, dev = state.pos.shape[0], state.pos.device
    mc = torch.as_tensor(min_cov, dtype=torch.float32, device=dev).expand(W).contiguous()
    bd = torch.as_tensor(bound, dtype=torch.int32, device=dev).expand(W).contiguous()
    return mc, bd


def clone_state(state: WalkState) -> WalkState:
    return WalkState(*(None if t is None else t.clone() for t in state))


def take_lanes(state: WalkState, lanes: slice) -> WalkState:
    """The walk state of ``lanes``, contiguous."""
    return WalkState(*(None if t is None else t[lanes].contiguous() for t in state))


def extend_walks_plain(
    state: WalkState,
    graph: GraphState,
    cfg: GraphConfig,
    wcfg: WalkConfig,
    min_cov: torch.Tensor,
    bound: torch.Tensor,
    superstep_hops: int = 64,
    max_supersteps: int = 64,
    mode: str = "greedy",
) -> WalkState:
    """The JAX package's lockstep loop (``_extend_walks_fused``) on whole
    lanes, on any device; ``state`` is left unchanged."""
    state = clone_state(state)
    for _ in range(max_supersteps):
        if not bool(((state.status == ACTIVE) | (state.status == BRANCH)).any()):
            break
        state = walk_superstep(state, graph, cfg, wcfg, min_cov, bound, superstep_hops)
        if bool((state.status == BRANCH).any()):
            state = resolve_branches(state, graph, cfg, wcfg, min_cov, mode)
    return state


def extend_walks(
    state: WalkState,
    graph: GraphState,
    cfg: GraphConfig,
    wcfg: WalkConfig,
    min_cov,
    bound,
    mode: str = "greedy",
    terminators: Optional[torch.Tensor] = None,
    superstep_hops: int = 64,
    max_supersteps: int = 64,
) -> WalkState:
    """Extend every walk lane to completion; returns a new state.  Pair
    mode needs the pair ring (``wcfg.pair_ring > 0``); back-branch checks
    are taken in naive mode, the only mode that the JAX package runs them
    in (``-extend``)."""
    if terminators is not None:
        raise NotImplementedError(_TERM)
    if mode not in ("greedy", "pair", "naive"):
        raise ValueError(f"unknown walk mode {mode!r}")
    if mode == "pair" and wcfg.pair_ring <= 0:
        raise ValueError("pair walks need a pair ring (WalkConfig.pair_ring > 0)")
    if mode != "naive" and wcfg.check_back_branches:
        raise ValueError(f"back-branch checks in {mode} walks: only naive walks take them")
    from ..ops import walk

    min_cov, bound = lane_args(state, min_cov, bound)
    run = {"greedy": walk.walk_greedy, "pair": walk.walk_pair, "naive": walk.walk_naive}[mode]
    return run(state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps)


def harvest(state: WalkState) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(buf, pos, status) as numpy: the walks' code sequences."""
    return state.buf.cpu().numpy(), state.pos.cpu().numpy(), state.status.cpu().numpy()


def from_limbs(lo: np.ndarray, hi: np.ndarray) -> torch.Tensor:
    """int64 bit patterns from (lo, hi) uint32 limb pairs."""
    u = np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))
    return torch.from_numpy(u.view(np.int64))


def walk_state_from_limbs(ref) -> WalkState:
    """A WalkState from a walk state held as numpy arrays with its 64-bit
    hashes as ``.lo`` / ``.hi`` uint32 limb pairs (the JAX package's form,
    after a device-to-host copy)."""
    def arr(x, dtype):
        return torch.from_numpy(np.asarray(x).astype(dtype))

    def limbs(x):
        return None if x is None else from_limbs(x.lo, x.hi)

    return WalkState(
        buf=arr(ref.buf, np.uint8),
        pos=arr(ref.pos, np.int32),
        fh=from_limbs(ref.fh.lo, ref.fh.hi),
        rh=from_limbs(ref.rh.lo, ref.rh.hi),
        hist=from_limbs(ref.hist.lo, ref.hist.hi),
        status=arr(ref.status, np.int32),
        hops=arr(ref.hops, np.int32),
        path_min=arr(ref.path_min, np.float32),
        ring_fh=limbs(ref.ring_fh),
        ring_rh=limbs(ref.ring_rh),
    )
