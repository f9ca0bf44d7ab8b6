"""Frontier-batched de Bruijn graph walks, greedy mode.

Port of ``rnabloom_tpu/graph/traverse.py`` for ``mode="greedy"`` without
terminators, back-branch checks, pair rings or speculative hops; asking
for one of those raises ``NotImplementedError`` naming its ROADMAP item.
W walks
advance as lanes of one batch:

  * a superstep advances every ACTIVE lane while it has exactly one viable
    successor, for up to ``superstep_hops`` hops; a lane freezes at a dead
    end (DEAD), a branch (BRANCH), a recent k-mer (CYCLE) or its buffer or
    hop bound (FULL);
  * BRANCH lanes are then resolved by greedy lookahead scoring and resume;
  * supersteps repeat while any lane is ACTIVE or BRANCH, at most
    ``max_supersteps`` times.

``extend_walks`` goes through ``ops.walk.walk_greedy``: the CUDA kernel
``csrc/walk_greedy.cu`` (a tile of threads per lane, the whole loop on the
card) for a CUDA graph, and ``extend_walks_plain`` for a CPU graph.
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
STOPPED_BRANCH = 6  # naive mode: too many good branches

_NAIVE = "naive and back-branch walks (-extend) are ROADMAP queue-1 item 7a"
_PAIR = "pair-scored walks and terminators are stage 3, ROADMAP queue-1 item 10"


@dataclass(frozen=True)
class WalkConfig:
    """Static traversal parameters (the JAX package's fields that greedy
    walks read, and those that select an unported mode)."""

    max_len: int  # output buffer length (incl. seed)
    lookahead: int = 3
    cycle_window: int = 64
    left: bool = False  # walk is the reverse complement of the sequence
    check_back_branches: bool = False
    use_terminators: bool = False
    pair_ring: int = 0

    def __post_init__(self):
        if self.check_back_branches:
            raise NotImplementedError(_NAIVE)
        if self.use_terminators or self.pair_ring > 0:
            raise NotImplementedError(_PAIR)


class WalkState(NamedTuple):
    buf: torch.Tensor  # (W, max_len) uint8 codes, seed at [0, pos)
    pos: torch.Tensor  # (W,) int32
    fh: torch.Tensor  # (W,) int64 forward hash of the current walk k-mer
    rh: torch.Tensor  # (W,) int64 reverse hash
    hist: torch.Tensor  # (W, cycle_window) int64 recent query hashes (ring)
    status: torch.Tensor  # (W,) int32
    hops: torch.Tensor  # (W,) int32 total appended bases
    path_min: torch.Tensor  # (W,) float32 running min coverage along the path


def make_walks(
    cfg: GraphConfig,
    wcfg: WalkConfig,
    seeds: np.ndarray,
    seed_lens: Optional[np.ndarray] = None,
    device="cpu",
) -> WalkState:
    """Walks from seed sequences (k-mers or whole fragments) on ``device``.

    seeds: (W, Ls) uint8 codes, Ls >= k, padded with 4 beyond each row's
    seed_lens (default: full rows).  The walk continues from each seed's
    LAST k-mer.  The lane count pads to a power of two (at least 64) as in
    the JAX package; padded lanes start DEAD."""
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
    lens = torch.from_numpy(seed_lens.astype(np.int64)).to(device)
    fh_all, rh_all, valid_all = nthash.rolling_hash(seeds_t, k, stranded=False)
    P = Ls - k + 1
    rows = torch.arange(W, device=device)
    last = torch.clamp(lens - k, min=0)
    fh, rh = fh_all[rows, last], rh_all[rows, last]
    n_kmers = lens - k + 1
    in_seed = torch.arange(P, device=device)[None, :] < n_kmers[:, None]
    valid = torch.all(torch.where(in_seed, valid_all, True), dim=1) & (n_kmers >= 1)
    buf = torch.zeros((W, wcfg.max_len), dtype=torch.uint8, device=device)
    buf[:, :Ls] = seeds_t
    hist = torch.zeros((W, wcfg.cycle_window), dtype=torch.int64, device=device)
    hist[:, 0] = _query_hash(cfg, wcfg, fh, rh)
    return WalkState(
        buf=buf,
        pos=lens.to(torch.int32),
        fh=fh,
        rh=rh,
        hist=hist,
        status=torch.where(valid, ACTIVE, DEAD).to(torch.int32),
        hops=torch.zeros(W, dtype=torch.int32, device=device),
        path_min=torch.full((W,), float("inf"), dtype=torch.float32, device=device),
    )


def revcomp_reseed(cfg: GraphConfig, wcfg: WalkConfig, buf: torch.Tensor, pos: torch.Tensor) -> WalkState:
    """Re-seed walks with the reverse complement of finished walks: the
    right-to-left hand-off of ``-extend``, not ported."""
    raise NotImplementedError(_NAIVE)


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
    """Append ``code`` to advancing lanes.  ``buf`` and ``hist`` are
    updated in place; the other fields are new tensors."""
    rows = torch.arange(state.pos.shape[0], device=state.pos.device)
    col = torch.clamp(state.pos, max=wcfg.max_len - 1).long()
    state.buf[rows, col] = torch.where(advance, code.to(torch.uint8), state.buf[rows, col])
    _push_hist(state.hist, _pick(q4, code), state.hops, wcfg, advance)
    return state._replace(
        pos=torch.where(advance, state.pos + 1, state.pos),
        fh=torch.where(advance, _pick(fh4, code), state.fh),
        rh=torch.where(advance, _pick(rh4, code), state.rh),
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
        advance = active & (nviable == 1) & ~cyc & ~full
        status = torch.where(
            nviable == 0, DEAD,
            torch.where(nviable > 1, BRANCH,
                        torch.where(cyc, CYCLE, torch.where(full, FULL, ACTIVE))),
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


def resolve_branches(
    state: WalkState, graph: GraphState, cfg: GraphConfig, wcfg: WalkConfig, min_cov: torch.Tensor
) -> WalkState:
    """Resolve BRANCH lanes greedily: the candidate with the best lookahead
    score wins (ties: higher candidate count, then smaller base code, the
    reference's first-wins order); the lane resumes ACTIVE unless the
    chosen k-mer is in its cycle ring (CYCLE) or its buffer is full
    (FULL)."""
    at_branch = state.status == BRANCH
    out_codes = _gather_out_codes(state.buf, state.pos, cfg.k)
    fh4, rh4, q4 = _successors(cfg, wcfg, state.fh, state.rh, out_codes)
    counts = dbg.get_counts(graph, cfg, q4)
    viable = counts >= torch.clamp(min_cov, min=1.0)[:, None]
    scores = _expand_scores(graph, cfg, wcfg, state.buf, state.pos, fh4, rh4, q4)
    scores = torch.where(viable, scores, -1.0)
    is_best = scores >= scores.amax(dim=1, keepdim=True)
    best = torch.argmax(torch.where(is_best & viable, counts, -1.0), dim=1)

    cyc = _in_hist(state.hist, _pick(q4, best))
    full = state.pos >= wcfg.max_len - 1
    advance = at_branch & ~cyc & ~full
    new_status = torch.where(
        at_branch & cyc, CYCLE,
        torch.where(at_branch & full, FULL, torch.where(at_branch, ACTIVE, state.status)),
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
    return WalkState(*(t.clone() for t in state))


def extend_walks_plain(
    state: WalkState,
    graph: GraphState,
    cfg: GraphConfig,
    wcfg: WalkConfig,
    min_cov: torch.Tensor,
    bound: torch.Tensor,
    superstep_hops: int = 64,
    max_supersteps: int = 64,
) -> WalkState:
    """The JAX package's lockstep loop (``_extend_walks_fused``) on whole
    lanes, on any device; ``state`` is left unchanged."""
    state = clone_state(state)
    for _ in range(max_supersteps):
        if not bool(((state.status == ACTIVE) | (state.status == BRANCH)).any()):
            break
        state = walk_superstep(state, graph, cfg, wcfg, min_cov, bound, superstep_hops)
        if bool((state.status == BRANCH).any()):
            state = resolve_branches(state, graph, cfg, wcfg, min_cov)
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
    """Extend every walk lane to completion; returns a new state."""
    if mode == "naive":
        raise NotImplementedError(_NAIVE)
    if mode != "greedy" or terminators is not None:
        raise NotImplementedError(_PAIR)
    from ..ops import walk

    min_cov, bound = lane_args(state, min_cov, bound)
    return walk.walk_greedy(state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps)


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

    return WalkState(
        buf=arr(ref.buf, np.uint8),
        pos=arr(ref.pos, np.int32),
        fh=from_limbs(ref.fh.lo, ref.fh.hi),
        rh=from_limbs(ref.rh.lo, ref.rh.hi),
        hist=from_limbs(ref.hist.lo, ref.hist.hi),
        status=arr(ref.status, np.int32),
        hops=arr(ref.hops, np.int32),
        path_min=arr(ref.path_min, np.float32),
    )
