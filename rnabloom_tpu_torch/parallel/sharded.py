"""Multi-device graph build: filters sharded by hash range over a mesh.

Port of ``rnabloom_tpu/parallel/sharded.py``, in one process that drives
every shard:

  * **DP over reads**: shard s hashes rows [s*B/n, (s+1)*B/n) of a batch
    of B rows on its own device.
  * **Hash-range sharding of every filter**: shard s owns lanes
    [s * local, (s+1) * local).  A filter of 2**G lanes over n = 2**N
    shards keeps local = 2**(G-N) lanes and one trash cell a shard (a
    128-cell trash row for the blocked cbf), each shard its own tensor on
    its own device.
  * **All-to-all routing** (``comm.all_to_all``): lane indices are
    bucketed by owner shard into buckets of a fixed capacity, moved,
    answered by the owner and, for lookups, routed back.  Inserts apply
    every round's received indices in one kernel launch on the owner
    (``ops.cell_insert``): ``set`` on bit lanes, ``add``, ``add_u16`` and
    ``add_mf8`` (its rounding keyed by the global cell index) on count-min
    cells, ``max`` for the conservative update, whose within-batch
    multiplicities come from a scratch sketch summed over the shards
    (``comm.all_reduce``).  Every reducer is order-free, so the sharded
    filters equal the single-device build's in every lane outside the
    trash cells.

The bucket capacity, the row split and the sentinel slots are the JAX
package's, so ``comm_accounting`` counts what its trace counts.

Walks over the shards (``sharded_extend_walks``, the routed engine, and
``grouped_extend_walks``, filters regrouped R ways and replicated N/R
ways): on the CPU the JAX package's lockstep loop reads the shards through
``ShardedBackend`` (routed reads, the walk lanes split over the shards as
``P(axis)`` splits them); on the card the walk kernel reads every shard in
place (``ops.walk.walk_mesh``), one launch a device that holds lanes.
Both give every lane its single-device walk.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bloom import filters
from ..bloom.filters import CountingConfig
from ..graph import dbg, traverse
from ..graph.dbg import GraphConfig
from ..ops import minifloat, nthash
from ..ops.cell_insert import cell_insert
from . import comm
from .comm import Mesh

Shards = Tuple[torch.Tensor, ...]

comm_accounting = comm.accounting

# routed calls, and those that ran a second round (a bucket overflowed)
ROUTING = {"calls": 0, "second_rounds": 0}


def reset_routing_counts() -> None:
    for key in ROUTING:
        ROUTING[key] = 0


class ShardedGraphState(NamedTuple):
    """Filter lanes, one tensor a shard (local lanes then the trash)."""

    dbgbf: Optional[Shards]
    cbf: Shards
    rpkbf: Optional[Shards] = None
    fpkbf: Optional[Shards] = None


def make_mesh(devices: Sequence) -> Mesh:
    """A mesh of one shard a listed device (a power of two of them; a
    device may be listed more than once)."""
    devs = tuple(_resolved(torch.device(d)) for d in devices)
    n = len(devs)
    if n < 1 or n & (n - 1):
        raise ValueError(f"a mesh needs a power-of-two number of shards, got {n}")
    return Mesh(devs)


def _resolved(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's index (tensors report theirs)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _shards_log2(mesh: Mesh) -> int:
    return mesh.size.bit_length() - 1


def make_sharded_graph(cfg: GraphConfig, mesh: Mesh, with_rpkbf: bool = False, with_fpkbf: bool = False
                       ) -> ShardedGraphState:
    n = mesh.size

    def filt(size_log2: int, dtype, trash: int = 1) -> Shards:
        # each shard its own allocation: the uint8 max insert needs its
        # table to start its storage
        local = (1 << size_log2) // n + trash
        return tuple(torch.zeros(local, dtype=dtype, device=dev) for dev in mesh.devices)

    return ShardedGraphState(
        dbgbf=filt(cfg.dbgbf.size_log2, torch.uint8) if cfg.exact_counts else None,
        cbf=filt(cfg.cbf.size_log2, cfg.cbf.torch_dtype, trash=128 if cfg.cbf.blocked else 1),
        rpkbf=filt(cfg.pkbf.size_log2, torch.uint8) if with_rpkbf else None,
        fpkbf=filt(cfg.pkbf.size_log2, torch.uint8) if with_fpkbf else None,
    )


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _bucket_capacity(m: int, n: int) -> int:
    """Per-round bucket size (the JAX package's rule).

    One round of capacity m when m <= 32768 or n <= 4.  Otherwise the
    hash-uniform mean per target plus over 6 sigma of Poisson slack, so a
    shard's receive side handles about m slots, not n * m; a bucket that
    overflows (poly-A, rRNA) rides a second round of capacity m."""
    if m <= 32768 or n <= 4:
        return m
    mean = m / n
    c = int(mean + 6.0 * math.sqrt(mean) + 256.0)
    return min(m, (c + 127) // 128 * 128)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """uint32 values (int64) as int32 bit patterns: indices ride the
    all-to-all in 4 bytes, as the JAX package's uint32 do."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _unwire(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.int64) & 0xFFFFFFFF


class Routed(NamedTuple):
    """What ``_routed_rounds`` returns: per shard, the indices it received
    (int64, every round, sentinel slots included) with their payloads, and
    the responses to its own requests (aligned to them; None without a
    responder)."""

    received: List[torch.Tensor]
    payloads: List[Tuple[torch.Tensor, ...]]
    outs: List[Optional[torch.Tensor]]


def _routed_rounds(
    mesh: Mesh,
    lidx: Sequence[torch.Tensor],
    target: Sequence[torch.Tensor],
    sentinel: int,
    payloads: Sequence[Tuple[torch.Tensor, ...]] = (),
    respond: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
) -> Routed:
    """Exact all-to-all routing: every request is delivered in some round.

    lidx[s], target[s]: shard s's (m,) int64 lane indices (uint32 values)
    and owner shards; payloads[s]: a tuple of (m,) tensors routed beside
    them.  A round sends up to C requests to each target, in a (n, C)
    bucket whose free slots hold ``sentinel`` (the owner's trash cell) and
    zero payloads; requests past C stay pending for the next round.
    ``respond(d, req)`` answers shard d's received (n*C,) indices with
    values of the same shape, which are routed back."""
    n = mesh.size
    m = int(lidx[0].shape[0])
    cap = _bucket_capacity(m, n)
    n_pay = len(payloads[0]) if payloads else 0
    remaining = [torch.ones(m, dtype=torch.bool, device=dev) for dev in mesh.devices]
    outs: List[Optional[torch.Tensor]] = [None] * n
    received: List[List[torch.Tensor]] = [[] for _ in range(n)]
    received_pay: List[List[List[torch.Tensor]]] = [[[] for _ in range(n_pay)] for _ in range(n)]

    def one_round(cap: int) -> None:
        sends, pay_sends, slots = [], [[] for _ in range(n_pay)], []
        for s, dev in enumerate(mesh.devices):
            key = torch.where(remaining[s], target[s], n)
            order = torch.argsort(key, stable=True)
            ts = key[order]
            start = torch.searchsorted(ts, torch.arange(n, device=dev))
            rank = torch.arange(m, device=dev) - start[torch.clamp(ts, max=n - 1)]
            active = (ts < n) & (rank < cap)
            a_t, a_rank, a_src = ts[active], rank[active], order[active]
            send = torch.full((n, cap), sentinel, dtype=torch.int64, device=dev)
            send[a_t, a_rank] = lidx[s][a_src]
            sends.append(_wire(send))
            for j in range(n_pay):
                p = payloads[s][j]
                ps = torch.zeros((n, cap), dtype=p.dtype, device=dev)
                ps[a_t, a_rank] = p[a_src]
                pay_sends[j].append(ps)
            slots.append((a_t, a_rank, a_src))
            remaining[s][a_src] = False
        req = comm.all_to_all(mesh, sends)
        preqs = [comm.all_to_all(mesh, ps) for ps in pay_sends]
        for d in range(n):
            received[d].append(_unwire(req[d]).reshape(-1))
            for j in range(n_pay):
                received_pay[d][j].append(preqs[j][d].reshape(-1))
        if respond is None:
            return
        back = comm.all_to_all(mesh, [respond(d, received[d][-1]).reshape(n, cap) for d in range(n)])
        for s in range(n):
            if outs[s] is None:
                outs[s] = torch.zeros(m, dtype=back[s].dtype, device=mesh.devices[s])
            a_t, a_rank, a_src = slots[s]
            outs[s][a_src] = back[s][a_t, a_rank]

    ROUTING["calls"] += 1
    one_round(cap)
    if cap < m:
        # the second round (capacity m: provably complete) runs only when a
        # bucket overflowed, decided by a sum over the shards as in the JAX
        # package, so every shard runs the same collectives
        pending = comm.all_reduce(mesh, [r.any().to(torch.int32).reshape(1) for r in remaining])
        if int(pending[0][0]) > 0:
            ROUTING["second_rounds"] += 1
            one_round(m)
    return Routed(
        received=[torch.cat(r) for r in received],
        payloads=[tuple(torch.cat(p) for p in pays) for pays in received_pay],
        outs=outs,
    )


def _global_indices(hashes: torch.Tensor, size_log2: int, valid: Optional[torch.Tensor], my: int,
                    local_log2: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(local index, owner shard) for each hash, flattened; invalid lanes
    go to this shard's own trash cell."""
    gidx = filters.bloom_indices(hashes, size_log2)
    t = gidx >> local_log2
    lidx = gidx & ((1 << local_log2) - 1)
    if valid is not None:
        v = valid[..., None].expand(hashes.shape)
        t = torch.where(v, t, my)
        lidx = torch.where(v, lidx, 1 << local_log2)
    return lidx.reshape(-1), t.reshape(-1)


def _routed_gather(mesh: Mesh, flats: Shards, lidx, target, sentinel: int) -> List[torch.Tensor]:
    """flats[t][lidx] for every request, from its owner shard ``t``."""
    return _routed_rounds(mesh, lidx, target, sentinel, respond=lambda d, req: flats[d][req]).outs


def _sharded_bloom_insert_lookup(
    mesh: Mesh, bits: Shards, hashes: Sequence[torch.Tensor], valid: Sequence[torch.Tensor], size_log2: int,
    do_insert: bool = True, do_lookup: bool = True,
) -> Optional[List[torch.Tensor]]:
    """Membership before the batch (``do_lookup``), then the batch's insert
    (``do_insert``), in place; returns the membership per shard or None.
    The lookup and the insert route separately, so every round of a skewed
    batch reads the pre-batch lanes."""
    local_log2 = size_log2 - _shards_log2(mesh)
    trash = 1 << local_log2
    lidx, t = zip(*(_global_indices(h, size_log2, v, s, local_log2) for s, (h, v) in enumerate(zip(hashes, valid))))
    present = None
    if do_lookup:
        mine = _routed_gather(mesh, bits, lidx, t, trash)
        present = [torch.all(x.reshape(h.shape) != 0, dim=-1) for x, h in zip(mine, hashes)]
    if do_insert:
        routed = _routed_rounds(mesh, lidx, t, trash)
        for table, idx in zip(bits, routed.received):
            cell_insert(table, idx, "set")
    return present


def _sharded_counting_increment(
    mesh: Mesh, counts: Shards, hashes, valid, dec_first, ccfg: CountingConfig, salt: int = 0,
) -> None:
    """The conservative update (exact counts) over the shards, in place: a
    routed gather of each key's cells, the within-batch multiplicity from
    a scratch sketch summed over the shards, then a routed ``max`` of the
    encoded new values on the owners.

    As in the JAX package's sharded path, the scratch sketch has the cells'
    dtype, so a uint8 (mf8) or uint16 multiplicity wraps where the
    single-device build's int32 sketch does not (ROADMAP §3)."""
    n = mesh.size
    local_log2 = ccfg.size_log2 - _shards_log2(mesh)
    trash = 1 << local_log2
    lidx, t = zip(*(_global_indices(h, ccfg.size_log2, v, s, local_log2) for s, (h, v) in enumerate(zip(hashes, valid))))
    mine = _routed_gather(mesh, counts, lidx, t, trash)

    sidx = [filters.bloom_indices(h, ccfg.scratch_log2, filters._bcast_valid(v, h)) for h, v in zip(hashes, valid)]
    parts = []
    for dev, si in zip(mesh.devices, sidx):
        scratch = torch.zeros((1 << ccfg.scratch_log2) + 1, dtype=torch.int32, device=dev)
        cell_insert(scratch, si.reshape(-1), "add")
        parts.append(scratch.to(ccfg.torch_dtype))  # wraps, as the JAX package's narrow sketch does
    scratch = comm.all_reduce(mesh, parts)

    upd = []
    for s in range(n):
        h = hashes[s]
        cur_min = torch.amin(filters.decode_counts(mine[s].reshape(h.shape), ccfg.dtype), dim=-1)
        mult = torch.amin(scratch[s][sidx[s]].to(torch.int32) & _UNSIGNED[ccfg.dtype], dim=-1)
        if dec_first is not None:
            mult = mult - dec_first[s].to(torch.int32)
        new_val = cur_min + torch.clamp(mult, min=0).to(cur_min.dtype)
        if valid[s] is not None:
            new_val = torch.where(valid[s], new_val, torch.zeros_like(new_val))
        u01 = minifloat.mix_u01(h[..., 0], salt) if ccfg.dtype == "mf8" else None
        upd.append((filters.encode_counts(new_val, ccfg.dtype, u01)[..., None].expand(h.shape).reshape(-1),))
    routed = _routed_rounds(mesh, lidx, t, trash, payloads=upd)
    for table, idx, (vals,) in zip(counts, routed.received, routed.payloads):
        cell_insert(table, idx, "max", values=vals)


_UNSIGNED = {"int32": -1, "u16": 0xFFFF, "mf8": 0xFF}  # a cell dtype's bits, read unsigned
_CM_OPS = {"int32": "add", "u16": "add_u16", "mf8": "add_mf8"}


def _sharded_counting_add_cm(mesh: Mesh, counts: Shards, hashes, valid, ccfg: CountingConfig, salt: int = 0) -> None:
    """Count-min increment, in place: indices routed once, each owner
    applying every round's indices in one insert; mf8 rounding is keyed by
    the global cell index (``base`` = the shard's first lane)."""
    local_log2 = ccfg.size_log2 - _shards_log2(mesh)
    lidx, t = zip(*(_global_indices(h, ccfg.size_log2, v, s, local_log2) for s, (h, v) in enumerate(zip(hashes, valid))))
    routed = _routed_rounds(mesh, lidx, t, 1 << local_log2)
    for d, (table, idx) in enumerate(zip(counts, routed.received)):
        base = d << local_log2 if ccfg.dtype == "mf8" else 0
        cell_insert(table, idx, _CM_OPS[ccfg.dtype], salt, base=base)


def _sharded_counting_add_blocked(mesh: Mesh, counts: Shards, hashes, valid, ccfg: CountingConfig) -> None:
    """Blocked count-min increment over row-range shards, in place.  One
    packed uint32 a key rides the all-to-all, (local row << 14) | (lane0 <<
    7) | lane1, and the owner unpacks it into its two cells."""
    assert ccfg.num_hash == 2, "packed routing supports num_hash == 2"
    assert ccfg.dtype == "int32", "blocked layout is int32-only"
    local_rows_log2 = ccfg.size_log2 - 7 - _shards_log2(mesh)
    assert local_rows_log2 <= 17, "packed routing needs local rows <= 2^17"
    trash_row = 1 << local_rows_log2
    packed, t = [], []
    for s, (h, v) in enumerate(zip(hashes, valid)):
        row, lanes = filters.blocked_cells(ccfg, h)
        ts = row >> local_rows_log2
        lrow = row & (trash_row - 1)
        if v is not None:
            ts = torch.where(v, ts, s)
            lrow = torch.where(v, lrow, trash_row)
        packed.append(((lrow << 14) | (lanes[..., 0] << 7) | lanes[..., 1]).reshape(-1))
        t.append(ts.reshape(-1))
    routed = _routed_rounds(mesh, packed, t, trash_row << 14)
    for table, r in zip(counts, routed.received):
        cells = (r >> 14) * 128
        cell_insert(table, torch.stack([cells + ((r >> 7) & 127), cells + (r & 127)], dim=-1).reshape(-1), "add")


def _blocked_cell_indices(ccfg: CountingConfig, hashes: torch.Tensor, valid, my: int, n_log2: int):
    """(local index, owner shard) of every cell of each key in the blocked
    layout; row-range shards are contiguous in cell index."""
    local_rows_log2 = ccfg.size_log2 - 7 - n_log2
    row, lanes = filters.blocked_cells(ccfg, hashes)
    t = (row >> local_rows_log2)[..., None].expand(lanes.shape)
    lidx = (row & ((1 << local_rows_log2) - 1))[..., None] * 128 + lanes
    if valid is not None:
        v = valid[..., None].expand(lanes.shape)
        t = torch.where(v, t, my)
        lidx = torch.where(v, lidx, 128 << local_rows_log2)
    return lidx.reshape(-1), t.reshape(-1)


def _cbf_requests(mesh: Mesh, ccfg: CountingConfig, hashes, valid):
    """(lidx, target, sentinel) of a routed read of the cbf's cells."""
    n_log2 = _shards_log2(mesh)
    if ccfg.blocked:
        req = [_blocked_cell_indices(ccfg, h, v, s, n_log2) for s, (h, v) in enumerate(zip(hashes, valid))]
        sentinel = 128 << (ccfg.size_log2 - 7 - n_log2)
    else:
        local_log2 = ccfg.size_log2 - n_log2
        req = [_global_indices(h, ccfg.size_log2, v, s, local_log2) for s, (h, v) in enumerate(zip(hashes, valid))]
        sentinel = 1 << local_log2
    lidx, t = zip(*req)
    return lidx, t, sentinel


def _sharded_counting_count(mesh: Mesh, counts: Shards, ccfg: CountingConfig, hashes, valid=None):
    """Routed count-min read: the decoded min over each key's cells."""
    if valid is None:
        valid = [None] * mesh.size
    lidx, t, sentinel = _cbf_requests(mesh, ccfg, hashes, valid)
    mine = _routed_gather(mesh, counts, lidx, t, sentinel)
    return [torch.amin(filters.decode_counts(x.reshape(h.shape), ccfg.dtype), dim=-1) for x, h in zip(mine, hashes)]


def _sharded_bloom_query(mesh: Mesh, lanes: Shards, size_log2: int, hashes) -> List[torch.Tensor]:
    """Routed Bloom membership: AND over each key's hash lanes."""
    local_log2 = size_log2 - _shards_log2(mesh)
    lidx, t = zip(*(_global_indices(h, size_log2, None, s, local_log2) for s, h in enumerate(hashes)))
    mine = _routed_gather(mesh, lanes, lidx, t, 1 << local_log2)
    return [torch.all(x.reshape(h.shape) != 0, dim=-1) for x, h in zip(mine, hashes)]


def _sharded_counts(mesh: Mesh, state: ShardedGraphState, cfg: GraphConfig, base) -> List[torch.Tensor]:
    """Float32 count per key (``dbg.get_counts`` over the shards)."""
    h_cbf = [nthash.multi_hash(b, cfg.k, cfg.cbf.num_hash) for b in base]
    est = _sharded_counting_count(mesh, state.cbf, cfg.cbf, h_cbf)
    if not cfg.exact_counts:
        return [e.to(torch.float32) for e in est]
    h_dbg = [nthash.multi_hash(b, cfg.k, cfg.dbgbf.num_hash) for b in base]
    member = _sharded_bloom_query(mesh, state.dbgbf, cfg.dbgbf.size_log2, h_dbg)
    return [torch.where(m_, e.to(torch.float32) + 1.0, 0.0) for m_, e in zip(member, est)]


class ShardedBackend(traverse.DeviceBackend):
    """The walk loop's filter reads over a mesh's shards (the JAX package's
    ShardedBackend in its ``shard_map``).  The loop holds every lane; a
    read hashes its keys and finds their cells on the lanes' device, then
    splits its rows over the shards in contiguous runs, as ``P(axis)``
    splits the lanes (row s * m / n onward on shard s), routes each run's
    cells to their owners and joins the answers on the lanes' device.  A
    loop decision is an all-reduce over the shards, as the JAX package's
    psum, so ``comm_accounting`` counts the JAX schedule."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _split(self, x: torch.Tensor) -> List[torch.Tensor]:
        n = self.mesh.size
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} shards")
        per = x.shape[0] // n
        return [x[s * per : (s + 1) * per].to(dev) for s, dev in enumerate(self.mesh.devices)]

    def _gather(self, flats: Shards, lidx: torch.Tensor, t: torch.Tensor, sentinel: int) -> torch.Tensor:
        """flats[t][lidx] of every cell, each run of rows from its shard."""
        outs = _routed_gather(self.mesh, flats, self._split(lidx), self._split(t), sentinel)
        return torch.cat([x.to(lidx.device) for x in outs])

    def _count(self, cells: Shards, ccfg: CountingConfig, h: torch.Tensor) -> torch.Tensor:
        """``_sharded_counting_count`` of the multi-hashes ``h``."""
        n_log2 = _shards_log2(self.mesh)
        if ccfg.blocked:
            lidx, t = _blocked_cell_indices(ccfg, h, None, 0, n_log2)
            sentinel = 128 << (ccfg.size_log2 - 7 - n_log2)
        else:
            lidx, t = _global_indices(h, ccfg.size_log2, None, 0, ccfg.size_log2 - n_log2)
            sentinel = 1 << (ccfg.size_log2 - n_log2)
        mine = self._gather(cells, lidx, t, sentinel)
        return torch.amin(filters.decode_counts(mine.reshape(h.shape), ccfg.dtype), dim=-1)

    def counts(self, graph: ShardedGraphState, cfg: GraphConfig, base: torch.Tensor) -> torch.Tensor:
        """``_sharded_counts``: float32 count per key."""
        est = self._count(graph.cbf, cfg.cbf, nthash.multi_hash(base, cfg.k, cfg.cbf.num_hash))
        if not cfg.exact_counts:
            return est.to(torch.float32)
        member = self.bloom_lookup(graph.dbgbf, cfg.dbgbf, nthash.multi_hash(base, cfg.k, cfg.dbgbf.num_hash))
        return torch.where(member, est.to(torch.float32) + 1.0, 0.0)

    def bloom_lookup(self, lanes: Shards, bcfg, hashes: torch.Tensor) -> torch.Tensor:
        """``_sharded_bloom_query``: AND over each key's hash lanes."""
        local_log2 = bcfg.size_log2 - _shards_log2(self.mesh)
        lidx, t = _global_indices(hashes, bcfg.size_log2, None, 0, local_log2)
        mine = self._gather(lanes, lidx, t, 1 << local_log2)
        return torch.all(mine.reshape(hashes.shape) != 0, dim=-1)

    def any_global(self, x: torch.Tensor) -> bool:
        total = comm.all_reduce(self.mesh, [p.any().to(torch.int32) for p in self._split(x)])
        return int(total[0]) > 0


# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------


def _shard_rows(mesh: Mesh, codes) -> List[torch.Tensor]:
    """Shard s's rows of a (B, L) code batch, B a multiple of n, on its
    device."""
    n = mesh.size
    if isinstance(codes, np.ndarray):
        codes = torch.from_numpy(np.ascontiguousarray(codes))
    B = codes.shape[0]
    if B % n:
        raise ValueError(f"{B} rows do not split over {n} shards")
    rows = B // n
    return [codes[s * rows : (s + 1) * rows].to(dev) for s, dev in enumerate(mesh.devices)]


def _hash_shards(mesh: Mesh, cfg: GraphConfig, codes):
    """Per shard (fh, rh, base, valid) of its rows."""
    return [dbg.seq_hashes(cfg, c) for c in _shard_rows(mesh, codes)]


def _pair_keys(cfg: GraphConfig, hashed, d: int):
    """Per shard (pair-key hashes, pair validity) of the k-mer pairs (i, i+d)."""
    out = []
    for fh, rh, _, valid in hashed:
        pair_base, np_ = dbg.pair_base_hashes(cfg, fh, rh, d)
        out.append((nthash.multi_hash(pair_base, cfg.k, cfg.pkbf.num_hash), valid[..., :np_] & valid[..., d:]))
    return out


def _add_kmers(mesh: Mesh, state: ShardedGraphState, cfg: GraphConfig, hashed, salt: int) -> None:
    """``dbg.add_kmers`` over the shards."""
    valid = [x[3] for x in hashed]
    h_cbf = [nthash.multi_hash(x[2], cfg.k, cfg.cbf.num_hash) for x in hashed]
    if cfg.exact_counts:
        h_dbg = [nthash.multi_hash(x[2], cfg.k, cfg.dbgbf.num_hash) for x in hashed]
        present = _sharded_bloom_insert_lookup(mesh, state.dbgbf, h_dbg, valid, cfg.dbgbf.size_log2)
        dec_first = [v & ~p for v, p in zip(valid, present)]
        _sharded_counting_increment(mesh, state.cbf, h_cbf, valid, dec_first, cfg.cbf, salt)
    elif cfg.cbf.blocked:
        _sharded_counting_add_blocked(mesh, state.cbf, h_cbf, valid, cfg.cbf)
    else:
        _sharded_counting_add_cm(mesh, state.cbf, h_cbf, valid, cfg.cbf, salt)


def _add_pairs(mesh: Mesh, lanes: Shards, cfg: GraphConfig, hashed, d: int) -> None:
    keys = _pair_keys(cfg, hashed, d)
    _sharded_bloom_insert_lookup(mesh, lanes, [h for h, _ in keys], [v for _, v in keys], cfg.pkbf.size_log2,
                                 do_lookup=False)


def sharded_build_step(mesh: Mesh, cfg: GraphConfig, add_read_pairs: bool = False):
    """(state, codes, salt=0) -> state: one stage-1 step over the mesh.
    ``codes`` is (B, L) with B a multiple of the shard count.  The filters
    are updated in place; the returned state is a new tuple of them (the
    engine's replica cache keys on its identity)."""

    def step(state: ShardedGraphState, codes, salt: int = 0) -> ShardedGraphState:
        if state.fpkbf is not None:
            raise ValueError("the build step takes no fpkbf (the rebuild step writes it)")
        hashed = _hash_shards(mesh, cfg, codes)
        _add_kmers(mesh, state, cfg, hashed, salt)
        if add_read_pairs and state.rpkbf is not None and cfg.read_pair_distance > 0:
            _add_pairs(mesh, state.rpkbf, cfg, hashed, cfg.read_pair_distance)
        return ShardedGraphState(*state)

    return step


def sharded_rebuild_step(mesh: Mesh, cfg: GraphConfig, add_frag_pairs: bool = True):
    """(state, codes, salt=0) -> state: one stage-2b step over the mesh,
    the counters and (``add_frag_pairs``) the fragment-pair keys."""

    def step(state: ShardedGraphState, codes, salt: int = 0) -> ShardedGraphState:
        hashed = _hash_shards(mesh, cfg, codes)
        _add_kmers(mesh, state, cfg, hashed, salt)
        if add_frag_pairs and state.fpkbf is not None and cfg.fragment_pair_distance > 0:
            _add_pairs(mesh, state.fpkbf, cfg, hashed, cfg.fragment_pair_distance)
        return ShardedGraphState(*state)

    return step


def sharded_count_query(mesh: Mesh, cfg: GraphConfig):
    """(state, codes) -> (counts (B, P) float32, valid), on the mesh's
    first device: every cell read routed to its owner."""

    def query(state: ShardedGraphState, codes):
        hashed = _hash_shards(mesh, cfg, codes)
        valid = [x[3] for x in hashed]
        h_cbf = [nthash.multi_hash(x[2], cfg.k, cfg.cbf.num_hash) for x in hashed]
        est = _sharded_counting_count(mesh, state.cbf, cfg.cbf, h_cbf, valid)
        if cfg.exact_counts:
            h_dbg = [nthash.multi_hash(x[2], cfg.k, cfg.dbgbf.num_hash) for x in hashed]
            member = _sharded_bloom_insert_lookup(mesh, state.dbgbf, h_dbg, valid, cfg.dbgbf.size_log2,
                                                  do_insert=False)
            counts = [torch.where(m_, e.to(torch.float32) + 1.0, 0.0) for m_, e in zip(member, est)]
        else:
            counts = [e.to(torch.float32) for e in est]
        home = mesh.devices[0]
        return (torch.cat([torch.where(v, c, 0.0).to(home) for c, v in zip(counts, valid)]),
                torch.cat([v.to(home) for v in valid]))

    return query


def sharded_pair_support(mesh: Mesh, cfg: GraphConfig, d_frag: int, d_read: int):
    """(state, codes) -> (2, B, P) bool on the mesh's first device:
    fragment- then read-pair support, each pair key looked up on its
    owners.  A zero distance or a missing filter gives a False plane."""

    def query(state: ShardedGraphState, codes):
        hashed = _hash_shards(mesh, cfg, codes)
        planes = []
        for d, lanes in ((d_frag, state.fpkbf), (d_read, state.rpkbf)):
            plane = [torch.zeros(x[3].shape, dtype=torch.bool, device=x[3].device) for x in hashed]
            if d > 0 and lanes is not None:
                keys = _pair_keys(cfg, hashed, d)
                sup = _sharded_bloom_query(mesh, lanes, cfg.pkbf.size_log2, [h for h, _ in keys])
                for p, s_, (_, pv) in zip(plane, sup, keys):
                    p[:, : pv.shape[-1]] = s_ & pv
            planes.append(torch.cat([p.to(mesh.devices[0]) for p in plane]))
        return torch.stack(planes)

    return query


def sharded_variant_counts(mesh: Mesh, cfg: GraphConfig):
    """(state, codes) -> (hit, valid) on the mesh's first device: does any
    left or right SNV variant of each k-mer exist (routed counts)?"""

    def query(state: ShardedGraphState, codes):
        shards = _shard_rows(mesh, codes)
        hashed = [dbg.seq_hashes(cfg, c) for c in shards]
        hit = [torch.zeros_like(x[3]) for x in hashed]
        for variants, side in ((nthash.variant_hashes_right, "last"), (nthash.variant_hashes_left, "first")):
            cur, q4 = [], []
            for c, (fh, rh, _, _) in zip(shards, hashed):
                P = fh.shape[-1]
                cur.append(c[:, cfg.k - 1 : cfg.k - 1 + P] if side == "last" else c[:, :P])
                q4.append(nthash.canonical(*variants(fh, cur[-1], cfg.k, rh)))
            for h, c4, cs in zip(hit, _sharded_counts(mesh, state, cfg, q4), cur):
                is_self = torch.arange(4, device=cs.device) == cs.long()[..., None]
                h |= ((c4 > 0) & ~is_self).any(dim=-1)
        home = mesh.devices[0]
        return (torch.cat([(h & x[3]).to(home) for h, x in zip(hit, hashed)]),
                torch.cat([x[3].to(home) for x in hashed]))

    return query


# ---------------------------------------------------------------------------
# Walks over the shards
# ---------------------------------------------------------------------------


def _with_spec_default(wcfg: traverse.WalkConfig) -> traverse.WalkConfig:
    """The mesh walks default to depth-2 speculative supersteps (each round
    one batched read of the 20-node successor tree, then up to 2 hops),
    unless back-branch checks are on or the caller set ``spec_hops``."""
    if wcfg.spec_hops == 1 and not wcfg.check_back_branches:
        return dataclasses.replace(wcfg, spec_hops=2)
    return wcfg


def _walk_args(wstate, mesh: Mesh, wcfg, mode: str, min_cov, bound):
    """The per-lane min_cov and bound, after the checks that the JAX
    package's ``shard_map`` makes before any work: the lanes split evenly
    over the mesh's shards."""
    traverse.check_mode(wcfg, mode)
    W = wstate.pos.shape[0]
    if W % mesh.size:
        raise ValueError(f"mesh walks: {W} walk lanes are not evenly divisible by the mesh's {mesh.size} shards")
    return traverse.lane_args(wstate, min_cov, bound)


def sharded_extend_walks(mesh: Mesh, cfg: GraphConfig, wcfg, mode: str, superstep_hops: int = 64,
                         max_supersteps: int = 64):
    """(wstate, state, min_cov, bound) -> WalkState: the routed mesh walk.
    The lanes split over the shards (W a multiple of their count, as the
    JAX package's ``P(axis)`` requires; it raises otherwise), each read
    answered by the shard that owns its cell, under depth-2 speculative
    supersteps by default.  Every lane walks as on one device."""
    from ..ops import walk

    wcfg = _with_spec_default(wcfg)

    def run(wstate, state: ShardedGraphState, min_cov, bound):
        min_cov, bound = _walk_args(wstate, mesh, wcfg, mode, min_cov, bound)
        return walk.walk_mesh(mode, wstate, state, mesh, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps)

    return run


@dataclass(frozen=True)
class GroupMesh:
    """A (rep, shard) mesh: the shards of ``mesh`` in N / r groups of r
    consecutive ones, group g on shards [g r, (g + 1) r) (the rows of the
    JAX package's ``make_group_mesh``)."""

    mesh: Mesh
    r: int

    @property
    def groups(self) -> Tuple[Mesh, ...]:
        d, r = self.mesh.devices, self.r
        return tuple(Mesh(d[g * r : (g + 1) * r]) for g in range(len(d) // r))


def make_group_mesh(r: int, mesh: Mesh) -> GroupMesh:
    """Filters sharded r ways within each group and replicated over the N /
    r groups: the middle point between the replica (r = 1) and the routed
    engine (r = N)."""
    n = mesh.size
    assert n % r == 0, f"group size {r} must divide device count {n}"
    return GroupMesh(mesh, r)


def group_state(gmesh: GroupMesh, state: ShardedGraphState, cfg: GraphConfig) -> Tuple[ShardedGraphState, ...]:
    """The N-way shards regrouped r ways, one state a group (the JAX
    package's ``regroup``): r-way shard j is N-way shards [j N / r, (j + 1)
    N / r) joined without their trash, then a zeroed trash, copied onto the
    group's j-th device.  Groups on the same devices (several on one card)
    share one copy."""
    n, r = gmesh.mesh.size, gmesh.r
    per = n // r
    src = gmesh.mesh.devices
    cbf_trash = 128 if cfg.cbf.blocked else 1
    made = {}

    def regroup(lanes: Optional[Shards], trash: int, devices) -> Optional[Shards]:
        if lanes is None:
            return None
        return tuple(comm.gather(Mesh(src[j * per : (j + 1) * per]),
                                 [x[: x.numel() - trash] for x in lanes[j * per : (j + 1) * per]], dev, pad=trash)
                     for j, dev in enumerate(devices))

    out = []
    for group in gmesh.groups:
        if group.devices not in made:
            made[group.devices] = ShardedGraphState(
                dbgbf=regroup(state.dbgbf, 1, group.devices),
                cbf=regroup(state.cbf, cbf_trash, group.devices),
                rpkbf=regroup(state.rpkbf, 1, group.devices),
                fpkbf=regroup(state.fpkbf, 1, group.devices),
            )
        out.append(made[group.devices])
    return tuple(out)


def grouped_extend_walks(gmesh: GroupMesh, cfg: GraphConfig, wcfg, mode: str, superstep_hops: int = 64,
                         max_supersteps: int = 64):
    """(wstate, group states, min_cov, bound) -> WalkState: the grouped
    mesh walk.  The lanes split over all N shards (W a multiple of N);
    group g walks its r runs of them over its own r-way shards, reads
    routed within the group, under depth-2 speculative supersteps by
    default.  Groups that read one copy of the shards (several groups on
    the same devices, as on one card) walk together, their lanes split
    over that copy's shards: on the card one launch a device that holds
    lanes."""
    from ..ops import walk

    wcfg = _with_spec_default(wcfg)
    groups = gmesh.groups

    def run(wstate, states: Sequence[ShardedGraphState], min_cov, bound):
        min_cov, bound = _walk_args(wstate, gmesh.mesh, wcfg, mode, min_cov, bound)
        per = wstate.pos.shape[0] // len(groups)
        runs: List[list] = []  # [group mesh, its state, first lane, end]
        for g, (group, st) in enumerate(zip(groups, states)):
            if runs and runs[-1][1] is st and runs[-1][0] == group:
                runs[-1][3] += per
            else:
                runs.append([group, st, g * per, (g + 1) * per])
        parts = [walk.walk_mesh(mode, traverse.take_lanes(wstate, slice(a, b)), st, group, cfg, wcfg, min_cov[a:b],
                                bound[a:b], superstep_hops, max_supersteps) for group, st, a, b in runs]
        if len(parts) == 1:
            return parts[0]
        return traverse.WalkState(*(None if f[0] is None else torch.cat(f) for f in zip(*parts)))

    return run


def _merge(mesh: Mesh, lanes: Optional[Shards], trash: int, out_trash: int, device) -> Optional[torch.Tensor]:
    """Shard-major lanes -> the single-device layout on ``device``: each
    shard's lanes without its trash, then ``out_trash`` zero cells."""
    if lanes is None:
        return None
    return comm.gather(mesh, [x[: x.numel() - trash] for x in lanes], device, pad=out_trash)


def replicate_graph(mesh: Mesh, state: ShardedGraphState, cfg: GraphConfig, device) -> dbg.GraphState:
    """The filters gathered into the single-device layout on ``device``
    (the trash cells zeroed): the replica that walks and queries read,
    collective-free, while the graph does not change."""
    cbf_trash = 128 if cfg.cbf.blocked else 1
    return dbg.GraphState(
        dbgbf=_merge(mesh, state.dbgbf, 1, cfg.dbgbf.trash, device),
        cbf=_merge(mesh, state.cbf, cbf_trash, cfg.cbf.trash, device),
        rpkbf=_merge(mesh, state.rpkbf, 1, 1, device),
        fpkbf=_merge(mesh, state.fpkbf, 1, 1, device),
    )


def sharded_fprs(state: ShardedGraphState, cfg: GraphConfig) -> dict:
    """Filter FPRs from the popcounts over the shards, by the JAX
    package's arithmetic for a mesh: the int32 popcount over the size in
    float32, raised to the hash count in float64 (``dbg.fprs`` raises in
    float32)."""

    def fpr(lanes: Shards, trash: int, size: int, num_hash: int) -> float:
        nonzero = sum(filters._count_nonzero(x[: x.numel() - trash]) for x in lanes)
        fill = torch.tensor(float(nonzero), dtype=torch.float32) / size
        return float(fill) ** num_hash

    out = {"cbf": fpr(state.cbf, 128 if cfg.cbf.blocked else 1, cfg.cbf.size, cfg.cbf.num_hash)}
    if state.dbgbf is not None:
        out["dbgbf"] = fpr(state.dbgbf, 1, cfg.dbgbf.size, cfg.dbgbf.num_hash)
    if state.rpkbf is not None:
        out["rpkbf"] = fpr(state.rpkbf, 1, cfg.pkbf.size, cfg.pkbf.num_hash)
    if state.fpkbf is not None:
        out["fpkbf"] = fpr(state.fpkbf, 1, cfg.pkbf.size, cfg.pkbf.num_hash)
    return out
