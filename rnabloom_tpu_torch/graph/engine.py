"""Graph execution engine: one query surface, one device or a mesh.

Port of ``rnabloom_tpu/graph/engine.py``.  Pipelines call graph operations
through this module, which moves host code batches to the graph's device
and counts dispatches per kind.  A plain ``GraphState`` runs the
single-device code (``graph/dbg.py``, ``graph/traverse.py``); a
``MeshGraph`` runs the hash-range-sharded programs of
``parallel/sharded.py``: the build and rebuild steps route every insert to
its owner shard, and queries and walks read a replica of the graph
gathered once a graph version, one a distinct device, with the walk lanes
split over the devices.  ``RNB_MESH_WALK`` picks another engine, as in the
JAX package: ``grouped`` walks over the filters regrouped
``RNB_MESH_GROUP`` (default 2) ways, each group's copy replicated over the
groups; any other value but ``replicated`` walks routed, every read
answered by the shard that owns it.  On the card the walk kernel reads
those shards in place, and the queries of both route their reads to the
graph's shards.  Queries return numpy, as the JAX
package's do.  Both engines give the same filters outside the trash cells,
the same counts and the same walks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from ..bloom import filters
from ..ops import nthash
from . import dbg, traverse
from .dbg import GraphConfig, GraphState

DISPATCHES = {"build": 0, "query": 0, "walk": 0}


def _tick(kind: str) -> None:
    DISPATCHES[kind] += 1


def dispatch_counts() -> dict:
    return dict(DISPATCHES)


def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and there is
    no card (the port never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    return dev


@dataclass
class MeshGraph:
    """A sharded graph state over a mesh, with the replicas its queries
    and walks read and the group states of its grouped walks (both cached
    until a build or rebuild step rebinds ``state``)."""

    mesh: object  # parallel.comm.Mesh
    state: object  # parallel.sharded.ShardedGraphState
    _replicas: dict = field(default_factory=dict)
    _groups: dict = field(default_factory=dict)  # r -> (state, group states)

    @property
    def rpkbf(self):
        return self.state.rpkbf

    @property
    def fpkbf(self):
        return self.state.fpkbf


def make_mesh_if_multi(device="cuda", min_devices: int = 2):
    """A mesh of one shard a visible card, over the largest power of two
    of them, when that is at least ``min_devices``; None otherwise, and
    for a CPU ``device``.  Raises where ``device`` names CUDA and there is
    no card."""
    dev = require_device(device)
    if dev.type != "cuda":
        return None
    n = torch.cuda.device_count()
    n = 1 << (n.bit_length() - 1)  # the largest power of two
    if n < min_devices:
        return None
    from ..parallel import sharded

    return sharded.make_mesh([torch.device("cuda", i) for i in range(n)])


def make_graph(cfg: GraphConfig, with_rpkbf: bool = False, with_fpkbf: bool = False, *, device=None, mesh=None):
    """Zeroed filters on ``device``, or sharded over ``mesh`` (a MeshGraph)."""
    if mesh is None:
        if device is None:
            raise TypeError("make_graph needs a device or a mesh")
        return dbg.make_graph(cfg, with_rpkbf=with_rpkbf, with_fpkbf=with_fpkbf, device=device)
    from ..parallel import sharded

    return MeshGraph(mesh=mesh, state=sharded.make_sharded_graph(cfg, mesh, with_rpkbf=with_rpkbf,
                                                                   with_fpkbf=with_fpkbf))


def is_sharded(graph) -> bool:
    return isinstance(graph, MeshGraph)


def device_of(graph) -> torch.device:
    """The device that a graph's walks, screens and query results live on:
    a mesh's first."""
    return graph.mesh.devices[0] if is_sharded(graph) else graph.cbf.device


def synchronize(graph) -> None:
    """Wait for the card(s) holding ``graph`` (nothing on the CPU)."""
    devices = graph.mesh.distinct if is_sharded(graph) else (graph.cbf.device,)
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _pad_rows(codes, n: int) -> np.ndarray:
    """A host code batch padded with rows of code 4 to a multiple of ``n``."""
    codes = np.asarray(codes)
    B = codes.shape[0]
    if B % n == 0:
        return codes
    return np.concatenate([codes, np.full((n - B % n,) + codes.shape[1:], 4, codes.dtype)])


def _on_device(codes, graph) -> torch.Tensor:
    if isinstance(codes, np.ndarray):
        codes = torch.from_numpy(np.ascontiguousarray(codes))
    return codes.to(device_of(graph))


def _host_codes(codes) -> np.ndarray:
    return codes.cpu().numpy() if isinstance(codes, torch.Tensor) else np.asarray(codes)


# ---------------------------------------------------------------------------
# inserts
# ---------------------------------------------------------------------------


def build_step(graph, cfg: GraphConfig, codes, add_read_pairs: bool = False, salt: int = 0):
    _tick("build")
    if not is_sharded(graph):
        return dbg.build_step(graph, cfg, _on_device(codes, graph), add_read_pairs=add_read_pairs, salt=salt)
    from ..parallel import sharded

    step = sharded.sharded_build_step(graph.mesh, cfg, add_read_pairs=add_read_pairs)
    graph.state = step(graph.state, _pad_rows(_host_codes(codes), graph.mesh.size), salt)
    return graph


def rebuild_step(graph, cfg: GraphConfig, codes, add_frag_pairs: bool = True, salt: int = 0):
    """One stage-2b step: a fragment batch into the counters (and the
    fragment-pair keys); the graph's tensors are updated in place."""
    _tick("build")
    if not is_sharded(graph):
        return dbg.rebuild_step(graph, cfg, _on_device(codes, graph), add_frag_pairs=add_frag_pairs, salt=salt)
    from ..parallel import sharded

    step = sharded.sharded_rebuild_step(graph.mesh, cfg, add_frag_pairs=add_frag_pairs)
    graph.state = step(graph.state, _pad_rows(_host_codes(codes), graph.mesh.size), salt)
    return graph


def fresh_rebuild_state(graph, cfg: GraphConfig, keep_rpkbf: bool = True, with_fpkbf: bool = True,
                        copy_rpkbf: bool = False):
    """Zeroed counters (and a fresh fpkbf) for the stage-2b fragment graph
    on the graph's device(s), keeping the read-pair keys
    (populateGraphFromFragments); no dbgbf.  ``copy_rpkbf`` copies the
    read-pair lanes instead of sharing them with ``graph`` (the rebuild
    never writes them; the JAX package copies them against buffer
    donation)."""
    if not is_sharded(graph):
        rpk = graph.rpkbf if keep_rpkbf else None
        if rpk is not None and copy_rpkbf:
            rpk = rpk.clone()
        return GraphState(
            dbgbf=None,
            cbf=torch.zeros_like(graph.cbf),
            rpkbf=rpk,
            fpkbf=filters.make_bloom(cfg.pkbf, device=graph.cbf.device) if with_fpkbf else None,
        )
    from ..parallel import sharded

    fresh = sharded.make_sharded_graph(cfg, graph.mesh, with_fpkbf=with_fpkbf)
    rpk = graph.state.rpkbf if keep_rpkbf else None
    if rpk is not None and copy_rpkbf:
        rpk = tuple(x.clone() for x in rpk)
    return MeshGraph(mesh=graph.mesh, state=sharded.ShardedGraphState(
        dbgbf=None, cbf=fresh.cbf, rpkbf=rpk, fpkbf=fresh.fpkbf))


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def _use_replicated() -> bool:
    """Mesh queries read the replica unless RNB_MESH_WALK asks otherwise
    (``routed``: every read routed to its owner shard)."""
    return os.environ.get("RNB_MESH_WALK", "replicated") == "replicated"


def _replicated_graph(graph: MeshGraph, cfg: GraphConfig, device=None) -> GraphState:
    """The graph gathered into the single-device layout on ``device`` (the
    mesh's first by default), cached until a build or rebuild step rebinds
    ``graph.state``."""
    from ..parallel import sharded

    device = torch.device(device) if device is not None else graph.mesh.devices[0]
    cached = graph._replicas.get(device)
    if cached is not None and cached[0] is graph.state:
        return cached[1]
    if any(s is not graph.state for s, _ in graph._replicas.values()):
        graph._replicas.clear()  # a new graph version: drop the old replicas first
    rep = sharded.replicate_graph(graph.mesh, graph.state, cfg, device)
    graph._replicas[device] = (graph.state, rep)
    return rep


def _routed(graph: MeshGraph, make, codes):
    """Run a routed query program on a host code batch padded to the shard
    count; returns its output and the batch's row count."""
    codes = _host_codes(codes)
    return make(graph.mesh)(graph.state, _pad_rows(codes, graph.mesh.size)), codes.shape[0]


def _count_step(graph: GraphState, cfg: GraphConfig, codes):
    return dbg.count_step(graph, cfg, _on_device(codes, graph))


def count_step(graph, cfg: GraphConfig, codes) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts (B, P) float32, valid) for every k-mer of a code batch, on
    the graph's device."""
    _tick("query")
    if not is_sharded(graph):
        return _count_step(graph, cfg, codes)
    if _use_replicated():
        return _count_step(_replicated_graph(graph, cfg), cfg, codes)
    from ..parallel import sharded

    (counts, valid), B = _routed(graph, lambda mesh: sharded.sharded_count_query(mesh, cfg), codes)
    return counts[:B], valid[:B]


def _pair_plane(graph: GraphState, cfg: GraphConfig, fh, rh, valid, d: int, lookup) -> torch.Tensor:
    """(B, P) support of k-mer pairs (i, i+d): entry i covers the pair."""
    B, P = valid.shape
    out = torch.zeros((B, P), dtype=torch.bool, device=valid.device)
    if d > 0:
        pair_base, np_ = dbg.pair_base_hashes(cfg, fh, rh, d)
        out[:, :np_] = lookup(graph, cfg, pair_base) & valid[..., :np_] & valid[..., d:]
    return out


def _pair_support_both(graph: GraphState, cfg: GraphConfig, codes, d_frag: int, d_read: int) -> np.ndarray:
    fh, rh, _, valid = dbg.seq_hashes(cfg, _on_device(codes, graph))
    planes = [
        _pair_plane(graph, cfg, fh, rh, valid, d_frag if graph.fpkbf is not None else 0, dbg.lookup_fragment_pair),
        _pair_plane(graph, cfg, fh, rh, valid, d_read if graph.rpkbf is not None else 0, dbg.lookup_read_pair),
    ]
    return torch.stack(planes).cpu().numpy()


def pair_support_both(graph, cfg: GraphConfig, codes, d_frag: int, d_read: int) -> np.ndarray:
    """(2, B, P) bool: fragment- then read-pair support planes (a missing
    filter answers a False plane)."""
    _tick("query")
    if not is_sharded(graph):
        return _pair_support_both(graph, cfg, codes, d_frag, d_read)
    if _use_replicated():
        return _pair_support_both(_replicated_graph(graph, cfg), cfg, codes, d_frag, d_read)
    from ..parallel import sharded

    out, B = _routed(graph, lambda mesh: sharded.sharded_pair_support(mesh, cfg, d_frag, d_read), codes)
    return out[:, :B].cpu().numpy()


def _counts_and_read_support(graph: GraphState, cfg: GraphConfig, codes):
    fh, rh, base, valid = dbg.seq_hashes(cfg, _on_device(codes, graph))
    counts = torch.where(valid, dbg.get_counts(graph, cfg, base), 0.0)
    d = cfg.read_pair_distance if graph.rpkbf is not None else 0
    sup = _pair_plane(graph, cfg, fh, rh, valid, d, dbg.lookup_read_pair)
    return counts.cpu().numpy(), valid.cpu().numpy(), sup.cpu().numpy()


def counts_and_read_support(graph, cfg: GraphConfig, codes):
    """(counts, valid, read-pair support) as numpy, from one hashing pass
    (the routed mesh queries take two programs, as in the JAX package)."""
    _tick("query")
    if not is_sharded(graph):
        return _counts_and_read_support(graph, cfg, codes)
    if _use_replicated():
        return _counts_and_read_support(_replicated_graph(graph, cfg), cfg, codes)
    sup = pair_support_both(graph, cfg, codes, 0, cfg.read_pair_distance)[1]
    counts, valid = count_step(graph, cfg, codes)
    return counts.cpu().numpy(), valid.cpu().numpy(), sup


def _variant_exists(graph: GraphState, cfg: GraphConfig, codes) -> Tuple[np.ndarray, np.ndarray]:
    codes = _on_device(codes, graph)
    fh, rh, _, valid = dbg.seq_hashes(cfg, codes)
    P = fh.shape[-1]
    last = codes[:, cfg.k - 1 : cfg.k - 1 + P]
    first = codes[:, :P]
    hit = torch.zeros_like(valid)
    for variants, cur in ((nthash.variant_hashes_right, last), (nthash.variant_hashes_left, first)):
        f4, r4 = variants(fh, cur, cfg.k, rh)
        counts4 = dbg.get_counts(graph, cfg, nthash.canonical(f4, r4))  # (B, P, 4)
        is_self = torch.arange(4, device=codes.device) == cur.long()[..., None]
        hit |= ((counts4 > 0) & ~is_self).any(dim=-1)
    return (hit & valid).cpu().numpy(), valid.cpu().numpy()


def variant_exists(graph, cfg: GraphConfig, codes) -> Tuple[np.ndarray, np.ndarray]:
    """Per k-mer: does any left or right SNV variant exist in the graph?
    (hit, valid) as numpy, both (B, P).

    The reference's isBranchFree (GraphUtils.java:7651-7672) additionally
    requires the variant to have depth > maxTipLength; here, as in the JAX
    package, any existing variant counts as a branch."""
    _tick("query")
    if not is_sharded(graph):
        return _variant_exists(graph, cfg, codes)
    if _use_replicated():
        return _variant_exists(_replicated_graph(graph, cfg), cfg, codes)
    from ..parallel import sharded

    (hit, valid), B = _routed(graph, lambda mesh: sharded.sharded_variant_counts(mesh, cfg), codes)
    return hit[:B].cpu().numpy(), valid[:B].cpu().numpy()


# ---------------------------------------------------------------------------
# walks
# ---------------------------------------------------------------------------


def _take(state: traverse.WalkState, lanes: slice, device) -> traverse.WalkState:
    return traverse.WalkState(*(None if t is None else t[lanes].to(device) for t in state))


def _group_states(graph: MeshGraph, cfg: GraphConfig, gmesh) -> tuple:
    """The filters regrouped ``gmesh.r`` ways (``sharded.group_state``),
    cached until a build or rebuild step rebinds ``graph.state``."""
    from ..parallel import sharded

    cached = graph._groups.get(gmesh.r)
    if cached is not None and cached[0] is graph.state:
        return cached[1]
    graph._groups.clear()  # one graph version's group states at a time
    states = sharded.group_state(gmesh, graph.state, cfg)
    graph._groups[gmesh.r] = (graph.state, states)
    return states


def _pad_lanes(state: traverse.WalkState, pad: int) -> traverse.WalkState:
    """``pad`` copies of lane 0 after the lanes (the JAX package's)."""
    return traverse.WalkState(*(None if t is None else torch.cat([t, t[:1].expand(pad, *t.shape[1:])])
                                for t in state))


def extend_walks(wstate, graph, cfg: GraphConfig, wcfg, min_cov, bound, mode: str = "greedy"):
    """Extend every walk lane to completion (``traverse.extend_walks``).

    On a mesh, as ``RNB_MESH_WALK`` says: ``replicated`` (the default)
    reads replicas of the graph, one a distinct device, the lanes split
    into one contiguous run a device; ``grouped`` reads the filters
    regrouped ``RNB_MESH_GROUP`` ways (the lanes padded with copies of
    lane 0 to a multiple of the shard count, as in the JAX package);
    any other value walks routed (``sharded.sharded_extend_walks``; the
    lanes must split evenly over the shards).  Every lane walks as it
    would on one device."""
    _tick("walk")
    if not is_sharded(graph):
        return traverse.extend_walks(wstate, graph, cfg, wcfg, min_cov, bound, mode=mode)
    from ..parallel import sharded

    walk_env = os.environ.get("RNB_MESH_WALK", "replicated")
    if walk_env == "grouped":
        gmesh = sharded.make_group_mesh(int(os.environ.get("RNB_MESH_GROUP", "2")), graph.mesh)
        states = _group_states(graph, cfg, gmesh)
        W = wstate.pos.shape[0]
        pad = (-W) % graph.mesh.size
        min_cov, bound = traverse.lane_args(wstate, min_cov, bound)
        if pad:
            wstate = _pad_lanes(wstate, pad)
            min_cov, bound = torch.cat([min_cov, min_cov[:1].expand(pad)]), torch.cat([bound, bound[:1].expand(pad)])
        out = sharded.grouped_extend_walks(gmesh, cfg, wcfg, mode)(wstate, states, min_cov, bound)
        return traverse.take_lanes(out, slice(0, W)) if pad else out
    if walk_env != "replicated":
        return sharded.sharded_extend_walks(graph.mesh, cfg, wcfg, mode)(wstate, graph.state, min_cov, bound)
    devices = graph.mesh.distinct
    if len(devices) == 1:
        return traverse.extend_walks(wstate, _replicated_graph(graph, cfg, devices[0]), cfg, wcfg, min_cov, bound,
                                     mode=mode)
    min_cov, bound = traverse.lane_args(wstate, min_cov, bound)
    home, W = wstate.pos.device, wstate.pos.shape[0]
    per = -(-W // len(devices))
    parts = []
    for i, dev in enumerate(devices):
        lanes = slice(i * per, min((i + 1) * per, W))
        if lanes.start >= lanes.stop:
            break
        parts.append(traverse.extend_walks(
            _take(wstate, lanes, dev), _replicated_graph(graph, cfg, dev), cfg, wcfg,
            min_cov[lanes].to(dev), bound[lanes].to(dev), mode=mode))
    return traverse.WalkState(*(
        None if fields[0] is None else torch.cat([t.to(home) for t in fields]) for fields in zip(*parts)))


# ---------------------------------------------------------------------------
# statistics and host transfer (checkpointing)
# ---------------------------------------------------------------------------


def fprs(graph, cfg: GraphConfig) -> dict:
    if not is_sharded(graph):
        return dbg.fprs(graph, cfg)
    from ..parallel import sharded

    return sharded.sharded_fprs(graph.state, cfg)


def to_host_state(graph, cfg: GraphConfig) -> GraphState:
    """The filters in the single-device layout (lanes then trash cell), on
    the CPU: the form checkpoints store.  A mesh's shards are merged, their
    trash cells dropped, and the merged trash zeroed."""
    if not is_sharded(graph):
        return GraphState(*(None if a is None else a.cpu() for a in graph))
    from ..parallel import sharded

    return sharded.replicate_graph(graph.mesh, graph.state, cfg, "cpu")


def from_host_state(state: GraphState, cfg: GraphConfig, mesh) -> MeshGraph:
    """Split a single-device checkpoint into the shards of ``mesh`` (each
    shard's trash zeroed)."""
    from ..parallel import sharded

    n = mesh.size

    def split(arr, in_trash: int, trash: int):
        if arr is None:
            return None
        local = (arr.shape[0] - in_trash) // n
        out = []
        for s, dev in enumerate(mesh.devices):
            shard = torch.zeros(local + trash, dtype=arr.dtype, device=dev)
            shard[:local].copy_(arr[s * local : (s + 1) * local])
            out.append(shard)
        return tuple(out)

    cbf_trash = 128 if cfg.cbf.blocked else 1
    return MeshGraph(mesh=mesh, state=sharded.ShardedGraphState(
        dbgbf=split(state.dbgbf, cfg.dbgbf.trash, 1),
        cbf=split(state.cbf, cfg.cbf.trash, cbf_trash),
        rpkbf=split(state.rpkbf, 1, 1),
        fpkbf=split(state.fpkbf, 1, 1),
    ))
