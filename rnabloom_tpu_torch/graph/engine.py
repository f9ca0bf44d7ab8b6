"""Graph execution engine, single device.

Port of the single-device branches of ``rnabloom_tpu/graph/engine.py``:
pipelines call graph operations through this module, which moves host code
batches to the graph's device and counts dispatches per kind.  Queries
return numpy, as the JAX package's do.  The mesh (multi-device) branches
are not ported yet.
"""

from __future__ import annotations

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


def make_graph(
    cfg: GraphConfig, with_rpkbf: bool = False, with_fpkbf: bool = False, *, device
) -> GraphState:
    return dbg.make_graph(cfg, with_rpkbf=with_rpkbf, with_fpkbf=with_fpkbf, device=device)


def _on_device(codes, graph: GraphState) -> torch.Tensor:
    if isinstance(codes, np.ndarray):
        codes = torch.from_numpy(np.ascontiguousarray(codes))
    return codes.to(graph.cbf.device)


def build_step(graph: GraphState, cfg: GraphConfig, codes, add_read_pairs: bool = False, salt: int = 0):
    _tick("build")
    return dbg.build_step(graph, cfg, _on_device(codes, graph), add_read_pairs=add_read_pairs, salt=salt)


def rebuild_step(graph: GraphState, cfg: GraphConfig, codes, add_frag_pairs: bool = True, salt: int = 0):
    """One stage-2b step: a fragment batch into the counters (and the
    fragment-pair keys); the graph's tensors are updated in place."""
    _tick("build")
    return dbg.rebuild_step(graph, cfg, _on_device(codes, graph), add_frag_pairs=add_frag_pairs, salt=salt)


def fresh_rebuild_state(
    graph: GraphState, cfg: GraphConfig, keep_rpkbf: bool = True, with_fpkbf: bool = True,
    copy_rpkbf: bool = False,
) -> GraphState:
    """Zeroed counters (and a fresh fpkbf) for the stage-2b fragment graph
    on the graph's device, keeping the read-pair keys
    (populateGraphFromFragments).  ``copy_rpkbf`` copies the read-pair lanes
    instead of sharing them with ``graph`` (the rebuild never writes them;
    the JAX package copies them against buffer donation)."""
    rpk = graph.rpkbf if keep_rpkbf else None
    if rpk is not None and copy_rpkbf:
        rpk = rpk.clone()
    return GraphState(
        dbgbf=None,
        cbf=torch.zeros_like(graph.cbf),
        rpkbf=rpk,
        fpkbf=filters.make_bloom(cfg.pkbf, device=graph.cbf.device) if with_fpkbf else None,
    )


def count_step(graph: GraphState, cfg: GraphConfig, codes) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts (B, P) float32, valid) for every k-mer of a code batch."""
    _tick("query")
    return dbg.count_step(graph, cfg, _on_device(codes, graph))


def _pair_plane(graph: GraphState, cfg: GraphConfig, fh, rh, valid, d: int, lookup) -> torch.Tensor:
    """(B, P) support of k-mer pairs (i, i+d): entry i covers the pair."""
    B, P = valid.shape
    out = torch.zeros((B, P), dtype=torch.bool, device=valid.device)
    if d > 0:
        pair_base, np_ = dbg.pair_base_hashes(cfg, fh, rh, d)
        out[:, :np_] = lookup(graph, cfg, pair_base) & valid[..., :np_] & valid[..., d:]
    return out


def pair_support_both(graph: GraphState, cfg: GraphConfig, codes, d_frag: int, d_read: int) -> np.ndarray:
    """(2, B, P) bool: fragment- then read-pair support planes."""
    _tick("query")
    fh, rh, _, valid = dbg.seq_hashes(cfg, _on_device(codes, graph))
    planes = [
        _pair_plane(graph, cfg, fh, rh, valid, d_frag, dbg.lookup_fragment_pair),
        _pair_plane(graph, cfg, fh, rh, valid, d_read, dbg.lookup_read_pair),
    ]
    return torch.stack(planes).cpu().numpy()


def counts_and_read_support(graph: GraphState, cfg: GraphConfig, codes):
    """(counts, valid, read-pair support) as numpy, from one hashing pass."""
    _tick("query")
    fh, rh, base, valid = dbg.seq_hashes(cfg, _on_device(codes, graph))
    counts = torch.where(valid, dbg.get_counts(graph, cfg, base), 0.0)
    d = cfg.read_pair_distance if graph.rpkbf is not None else 0
    sup = _pair_plane(graph, cfg, fh, rh, valid, d, dbg.lookup_read_pair)
    return counts.cpu().numpy(), valid.cpu().numpy(), sup.cpu().numpy()


def variant_exists(graph: GraphState, cfg: GraphConfig, codes) -> Tuple[np.ndarray, np.ndarray]:
    """Per k-mer: does any left or right SNV variant exist in the graph?
    (hit, valid) as numpy, both (B, P).

    The reference's isBranchFree (GraphUtils.java:7651-7672) additionally
    requires the variant to have depth > maxTipLength; here, as in the JAX
    package, any existing variant counts as a branch."""
    _tick("query")
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


def extend_walks(wstate, graph: GraphState, cfg: GraphConfig, wcfg, min_cov, bound, mode: str = "greedy"):
    """Extend every walk lane to completion (``traverse.extend_walks``)."""
    _tick("walk")
    return traverse.extend_walks(wstate, graph, cfg, wcfg, min_cov, bound, mode=mode)


def fprs(graph: GraphState, cfg: GraphConfig) -> dict:
    return dbg.fprs(graph, cfg)


def to_host_state(graph: GraphState, cfg: GraphConfig) -> GraphState:
    """The filters in the single-device layout (lanes then trash cell), on
    the CPU — the form checkpoints store."""
    return GraphState(*(None if a is None else a.cpu() for a in graph))
