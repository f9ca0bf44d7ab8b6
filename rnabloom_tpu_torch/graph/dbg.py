"""Implicit de Bruijn graph over Bloom structures — tensors on one device.

Port of ``rnabloom_tpu/graph/dbg.py`` for the count-min mode
(``exact_counts=False``, the default): the graph is a bundle of filter
arrays (cbf counters, read/fragment pair-key bit lanes) plus static hash
config, and every insert or query is a batched hash -> index pipeline.
Membership is count > 0; there is no dbgbf array.

Inserts update the state's tensors in place (the JAX package donates them
to the jitted step instead).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from ..bloom import filters
from ..bloom.filters import BloomConfig, CountingConfig
from ..ops import nthash

_EXACT = (
    "exact_counts=True (dbgbf + conservative-update counters) is not ported; "
    "the count-min default is"
)


@dataclass(frozen=True)
class GraphConfig:
    """Static graph parameters (same fields as the JAX package's)."""

    k: int
    stranded: bool
    dbgbf: BloomConfig
    cbf: CountingConfig
    pkbf: Optional[BloomConfig] = None  # shared shape for rpkbf/fpkbf
    read_pair_distance: int = -1
    fragment_pair_distance: int = -1
    exact_counts: bool = False


class GraphState(NamedTuple):
    """Filter arrays of the implicit graph."""

    dbgbf: Optional[torch.Tensor]  # always None (count-min mode)
    cbf: torch.Tensor
    rpkbf: Optional[torch.Tensor] = None
    fpkbf: Optional[torch.Tensor] = None


def make_graph(
    cfg: GraphConfig, with_rpkbf: bool = False, with_fpkbf: bool = False, *, device
) -> GraphState:
    if cfg.exact_counts:
        raise NotImplementedError(_EXACT)
    return GraphState(
        dbgbf=None,
        cbf=filters.make_counting(cfg.cbf, device=device),
        rpkbf=filters.make_bloom(cfg.pkbf, device=device) if with_rpkbf else None,
        fpkbf=filters.make_bloom(cfg.pkbf, device=device) if with_fpkbf else None,
    )


def seq_hashes(cfg: GraphConfig, codes: torch.Tensor):
    """(fh, rh, base, valid) for every k-mer window of a code batch."""
    fh, rh, valid = nthash.rolling_hash(codes, cfg.k, cfg.stranded)
    return fh, rh, nthash.canonical(fh, rh), valid


def _multi(cfg: GraphConfig, base: torch.Tensor, m: int) -> torch.Tensor:
    return nthash.multi_hash(base, cfg.k, m)


def pair_base_hashes(
    cfg: GraphConfig, fh: torch.Tensor, rh: Optional[torch.Tensor], distance: int
) -> Tuple[torch.Tensor, int]:
    """Combined pair hash of k-mers (i, i+distance) along the last axis.
    Returns (pair_base (..., P-distance), P-distance)."""
    np_ = fh.shape[-1] - distance
    assert np_ >= 1, "sequence shorter than pair distance"
    fl, fr = fh[..., :np_], fh[..., distance:]
    if cfg.stranded or rh is None:
        return nthash.combine(fl, fr), np_
    return nthash.combine_canonical(fl, rh[..., :np_], fr, rh[..., distance:]), np_


def add_kmers(state: GraphState, cfg: GraphConfig, base, valid, salt: int = 0) -> GraphState:
    """Count k-mer occurrences into the cbf; ``salt`` (the batch counter)
    keys the mf8 stochastic rounding."""
    if cfg.exact_counts:
        raise NotImplementedError(_EXACT)
    h_cbf = _multi(cfg, base, cfg.cbf.num_hash)
    filters.counting_increment_cm(state.cbf, cfg.cbf, h_cbf, valid=valid, salt=salt)
    return state


def _add_pair_kmers(lanes: torch.Tensor, cfg: GraphConfig, fh, rh, valid, d: int) -> None:
    """Insert the keys of k-mer pairs (i, i + d) into ``lanes``."""
    pair_base, np_ = pair_base_hashes(cfg, fh, rh, d)
    pv = valid[..., :np_] & valid[..., d:]
    filters.bloom_add(lanes, cfg.pkbf, _multi(cfg, pair_base, cfg.pkbf.num_hash), pv)


def add_read_pair_kmers(state: GraphState, cfg: GraphConfig, fh, rh, valid) -> GraphState:
    """Insert read-distance paired k-mer keys into rpkbf."""
    assert state.rpkbf is not None and cfg.read_pair_distance > 0
    _add_pair_kmers(state.rpkbf, cfg, fh, rh, valid, cfg.read_pair_distance)
    return state


def add_fragment_pair_kmers(state: GraphState, cfg: GraphConfig, fh, rh, valid) -> GraphState:
    """Insert fragment-distance paired k-mer keys into fpkbf."""
    assert state.fpkbf is not None and cfg.fragment_pair_distance > 0
    _add_pair_kmers(state.fpkbf, cfg, fh, rh, valid, cfg.fragment_pair_distance)
    return state


def build_step(
    state: GraphState, cfg: GraphConfig, codes: torch.Tensor,
    add_read_pairs: bool = False, salt: int = 0,
) -> GraphState:
    """One stage-1 step: hash a (B, L) uint8 code batch and insert it into
    the counters (and the read-pair keys)."""
    fh, rh, base, valid = seq_hashes(cfg, codes)
    state = add_kmers(state, cfg, base, valid, salt=salt)
    if add_read_pairs and state.rpkbf is not None and cfg.read_pair_distance > 0:
        state = add_read_pair_kmers(state, cfg, fh, rh, valid)
    return state


def rebuild_step(
    state: GraphState, cfg: GraphConfig, codes: torch.Tensor,
    add_frag_pairs: bool = True, salt: int = 0,
) -> GraphState:
    """One stage-2b step (the fragment-graph rebuild): hash a (B, L) uint8
    fragment batch and insert it into the counters (and the fragment-pair
    keys)."""
    fh, rh, base, valid = seq_hashes(cfg, codes)
    state = add_kmers(state, cfg, base, valid, salt=salt)
    if add_frag_pairs and state.fpkbf is not None and cfg.fragment_pair_distance > 0:
        state = add_fragment_pair_kmers(state, cfg, fh, rh, valid)
    return state


def get_counts(state: GraphState, cfg: GraphConfig, base: torch.Tensor) -> torch.Tensor:
    """Float32 count per k-mer (count-min estimate)."""
    if cfg.exact_counts:
        raise NotImplementedError(_EXACT)
    est = filters.counting_count(state.cbf, cfg.cbf, _multi(cfg, base, cfg.cbf.num_hash))
    return est.to(torch.float32)


def contains(state: GraphState, cfg: GraphConfig, base: torch.Tensor) -> torch.Tensor:
    """Membership per k-mer: count-min estimate > 0."""
    if cfg.exact_counts:
        raise NotImplementedError(_EXACT)
    return filters.counting_count(state.cbf, cfg.cbf, _multi(cfg, base, cfg.cbf.num_hash)) > 0


def lookup_pair(lanes: torch.Tensor, cfg: GraphConfig, pair_base: torch.Tensor) -> torch.Tensor:
    """Membership of pair keys in a pair-key filter (rpkbf or fpkbf)."""
    return filters.bloom_lookup(lanes, cfg.pkbf, _multi(cfg, pair_base, cfg.pkbf.num_hash))


def lookup_read_pair(state: GraphState, cfg: GraphConfig, pair_base: torch.Tensor) -> torch.Tensor:
    return lookup_pair(state.rpkbf, cfg, pair_base)


def lookup_fragment_pair(state: GraphState, cfg: GraphConfig, pair_base: torch.Tensor) -> torch.Tensor:
    return lookup_pair(state.fpkbf, cfg, pair_base)


def count_step(
    state: GraphState, cfg: GraphConfig, codes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counts for every k-mer of a code batch: (counts (B, P) float32, valid)."""
    _, _, base, valid = seq_hashes(cfg, codes)
    counts = get_counts(state, cfg, base)
    return torch.where(valid, counts, 0.0), valid


def fprs(state: GraphState, cfg: GraphConfig) -> dict:
    out = {"cbf": filters.counting_fpr(state.cbf, cfg.cbf)}
    if state.rpkbf is not None:
        out["rpkbf"] = filters.bloom_fpr(state.rpkbf, cfg.pkbf)
    if state.fpkbf is not None:
        out["fpkbf"] = filters.bloom_fpr(state.fpkbf, cfg.pkbf)
    return out
