"""Graph execution engine, single device.

Port of the single-device branches of ``rnabloom_tpu/graph/engine.py``:
pipelines call graph operations through this module, which moves host code
batches to the graph's device and counts dispatches per kind.  The mesh
(multi-device) branches are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import dbg
from .dbg import GraphConfig, GraphState

DISPATCHES = {"build": 0, "query": 0, "walk": 0}


def _tick(kind: str) -> None:
    DISPATCHES[kind] += 1


def dispatch_counts() -> dict:
    return dict(DISPATCHES)


def make_graph(
    cfg: GraphConfig, with_rpkbf: bool = False, with_fpkbf: bool = False, device="cpu"
) -> GraphState:
    return dbg.make_graph(cfg, with_rpkbf=with_rpkbf, with_fpkbf=with_fpkbf, device=device)


def _on_device(codes, graph: GraphState) -> torch.Tensor:
    if isinstance(codes, np.ndarray):
        codes = torch.from_numpy(np.ascontiguousarray(codes))
    return codes.to(graph.cbf.device)


def build_step(graph: GraphState, cfg: GraphConfig, codes, add_read_pairs: bool = False, salt: int = 0):
    _tick("build")
    return dbg.build_step(graph, cfg, _on_device(codes, graph), add_read_pairs=add_read_pairs, salt=salt)


def count_step(graph: GraphState, cfg: GraphConfig, codes) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts (B, P) float32, valid) for every k-mer of a code batch."""
    _tick("query")
    return dbg.count_step(graph, cfg, _on_device(codes, graph))


def fprs(graph: GraphState, cfg: GraphConfig) -> dict:
    return dbg.fprs(graph, cfg)


def to_host_state(graph: GraphState, cfg: GraphConfig) -> GraphState:
    """The filters in the single-device layout (lanes then trash cell), on
    the CPU — the form checkpoints store."""
    return GraphState(*(None if a is None else a.cpu() for a in graph))
