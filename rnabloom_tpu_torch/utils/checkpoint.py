"""Graph checkpointing and stage stamps.

Port of ``rnabloom_tpu/utils/checkpoint.py`` in the same on-disk format:
``{prefix}.graph.json`` (the GraphConfig as JSON) plus one ``.npy`` per
filter array, trash cells included.  int32 counters are stored as
MiniFloat bytes (codec "minifloat"); mf8 and u16 counters are stored raw,
u16 as uint16.  A checkpoint written by either package loads in the other.

The JAX package on a TPU writes filters in its merge layout (``merge:
true`` in a filter's descriptor, and a trash block after the ``size``
cells).  The port loads them as its scatter layout: the first ``size``
cells, then one zeroed trash cell (``bloom_indices`` masks every query
into the first ``size``), so such a checkpoint saved again by the port has
``merge: false`` and one trash cell.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict

import numpy as np
import torch

from ..bloom.filters import BloomConfig, CountingConfig
from ..graph import dbg
from ..graph.engine import require_device
from ..ops import minifloat

STAMP_STARTED = "STARTED"
STAMP_DBG_DONE = "DBG.DONE"
STAMP_FRAGMENTS_DONE = "FRAGMENTS.DONE"
STAMP_TRANSCRIPTS_DONE = "TRANSCRIPTS.DONE"
STAMP_TRANSCRIPTS_NR_DONE = "TRANSCRIPTS_NR.DONE"
STAMP_LONGREADS_CORRECTED = "LONGREADS.CORRECTED"
STAMP_LONGREADS_ASSEMBLED = "LONGREADS.ASSEMBLED"

_NAMES = ("dbgbf", "cbf", "rpkbf", "fpkbf")


def touch_stamp(outdir: str, name: str) -> None:
    with open(os.path.join(outdir, name), "w") as f:
        f.write("")


def has_stamp(outdir: str, name: str) -> bool:
    return os.path.exists(os.path.join(outdir, name))


def clear_stamps(outdir: str) -> None:
    for name in (
        STAMP_STARTED, STAMP_DBG_DONE, STAMP_FRAGMENTS_DONE,
        STAMP_TRANSCRIPTS_DONE, STAMP_TRANSCRIPTS_NR_DONE,
        STAMP_LONGREADS_CORRECTED, STAMP_LONGREADS_ASSEMBLED,
    ):
        p = os.path.join(outdir, name)
        if os.path.exists(p):
            os.remove(p)


def save_graph(prefix: str, state: dbg.GraphState, cfg: dbg.GraphConfig) -> None:
    """Persist the graph: {prefix}.graph.json + per-filter .npy arrays."""
    desc = {
        "k": cfg.k,
        "stranded": cfg.stranded,
        "exact_counts": cfg.exact_counts,
        "read_pair_distance": cfg.read_pair_distance,
        "fragment_pair_distance": cfg.fragment_pair_distance,
        "dbgbf": asdict(cfg.dbgbf),
        "cbf": asdict(cfg.cbf),
        "pkbf": asdict(cfg.pkbf) if cfg.pkbf else None,
        "filters": {},
        "codecs": {},
    }
    for name in _NAMES:
        arr = getattr(state, name)
        if arr is None:
            continue
        path = f"{prefix}.{name}.npy"
        arr = arr.cpu()
        if name == "cbf" and cfg.cbf.dtype == "int32":
            arr = minifloat.encode(arr)
            desc["codecs"][name] = "minifloat"
        host = arr.numpy()
        if name == "cbf" and cfg.cbf.dtype == "u16":
            host = host.view(np.uint16)
        np.save(path, host)
        desc["filters"][name] = os.path.basename(path)
    with open(f"{prefix}.graph.json", "w") as f:
        json.dump(desc, f, indent=1)


def update_fragment_distance(prefix: str, d: int) -> None:
    """Persist the stage-2-learned fragment pair distance into the desc."""
    path = f"{prefix}.graph.json"
    with open(path) as f:
        desc = json.load(f)
    desc["fragment_pair_distance"] = d
    with open(path, "w") as f:
        json.dump(desc, f, indent=1)


def load_graph(prefix: str, device="cuda"):
    """Restore (state, cfg) from a save_graph checkpoint onto ``device``:
    the card unless the caller asks for the CPU; raises without a card.
    Filters saved in the merge layout come back in the scatter layout."""
    device = require_device(device)
    with open(f"{prefix}.graph.json") as f:
        desc = json.load(f)

    def scatter(fields):  # the config in the scatter layout
        return {**fields, "merge": False}

    cfg = dbg.GraphConfig(
        k=desc["k"],
        stranded=desc["stranded"],
        exact_counts=desc["exact_counts"],
        read_pair_distance=desc["read_pair_distance"],
        fragment_pair_distance=desc["fragment_pair_distance"],
        dbgbf=BloomConfig(**scatter(desc["dbgbf"])),
        cbf=CountingConfig(**scatter(desc["cbf"])),
        pkbf=BloomConfig(**scatter(desc["pkbf"])) if desc["pkbf"] else None,
    )
    # filter -> its cell count when its descriptor has the merge layout
    merged = {
        name: fields["size_log2"]
        for name, fields in (("dbgbf", desc["dbgbf"]), ("cbf", desc["cbf"]), ("rpkbf", desc["pkbf"]),
                             ("fpkbf", desc["pkbf"]))
        if fields and fields.get("merge")
    }
    arrays = {}
    base = os.path.dirname(prefix)
    codecs = desc.get("codecs", {})
    for name in _NAMES:
        fname = desc["filters"].get(name)
        if not fname:
            arrays[name] = None
            continue
        host = np.load(os.path.join(base, fname))
        if name in merged:
            host = np.concatenate([host[: 1 << merged[name]], np.zeros(1, host.dtype)])
        if host.dtype == np.uint16:
            host = host.view(np.int16)
        arr = torch.from_numpy(host)
        if codecs.get(name) == "minifloat":
            arr = torch.round(minifloat.decode(arr)).to(torch.int32)
        arrays[name] = arr.to(device)
    return dbg.GraphState(**arrays), cfg
