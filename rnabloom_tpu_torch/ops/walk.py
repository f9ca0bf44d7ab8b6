"""Walk loops: every lane of a walk batch extended to completion.

``walk_greedy`` (greedy lookahead resolves), ``walk_pair`` (pair-scored
resolves against the walk's pair ring) and ``walk_naive`` (depth-probed
resolves and, with ``check_back_branches``, back-branch stops) launch the
hand-written CUDA kernel (``csrc/walk_greedy.cu``, a tile of threads per
lane, which states its design) for walks on a CUDA device, and run
``walk_greedy_plain`` / ``walk_pair_plain`` / ``walk_naive_plain`` for walks
on the CPU.  The plain versions are ``graph/traverse.py::
extend_walks_plain``, the JAX package's lockstep loop
(``traverse._extend_walks_fused``) op for op.  Every mode reads exact-count
graphs (a count is ``in dbgbf ? cbf estimate + 1 : 0``) and takes
terminators.

``walk_mesh`` walks over a mesh's shards (the routed and grouped mesh
walks of ``parallel/sharded.py``): on CUDA shards it launches the kernel's
sharded layouts, which read every filter where its shards lie (on the
launching card, or on another card of the host through peer access), one
launch a card that holds lanes; on CPU shards it runs
``walk_mesh_plain``, the lockstep loop over routed reads
(``sharded.ShardedBackend``).  ``LAUNCHES`` counts kernel launches per
mode, the sharded ones apart; ``launch_timer.recording()`` times them on
the card.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import launch_timer, minifloat, nthash

LAUNCHES: Dict[str, int] = {"walk_greedy": 0, "walk_pair": 0, "walk_naive": 0, "walk_greedy_sharded": 0,
                            "walk_pair_sharded": 0, "walk_naive_sharded": 0}
MAX_SHARDS = 32  # csrc/walk_greedy.cu kMaxShards: the shard tables' rows

_LAYOUTS = {"mf8": 0, "u16": 1, "int32": 2}
_I32_BLOCKED = 3
_EXACT = 4  # added to a flat layout: the exact-count gate reads the dbgbf

# mf8 decode table per device: minifloat.decode of every byte
_decode: Dict[torch.device, torch.Tensor] = {}
# (device, shards' base pointers) -> the shard tables on the device
_tables: Dict[tuple, torch.Tensor] = {}
_peers = set()  # (device, peer) card pairs with peer access enabled


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def walk_greedy_plain(state, graph, cfg, wcfg, min_cov, bound, superstep_hops=64, max_supersteps=64,
                      terminators=None):
    """Plain PyTorch version of the kernel (any device)."""
    from ..graph import traverse

    return traverse.extend_walks_plain(
        state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, terminators=terminators
    )


def walk_pair_plain(state, graph, cfg, wcfg, min_cov, bound, superstep_hops=64, max_supersteps=64,
                    terminators=None):
    """Plain PyTorch version of the kernel in pair mode (any device)."""
    from ..graph import traverse

    return traverse.extend_walks_plain(
        state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, mode="pair",
        terminators=terminators,
    )


def walk_naive_plain(state, graph, cfg, wcfg, min_cov, bound, superstep_hops=64, max_supersteps=64,
                     terminators=None):
    """Plain PyTorch version of the kernel in naive mode (any device)."""
    from ..graph import traverse

    return traverse.extend_walks_plain(
        state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, mode="naive",
        terminators=terminators,
    )


def _decode_table(device: torch.device) -> torch.Tensor:
    t = _decode.get(device)
    if t is None:
        t = _decode[device] = minifloat.decode(torch.arange(256, dtype=torch.uint8, device=device)).contiguous()
    return t


def _check_lanes(t, cfg, what: str, dev) -> None:
    if t.device != dev or t.dtype != torch.uint8 or not t.is_contiguous() or t.dim() != 1:
        raise ValueError(f"{what}: want a contiguous 1-D uint8 tensor on {dev}")
    if t.numel() < cfg.size + 1 or cfg.size_log2 > 32:
        raise ValueError(f"{what}: want 2^{cfg.size_log2} + 1 lanes (size_log2 <= 32), got {t.numel()}")


def _gate_args(graph, cfg, wcfg, terminators) -> list:
    """The kernel's exact-gate and terminator arguments: the dbgbf lanes,
    their size_log2 and num_hash (null: count-min), then the terminator
    lanes, their size_log2 and num_hash (null: no terminators; as in the
    plain loop, terminators stop hops only with ``wcfg.use_terminators``)."""
    dev = graph.cbf.device
    args = [None, 0, 0]
    if cfg.exact_counts:
        if cfg.cbf.blocked:
            raise ValueError("exact counts keep the flat counter layout")
        _check_lanes(graph.dbgbf, cfg.dbgbf, "dbgbf", dev)
        args = [graph.dbgbf.data_ptr(), cfg.dbgbf.size_log2, cfg.dbgbf.num_hash]
    if terminators is None or not wcfg.use_terminators:
        return args + [None, 0, 0]
    if wcfg.term_cfg is None:
        raise ValueError("terminators need their filter's shape (WalkConfig.term_cfg)")
    _check_lanes(terminators, wcfg.term_cfg, "terminators", dev)
    return args + [terminators.data_ptr(), wcfg.term_cfg.size_log2, wcfg.term_cfg.num_hash]


def _check(state, dev, min_cov, bound, wcfg, mode: str) -> None:
    """The walk state, min_cov and bound of a launch on ``dev``."""
    pair = mode == "walk_pair"
    if wcfg.check_back_branches and mode != "walk_naive":
        raise ValueError(f"{mode}: back-branch checks are a naive-mode option")
    W = state.pos.shape[0]
    want = {
        "buf": (torch.uint8, (W, wcfg.max_len)), "pos": (torch.int32, (W,)), "fh": (torch.int64, (W,)),
        "rh": (torch.int64, (W,)), "hist": (torch.int64, (W, wcfg.cycle_window)),
        "status": (torch.int32, (W,)), "hops": (torch.int32, (W,)), "path_min": (torch.float32, (W,)),
    }
    if pair:
        if state.ring_fh is None or wcfg.pair_ring <= 0:
            raise ValueError("pair walks need the pair ring (WalkConfig.pair_ring > 0, make_walks fills it)")
        want.update(ring_fh=(torch.int64, (W, wcfg.pair_ring)), ring_rh=(torch.int64, (W, wcfg.pair_ring)))
    elif state.ring_fh is not None:
        raise ValueError(f"{mode} with a pair ring: no caller writes the ring outside pair mode")
    for name, (dtype, shape) in want.items():
        t = getattr(state, name)
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(
                f"walk state {name}: want {dtype} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    for name, t, dtype in (("min_cov", min_cov, torch.float32), ("bound", bound, torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != (W,) or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dtype} ({W},) tensor on {dev}")


def _check_graph(graph, mode: str) -> None:
    pair = mode == "walk_pair"
    dev = graph.cbf.device
    if not graph.cbf.is_contiguous():
        raise ValueError("the counter table must be contiguous")
    for t in (graph.rpkbf, graph.fpkbf):
        if pair and t is not None and (t.device != dev or t.dtype != torch.uint8 or not t.is_contiguous()):
            raise ValueError(f"pair-key lanes: want a contiguous uint8 tensor on {dev}")


def _pair_args(graph, cfg, wcfg, out) -> list:
    """The kernel's pair-mode arguments: the ring, its length and the probe
    depth; rpkbf and fpkbf (null where a class has no filter or distance),
    the pair-key filter shape and both pair distances (0 where absent)."""
    if not 1 <= wcfg.pair_probe_depth <= cfg.k - 1:
        raise ValueError(f"pair_probe_depth {wcfg.pair_probe_depth} must lie in [1, k - 1 = {cfg.k - 1}]")
    rp = graph.rpkbf is not None and cfg.read_pair_distance > 0
    fp = graph.fpkbf is not None and cfg.fragment_pair_distance > 0
    pk = cfg.pkbf
    return [
        out.ring_fh.data_ptr(), out.ring_rh.data_ptr(), wcfg.pair_ring, wcfg.pair_probe_depth,
        graph.rpkbf.data_ptr() if rp else None, graph.fpkbf.data_ptr() if fp else None,
        pk.size_log2 if pk else 0, pk.num_hash if pk else 0,
        cfg.read_pair_distance if rp else 0, cfg.fragment_pair_distance if fp else 0,
    ]


def _superstep_hops(wcfg, superstep_hops: int) -> int:
    """The kernel's hops a superstep.  With speculative rounds (spec_hops D
    > 1, no back-branch checks) the plain loop runs ceil(h / D) rounds of D
    hops, so h rounded up to a multiple of D; the rounds themselves change
    nothing that the kernel computes (it has no collectives to save)."""
    D = wcfg.spec_hops
    if D > 1 and not wcfg.check_back_branches:
        return -(-superstep_hops // D) * D
    return superstep_hops


def _args(name: str, out, dev, cbf, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, gates, pair_graph):
    """A walk entry's arguments up to its stream (its sharded version adds
    the shard tables): the state ``out`` and ``cbf`` on ``dev``, the gates
    (``_gate_args``), and in pair mode ``pair_graph``'s pair-key lanes."""
    c = cfg.cbf
    layout = _I32_BLOCKED if c.blocked else _LAYOUTS[c.dtype] + (_EXACT if cfg.exact_counts else 0)
    kms = (cfg.k * nthash.MULTI_SEED) & nthash.M64
    args = [
        out.buf.data_ptr(), out.pos.data_ptr(), out.fh.data_ptr(), out.rh.data_ptr(),
        out.hist.data_ptr(), out.status.data_ptr(), out.hops.data_ptr(), out.path_min.data_ptr(),
        min_cov.data_ptr(), bound.data_ptr(),
        out.pos.shape[0], wcfg.max_len, wcfg.cycle_window,
        cbf.data_ptr(), layout, c.size_log2, c.num_hash, _decode_table(dev).data_ptr(), kms,
        cfg.k, int(cfg.stranded), int(wcfg.left), wcfg.lookahead, _superstep_hops(wcfg, superstep_hops),
        max_supersteps, *gates,
    ]
    if name == "walk_pair":
        args += _pair_args(pair_graph, cfg, wcfg, out)
    elif name == "walk_naive":
        args += [wcfg.tip_probe_depth, int(wcfg.check_back_branches)]
    return args


def _run(lib, entry: str, args: list, dev, W: int) -> None:
    """Launch ``entry`` on ``dev``'s current stream, timed; raises when the
    launch fails."""
    with torch.cuda.device(dev):  # the launch goes to its device, whichever is current
        start = launch_timer.begin(dev)
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
        launch_timer.end(start, dev, entry, W)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")
    LAUNCHES[entry] += 1


def _launch(name: str, state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, terminators):
    dev = graph.cbf.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check(state, dev, min_cov, bound, wcfg, name)
    _check_graph(graph, name)
    gates = _gate_args(graph, cfg, wcfg, terminators)
    from ..graph.traverse import clone_state
    from ._build import walk_kernels

    lib = walk_kernels(exact=cfg.exact_counts, greedy=name == "walk_greedy", terminators=gates[3] is not None)
    out = clone_state(state)
    args = _args(name, out, dev, graph.cbf, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, gates, graph)
    _run(lib, name, args, dev, out.pos.shape[0])
    return out


def walk_greedy(state, graph, cfg, wcfg, min_cov, bound, superstep_hops=64, max_supersteps=64, terminators=None):
    """Extend every lane of ``state`` greedily; returns a new WalkState.

    ``min_cov`` (float32) and ``bound`` (int32) are per-lane tensors on the
    walks' device; ``terminators`` (uint8 lanes of shape ``wcfg.term_cfg``,
    or None) stop a hop whose single viable successor they hold.  Walks on the CPU take the plain version; walks on a
    CUDA device launch the kernel on the current stream, or raise."""
    if graph.cbf.device.type == "cpu":
        return walk_greedy_plain(state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, terminators)
    return _launch("walk_greedy", state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, terminators)


def walk_pair(state, graph, cfg, wcfg, min_cov, bound, superstep_hops=64, max_supersteps=64, terminators=None):
    """Extend every lane of ``state`` with pair-scored branch resolution
    (the state carries the pair ring); returns a new WalkState.  Same
    device rule as ``walk_greedy``."""
    if graph.cbf.device.type == "cpu":
        return walk_pair_plain(state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, terminators)
    return _launch("walk_pair", state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, terminators)


def walk_naive(state, graph, cfg, wcfg, min_cov, bound, superstep_hops=64, max_supersteps=64, terminators=None):
    """Extend every lane of ``state`` with naive (depth-probed) branch
    resolution, and back-branch stops when ``wcfg.check_back_branches``;
    returns a new WalkState.  Same device rule as ``walk_greedy``."""
    if graph.cbf.device.type == "cpu":
        return walk_naive_plain(state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, terminators)
    return _launch("walk_naive", state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, terminators)


# ---- walks over a mesh's shards ----


def walk_mesh_plain(mode: str, state, shards, mesh, cfg, wcfg, min_cov, bound, superstep_hops=64,
                    max_supersteps=64):
    """Plain PyTorch version of the sharded kernel (any device): the
    lockstep loop with every filter read routed to the shards."""
    from ..graph import traverse
    from ..parallel import sharded

    return traverse.extend_walks_plain(state, shards, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps,
                                       mode=mode, backend=sharded.ShardedBackend(mesh))


def _shard_filters(shards, cfg, mode: str):
    """(table row, shards, element dtype, elements a shard) of each filter
    that a walk of ``mode`` reads."""
    c = cfg.cbf
    out = [(0, shards.cbf, c.torch_dtype, c.size)]
    if cfg.exact_counts:
        if c.blocked:
            raise ValueError("exact counts keep the flat counter layout")
        out.append((1, shards.dbgbf, torch.uint8, cfg.dbgbf.size))
    if mode == "walk_pair":
        for row, lanes, dist in ((2, shards.rpkbf, cfg.read_pair_distance), (3, shards.fpkbf,
                                                                               cfg.fragment_pair_distance)):
            if lanes is not None and dist > 0:
                out.append((row, lanes, torch.uint8, cfg.pkbf.size))
    return out


def _check_shards(shards, mesh, cfg, mode: str) -> int:
    """Each filter's shards: one a mesh shard, on its device, contiguous,
    of its dtype and ``size / n`` elements plus the trash; returns log2 n."""
    n = mesh.size
    if n > MAX_SHARDS or n & (n - 1):
        raise ValueError(f"{mode}: a mesh of {n} shards (a power of two up to {MAX_SHARDS})")
    for row, parts, dtype, size in _shard_filters(shards, cfg, mode):
        trash = 128 if row == 0 and cfg.cbf.blocked else 1
        if parts is None or len(parts) != n:
            raise ValueError(f"{mode}: filter {row} wants {n} shards")
        for t, dev in zip(parts, mesh.devices):
            if (t.device != dev or t.dtype != dtype or t.dim() != 1 or not t.is_contiguous()
                    or t.numel() != size // n + trash):
                raise ValueError(f"{mode}: a shard of filter {row}: want a contiguous {dtype} tensor of "
                                 f"{size // n} + {trash} elements on {dev}")
    return n.bit_length() - 1


def _shard_table(dev, shards, cfg, mode: str) -> torch.Tensor:
    """The kernel's shard tables on ``dev``: row r holds the base pointers
    of filter r's shards (cbf, dbgbf, rpkbf, fpkbf; 0 where not read)."""
    rows = np.zeros((4, MAX_SHARDS), np.int64)
    for row, parts, _, _ in _shard_filters(shards, cfg, mode):
        rows[row, : len(parts)] = [t.data_ptr() for t in parts]
    key = (dev, rows.tobytes())
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= 64:
            _tables.clear()
        table = _tables[key] = torch.from_numpy(rows).to(dev)
    return table


def _peer_access(lib, devices) -> None:
    """Peer access between every two cards of ``devices`` (a lane reads any
    shard); raises before any launch where a pair has none."""
    pairs = [(a.index, b.index) for a in devices for b in devices if a != b]
    for a, b in pairs:
        if not torch.cuda.can_device_access_peer(a, b):
            raise RuntimeError(f"sharded walks: cuda:{a} has no peer access to cuda:{b}")
    for pair in pairs:
        if pair not in _peers:
            err = lib.walk_peer_access(*pair)
            if err != 0:
                raise RuntimeError(f"sharded walks: enabling peer access {pair} failed: cudaError_t {err}")
            _peers.add(pair)


def _launch_mesh(name: str, state, shards, mesh, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps):
    """One launch of the sharded kernel a distinct device of the mesh: the
    lanes of its shards (shard s holds lanes [s W / n, (s + 1) W / n), as
    the routed engine splits them), every shard read in place; the lanes
    come back to the walks' device."""
    from ..graph import dbg
    from ..graph.traverse import WalkState, clone_state
    from ._build import walk_kernels

    n_log2 = _check_shards(shards, mesh, cfg, name)
    n, W, home = mesh.size, state.pos.shape[0], state.pos.device
    if W % n:
        raise ValueError(f"{name}: {W} walk lanes do not split evenly over {n} shards")
    lib = walk_kernels(exact=cfg.exact_counts, sharded=True)
    devices = mesh.distinct
    _peer_access(lib, devices)
    first = dbg.GraphState(**{f: None if t is None else t[0] for f, t in shards._asdict().items()})  # shard 0's
    gates = [None, 0, 0]
    if cfg.exact_counts:
        gates = [shards.dbgbf[0].data_ptr(), cfg.dbgbf.size_log2, cfg.dbgbf.num_hash]
    gates += [None, 0, 0]
    per = W // n
    parts = []
    for dev in devices:
        lanes = [s for s in range(n) if mesh.devices[s] == dev]
        if len(devices) == 1 and dev == home:
            sub, mc, bd = clone_state(state), min_cov, bound
        else:
            rows = torch.cat([torch.arange(s * per, (s + 1) * per) for s in lanes]).to(home)
            sub = WalkState(*(None if t is None else t[rows].to(dev) for t in state))
            mc, bd = min_cov[rows].to(dev), bound[rows].to(dev)
            parts.append((rows, sub))
        _check(sub, dev, mc, bd, wcfg, name)
        args = _args(name, sub, dev, shards.cbf[0], cfg, wcfg, mc, bd, superstep_hops, max_supersteps, gates,
                     first)
        _run(lib, name + "_sharded", args + [_shard_table(dev, shards, cfg, name).data_ptr(), n_log2], dev,
             sub.pos.shape[0])
    if not parts:
        return sub
    out = clone_state(state)
    for rows, sub in parts:
        for o, t in zip(out, sub):
            if o is not None:
                o[rows] = t.to(home)
    return out


def walk_mesh(mode: str, state, shards, mesh, cfg, wcfg, min_cov, bound, superstep_hops=64, max_supersteps=64):
    """Extend every lane of ``state`` (on one device) over the shards of
    ``mesh`` (``shards``: a ``parallel.sharded.ShardedGraphState``) in
    ``mode``; returns a new WalkState on the state's device.  CPU shards
    take the plain version; CUDA shards launch the sharded kernel, or
    raise (a card without peer access to another, a failed build or
    launch)."""
    name = f"walk_{mode}"
    if name not in ("walk_greedy", "walk_pair", "walk_naive"):
        raise ValueError(f"unknown walk mode {mode!r}")
    kinds = {d.type for d in mesh.devices}
    if kinds == {"cpu"}:
        return walk_mesh_plain(mode, state, shards, mesh, cfg, wcfg, min_cov, bound, superstep_hops,
                               max_supersteps)
    if kinds != {"cuda"}:
        raise ValueError(f"{name}: a mesh of {sorted(kinds)} shards")
    return _launch_mesh(name, state, shards, mesh, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps)
