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
terminators.  ``LAUNCHES`` counts kernel launches per mode;
``launch_timer.recording()`` times them on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import launch_timer, minifloat, nthash

LAUNCHES: Dict[str, int] = {"walk_greedy": 0, "walk_pair": 0, "walk_naive": 0}

_LAYOUTS = {"mf8": 0, "u16": 1, "int32": 2}
_I32_BLOCKED = 3
_EXACT = 4  # added to a flat layout: the exact-count gate reads the dbgbf

# mf8 decode table per device: minifloat.decode of every byte
_decode: Dict[torch.device, torch.Tensor] = {}


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


def _check(state, graph, min_cov, bound, wcfg, mode: str) -> None:
    pair = mode == "walk_pair"
    if wcfg.check_back_branches and mode != "walk_naive":
        raise ValueError(f"{mode}: back-branch checks are a naive-mode option")
    dev = graph.cbf.device
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


def _launch(name: str, state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps, terminators):
    pair = name == "walk_pair"
    dev = graph.cbf.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check(state, graph, min_cov, bound, wcfg, name)
    gates = _gate_args(graph, cfg, wcfg, terminators)
    from ..graph.traverse import clone_state
    from ._build import walk_kernels

    lib = walk_kernels(exact=cfg.exact_counts, greedy=name == "walk_greedy", terminators=gates[3] is not None)
    out = clone_state(state)
    c = cfg.cbf
    layout = _I32_BLOCKED if c.blocked else _LAYOUTS[c.dtype] + (_EXACT if cfg.exact_counts else 0)
    kms = (cfg.k * nthash.MULTI_SEED) & nthash.M64
    args = [
        out.buf.data_ptr(), out.pos.data_ptr(), out.fh.data_ptr(), out.rh.data_ptr(),
        out.hist.data_ptr(), out.status.data_ptr(), out.hops.data_ptr(), out.path_min.data_ptr(),
        min_cov.data_ptr(), bound.data_ptr(),
        out.pos.shape[0], wcfg.max_len, wcfg.cycle_window,
        graph.cbf.data_ptr(), layout, c.size_log2, c.num_hash, _decode_table(dev).data_ptr(), kms,
        cfg.k, int(cfg.stranded), int(wcfg.left), wcfg.lookahead, superstep_hops, max_supersteps, *gates,
    ]
    if pair:
        args += _pair_args(graph, cfg, wcfg, out)
    elif name == "walk_naive":
        args += [wcfg.tip_probe_depth, int(wcfg.check_back_branches)]
    with torch.cuda.device(dev):  # the launch goes to the graph's device, whichever is current
        start = launch_timer.begin(dev)
        err = getattr(lib, name)(*args, torch.cuda.current_stream(dev).cuda_stream)
        launch_timer.end(start, dev, name, out.pos.shape[0])
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
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
