"""Greedy walk loop: every lane of a walk batch extended to completion.

``walk_greedy`` launches the hand-written CUDA kernel
(``csrc/walk_greedy.cu``, a tile of threads per lane, which states its
design) for walks on a CUDA device, and runs ``walk_greedy_plain`` for walks on
the CPU.  The plain version is ``graph/traverse.py::extend_walks_plain``,
the JAX package's lockstep loop (``traverse._extend_walks_fused``) op for
op.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import minifloat, nthash

LAUNCHES: Dict[str, int] = {"walk_greedy": 0}

_LAYOUTS = {"mf8": 0, "u16": 1, "int32": 2}
_I32_BLOCKED = 3

# mf8 decode table per device: minifloat.decode of every byte
_decode: Dict[torch.device, torch.Tensor] = {}


def reset_launch_counts() -> None:
    LAUNCHES["walk_greedy"] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def walk_greedy_plain(state, graph, cfg, wcfg, min_cov, bound, superstep_hops=64, max_supersteps=64):
    """Plain PyTorch version of the kernel (any device)."""
    from ..graph import traverse

    return traverse.extend_walks_plain(state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps)


def _decode_table(device: torch.device) -> torch.Tensor:
    t = _decode.get(device)
    if t is None:
        t = _decode[device] = minifloat.decode(torch.arange(256, dtype=torch.uint8, device=device)).contiguous()
    return t


def _check(state, graph, min_cov, bound, wcfg) -> None:
    dev = graph.cbf.device
    W = state.pos.shape[0]
    want = {
        "buf": (torch.uint8, (W, wcfg.max_len)), "pos": (torch.int32, (W,)), "fh": (torch.int64, (W,)),
        "rh": (torch.int64, (W,)), "hist": (torch.int64, (W, wcfg.cycle_window)),
        "status": (torch.int32, (W,)), "hops": (torch.int32, (W,)), "path_min": (torch.float32, (W,)),
    }
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


def walk_greedy(state, graph, cfg, wcfg, min_cov, bound, superstep_hops=64, max_supersteps=64):
    """Extend every lane of ``state`` greedily; returns a new WalkState.

    ``min_cov`` (float32) and ``bound`` (int32) are per-lane tensors on the
    walks' device.  Walks on the CPU take the plain version; walks on a
    CUDA device launch the kernel on the current stream, or raise."""
    dev = graph.cbf.device
    if dev.type == "cpu":
        return walk_greedy_plain(state, graph, cfg, wcfg, min_cov, bound, superstep_hops, max_supersteps)
    if dev.type != "cuda":
        raise ValueError(f"walk_greedy: unsupported device {dev}")
    _check(state, graph, min_cov, bound, wcfg)
    from ..graph.traverse import clone_state
    from ._build import walk_kernels

    lib = walk_kernels()
    out = clone_state(state)
    c = cfg.cbf
    layout = _I32_BLOCKED if c.blocked else _LAYOUTS[c.dtype]
    kms = (cfg.k * nthash.MULTI_SEED) & nthash.M64
    err = lib.walk_greedy(
        out.buf.data_ptr(), out.pos.data_ptr(), out.fh.data_ptr(), out.rh.data_ptr(),
        out.hist.data_ptr(), out.status.data_ptr(), out.hops.data_ptr(), out.path_min.data_ptr(),
        min_cov.data_ptr(), bound.data_ptr(),
        out.pos.shape[0], wcfg.max_len, wcfg.cycle_window,
        graph.cbf.data_ptr(), layout, c.size_log2, c.num_hash, _decode_table(dev).data_ptr(), kms,
        cfg.k, int(cfg.stranded), int(wcfg.left), wcfg.lookahead, superstep_hops, max_supersteps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"walk_greedy launch failed: cudaError_t {err}")
    LAUNCHES["walk_greedy"] += 1
    return out
