"""Column-majority consensus vote of placed reads over unitigs.

Port of the JAX package's ``_vote_kernel``
(``rnabloom_tpu/olc/consensus.py:88-116``), one batch of placed reads:
every read base at unitig position ``start + j`` inside [0, L) adds one
vote to (unitig, position, base) in a zeroed int32 table; then per
(unitig, position) the depth (votes summed), the base of most votes (the
first on a tie, as ``jnp.argmax``) and the polished code: that base where
the depth reaches ``min_depth`` and the unitig holds a base there, else the
unitig's own code.  ``olc/consensus.py::polish`` calls it once per batch of
reads with a fresh table, on the previous batch's polished codes.

``consensus_vote`` launches the hand-written CUDA kernel
(``csrc/lr_kernels.cu``: one pass, a block a unitig's tiles of columns,
the counts in registers, no vote table in device memory) for tensors on
the card, and runs ``consensus_vote_plain`` for tensors on the CPU.
``LAUNCHES`` counts kernel launches; ``launch_timer.recording()`` times
them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import launch_timer

LAUNCHES: Dict[str, int] = {"consensus_vote": 0}


def reset_launch_counts() -> None:
    LAUNCHES["consensus_vote"] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _check(unitigs: torch.Tensor, reads: torch.Tensor, tgt: torch.Tensor, start: torch.Tensor) -> None:
    dev = unitigs.device
    if unitigs.dtype != torch.uint8 or unitigs.dim() != 2 or not unitigs.is_contiguous():
        raise ValueError("consensus_vote: unitigs must be a contiguous (U, L) uint8 tensor")
    if reads.dtype != torch.uint8 or reads.dim() != 2 or not reads.is_contiguous() or reads.device != dev:
        raise ValueError(f"consensus_vote: reads must be a contiguous (R, Lr) uint8 tensor on {dev}")
    for t in (tgt, start):
        if t.dtype != torch.int32 or t.shape != (reads.shape[0],) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"consensus_vote: tgt and start must be contiguous (R,) int32 tensors on {dev}")


def consensus_vote_plain(
    unitigs: torch.Tensor, reads: torch.Tensor, tgt: torch.Tensor, start: torch.Tensor, min_depth: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (any device): (polished (U, L)
    uint8, depth (U, L) int32)."""
    _check(unitigs, reads, tgt, start)
    U, L = unitigs.shape
    Lr = reads.shape[1]
    pos = start.long()[:, None] + torch.arange(Lr, device=reads.device)[None, :]
    valid = (reads < 4) & (pos >= 0) & (pos < L)
    pos = pos.clamp(0, L - 1)
    base = torch.where(valid, reads, 0).long()
    flat = (tgt.long()[:, None] * L + pos) * 4 + base
    votes = torch.zeros(U * L * 4, dtype=torch.int32, device=reads.device)
    votes.index_add_(0, flat.reshape(-1), valid.reshape(-1).to(torch.int32))
    votes = votes.view(U, L, 4)
    depth = votes.sum(dim=-1, dtype=torch.int32)
    winner = torch.argmax(votes, dim=-1).to(torch.uint8)  # the first maximum
    polished = torch.where((depth >= min_depth) & (unitigs < 4), winner, unitigs)
    return polished, depth


def consensus_vote(
    unitigs: torch.Tensor, reads: torch.Tensor, tgt: torch.Tensor, start: torch.Tensor, min_depth: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(polished, depth) of one batch of placed reads (see the module
    docstring).  CPU tensors take the plain version; CUDA tensors launch the
    kernel on the current stream, or raise."""
    if unitigs.device.type == "cpu":
        return consensus_vote_plain(unitigs, reads, tgt, start, min_depth)
    dev = unitigs.device
    if dev.type != "cuda":
        raise ValueError(f"consensus_vote: unsupported device {dev}")
    _check(unitigs, reads, tgt, start)
    from ._build import lr_kernels

    lib = lr_kernels()
    U, L = unitigs.shape
    R, Lr = reads.shape
    polished = torch.empty_like(unitigs)
    depth = torch.empty((U, L), dtype=torch.int32, device=dev)
    begin = launch_timer.begin(dev)
    err = lib.consensus_vote(
        unitigs.data_ptr(), U, L, reads.data_ptr(), R, Lr, tgt.data_ptr(), start.data_ptr(), int(min_depth),
        None, polished.data_ptr(), depth.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    launch_timer.end(begin, dev, "consensus_vote", R * Lr)
    if err != 0:
        raise RuntimeError(f"consensus_vote launch failed: cudaError_t {err}")
    LAUNCHES["consensus_vote"] += 1
    return polished, depth
