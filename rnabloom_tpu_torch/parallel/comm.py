"""Collectives over the shards of a mesh, in one process.

A ``Mesh`` is a list of torch devices, one a shard.  It may name one device
more than once: several shards on one card, or on the CPU in the tests (the
counterpart of the JAX package's virtual 8-device CPU mesh).  Each
collective takes one tensor a shard, on that shard's device, and returns
one a shard, on that shard's device:

  all_to_all  row d of shard s's tensor becomes row s of shard d's
              (``jax.lax.all_to_all`` with split and concat axis 0, tiled)
  all_reduce  every shard gets the sum of the shards' tensors (``psum``)
  gather      the shards' tensors, concatenated on one device (the layout
              change behind replication and checkpoints)

They are ``Tensor.to(device)`` copies: peer to peer between cards, none
within one.  A process group (for a mesh over several hosts) would take
their place behind the same functions.

``accounting()`` counts each all-to-all and all-reduce that runs and the
bytes each moves a shard, under the JAX package's keys
(``sharded.comm_accounting``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """The devices of a mesh's shards, shard s on ``devices[s]``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """Each device once, in the order of its first shard."""
        return tuple(dict.fromkeys(self.devices))


_local = threading.local()  # .counts: this thread's open accounting, or None


@contextlib.contextmanager
def accounting():
    """Count the collectives that this thread runs inside the block::

        with accounting() as comm:
            step(state, codes)
        # comm == {"all_to_all": ..., "psum": ...,
        #          "a2a_bytes_per_shard": ..., "psum_bytes_per_shard": ...}
    """
    prev = getattr(_local, "counts", None)
    _local.counts = {"all_to_all": 0, "psum": 0, "a2a_bytes_per_shard": 0, "psum_bytes_per_shard": 0}
    try:
        yield _local.counts
    finally:
        _local.counts = prev


def _note(kind: str, bytes_key: str, x: torch.Tensor) -> None:
    counts = getattr(_local, "counts", None)
    if counts is not None:
        counts[kind] += 1
        counts[bytes_key] += x.numel() * x.element_size()


def _check(mesh: Mesh, parts: Sequence[torch.Tensor]) -> None:
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} tensors for a mesh of {mesh.size} shards")
    for s, (x, dev) in enumerate(zip(parts, mesh.devices)):
        if x.device != dev:
            raise ValueError(f"shard {s}'s tensor is on {x.device}, its shard on {dev}")


def all_to_all(mesh: Mesh, sends: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """sends[s]: (n, ...) on shard s's device; returns recv with
    recv[d][s] = sends[s][d], on shard d's device."""
    _check(mesh, sends)
    n = mesh.size
    if sends[0].shape[0] != n:
        raise ValueError(f"all_to_all: {sends[0].shape[0]} rows for {n} shards")
    _note("all_to_all", "a2a_bytes_per_shard", sends[0])
    return [torch.stack([sends[s][d].to(dev) for s in range(n)]) for d, dev in enumerate(mesh.devices)]


def all_reduce(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' tensors (integer sums wrap in their dtype, as
    ``psum``'s do), one copy a device: shards on one device share it."""
    _check(mesh, parts)
    _note("psum", "psum_bytes_per_shard", parts[0])
    home = mesh.devices[0]
    total = parts[0].clone()
    for x in parts[1:]:
        total += x.to(home)
    copies = {dev: total.to(dev) for dev in mesh.distinct}
    return [copies[dev] for dev in mesh.devices]


def gather(mesh: Mesh, parts: Sequence[torch.Tensor], device, pad: int = 0) -> torch.Tensor:
    """The shards' 1-D tensors concatenated on ``device``, then ``pad``
    zeros: one buffer, each shard copied into its place."""
    _check(mesh, parts)
    device = torch.device(device)
    total = sum(x.numel() for x in parts)
    out = torch.empty(total + pad, dtype=parts[0].dtype, device=device)
    at = 0
    for x in parts:
        out[at : at + x.numel()].copy_(x.reshape(-1))
        at += x.numel()
    out[total:] = 0
    return out
