"""Card time of the kernels' launches, recorded only when asked for.

Off by default.  Inside ``with recording() as rec:`` each kernel wrapper
(``ops/walk.py``, ``ops/cell_insert.py``) records a pair of CUDA events on
its stream around each launch, without synchronising, tagged with the
launch's name and size (a walk's lanes, an insert's indices).
``rec.times()`` synchronises once and returns ``(name, size, ms)`` per
launch, in launch order.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch


class Recorder:
    def __init__(self) -> None:
        self.launches: List[tuple] = []  # (name, size, start event, stop event)

    def times(self) -> List[Tuple[str, int, float]]:
        torch.cuda.synchronize()
        return [(name, size, start.elapsed_time(stop)) for name, size, start, stop in self.launches]


_active: Optional[Recorder] = None


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record every launch made inside the block."""
    global _active
    rec, outer = Recorder(), _active
    _active = rec
    try:
        yield rec
    finally:
        _active = outer


def begin(device: torch.device):
    """The start event of a launch on ``device``'s current stream, or None
    when nothing is recording."""
    if _active is None:
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    return start


def end(start, device: torch.device, name: str, size: int) -> None:
    """Close the launch that ``begin`` opened (nothing when it returned None)."""
    if start is None or _active is None:
        return
    stop = torch.cuda.Event(enable_timing=True)
    stop.record(torch.cuda.current_stream(device))
    _active.launches.append((name, size, start, stop))
