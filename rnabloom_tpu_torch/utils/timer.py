"""Stage timing + progress reporting (util/Timer.java equivalent).

The port's copy of ``rnabloom_tpu/utils/timer.py``, plus named spans:
``span(name)`` adds the wall time of its block to ``SPANS[name]`` (always
on; a caller reads ``span_totals()`` before and after the work it splits).
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict

SPANS: Dict[str, float] = {}


@contextlib.contextmanager
def span(name: str):
    """Add the wall time of the block to ``SPANS[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SPANS[name] = SPANS.get(name, 0.0) + time.perf_counter() - t0


def span_totals() -> Dict[str, float]:
    return dict(SPANS)


def dhms(seconds: float) -> str:
    """Wall-clock formatting matching the reference's DHMS style."""
    s = int(seconds)
    d, s = divmod(s, 86400)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    parts = []
    if d:
        parts.append(f"{d}d")
    if h or d:
        parts.append(f"{h}h")
    if m or h or d:
        parts.append(f"{m}m")
    parts.append(f"{s}s")
    return " ".join(parts)


class Timer:
    def __init__(self, quiet: bool = False):
        self._t0 = time.time()
        self._stage_t0 = self._t0
        self.quiet = quiet

    def start(self, stage: str) -> None:
        self._stage_t0 = time.time()
        self._log(f"> {stage}")

    def done(self, stage: str, extra: str = "") -> None:
        dt = time.time() - self._stage_t0
        msg = f"  {stage} in {dhms(dt)}"
        if extra:
            msg += f" ({extra})"
        self._log(msg)

    def total(self) -> float:
        return time.time() - self._t0

    def _log(self, msg: str) -> None:
        if not self.quiet:
            print(msg, file=sys.stderr, flush=True)
