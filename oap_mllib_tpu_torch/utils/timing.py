"""Per-phase wall time of a fit.

``phase_timer`` records a named phase into :class:`Timings`, which the
fit's summary carries; a streamed pass records its stage / transfer /
compute split under ``<phase>/...`` (data/prefetch.PrefetchStats).  Work on the card is asynchronous, so a phase on
a CUDA device ends in ``torch.cuda.synchronize()``: the time is the
phase's work, not its enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch


class Timings:
    """Seconds per phase of one fit (repeated phases add up)."""

    def __init__(self, root: str = "fit") -> None:
        self.root = root
        self._phases: Dict[str, float] = {}

    def add(self, phase: str, seconds: float) -> None:
        self._phases[phase] = self._phases.get(phase, 0.0) + seconds

    def as_dict(self) -> Dict[str, float]:
        return dict(self._phases)

    def subphases(self, prefix: str) -> Dict[str, float]:
        """The phases recorded under ``prefix/``, keyed by the rest of
        their name (a streamed pass's ``stage``, ``transfer``,
        ``compute`` and ``stream_wall``, data/prefetch.PrefetchStats)."""
        head = prefix + "/"
        return {p[len(head):]: s for p, s in self._phases.items() if p.startswith(head)}

    def overlap_efficiency(self, prefix: str) -> Optional[float]:
        """The share of a streamed phase's staging (stage + transfer)
        hidden behind the consumer's work, in [0, 1]: 0 when the
        consumer waited out all of it, 1 when it never waited.  None
        when the phase recorded no streamed split."""
        sub = self.subphases(prefix)
        staging = sub.get("stage", 0.0) + sub.get("transfer", 0.0)
        if "stream_wall" not in sub or staging <= 0.0:
            return None
        wait = max(sub["stream_wall"] - sub.get("compute", 0.0), 0.0)
        return max(0.0, min(1.0, 1.0 - wait / staging))

    def __repr__(self) -> str:
        parts = ", ".join(f"{p}={s:.3f}s" for p, s in self._phases.items())
        return f"Timings({self.root}: {parts})"


def tick() -> Callable[[], float]:
    """A duration clock: the seconds since the call, each time the
    returned callable is called."""
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


@contextlib.contextmanager
def phase_timer(timings: Timings, phase: str, device=None):
    """Time one phase; on a CUDA ``device`` (or a list of devices, a
    mesh's) the phase ends in a synchronisation of each."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for dev in (device if isinstance(device, (list, tuple)) else [device]):
            if dev is not None and torch.device(dev).type == "cuda":
                torch.cuda.synchronize(dev)
        timings.add(phase, time.perf_counter() - t0)
