"""Per-phase wall time of a fit.

``phase_timer`` records a named phase into :class:`Timings`, which the
fit's summary carries.  Work on the card is asynchronous, so a phase on
a CUDA device ends in ``torch.cuda.synchronize()``: the time is the
phase's work, not its enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

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

    def __repr__(self) -> str:
        parts = ", ".join(f"{p}={s:.3f}s" for p, s in self._phases.items())
        return f"Timings({self.root}: {parts})"


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
