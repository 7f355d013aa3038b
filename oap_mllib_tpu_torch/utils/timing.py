"""Per-phase wall time of a fit, stored as a span tree (the JAX
package's ``utils/timing.py``).

``Timings`` owns a root span named after the fit (``kmeans.fit``, ...;
telemetry/spans.py); ``add`` and ``phase_timer`` record ``a/b`` phase
paths as nested spans, and ``as_dict``, ``subphases``,
``overlap_efficiency`` and ``compile_split`` are views over the tree
that return what the JAX package's return for the same recordings.  A
phase entered through :func:`phase_timer` is the thread's active span
while it runs, so the host collectives and the kernel wrappers attach
to it.  A streamed pass records its stage / transfer / compute split
under ``<phase>/...`` (data/prefetch.PrefetchStats).

Work on the card is asynchronous, so a phase on a CUDA device ends in
``torch.cuda.synchronize()``: the time is the phase's work, not its
enqueue.  The port always times its phases; it has no ``timing``
switch to log them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch

from oap_mllib_tpu_torch.telemetry.spans import Span, enter


class Timings:
    """Per-fit phase registry: a named span tree with flat views.
    ``root`` names the fit; repeated phases add up."""

    def __init__(self, root: str = "fit") -> None:
        self.root = Span(root)

    def add(self, phase: str, seconds: float) -> None:
        self.root.node(phase).record(seconds)

    @contextlib.contextmanager
    def span(self, phase: str):
        """Time one entry of ``phase`` as the thread's active span."""
        with enter(self.root.node(phase)) as node:
            yield node

    def as_dict(self) -> Dict[str, float]:
        return self.root.flat()

    def total(self) -> float:
        return sum(self.as_dict().values())

    def subphases(self, prefix: str) -> Dict[str, float]:
        """The phases recorded under ``prefix/``, keyed by the rest of
        their name (a streamed pass's ``stage``, ``transfer``,
        ``compute`` and ``stream_wall``, data/prefetch.PrefetchStats)."""
        head = prefix + "/"
        return {p[len(head):]: s for p, s in self.as_dict().items() if p.startswith(head)}

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

    def compile_split(self, prefix: str) -> Optional[Dict[str, float]]:
        """The ``{compile, execute}`` split that utils/progcache.launch
        books under a phase, or None when it booked none there."""
        sub = self.subphases(prefix)
        if "compile" not in sub and "execute" not in sub:
            return None
        return {"compile": sub.get("compile", 0.0), "execute": sub.get("execute", 0.0)}

    def __repr__(self) -> str:
        parts = ", ".join(f"{p}={s:.3f}s" for p, s in self.as_dict().items())
        return f"Timings({self.root.name}: {parts})"


def tick() -> Callable[[], float]:
    """A duration clock: the seconds since the call, each time the
    returned callable is called."""
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


@contextlib.contextmanager
def phase_timer(timings: Timings, phase: str, device=None):
    """Time one phase as the thread's active span; on a CUDA ``device``
    (or a list of devices, a mesh's) the phase ends in a synchronisation
    of each, inside the span."""
    with timings.span(phase):
        try:
            yield
        finally:
            for dev in (device if isinstance(device, (list, tuple)) else [device]):
                if dev is not None and torch.device(dev).type == "cuda":
                    torch.cuda.synchronize(dev)
