"""Span-tree tracing: the storage under every fit's phase timings (the
JAX package's ``telemetry/spans.py``).

A fit is a tree of named :class:`Span` nodes: the root is the fit
(``kmeans.fit``, ``pca.fit``, ``als.fit``), its children the phases the
estimators time (``table_convert``, ``init_centers``, ``lloyd_loop``,
...), and theirs the streamed passes' splits (``stage``, ``transfer``,
``compute``, ``stream_wall``).  ``utils/timing.Timings`` is a view over
this tree.

Clocks are monotonic (``time.perf_counter``).  A thread-local stack of
active spans lets deeper layers attach to the running phase without a
handle: the host collectives book their bytes and wall onto
:func:`current_span` (parallel/collective.py), the kernel wrappers
their launches (ops/cuda/_tiers.kernel_launch).  The prefetch producer
and the recovery watcher run on threads of their own, whose stacks are
empty: they attach to no span of the consumer.

While a profiler trace is live (utils/profiling.py) entering a span
also opens ``torch.profiler.record_function(name)``, the counterpart of
``jax.profiler.TraceAnnotation``, so the phases line up with the
kernels in the trace; with no trace running that step is skipped
behind one module-level bool.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

_SEP = "/"


class Span:
    """One named node of a fit's span tree.

    ``duration_s`` accumulates over repeated entries of one path (a
    streamed phase is entered once a pass); ``count`` is the number of
    explicit recordings: path containers created on the way keep 0 and
    stay out of the flat views."""

    __slots__ = ("name", "duration_s", "count", "attrs", "children")

    def __init__(self, name: str):
        self.name = name
        self.duration_s = 0.0
        self.count = 0
        self.attrs: Dict[str, Any] = {}
        self.children: List["Span"] = []

    def child(self, name: str) -> "Span":
        """Find or create the child ``name`` (first match, so repeated
        phases accumulate onto one node in first-seen order)."""
        for c in self.children:
            if c.name == name:
                return c
        c = Span(name)
        self.children.append(c)
        return c

    def node(self, path: str) -> "Span":
        """Find or create the descendant at an ``a/b/c`` path."""
        n = self
        for part in path.split(_SEP):
            n = n.child(part)
        return n

    def record(self, seconds: float) -> None:
        self.duration_s += seconds
        self.count += 1

    def note_collective(self, op: str, nbytes: int, dispatch_s: float) -> None:
        """Add one host-collective dispatch to this span's attributes."""
        per = self.attrs.setdefault("collectives", {}).setdefault(
            op, {"ops": 0, "bytes": 0, "dispatch_s": 0.0})
        per["ops"] += 1
        per["bytes"] += int(nbytes)
        per["dispatch_s"] += float(dispatch_s)

    def flat(self) -> Dict[str, float]:
        """``{path: seconds}`` over the explicitly recorded descendants, in
        first-recorded order (``Timings.as_dict``)."""
        out: Dict[str, float] = {}
        stack = [("", c) for c in reversed(self.children)]
        while stack:
            prefix, n = stack.pop()
            path = prefix + n.name
            if n.count > 0:
                out[path] = out.get(path, 0.0) + n.duration_s
            stack.extend((path + _SEP, c) for c in reversed(n.children))
        return out

    def as_dict(self) -> Dict[str, Any]:
        """The JSON-ready tree (``summary.telemetry["spans"]``, the sink)."""
        out: Dict[str, Any] = {"name": self.name, "duration_s": self.duration_s,
                               "count": self.count}
        if self.attrs:
            out["attrs"] = self.attrs
        if self.children:
            out["children"] = [c.as_dict() for c in self.children]
        return out

    def walk(self, prefix: str = ""):
        """``(path, span)`` depth first, this span included."""
        path = prefix + self.name
        yield path, self
        for c in self.children:
            yield from c.walk(path + _SEP)

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.duration_s:.3f}s, children={len(self.children)})"


_tls = threading.local()


def current_span() -> Optional[Span]:
    """The innermost span entered on THIS thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def enter(span: Span, annotate: bool = True):
    """Time one entry of ``span`` as this thread's active span; record
    its wall on exit.  A live profiler trace (one bool) adds a
    ``record_function`` of the span's name; an armed flight recorder
    (one config check) records the open and the close."""
    from oap_mllib_tpu_torch.telemetry import flightrec
    from oap_mllib_tpu_torch.utils import profiling

    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(span)
    ann = None
    if annotate and profiling.trace_active():
        ann = profiling.annotate(span.name)
        ann.__enter__()
    if flightrec.enabled():
        flightrec.record("span_open", span.name)
    t0 = time.perf_counter()
    try:
        yield span
    finally:
        dt = time.perf_counter() - t0
        span.record(dt)
        if flightrec.enabled():
            flightrec.record("span_close", span.name, f"{dt:.6f}s")
        if ann is not None:
            ann.__exit__(None, None, None)
        stack.pop()
