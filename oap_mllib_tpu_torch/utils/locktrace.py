"""Runtime lock-order and hold-time tracing: the ``locks`` member of the
sanitizer plane (``Config.sanitizers``; the JAX package's
``utils/locktrace.py``).

- :class:`TrackedLock` wraps a ``threading.Lock`` / ``RLock`` at the
  port's seams that have a JAX counterpart: ``telemetry.sink``
  (telemetry/export.py), ``fleet.state`` and ``fleet.server``
  (telemetry/fleet.py), ``balance.sync`` and ``balance.state``
  (parallel/balance.py), ``sanitizers.seq`` (utils/sanitizers.py), and
  the program cache's ``progcache.clear`` / ``progcache.xla_events``.
  Disarmed, every operation is the inner lock plus one cached config
  check.
- Armed (``locks`` in ``Config.sanitizers``), each acquisition records
  the thread's held stack and folds (held -> acquiring) edges into one
  order graph for the process.  Acquiring B while holding A after some
  thread acquired A while holding B raises
  :class:`~oap_mllib_tpu_torch.utils.sanitizers.LockOrderError` BEFORE
  blocking, naming both witness stacks.
- Every release observes the hold into ``oap_lock_hold_seconds``
  (labelled by lock); a hold longer than ``Config.collective_timeout``
  is flagged (``oap_lock_hold_flags_total`` and a warning), never
  killed.
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from oap_mllib_tpu_torch import config as _config_mod
from oap_mllib_tpu_torch.config import get_config

log = logging.getLogger("oap_mllib_tpu")

# frames of the live stack kept per witness (innermost last, tracer
# frames trimmed) — enough to name the call path without dumping pages
_WITNESS_FRAMES = 8

# plain (untracked) lock guarding the order graph; never visible to the
# tracer itself, so it cannot participate in the orders it records
_graph_lock = threading.Lock()
_edges: Dict[Tuple[str, str], Dict[str, object]] = {}
_registry: Dict[str, "TrackedLock"] = {}
_tls = threading.local()


def _armed() -> bool:
    """One cached config-string check on the off path; the full
    validated-set parse (typo raises) only once sanitizers are set at
    all.  The live Config object is read WITHOUT the config lock —
    ``set_config`` mutates it in place and a reset leaves ``None``
    (routed to the locking initializer), so the lock-free read is
    always either current or deferred — this seam runs on every
    tracked acquisition and must cost one attribute read when off."""
    cfg = _config_mod._config
    if cfg is None:
        cfg = get_config()
    raw = cfg.sanitizers
    if not raw:
        return False
    from oap_mllib_tpu_torch.utils import sanitizers

    return sanitizers.enabled("locks")


def _held() -> List[List[object]]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _stack() -> List[str]:
    frames = traceback.extract_stack()
    trimmed = [f for f in frames if "locktrace.py" not in f.filename]
    return [
        f"{f.filename}:{f.lineno} in {f.name}"
        for f in trimmed[-_WITNESS_FRAMES:]
    ]


def _order_error(name: str, against: str, witness: Dict[str, object]):
    from oap_mllib_tpu_torch.telemetry import metrics as _tm
    from oap_mllib_tpu_torch.utils.sanitizers import LockOrderError

    _tm.counter(
        "oap_sanitizer_violations_total", {"sanitizer": "locks"},
        help="Sanitizer-witnessed invariant violations",
    ).inc()
    here = "\n    ".join(_stack())
    there = "\n    ".join(witness.get("stack", ()))  # type: ignore[arg-type]
    return LockOrderError(
        f"locks sanitizer: lock-order inversion — thread "
        f"{threading.current_thread().name!r} is acquiring "
        f"{name!r} while holding {against!r}, but thread "
        f"{witness.get('thread')!r} previously acquired {against!r} "
        f"while holding {name!r}.  Two threads interleaving these "
        "orders deadlock; pick one global order.\n"
        f"  This acquisition:\n    {here}\n"
        f"  Recorded witness ({against!r} after {name!r}):\n    {there}"
    )


def _before_acquire(name: str) -> None:
    """Order check + edge recording, BEFORE blocking on the inner lock
    (so an inversion raises instead of deadlocking)."""
    held = _held()
    if any(h[0] == name for h in held):
        return  # reentrant RLock acquisition: no new edge, no new clock
    held_names = [h[0] for h in held]
    if not held_names:
        return
    with _graph_lock:
        for h in held_names:
            witness = _edges.get((name, h))
            if witness is not None:
                raise _order_error(name, h, witness)
        for h in held_names:
            if (h, name) not in _edges:
                _edges[(h, name)] = {
                    "thread": threading.current_thread().name,
                    "stack": _stack(),
                }


def _after_acquire(name: str) -> None:
    held = _held()
    for h in held:
        if h[0] == name:
            h[2] += 1  # type: ignore[operator]
            return
    held.append([name, time.perf_counter(), 1])


def _after_release(name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] != name:
            continue
        held[i][2] -= 1  # type: ignore[operator]
        if held[i][2]:
            return
        t0 = held[i][1]
        del held[i]
        _observe_hold(name, time.perf_counter() - float(t0))  # type: ignore[arg-type]
        return


def _observe_hold(name: str, hold_s: float) -> None:
    from oap_mllib_tpu_torch.telemetry import metrics as _tm

    _tm.histogram(
        "oap_lock_hold_seconds", {"lock": name},
        help="Tracked-lock hold times under the locks sanitizer",
    ).observe(hold_s)
    try:
        deadline = float(get_config().collective_timeout)
    except (TypeError, ValueError):
        deadline = 0.0
    if deadline > 0 and hold_s > deadline:
        _tm.counter(
            "oap_lock_hold_flags_total", {"lock": name},
            help="Tracked-lock holds that exceeded the collective "
                 "deadline (flagged, never killed)",
        ).inc()
        log.warning(
            "locks sanitizer: lock %r held %.3fs — longer than "
            "collective_timeout=%.3fs; any collective waiting on work "
            "behind this lock would have expired its deadline "
            "(flagging only, nothing is killed)",
            name, hold_s, deadline,
        )


class TrackedLock:
    """A named lock behind the ``locks`` sanitizer seam.

    Drop-in for the ``threading.Lock``/``RLock`` it wraps (``with``,
    ``acquire``/``release``, ``locked``).  Pass an ``RLock`` as
    ``inner`` for reentrant semantics — reentrant acquisitions are
    recognized per thread and neither re-edge the order graph nor
    restart the hold clock."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner=None):
        self.name = name
        self._inner = threading.Lock() if inner is None else inner
        _registry[name] = self

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        armed = _armed()
        if armed:
            _before_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got and armed:
            _after_acquire(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        if _armed():
            _after_release(self.name)

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return bool(locked()) if locked is not None else False

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"TrackedLock({self.name!r})"


def tracked_lock(name: str, inner=None) -> TrackedLock:
    """The functional spelling of :class:`TrackedLock` (same registry)."""
    return TrackedLock(name, inner)


def order_edges() -> Dict[Tuple[str, str], Dict[str, object]]:
    """A copy of the recorded acquisition-order graph (tests/gate)."""
    with _graph_lock:
        return {k: dict(v) for k, v in _edges.items()}


def tracked_names() -> List[str]:
    return sorted(_registry)


def hold_quantile(q: float) -> float:
    """The ``q``-quantile of tracked-lock hold times, merged across
    every lock's ``oap_lock_hold_seconds`` series (0.0 when nothing was
    observed) — the bench's ``lock_hold_p99`` source."""
    from oap_mllib_tpu_torch.telemetry import metrics as _tm

    reg = _tm.registry()
    with _tm._LOCK:
        series = [
            m for (name, _), m in reg._metrics.items()
            if name == "oap_lock_hold_seconds"
        ]
    merged: Optional[_tm.Histogram] = None
    for h in series:
        if merged is None:
            merged = _tm.Histogram(h.bounds)
        for i, c in enumerate(h.counts):
            merged.counts[i] += c
        merged.sum += h.sum
        merged.count += h.count
    if merged is None or merged.count == 0:
        return 0.0
    return _tm.histogram_quantile(merged, q)


def summary_block() -> Dict[str, object]:
    """The ``locks`` entry of ``summary.sanitizers`` when armed."""
    with _graph_lock:
        n_edges = len(_edges)
    return {
        "tracked": len(_registry),
        "order_edges": n_edges,
        "hold_p99_s": hold_quantile(0.99),
    }


def _reset_for_tests() -> None:
    """Drop the order graph and this thread's held stack (test
    isolation; other threads' stacks die with their threads)."""
    with _graph_lock:
        _edges.clear()
    _tls.held = []
