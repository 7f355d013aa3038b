"""Flight recorder: a constant-memory ring of a process's recent events,
for post-mortems (the JAX package's ``telemetry/flightrec.py``).

``Config.flight_recorder`` is the slot count (0 = off).  The seams that
record one event each:

- ``span_open`` / ``span_close``: telemetry/spans.enter;
- ``collective``: the host collectives (parallel/collective.py:
  ``_all_gather_host``, ``all_to_all``, ``barrier``, ``agree``) and the
  streamed passes' two host reductions (ops/stream_ops.py);
- ``fault`` / ``retry`` / ``degrade``: utils/resilience.py;
- ``ckpt_commit``: utils/checkpoint.py's manifest flips;
- ``crash``: utils/recovery.write_crash_record.

An event is ``(seq, t, tid, kind, name, detail)``: ``seq`` counts over
the process's life (across the ring's wrap), ``t`` is the monotonic
clock.  The ring is allocated when armed and overwritten in place.  Off,
every seam pays one config check.  The tail rides crash records
(``flight_recorder``, schema 2) and the JSON-lines sink (``type:
"flightrec"`` records, telemetry/export.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from oap_mllib_tpu_torch.config import get_config

# how many trailing events ride a crash record (the post-mortem window;
# recorders smaller than this dump their whole ring)
CRASH_TAIL_EVENTS = 64

_FIELDS = ("seq", "t", "tid", "kind", "name", "detail")


class FlightRecorder:
    """Fixed-slot event ring.  ``seq`` is monotonic across wrap-around;
    slot ``seq % slots`` holds the event, so the newest ``slots`` events
    are always resident and nothing ever grows."""

    __slots__ = ("slots", "_buf", "_seq", "_lock")

    def __init__(self, slots: int):
        self.slots = int(slots)
        self._buf: List[Optional[tuple]] = [None] * self.slots
        self._seq = 0
        self._lock = threading.Lock()

    def record(self, kind: str, name: str, detail: str = "") -> int:
        t = time.perf_counter()
        tid = threading.get_ident()
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._buf[seq % self.slots] = (seq, t, tid, kind, name, detail)
        return seq

    def next_seq(self) -> int:
        with self._lock:
            return self._seq

    def tail(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The newest ``n`` events (all resident events when None), in
        seq order, as JSON-ready dicts."""
        with self._lock:
            events = sorted(e for e in self._buf if e is not None)
        if n is not None:
            events = events[-n:]
        return [dict(zip(_FIELDS, e)) for e in events]


# -- module-level recorder (per-process singleton, sized by config) -----------

_lock = threading.Lock()
_rec: Optional[FlightRecorder] = None
_drained_through = 0  # JSONL sink high-water mark (drain_new)


def slots_cfg(cfg=None) -> int:
    """Validated ``Config.flight_recorder`` — negative must raise, not
    silently disarm."""
    cfg = cfg or get_config()
    slots = int(cfg.flight_recorder)
    if slots < 0:
        raise ValueError(
            f"flight_recorder must be >= 0 event slots (0 = off), "
            f"got {slots}"
        )
    return slots


def enabled() -> bool:
    """One config check — the off-path cost at every recording seam."""
    return get_config().flight_recorder != 0


def _recorder() -> Optional[FlightRecorder]:
    """The armed recorder, (re)built when the configured slot count
    changes; None when off.  Seq restarts on a resize — resizing
    mid-flight is a test-only move."""
    global _rec
    slots = slots_cfg()
    if slots == 0:
        return None
    rec = _rec
    if rec is None or rec.slots != slots:
        with _lock:
            if _rec is None or _rec.slots != slots:
                _rec = FlightRecorder(slots)
            rec = _rec
    return rec


def record(kind: str, name: str, detail: str = "") -> Optional[int]:
    """Append one event; returns its seq, or None when the recorder is
    off (one config check).  Never raises on a well-formed call — the
    recorder is a diagnosis channel, not a liveness dependency."""
    rec = _recorder()
    if rec is None:
        return None
    return rec.record(kind, name, detail)


def last_seq() -> int:
    """Seq of the newest recorded event, or -1 (off / nothing yet)."""
    rec = _rec if enabled() else None
    if rec is None:
        return -1
    return rec.next_seq() - 1


def tail(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """The newest ``n`` resident events ([] when off) — what crash
    records embed (``CRASH_TAIL_EVENTS`` by default)."""
    rec = _rec if enabled() else None
    if rec is None:
        return []
    return rec.tail(n)


def drain_new() -> List[Dict[str, Any]]:
    """Events recorded since the last drain (the JSONL sink's cursor):
    each fit finalization emits only its own window, so concatenated
    sink files never repeat events.  Events that wrapped out of the
    ring between drains are gone — the constant-memory contract."""
    global _drained_through
    rec = _rec if enabled() else None
    if rec is None:
        return []
    with _lock:
        mark = _drained_through
        events = [e for e in rec.tail() if e["seq"] >= mark]
        _drained_through = rec.next_seq()
    return events


def _reset_for_tests() -> None:
    global _rec, _drained_through
    with _lock:
        _rec = None
        _drained_through = 0
