"""The traffic plane: the async request front of a served model (the
port of the JAX package's ``serving/traffic.py``; the same names,
signatures, reasons, counters and sideband files).

- :class:`TrafficQueue`: ``submit`` returns a ``concurrent.futures
  .Future`` at once; a dispatcher thread pops the pending set, sheds the
  requests past their deadline un-scored, orders the rest by deadline
  (not arrival), cuts them into groups of at most ``max_batch_rows``
  rows and answers each group with one ``handle.predict_many`` (one
  bucketed batch, serving/registry.py).
- **Admission**: ``submit`` bounds the queue (``Config.serve_queue_depth``)
  and prices the staged bytes against the card budget
  (``utils/membudget.Budgets`` x ``Config.serve_shed_headroom``, the
  budget resolved once per knob value).  A shed is loud: a
  :class:`ShedError` naming depth, deadline and bytes, and
  ``oap_serve_shed_total{reason=}``.
- **Durable futures**: a transient scoring fault re-enqueues the request
  at its own deadline priority (``Config.serve_retry_limit`` /
  ``serve_retry_backoff``); a crash of the dispatch cycle (fault site
  ``serve.dispatch``) fails or requeues that cycle's futures and the
  loop restarts; a classified fault in a coalesced group bisects it on
  the same row buckets until the poison request is isolated and
  quarantined (:class:`ServeError` ``reason="poison"``,
  ``oap_serve_poison_total``); :meth:`TrafficQueue.drain` stops
  admission, flushes, fails what is left loudly and posts
  ``serve.drain.done.rank<r>.json`` on the crash sideband, which the
  supervisor reads (utils/supervisor.py).
- :class:`BrownoutController` (``Config.serve_brownout``): under
  sustained over-budget pressure it steps topk -> bf16 -> stale and
  absorbs the breaches a rung buys back before the budget shed resumes.
- :class:`ScaleController` and :func:`write_scale_hint`: replica count
  from queue-depth samples, posted as ``serve.scale.hint.json`` for the
  supervisor's next relaunch.

Threads and the card: the dispatcher thread sets the handle's card as
its device before it scores, and every scoring program stages and reads
on the device's default stream, the stream a re-pin (serving/registry
.pin, a synchronous copy) stages on, so a swapped pin is whole before
any flush can read it.  The queue lock is a tracked lock held only
around list surgery; scoring and future resolution run outside it.  The
dispatcher thread is a daemon and :meth:`TrafficQueue.close` joins it.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import warnings
import weakref
import zlib
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.serving import reqtrace
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import faults, locktrace

# the supervisor sideband file the scale controller posts decisions to
# (crash_dir/<SCALE_HINT_FILENAME>, read and removed per attempt)
SCALE_HINT_FILENAME = "serve.scale.hint.json"

# the last scale decision, for serving_summary
_STATE_LOCK = locktrace.TrackedLock("serving.scale")
_scale_state: Dict[str, Any] = {}

# the last request this process shed: (reason, monotonic time), for the
# /healthz serving block
_last_shed: Optional[tuple] = None

# live queues, weakly held: /healthz sums their in-flight sets
_QUEUES: "weakref.WeakSet[TrafficQueue]" = weakref.WeakSet()


class ShedError(RuntimeError):
    """A request refused at admission or dropped past its deadline.
    ``reason`` is ``"queue_full"``, ``"budget"``, ``"deadline"`` or
    ``"draining"``; the message names the depth, the deadline and the
    priced bytes against the budget."""

    def __init__(self, reason: str, msg: str, *,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 priced_bytes: Optional[int] = None,
                 budget_bytes: Optional[int] = None):
        self.reason = reason
        self.queue_depth = queue_depth
        self.deadline_ms = deadline_ms
        self.priced_bytes = priced_bytes
        self.budget_bytes = budget_bytes
        parts = []
        if queue_depth is not None:
            parts.append(f"queue depth {queue_depth}")
        if deadline_ms is not None and math.isfinite(deadline_ms):
            parts.append(f"deadline {deadline_ms:.1f} ms")
        if priced_bytes is not None:
            parts.append(
                f"priced ~{_fmt_bytes(priced_bytes)} vs budget "
                f"{_fmt_bytes(budget_bytes or 0)}"
            )
        detail = ", ".join(parts)
        super().__init__(
            f"serving traffic: request shed ({reason}) — {msg}"
            + (f" [{detail}]" if detail else "")
        )


class ServeError(RuntimeError):
    """An accepted request the plane could not answer.  ``reason``:
    ``"retries-exhausted"``, ``"poison"``, ``"fault"`` (a non-retriable
    classified fault, ``fault_class``), ``"dispatcher-crash"``,
    ``"drain-deadline"``, ``"shutdown"`` or ``"eviction"``.  Each one
    books ``oap_serve_request_failures_total{reason=}``."""

    def __init__(self, reason: str, msg: str, *,
                 fault_class: Optional[str] = None,
                 retries: int = 0,
                 cause: Optional[BaseException] = None,
                 crash_records=()):
        self.reason = reason
        self.fault_class = fault_class
        self.retries = int(retries)
        self.crash_records = tuple(crash_records)
        _tm.counter(
            "oap_serve_request_failures_total", {"reason": reason},
            help="Accepted requests the traffic plane failed loudly, "
                 "by classified reason",
        ).inc()
        parts = []
        if fault_class:
            parts.append(f"class={fault_class}")
        if retries:
            parts.append(f"retries={retries}")
        if self.crash_records:
            parts.append("crash records: "
                         + ", ".join(self.crash_records))
        detail = ", ".join(parts)
        super().__init__(
            f"serving traffic: request failed ({reason}) — {msg}"
            + (f" [{detail}]" if detail else "")
        )
        if cause is not None:
            self.__cause__ = cause


def _fmt_bytes(n: int) -> str:
    from oap_mllib_tpu_torch.utils.membudget import _fmt_bytes as fmt

    return fmt(int(n))


def _shed(reason: str, msg: str, **ctx) -> ShedError:
    """A ShedError, booked (counter, last shed, flight recorder)."""
    global _last_shed
    _tm.counter(
        "oap_serve_shed_total", {"reason": reason},
        help="Requests shed by traffic-plane admission control / "
             "deadline expiry, by reason",
    ).inc()
    with _STATE_LOCK:
        _last_shed = (reason, time.monotonic())
    from oap_mllib_tpu_torch.telemetry import flightrec

    flightrec.record("serve", "shed", f"reason={reason}")
    return ShedError(reason, msg, **ctx)


# -- validated traffic knobs ------------------------------------------------------


def traffic_cfg() -> Dict[str, float]:
    """The validated traffic knobs; a typo raises at submit."""
    cfg = get_config()
    depth = int(cfg.serve_queue_depth)
    if depth < 1:
        raise ValueError(
            f"serve_queue_depth must be >= 1, got {depth}"
        )
    deadline_ms = float(cfg.serve_deadline_ms)
    if deadline_ms < 0:
        raise ValueError(
            f"serve_deadline_ms must be >= 0 (0 = no deadline), got "
            f"{deadline_ms}"
        )
    headroom = float(cfg.serve_shed_headroom)
    if not 0.0 < headroom <= 1.0:
        raise ValueError(
            f"serve_shed_headroom must be in (0, 1], got {headroom}"
        )
    retry_limit = int(cfg.serve_retry_limit)
    if retry_limit < 0:
        raise ValueError(
            f"serve_retry_limit must be >= 0, got {retry_limit}"
        )
    retry_backoff = float(cfg.serve_retry_backoff)
    if retry_backoff < 0:
        raise ValueError(
            f"serve_retry_backoff must be >= 0, got {retry_backoff}"
        )
    brownout = str(cfg.serve_brownout).strip().lower()
    _parse_brownout(brownout)
    trace_sample = reqtrace.trace_sample_cfg(cfg)
    return {
        "queue_depth": depth,
        "deadline_ms": deadline_ms,
        "headroom": headroom,
        "retry_limit": retry_limit,
        "retry_backoff": retry_backoff,
        "brownout": brownout,
        "trace_sample": trace_sample,
    }


# the degradation rungs, cheapest last
BROWNOUT_RUNGS = ("off", "topk", "bf16", "stale")


def _parse_brownout(raw: str) -> Optional[int]:
    """``Config.serve_brownout`` (auto|off|pin:<rung>): the pinned rung's
    index, None for auto and off; anything else raises."""
    if raw in ("auto", "off"):
        return None
    if raw.startswith("pin:"):
        rung = raw[len("pin:"):]
        if rung in BROWNOUT_RUNGS:
            return BROWNOUT_RUNGS.index(rung)
    raise ValueError(
        f"serve_brownout must be auto, off, or pin:<rung> with rung in "
        f"{'|'.join(BROWNOUT_RUNGS)}; got {raw!r}"
    )


class _Request:
    __slots__ = ("x", "rows", "deadline", "deadline_ms", "seq", "future",
                 "submitted", "retries", "not_before", "running", "trace")

    def __init__(self, x: np.ndarray, deadline: float, deadline_ms: float,
                 seq: int, submitted: float):
        self.x = x
        self.rows = int(x.shape[0])
        self.deadline = deadline  # absolute clock seconds; inf = none
        self.deadline_ms = deadline_ms
        self.seq = seq
        self.submitted = submitted
        self.future: Future = Future()
        # the durable-future envelope: retries so far, the earliest clock
        # second of the next attempt, and whether the future is RUNNING
        # already (a requeued request is)
        self.retries = 0
        self.not_before = 0.0
        self.running = False
        self.trace: Optional[reqtrace.Ledger] = None


class TrafficQueue:
    """The async request front of one serving handle::

        q = serving.TrafficQueue(handle)
        futs = [q.submit(batch, deadline_ms=50.0) for batch in storm]
        ids = [f.result() for f in futs]
        q.close()

    Every future resolves or raises exactly once.  ``clock`` is
    injectable (tests drive the deadlines with a fake clock and
    :meth:`pump`); ``start=False`` starts no dispatcher thread, so
    :meth:`pump` is the only dispatch path."""

    def __init__(self, handle, *, max_batch_rows: int = 1024,
                 poll_s: float = 0.01,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        if not callable(getattr(handle, "predict_many", None)):
            raise TypeError(
                f"TrafficQueue needs a handle with predict_many (got "
                f"{type(handle).__name__}); serve() the model first"
            )
        if max_batch_rows < 1:
            raise ValueError(
                f"max_batch_rows must be >= 1, got {max_batch_rows}"
            )
        self._handle = handle
        self._kind = str(getattr(handle, "kind", ""))
        # the card the dispatcher thread scores on (None: not a card)
        dev = getattr(handle, "device", None)
        self._device = dev if isinstance(dev, torch.device) and dev.type == "cuda" else None
        self._max_batch_rows = int(max_batch_rows)
        self._poll_s = float(poll_s)
        self._clock = clock
        self._lock = locktrace.TrackedLock("serving.traffic")
        self._pending: List[_Request] = []
        self._inflight: Dict[int, _Request] = {}
        self._seq = 0
        self._closed = False
        self._draining = False
        self._budget_cache: Optional[tuple] = None
        self.submitted = 0
        self.answered = 0
        self.shed = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _QUEUES.add(self)
        if start:
            t = threading.Thread(
                target=self._run, name="oap-serve-dispatch", daemon=True
            )
            self._thread = t
            t.start()

    # -- admission -----------------------------------------------------------

    def submit(self, x, deadline_ms: Optional[float] = None) -> Future:
        """Admit one request and return its future, or shed it
        (:class:`ShedError`) when the queue is at ``serve_queue_depth`` or
        its priced bytes would pass the serving allowance."""
        knobs = traffic_cfg()
        if deadline_ms is None:
            deadline_ms = knobs["deadline_ms"]
        deadline_ms = float(deadline_ms)
        if deadline_ms < 0:
            raise ValueError(
                f"deadline_ms must be >= 0 (0 = no deadline), got "
                f"{deadline_ms}"
            )
        x = np.atleast_2d(np.asarray(x))
        allowance = self._allowance(knobs["headroom"])
        req_bytes = int(x.size * x.itemsize)
        now = self._clock()
        deadline = (
            now + deadline_ms / 1e3 if deadline_ms > 0 else math.inf
        )
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "TrafficQueue is closed; no further submissions"
                )
            depth = len(self._pending)
            if self._draining:
                raise _shed(
                    "draining",
                    "queue is draining for scale-in/shutdown; resubmit "
                    "to a live replica",
                    queue_depth=depth, deadline_ms=deadline_ms,
                )
            if depth >= knobs["queue_depth"]:
                raise _shed(
                    "queue_full",
                    f"pending queue at serve_queue_depth="
                    f"{knobs['queue_depth']}; retry after the dispatcher "
                    "drains or scale out",
                    queue_depth=depth, deadline_ms=deadline_ms,
                )
            bo: Optional[Dict[str, Any]] = None
            if allowance > 0:
                from oap_mllib_tpu_torch.utils.membudget import _OVERHEAD

                pending_bytes = sum(
                    int(r.x.size * r.x.itemsize) for r in self._pending
                )
                priced = int((pending_bytes + req_bytes) * _OVERHEAD)
                # the ladder sees every priced admission: over budget it
                # may step a rung and absorb the breach
                bo = brownout().observe_admission(priced, allowance)
                if priced > allowance and not bo["absorb"]:
                    raise _shed(
                        "budget",
                        "projected staged working set exceeds the "
                        "serving allowance (hbm budget x "
                        "serve_shed_headroom); shed instead of OOM",
                        queue_depth=depth, deadline_ms=deadline_ms,
                        priced_bytes=priced, budget_bytes=allowance,
                    )
            req = _Request(x, deadline, deadline_ms, self._seq, now)
            self._seq += 1
            if knobs["trace_sample"] > 0:
                # the ledger opens at submit entry and closes admission
                # under the lock, so no cycle pops an untraced request
                lg = reqtrace.begin(
                    now, int(get_config().process_id), req.seq,
                    deadline_ms,
                )
                if lg is not None:
                    t_adm = self._clock()
                    lg.cut("admission", t_adm)
                    if bo is not None and (bo["stepped"] or bo["rung"]):
                        lg.event(
                            "brownout",
                            f"rung={bo['rung_name']} "
                            f"stepped={bo['stepped']}",
                            t_adm,
                        )
                    req.trace = lg
                    req.future.ledger = lg  # type: ignore[attr-defined]
            self._pending.append(req)
            self.submitted += 1
        from oap_mllib_tpu_torch.serving import registry

        registry.note_queue_depth(1)
        self._wake.set()
        return req.future

    def _allowance(self, headroom: float) -> int:
        """The serving allowance in bytes (0 = unbounded): the resolved
        card budget times ``headroom``, resolved once per budget-knob
        value (admission queries no device per request)."""
        cfg = get_config()
        key = (cfg.memory_budget_hbm, cfg.memory_budget_host)
        cached = self._budget_cache
        if cached is None or cached[0] != key:
            from oap_mllib_tpu_torch.utils.membudget import Budgets

            cached = (key, Budgets.resolve())
            self._budget_cache = cached
        hbm = cached[1].hbm
        return int(hbm * headroom) if hbm > 0 else 0

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- dispatch ------------------------------------------------------------

    def _run(self) -> None:
        if self._device is not None:
            torch.cuda.set_device(self._device)
        while not self._stop.is_set():
            self._wake.wait(self._poll_s)
            self._wake.clear()
            try:
                self.pump()
            except Exception as exc:  # noqa: BLE001 — crash survived
                # pump already failed or requeued every future of the
                # cycle (_dispatcher_crash); the loop goes on, loudly
                warnings.warn(
                    "serving traffic: dispatcher crashed and restarted "
                    f"— in-cycle futures were failed/requeued ({exc!r})",
                    RuntimeWarning, stacklevel=2,
                )

    # -- future resolution (exactly once) ------------------------------------

    def _land(self, r: _Request, out) -> bool:
        self._inflight.pop(id(r), None)
        try:
            r.future.set_result(out)
        except Exception:  # InvalidStateError: close()/drain() won
            return False
        self._finalize_trace(r, "answered")
        return True

    def _land_exc(self, r: _Request, exc: BaseException) -> bool:
        self._inflight.pop(id(r), None)
        try:
            r.future.set_exception(exc)
        except Exception:  # InvalidStateError: close()/drain() won
            return False
        self._finalize_trace(
            r, "shed" if isinstance(exc, ShedError) else "failed"
        )
        return True

    def _finalize_trace(self, r: _Request, outcome: str) -> None:
        lg = r.trace
        if lg is None:
            return
        lg.retries = r.retries
        reqtrace.finalize(lg, outcome, self._clock(), model=self._kind)

    def pump(self) -> int:
        """One dispatch cycle: pop every pending request whose backoff
        has passed, shed the expired, order the rest by deadline, score
        them in row-bounded groups.  Returns the requests resolved.  A
        crash of the cycle itself (fault site ``serve.dispatch``) fails
        or requeues every unresolved future of the cycle, then
        re-raises."""
        now = self._clock()
        with self._lock:
            if not self._pending:
                return 0
            ready = [r for r in self._pending if r.not_before <= now]
            if not ready:
                return 0
            if len(ready) == len(self._pending):
                self._pending = []
            else:
                self._pending = [
                    r for r in self._pending if r.not_before > now
                ]
            for r in ready:
                self._inflight[id(r)] = r
        for r in ready:
            if r.trace is not None:
                r.trace.cut("queue_wait", now)
        from oap_mllib_tpu_torch.serving import registry

        registry.note_queue_depth(-len(ready))
        try:
            faults.maybe_fault("serve.dispatch")
            return self._dispatch(ready, now)
        except Exception as exc:  # noqa: BLE001 — classified below
            self._dispatcher_crash(ready, exc)
            raise

    def _dispatch(self, ready: List[_Request], now: float) -> int:
        resolved = 0
        live: List[_Request] = []
        for r in ready:
            if not r.running:
                if not r.future.set_running_or_notify_cancel():
                    self._inflight.pop(id(r), None)
                    self._finalize_trace(r, "cancelled")
                    resolved += 1  # cancelled by its caller
                    continue
                r.running = True
            if r.deadline <= now:
                late_ms = (now - r.deadline) * 1e3
                if self._land_exc(r, _shed(
                    "deadline",
                    f"request expired {late_ms:.1f} ms past its "
                    "deadline before dispatch (queue wait exceeded the "
                    "budget); shed un-scored",
                    queue_depth=len(ready),
                    deadline_ms=r.deadline_ms,
                )):
                    with self._lock:
                        self.shed += 1
                resolved += 1
                continue
            live.append(r)
        live.sort(key=lambda r: (r.deadline, r.seq))
        group: List[_Request] = []
        rows = 0
        groups: List[List[_Request]] = []
        for r in live:
            if group and rows + r.rows > self._max_batch_rows:
                groups.append(group)
                group, rows = [], 0
            group.append(r)
            rows += r.rows
        if group:
            groups.append(group)
        for g in groups:
            resolved += self._dispatch_group(g, now)
        return resolved

    def _dispatch_group(self, g: List[_Request], now: float) -> int:
        """Score one group; on a fault retry (transient), bisect (a
        classified fault in a group of several), quarantine (an isolated
        poison) or land the raw exception (unclassified: never
        masked)."""
        ledgers = [r.trace for r in g if r.trace is not None]
        if not ledgers:
            try:
                parts = self._handle.predict_many([r.x for r in g])
            except Exception as exc:  # noqa: BLE001 — classified below
                return self._group_fault(g, exc, now)
        else:
            t_score = self._clock()
            for lg in ledgers:
                lg.cut("batch_form", t_score)
            from oap_mllib_tpu_torch.utils import progcache

            compile0 = progcache.xla_compile_secs()
            try:
                # the batcher's pad timing folds into the attached
                # ledgers without plumbing predict_many
                with reqtrace.attach(ledgers) as att:
                    parts = self._handle.predict_many([r.x for r in g])
            except Exception as exc:  # noqa: BLE001 — classified below
                t_fault = self._clock()
                for lg in ledgers:
                    lg.cut("execute", t_fault)
                    lg.event("fault", type(exc).__name__, t_fault)
                return self._group_fault(g, exc, now)
            t_done = self._clock()
            pad_s = att.flush_notes().get("bucket_pad", 0.0)
            comp_s = progcache.xla_compile_secs() - compile0
            # every rider of the flush paid its pad and build walls
            for lg in ledgers:
                lg.cut_flush(t_done, pad_s, comp_s)
        resolved = 0
        for r, out in zip(g, parts):
            if self._land(r, out):
                resolved += 1
        with self._lock:
            self.answered += resolved
        return resolved

    def _group_fault(self, g: List[_Request], exc: BaseException,
                     now: float) -> int:
        from oap_mllib_tpu_torch.utils import resilience

        kind = resilience.classify_fault(exc)
        if kind == resilience.TRANSIENT:
            policy = resilience.RetryPolicy.for_serving()
            retriable = [r for r in g if r.retries < policy.max_retries]
            spent = [r for r in g if r.retries >= policy.max_retries]
            if retriable:
                self._requeue(retriable, now, policy)
            n = 0
            for r in spent:
                if self._land_exc(r, ServeError(
                    "retries-exhausted",
                    f"request seq={r.seq} kept hitting transient "
                    f"scoring faults past serve_retry_limit="
                    f"{policy.max_retries}",
                    fault_class=kind, retries=r.retries, cause=exc,
                )):
                    n += 1
            return n
        if len(g) > 1 and kind is not None:
            # bisection: each half pads to a row bucket already warm, so
            # isolating the poison builds nothing
            _tm.counter(
                "oap_serve_bisect_total",
                help="Coalesced-batch bisection rounds triggered by a "
                     "classified scoring fault",
            ).inc()
            mid = len(g) // 2
            return (self._dispatch_group(g[:mid], now)
                    + self._dispatch_group(g[mid:], now))
        if len(g) > 1:
            # unclassified: the raw exception on every future of the
            # group, never rescored (a programming error repeats)
            return sum(1 for r in g if self._land_exc(r, exc))
        return self._quarantine(g[0], exc, kind)

    def _quarantine(self, r: _Request, exc: BaseException,
                    kind: Optional[str]) -> int:
        from oap_mllib_tpu_torch.utils import resilience

        if kind is None:
            return 1 if self._land_exc(r, exc) else 0
        if kind == resilience.NONFINITE:
            from oap_mllib_tpu_torch.telemetry import flightrec

            digest = zlib.crc32(
                np.ascontiguousarray(r.x).tobytes()
            ) & 0xFFFFFFFF
            _tm.counter(
                "oap_serve_poison_total",
                help="Requests quarantined as poison by coalesced-"
                     "batch bisection",
            ).inc()
            flightrec.record(
                "serve", "poison",
                f"seq={r.seq} rows={r.rows} digest={digest:08x}: {exc}",
            )
            if r.trace is not None:
                r.trace.event(
                    "poison", f"digest={digest:08x}", self._clock()
                )
            err = ServeError(
                "poison",
                f"request seq={r.seq} quarantined: scoring it produces "
                f"a nonfinite outcome (payload digest {digest:08x}); "
                "innocents in its batch were answered",
                fault_class=kind, retries=r.retries, cause=exc,
            )
        else:
            err = ServeError(
                "fault",
                f"request seq={r.seq} failed a non-retriable {kind} "
                "scoring fault",
                fault_class=kind, retries=r.retries, cause=exc,
            )
        return 1 if self._land_exc(r, err) else 0

    def _requeue(self, rs: List[_Request], now: float, policy) -> None:
        """Re-enqueue transiently faulted requests, seq and deadline kept
        (the retry keeps its deadline priority), after the policy's
        jittered backoff."""
        for r in rs:
            r.not_before = now + policy.delay_s(r.retries,
                                                site="serve.batch")
            r.retries += 1
            if r.trace is not None:
                r.trace.retries = r.retries
                r.trace.event("retry", f"retries={r.retries}", now)
        from oap_mllib_tpu_torch.telemetry import flightrec

        flightrec.record("serve", "retry", f"n={len(rs)}")
        _tm.counter(
            "oap_serve_retries_total",
            help="Transient scoring faults re-enqueued by the durable-"
                 "future retry envelope",
        ).inc(len(rs))
        with self._lock:
            closed = self._closed
            if not closed:
                self._pending.extend(rs)
                for r in rs:
                    self._inflight.pop(id(r), None)
        if closed:
            for r in rs:
                self._land_exc(r, ServeError(
                    "shutdown",
                    f"request seq={r.seq} had retries left but the "
                    "queue is closing; resubmit to a live replica",
                    retries=r.retries,
                ))
            return
        from oap_mllib_tpu_torch.serving import registry

        registry.note_queue_depth(len(rs))
        self._wake.set()

    def _dispatcher_crash(self, ready: List[_Request],
                          exc: BaseException) -> None:
        """A crash of the cycle outside the scoring call: requeue the
        transient survivors with retries left, fail the rest with
        ``ServeError(reason="dispatcher-crash")``."""
        from oap_mllib_tpu_torch.utils import resilience

        _tm.counter(
            "oap_serve_dispatch_crashes_total",
            help="Dispatcher-thread crashes survived by the traffic "
                 "plane (futures failed/requeued, dispatch restarted)",
        ).inc()
        with self._lock:
            pending_ids = {id(r) for r in self._pending}
        leftover = [
            r for r in ready
            if not r.future.done() and id(r) not in pending_ids
        ]
        kind = resilience.classify_fault(exc)
        if kind == resilience.TRANSIENT:
            policy = resilience.RetryPolicy.for_serving()
            retriable = [
                r for r in leftover if r.retries < policy.max_retries
            ]
            leftover = [
                r for r in leftover if r.retries >= policy.max_retries
            ]
            if retriable:
                self._requeue(retriable, self._clock(), policy)
        for r in leftover:
            self._land_exc(r, ServeError(
                "dispatcher-crash",
                f"the dispatch cycle scoring request seq={r.seq} "
                "crashed; the dispatcher restarts but this future "
                "fails loudly rather than hang",
                fault_class=kind, retries=r.retries, cause=exc,
            ))

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout_s: float = 5.0) -> Dict[str, Any]:
        """Release this replica's queue: stop admission (later submits
        shed ``"draining"``), flush pending and retrying futures until
        the queue is empty or ``timeout_s`` of wall passes, fail what is
        left with ``ServeError(reason="drain-deadline")``.  Books
        ``oap_serve_drains_total``, posts ``serve.drain.done.rank<r>
        .json`` on the crash sideband when armed, returns the stats."""
        faults.maybe_fault("serve.drain")
        from oap_mllib_tpu_torch.telemetry import flightrec

        with self._lock:
            self._draining = True
            start_pending = len(self._pending) + len(self._inflight)
            for r in self._pending:
                if r.trace is not None:
                    r.trace.event(
                        "drain", f"pending={start_pending}",
                        self._clock(),
                    )
        flightrec.record(
            "serve", "drain", f"pending={start_pending}"
        )
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        answered0 = self.answered
        while True:
            try:
                self.pump()
            except Exception:  # noqa: BLE001 — the crash path already
                pass           # failed or requeued the cycle's futures
            with self._lock:
                left = len(self._pending) + len(self._inflight)
            if left == 0 or time.monotonic() >= deadline:
                break
            self._wake.set()
            time.sleep(min(self._poll_s, 0.005))
        with self._lock:
            leftovers = list(self._pending)
            self._pending = []
            stuck = [
                r for r in self._inflight.values()
                if not r.future.done()
            ]
        if leftovers:
            from oap_mllib_tpu_torch.serving import registry

            registry.note_queue_depth(-len(leftovers))
        failed = 0
        for r in leftovers + stuck:
            if self._land_exc(r, ServeError(
                "drain-deadline",
                f"request seq={r.seq} unresolved when the drain "
                f"deadline ({timeout_s:g}s) expired; resubmit to a "
                "live replica",
                retries=r.retries,
            )):
                failed += 1
        stats = {
            "pending_at_drain": start_pending,
            "answered": self.answered - answered0,
            "failed": failed,
            "drained": failed == 0,
            "timeout_s": float(timeout_s),
        }
        _tm.counter(
            "oap_serve_drains_total",
            help="Graceful drains of the traffic queue (scale-in / "
                 "shutdown)",
        ).inc()
        self._write_drain_report(stats)
        return stats

    def _write_drain_report(self, stats: Dict[str, Any]) -> Optional[str]:
        """Post the drain's outcome on the crash sideband (tmp + rename),
        named by this process's rank in its world."""
        crash_dir = str(get_config().crash_dir or "")
        if not crash_dir:
            return None
        from oap_mllib_tpu_torch.parallel import bootstrap

        rank = bootstrap.process_index()
        os.makedirs(crash_dir, exist_ok=True)
        path = os.path.join(crash_dir, f"serve.drain.done.rank{rank}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"rank": rank, **stats}, f)
        os.replace(tmp, path)
        return path

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Stop admission, join the dispatcher, run one last
        :meth:`pump`, then fail every future still unresolved (a retry
        whose backoff never passed, a scoring call wedged past
        ``timeout_s``) with ``ServeError(reason="shutdown")``: close
        never leaks a future."""
        with self._lock:
            self._closed = True
            for r in self._pending:
                # the last pump dispatches retries at once
                r.not_before = 0.0
        self._stop.set()
        self._wake.set()
        t = self._thread
        wedged = False
        if t is not None:
            t.join(timeout_s)
            if t.is_alive():
                wedged = True
                _tm.counter(
                    "oap_serve_close_wedged_total",
                    help="close() calls that found the dispatcher "
                         "wedged in a scoring call past the join "
                         "timeout (pending futures failed explicitly)",
                ).inc()
                warnings.warn(
                    "serving traffic: dispatcher did not join within "
                    f"{timeout_s}s at close (scoring callable wedged); "
                    "failing every unresolved future loudly",
                    RuntimeWarning, stacklevel=2,
                )
            else:
                self._thread = None
        if not wedged:
            try:
                self.pump()
            except Exception:  # noqa: BLE001 — the crash path already
                pass           # failed or requeued the cycle's futures
        with self._lock:
            leftovers = list(self._pending)
            self._pending = []
            stuck = [
                r for r in self._inflight.values()
                if not r.future.done()
            ]
        if leftovers:
            from oap_mllib_tpu_torch.serving import registry

            registry.note_queue_depth(-len(leftovers))
        for r in leftovers + stuck:
            self._land_exc(r, ServeError(
                "shutdown",
                f"request seq={r.seq} unresolved at TrafficQueue "
                "close; resubmit to a live replica",
                retries=r.retries,
            ))

    def __enter__(self) -> "TrafficQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the brownout ladder ------------------------------------------------------------


class BrownoutController:
    """Degrade before shedding.  Rungs: 0 ``off``; 1 ``topk`` (a
    recommendation's depth halves, :func:`brownout_topk`); 2 ``bf16``
    (scoring at bf16 for algorithms with a parity bound,
    :func:`brownout_precision_override`, folded into
    ``batcher.resolve_policy``; a ``serving_precision`` pin wins); 3
    ``stale`` (a re-pin may answer from the previous pin,
    :func:`brownout_stale_ok`, read by ``registry.pin``).

    A full window of admissions whose mean pressure (priced bytes over
    the allowance) is above 1.0, trend not falling, steps up; below 0.5,
    trend not rising, steps down.  ``pin:<rung>`` holds a rung, ``off``
    never steps.  Each step books ``oap_serve_brownout_rung``,
    ``oap_serve_brownout_steps_total{direction=}``, the flight recorder,
    the enclosing span's ``brownout`` attribute and the summary.  A
    breach is absorbed when the ladder just stepped up or holds an
    intermediate rung; at the top rung the budget shed resumes."""

    RUNGS = BROWNOUT_RUNGS
    WINDOW = 4  # samples a step decision (fleet._trend's minimum)

    def __init__(self, policy: Optional[str] = None):
        raw = str(
            get_config().serve_brownout if policy is None else policy
        ).strip().lower()
        self.policy = raw
        self.pinned = _parse_brownout(raw)
        self.rung = self.pinned or 0
        self.absorbed = 0
        self._ratios: deque = deque(maxlen=self.WINDOW)
        self.steps: List[Dict[str, Any]] = []
        self._gauge()

    def _gauge(self) -> None:
        _tm.gauge(
            "oap_serve_brownout_rung",
            help="Current brownout degradation rung (0=off, 1=topk, "
                 "2=bf16, 3=stale)",
        ).set(self.rung)

    def _step(self, direction: int, ratio: float, trend: str) -> None:
        old = self.rung
        self.rung += direction
        step = {
            "from": self.RUNGS[old],
            "to": self.RUNGS[self.rung],
            "ratio": round(float(ratio), 3),
            "trend": trend,
        }
        # the step records the SLO state that witnessed it
        from oap_mllib_tpu_torch.serving import slo

        slo_brief = slo.brief()
        if slo_brief:
            step["slo"] = slo_brief
        self.steps.append(step)
        self._ratios.clear()  # each rung needs fresh samples
        self._gauge()
        _tm.counter(
            "oap_serve_brownout_steps_total",
            {"direction": "up" if direction > 0 else "down"},
            help="Brownout ladder rung steps, by direction",
        ).inc()
        from oap_mllib_tpu_torch.telemetry import flightrec

        flightrec.record(
            "serve", "brownout",
            f"rung {self.RUNGS[old]}->{self.RUNGS[self.rung]} "
            f"(pressure {ratio:.2f}, {trend})",
        )
        from oap_mllib_tpu_torch.telemetry.spans import current_span

        sp = current_span()
        if sp is not None:
            sp.attrs["brownout"] = self.RUNGS[self.rung]

    def observe_admission(self, priced: int, budget: int) -> Dict[str, Any]:
        """Fold one priced admission; returns the decision (rung,
        whether this breach is absorbed, the ratio, the step).  Never
        blocks: ``submit`` calls it under its lock."""
        ratio = float(priced) / float(budget) if budget > 0 else 0.0
        self._ratios.append(ratio)
        if self.policy == "off" or self.pinned is not None:
            # a pinned rung degrades but never absorbs a breach
            return {
                "rung": self.rung, "rung_name": self.RUNGS[self.rung],
                "absorb": False, "ratio": ratio, "stepped": 0,
            }
        from oap_mllib_tpu_torch.telemetry.fleet import _trend

        trend = _trend(list(self._ratios))
        mean = float(np.mean(self._ratios))
        stepped = 0
        if (len(self._ratios) == self.WINDOW
                and mean > 1.0
                and trend != "falling"
                and self.rung < len(self.RUNGS) - 1):
            self._step(+1, ratio, trend)
            stepped = 1
        elif (len(self._ratios) == self.WINDOW
                and mean < 0.5
                and trend != "rising"
                and self.rung > 0):
            self._step(-1, ratio, trend)
            stepped = -1
        absorb = ratio > 1.0 and (
            stepped > 0 or 0 < self.rung < len(self.RUNGS) - 1
        )
        if absorb:
            self.absorbed += 1
            _tm.counter(
                "oap_serve_brownout_absorbed_total",
                help="Over-budget admissions absorbed by an active "
                     "brownout rung instead of shed",
            ).inc()
        return {
            "rung": self.rung, "rung_name": self.RUNGS[self.rung],
            "absorb": absorb, "ratio": ratio, "stepped": stepped,
        }

    observe = observe_admission

    def summary(self) -> Dict[str, Any]:
        out = {
            "policy": self.policy,
            "rung": self.RUNGS[self.rung],
            "rung_index": self.rung,
            "steps": len(self.steps),
            "absorbed": self.absorbed,
        }
        if self.steps:
            out["last_step"] = dict(self.steps[-1])
        return out


_BROWNOUT: Optional[BrownoutController] = None


def brownout() -> BrownoutController:
    """The process's ladder, rebuilt when ``Config.serve_brownout``
    changes."""
    global _BROWNOUT
    raw = str(get_config().serve_brownout).strip().lower()
    with _STATE_LOCK:
        b = _BROWNOUT
        if b is None or b.policy != raw:
            b = BrownoutController(raw)
            _BROWNOUT = b
    return b


def brownout_rung() -> int:
    """The current rung's index (0 = off)."""
    return brownout().rung


def brownout_topk(k: int) -> int:
    """At the topk rung or above: half the requested depth (at least
    1).  The halved depth is a new ``serve.topk`` key: warm it before
    counting on no miss at this rung."""
    if brownout_rung() >= BROWNOUT_RUNGS.index("topk"):
        reduced = max(1, int(k) // 2)
        if reduced < int(k):
            _tm.counter(
                "oap_serve_brownout_topk_reduced_total",
                help="Recommendation requests answered at reduced "
                     "top-k depth under brownout",
            ).inc()
        return reduced
    return int(k)


def brownout_precision_override(algo: str) -> str:
    """``"bf16"`` at the bf16 rung or above for an algorithm with a
    parity bound (``utils/precision.PARITY_BOUNDS``), else ``""``."""
    if brownout_rung() >= BROWNOUT_RUNGS.index("bf16"):
        from oap_mllib_tpu_torch.utils.precision import PARITY_BOUNDS

        if algo in PARITY_BOUNDS:
            return "bf16"
    return ""


def brownout_stale_ok() -> bool:
    """At the stale rung: ``registry.pin`` may answer from the previous
    pin while a replaced array waits to stage."""
    return brownout_rung() >= BROWNOUT_RUNGS.index("stale")


# -- replica-count control ------------------------------------------------------------


class ScaleController:
    """Replica count as a controlled variable.  Fed queue-depth / p99
    samples (:meth:`observe_view` of a :func:`serving.heartbeat` view, or
    :meth:`observe`), it votes **out** when the windowed mean depth a
    replica is above ``Config.serve_scale_high`` and not falling, **in**
    after ``Config.serve_scale_idle_s`` of idleness (a scale-in drains
    the attached ``queue`` first), else **hold**.  Decisions book
    ``oap_serve_scale_out_total`` / ``_in_total`` /
    ``oap_serve_scale_replicas`` and ``serving_summary()["scale"]``;
    :func:`write_scale_hint` posts them for the supervisor."""

    WINDOW = 4  # samples a decision window (fleet._trend's minimum)

    def __init__(self, replicas: int, *, min_replicas: int = 1,
                 max_replicas: int = 0,
                 high: Optional[float] = None,
                 idle_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 queue: Optional[TrafficQueue] = None):
        cfg = get_config()
        self.high = float(cfg.serve_scale_high if high is None else high)
        self.idle_s = float(
            cfg.serve_scale_idle_s if idle_s is None else idle_s
        )
        if self.high <= 0:
            raise ValueError(
                f"serve_scale_high must be > 0, got {self.high}"
            )
        if self.idle_s <= 0:
            raise ValueError(
                f"serve_scale_idle_s must be > 0, got {self.idle_s}"
            )
        if replicas < 1 or min_replicas < 1:
            raise ValueError(
                f"replicas/min_replicas must be >= 1, got "
                f"{replicas}/{min_replicas}"
            )
        self.replicas = int(replicas)
        self.min_replicas = int(min_replicas)
        # 0: the starting size x2 (unbounded growth is never sane)
        self.max_replicas = int(max_replicas) or 2 * int(replicas)
        self._clock = clock
        self._queue = queue
        self._depths: deque = deque(maxlen=self.WINDOW)
        self._p99s: deque = deque(maxlen=self.WINDOW)
        self._last_busy = clock()
        self._last_requests: Optional[int] = None
        self.decisions: List[Dict[str, Any]] = []

    def observe_view(self, view: Dict[str, Any],
                     p99_s: float = 0.0) -> Dict[str, Any]:
        """One heartbeat view: the fleet's summed depth and requests;
        the replica count follows the view's world."""
        self.replicas = max(self.min_replicas, int(view.get("world", 1)))
        return self.observe(
            queue_depth=int(sum(view.get("queue_depth", []) or [0])),
            p99_s=p99_s,
            requests=int(sum(view.get("requests", []) or [0])),
        )

    def observe(self, queue_depth: int, p99_s: float = 0.0,
                requests: Optional[int] = None) -> Dict[str, Any]:
        """Fold one sample and return the decision (action, replicas,
        reason, the sample, the trends)."""
        from oap_mllib_tpu_torch.telemetry.fleet import _trend

        now = self._clock()
        self._depths.append(float(queue_depth))
        self._p99s.append(float(p99_s))
        busy = queue_depth > 0 or (
            requests is not None and requests != self._last_requests
        )
        if requests is not None:
            self._last_requests = requests
        if busy:
            self._last_busy = now
        depth_trend = _trend(list(self._depths))
        p99_trend = _trend(list(self._p99s))
        per_replica = (
            float(np.mean(self._depths)) / max(1, self.replicas)
        )
        action, reason = "hold", ""
        if (len(self._depths) == self.WINDOW
                and per_replica > self.high
                and depth_trend != "falling"
                and self.replicas < self.max_replicas):
            action = "out"
            self.replicas += 1
            reason = (
                f"queue depth/replica {per_replica:.1f} > "
                f"serve_scale_high={self.high:g} (depth {depth_trend}, "
                f"p99 {p99_trend})"
            )
            self._depths.clear()
            self._p99s.clear()
            _tm.counter(
                "oap_serve_scale_out_total",
                help="Scale-out decisions by the serving replica "
                     "controller",
            ).inc()
        elif (now - self._last_busy >= self.idle_s
                and self.replicas > self.min_replicas):
            action = "in"
            self.replicas -= 1
            reason = (
                f"idle {now - self._last_busy:.1f}s >= "
                f"serve_scale_idle_s={self.idle_s:g}"
            )
            self._last_busy = now
            _tm.counter(
                "oap_serve_scale_in_total",
                help="Scale-in decisions by the serving replica "
                     "controller",
            ).inc()
        _tm.gauge(
            "oap_serve_scale_replicas",
            help="Replica count the serving scale controller currently "
                 "wants",
        ).set(self.replicas)
        decision = {
            "action": action,
            "replicas": self.replicas,
            "reason": reason,
            "queue_depth": int(queue_depth),
            "queue_depth_per_replica": round(per_replica, 3),
            "p99_s": float(p99_s),
            "depth_trend": depth_trend,
            "p99_trend": p99_trend,
        }
        from oap_mllib_tpu_torch.serving import slo

        slo_brief = slo.brief()
        if slo_brief:
            decision["slo"] = slo_brief
        if action == "in" and self._queue is not None:
            # the released replica flushes every accepted future first
            decision["drained"] = self._queue.drain()
        self.decisions.append(decision)
        with _STATE_LOCK:
            _scale_state.clear()
            _scale_state.update(decision)
        return decision


def write_scale_hint(crash_dir: str,
                     decision: Dict[str, Any]) -> Optional[str]:
    """Post an out / in decision as ``crash_dir/serve.scale.hint.json``
    (tmp + rename); the supervisor reads and removes it when it sizes
    the next relaunch.  None for hold or an empty ``crash_dir``."""
    if not crash_dir or decision.get("action") not in ("out", "in"):
        return None
    os.makedirs(crash_dir, exist_ok=True)
    path = os.path.join(crash_dir, SCALE_HINT_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(decision, f)
    os.replace(tmp, path)
    return path


def summary_block() -> Dict[str, Any]:
    """The traffic plane's keys of ``serving_summary()``: sheds and
    failures by reason, the durable-future counters, the brownout
    ladder, the last scale decision, the attribution and the SLO."""
    out: Dict[str, Any] = {}
    reg = _tm.registry()
    with _tm._LOCK:
        sheds = {
            dict(labels).get("reason", ""): int(m.value)
            for (name, labels), m in reg._metrics.items()
            if name == "oap_serve_shed_total"
        }
        fails = {
            dict(labels).get("reason", ""): int(m.value)
            for (name, labels), m in reg._metrics.items()
            if name == "oap_serve_request_failures_total"
        }
    if sheds:
        out["shed"] = {"total": sum(sheds.values()), **sheds}
    futures = {
        "retries": int(_tm.family_total("oap_serve_retries_total")),
        "poison": int(_tm.family_total("oap_serve_poison_total")),
        "bisections": int(_tm.family_total("oap_serve_bisect_total")),
        "dispatcher_crashes": int(
            _tm.family_total("oap_serve_dispatch_crashes_total")
        ),
        "drains": int(_tm.family_total("oap_serve_drains_total")),
    }
    if fails:
        futures["failed"] = {"total": sum(fails.values()), **fails}
    if fails or any(futures[k] for k in
                    ("retries", "poison", "bisections",
                     "dispatcher_crashes", "drains")):
        out["futures"] = futures
    b = _BROWNOUT
    if b is not None and (b.rung or b.steps or b.policy != "auto"
                          or b.absorbed):
        out["brownout"] = b.summary()
    with _STATE_LOCK:
        if _scale_state:
            out["scale"] = dict(_scale_state)
    attr = reqtrace.attribution_block()
    if attr:
        out["attribution"] = attr
    from oap_mllib_tpu_torch.serving import slo

    s = slo.summary_block()
    if s:
        out["slo"] = s
    return out


def serving_health_block() -> Dict[str, Any]:
    """The ``serving`` block of ``/healthz``: queue depth, in-flight
    requests, pinned models and their freshness, the brownout rung, the
    last shed (reason and age) and the SLO state."""
    from oap_mllib_tpu_torch.serving import registry, slo

    out: Dict[str, Any] = {
        "queue_depth": registry.queue_depth(),
        "in_flight": sum(
            len(q._inflight) for q in list(_QUEUES)
        ),
        "pinned_models": len(registry.served_models()),
    }
    handles = list(registry.served_models().values())
    if handles:
        out["models"] = [
            {
                "kind": h.kind,
                "model_version": h.model_version,
                "staleness_seconds": round(h.touch_staleness(), 3),
            }
            for h in handles
        ]
    b = _BROWNOUT
    out["brownout_rung"] = BROWNOUT_RUNGS[b.rung] if b is not None \
        else "off"
    with _STATE_LOCK:
        last = _last_shed
    if last is not None:
        out["last_shed"] = {
            "reason": last[0],
            "age_s": round(max(0.0, time.monotonic() - last[1]), 3),
        }
    s = slo.brief()
    if s:
        out["slo"] = s
    return out


def _reset_for_tests() -> None:
    global _BROWNOUT, _last_shed
    with _STATE_LOCK:
        _scale_state.clear()
        _BROWNOUT = None
        _last_shed = None
