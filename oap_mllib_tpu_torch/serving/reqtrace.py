"""Request tracing: the deadline-budget ledger every admitted request
carries through the traffic plane (the port of the JAX package's
``serving/reqtrace.py``; the same names, ids, sampling rule, stages and
record schema).

With ``Config.serve_trace_sample`` > 0 every ADMITTED request gets a
:class:`TraceContext` (a deterministic id, and a sampled flag from the
crc32 of that id, so both packages and every process sample the same
ids) and a :class:`Ledger` riding its future, with a fixed stage
schema:

========== ==================================================
stage       what the wall covers
========== ==================================================
admission   ``submit`` entry -> admitted (pricing, brownout,
            queue checks under the admission lock)
queue_wait  admitted -> popped by a dispatch cycle (retry
            backoff waits included)
batch_form  popped -> its group's scoring call begins
bucket_pad  inside the flush: padding the joined batch to its
            row bucket (``batcher.bucket_batch``)
compile     inside the flush: the program cache's kernel-library
            builds and loads (``progcache.xla_compile_secs``,
            the counterpart of the JAX package's XLA compile
            wall); zero once the libraries are loaded, so zero
            in a warm storm
execute     inside the flush: the rest of the scoring call
            (staging, the products, the fetch)
dispatch    scoring returned -> future resolved
========== ==================================================

The stages sum to the request wall by construction: every cut closes
the whole interval since the previous one (:meth:`Ledger.cut`), and the
flush split (:meth:`Ledger.cut_flush`) clamps its parts to the flush.
Events that are not stages (retry, poison, brownout, drain, fault) go to
the ledger's event list.

A finalized ledger books the ``oap_serve_stage_seconds{stage=}``
histograms (trace-id exemplars on sampled requests),
``oap_serve_traced_total{outcome=}``, feeds the SLO engine
(serving/slo.py), and, sampled, a flight-recorder ``request`` event and
a JSON-lines ``request`` record (telemetry/export.emit_requests).
Disarmed (the default) :func:`begin` returns None and every other hook
is a thread-local miss.
"""

from __future__ import annotations

import threading
import zlib
from typing import Any, Dict, List, Optional

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import locktrace

# the fixed stage schema, in lifecycle order
STAGES = (
    "admission",
    "queue_wait",
    "batch_form",
    "bucket_pad",
    "compile",
    "execute",
    "dispatch",
)

# terminal outcomes a ledger finalizes with
OUTCOMES = ("answered", "shed", "failed", "cancelled")

_STATE_LOCK = locktrace.TrackedLock("serving.reqtrace")
_wall_sum = 0.0   # finalized request walls (coverage denominator)
_stage_sum = 0.0  # finalized stage sums (coverage numerator)
_finalized = 0

_tls = threading.local()


def trace_sample_cfg(cfg=None) -> float:
    """Validated ``Config.serve_trace_sample``: outside [0, 1] raises."""
    cfg = cfg or get_config()
    sample = float(cfg.serve_trace_sample)
    if not 0.0 <= sample <= 1.0:
        raise ValueError(
            f"serve_trace_sample must be in [0, 1] (0 = tracing off), "
            f"got {sample}"
        )
    return sample


def armed() -> bool:
    """One config check: the off-path cost at the submit seam."""
    return get_config().serve_trace_sample != 0


def is_sampled(trace_id: str, sample: float) -> bool:
    """Whether ``trace_id`` is sampled at fraction ``sample``: the crc32
    of the id against the fraction, no RNG."""
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) / 2**32 < sample


def make_trace_id(rank: int, seq: int) -> str:
    """The id of admission ``seq`` on process ``rank``."""
    return f"{rank:02x}-{seq:08x}"


class TraceContext:
    """Who a traced request is (id, rank, admission seq), what it was
    promised (deadline), and whether it is sampled."""

    __slots__ = ("trace_id", "rank", "seq", "deadline_ms", "sampled")

    def __init__(self, rank: int, seq: int, deadline_ms: float,
                 sample: float):
        self.rank = int(rank)
        self.seq = int(seq)
        self.deadline_ms = float(deadline_ms)
        self.trace_id = make_trace_id(self.rank, self.seq)
        self.sampled = is_sampled(self.trace_id, sample)


class Ledger:
    """Where a request's wall went, stage by stage, and its events.

    Every stamp comes from the owning queue's clock (injectable), and
    :meth:`cut` closes the whole interval since the last boundary, so the
    stages sum to ``t_end - t0``, retries and all."""

    __slots__ = ("ctx", "t0", "stages", "events", "outcome", "model",
                 "wall_s", "retries", "_last")

    def __init__(self, ctx: TraceContext, t0: float):
        self.ctx = ctx
        self.t0 = float(t0)
        self.stages: Dict[str, float] = {s: 0.0 for s in STAGES}
        self.events: List[Dict[str, Any]] = []
        self.outcome = ""
        self.model = ""
        self.wall_s = 0.0
        self.retries = 0
        self._last = float(t0)

    def cut(self, stage: str, now: float) -> None:
        """Close the interval since the last boundary into ``stage``."""
        self.stages[stage] += max(0.0, float(now) - self._last)
        self._last = float(now)

    def cut_flush(self, now: float, pad_s: float, compile_s: float) -> None:
        """Close the scoring flush, split into bucket padding, kernel
        builds and execute (the rest), each part clamped to the flush so
        the sum stays the wall whatever the measurements say."""
        flush = max(0.0, float(now) - self._last)
        pad = min(max(0.0, float(pad_s)), flush)
        comp = min(max(0.0, float(compile_s)), flush - pad)
        self.stages["bucket_pad"] += pad
        self.stages["compile"] += comp
        self.stages["execute"] += flush - pad - comp
        self._last = float(now)

    def event(self, kind: str, detail: str, t: float) -> None:
        """Append one lifecycle event that is not a stage."""
        self.events.append(
            {"kind": str(kind), "t": float(t), "detail": str(detail)}
        )

    def stage_sum(self) -> float:
        return sum(self.stages.values())

    def as_record(self) -> Dict[str, Any]:
        """The JSON-lines ``type: "request"`` payload."""
        return {
            "trace_id": self.ctx.trace_id,
            "seq": self.ctx.seq,
            "rank": self.ctx.rank,
            "deadline_ms": self.ctx.deadline_ms,
            "sampled": self.ctx.sampled,
            "t0": self.t0,
            "wall_s": self.wall_s,
            "outcome": self.outcome,
            "model": self.model,
            "retries": self.retries,
            "stages": {s: self.stages[s] for s in STAGES},
            "events": list(self.events),
        }


def begin(queue_clock_now: float, rank: int, seq: int,
          deadline_ms: float) -> Optional[Ledger]:
    """A ledger for one admission, or None when tracing is off."""
    sample = trace_sample_cfg()
    if sample == 0.0:
        return None
    ctx = TraceContext(rank, seq, deadline_ms, sample)
    return Ledger(ctx, queue_clock_now)


def finalize(ledger: Optional[Ledger], outcome: str, now: float,
             model: str = "") -> None:
    """Close a ledger once: outcome and wall, the stage histograms, the
    outcome counter, the SLO engine and, sampled, the flight recorder
    and the sink.  A second call is a no-op (whoever lands the future
    finalizes)."""
    if ledger is None:
        return
    if ledger.outcome:
        return
    ledger.outcome = outcome if outcome in OUTCOMES else "failed"
    if model:
        ledger.model = model
    # the final boundary is the future landing, whatever path got here
    ledger.cut("dispatch", now)
    ledger.wall_s = max(0.0, float(now) - ledger.t0)
    exemplar = (
        {"trace_id": ledger.ctx.trace_id} if ledger.ctx.sampled else None
    )
    for stage in STAGES:
        v = ledger.stages[stage]
        if v > 0.0 or stage in ("queue_wait", "execute"):
            _tm.histogram(
                "oap_serve_stage_seconds", {"stage": stage},
                help="Per-request wall attributed to each traffic-plane "
                     "lifecycle stage (serving/reqtrace.py; stages sum "
                     "to the request wall)",
            ).observe(v, exemplar=exemplar)
    global _wall_sum, _stage_sum, _finalized
    with _STATE_LOCK:
        _wall_sum += ledger.wall_s
        _stage_sum += ledger.stage_sum()
        _finalized += 1
    _tm.counter(
        "oap_serve_traced_total", {"outcome": ledger.outcome},
        help="Traced requests finalized, by outcome",
    ).inc()
    from oap_mllib_tpu_torch.serving import slo

    slo.observe_request(
        ledger.wall_s, ok=ledger.outcome == "answered", t=now
    )
    if ledger.ctx.sampled:
        from oap_mllib_tpu_torch.telemetry import export, flightrec

        flightrec.record(
            "request", ledger.ctx.trace_id,
            f"outcome={ledger.outcome} wall_ms="
            f"{ledger.wall_s * 1e3:.3f} retries={ledger.retries}",
        )
        export.emit_requests([ledger.as_record()])


# -- thread-local attach: notes from below the traffic plane -------------------


class attach:
    """Bind the ledgers of an in-flight flush to the scoring thread, so
    seams below the traffic plane (the batcher's pad timing) fold into
    them without plumbing ``predict_many``.

    :meth:`flush_notes` keeps the notes past the block's exit, where the
    traffic plane reads them.  (The JAX package reads the thread-local
    after its exit has cleared it, so its ``bucket_pad`` stage is always
    0 and the pad lands in ``execute``.)"""

    def __init__(self, ledgers: List[Ledger]):
        self._ledgers = [lg for lg in ledgers if lg is not None]
        self._notes: Dict[str, float] = {}

    def __enter__(self):
        _tls.ledgers = self._ledgers
        _tls.flush = self._notes
        return self

    def __exit__(self, *exc) -> None:
        _tls.ledgers = None
        _tls.flush = None

    def flush_notes(self) -> Dict[str, float]:
        return dict(self._notes)


def current_ledgers() -> List[Ledger]:
    """The ledgers attached to this thread's flush ([] when none)."""
    return list(getattr(_tls, "ledgers", None) or [])


def exemplar_trace_id() -> Optional[str]:
    """A sampled trace id of the attached flush, or None: the exemplar
    the request-latency histogram pins to its bucket."""
    for lg in getattr(_tls, "ledgers", None) or ():
        if lg.ctx.sampled:
            return lg.ctx.trace_id
    return None


def note_flush(stage: str, seconds: float) -> None:
    """Add a measurement inside the attached flush (``bucket_pad`` from
    the batcher); a thread-local miss when none is attached."""
    acc = getattr(_tls, "flush", None)
    if acc is not None:
        acc[stage] = acc.get(stage, 0.0) + float(seconds)


def note_event(kind: str, detail: str, t: float) -> None:
    """Append an event to every attached ledger."""
    for lg in getattr(_tls, "ledgers", None) or ():
        lg.event(kind, detail, t)


# -- attribution rollup ---------------------------------------------------------


def stage_quantiles() -> Dict[str, Dict[str, float]]:
    """Per-stage p50 / p99 from the ``oap_serve_stage_seconds``
    histograms (upper-bound bucket estimates)."""
    reg = _tm.registry()
    out: Dict[str, Dict[str, float]] = {}
    with _tm._LOCK:
        series = [
            (dict(labels).get("stage", ""), m)
            for (name, labels), m in reg._metrics.items()
            if name == "oap_serve_stage_seconds"
        ]
    for stage, h in series:
        if h.count == 0:
            continue
        out[stage] = {
            "p50_s": _tm.histogram_quantile(h, 0.50),
            "p99_s": _tm.histogram_quantile(h, 0.99),
            "count": int(h.count),
            "sum_s": round(float(h.sum), 6),
        }
    return out


def attribution_block() -> Dict[str, Any]:
    """``serving_summary()["attribution"]``: per-stage p50 / p99 and the
    stage-sum over request-wall coverage (1.0 by construction); {} when
    nothing was traced."""
    with _STATE_LOCK:
        finalized, wall, stages = _finalized, _wall_sum, _stage_sum
    if finalized == 0:
        return {}
    return {
        "traced": finalized,
        "wall_s": round(wall, 6),
        "stage_s": round(stages, 6),
        "coverage": round(stages / wall, 4) if wall > 0 else 1.0,
        "stages": stage_quantiles(),
    }


def ledger_of(future) -> Optional[Ledger]:
    """The ledger of a traffic future, or None (tracing was off)."""
    return getattr(future, "ledger", None)


def _reset_for_tests() -> None:
    global _wall_sum, _stage_sum, _finalized
    with _STATE_LOCK:
        _wall_sum = 0.0
        _stage_sum = 0.0
        _finalized = 0
    _tls.ledgers = None
    _tls.flush = None
