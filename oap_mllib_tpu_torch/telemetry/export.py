"""Telemetry exporters: the JSON-lines sink, the Prometheus text, fit
reports, and the fit boundary (the JAX package's ``telemetry/export.py``).

- **JSON-lines sink**: ``Config.telemetry_log`` (env
  ``OAP_MLLIB_TPU_TELEMETRY_LOG``).  Every :func:`finalize_fit` appends
  one record per span of the fit (type ``"span"``: path, duration,
  count, attrs), the flight recorder's new events (type
  ``"flightrec"``) and a registry snapshot (type ``"metrics"``); the
  exit hook appends a final drain and snapshot.  A world of several
  processes writes ``<path>.rank<r>``; records carry the rank and a
  monotonic ``seq``.  Empty: no file is ever opened.
- **Prometheus text**: ``telemetry.metrics.render_prometheus``.
- **Report**: :func:`report` renders one fit's span tree with its
  streamed overlap, compile split, program-cache and ladder counters,
  or with no summary the process's totals.
- **Request ledgers**: :func:`emit_requests` appends the sampled
  requests' ledgers (serving/reqtrace.py) as ``type: "request"``
  records, rank- and seq-tagged like the rest.

:func:`shutdown` is the one exit hook (:func:`register_shutdown`, at the
first sink write or endpoint start): the recorder's drain and the final
snapshot first, then the fleet endpoint stops.
"""

from __future__ import annotations

import atexit
import itertools
import json
import threading
from typing import Any, Dict, List, Optional

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.telemetry import metrics as _metrics
from oap_mllib_tpu_torch.telemetry.spans import Span
from oap_mllib_tpu_torch.utils import locktrace

_seq = itertools.count()
# tracked (utils/locktrace.py): the sink lock serializes writers from
# fit threads and the exit hook — a seam the "locks" sanitizer watches
_lock = locktrace.TrackedLock("telemetry.sink", threading.Lock())
_shutdown_registered = False


def _place():
    """``(processes, this process's index)``: the joined world's
    (parallel/bootstrap.py; a world may be joined with arguments instead
    of the config), else the config's."""
    from oap_mllib_tpu_torch.parallel import bootstrap

    if bootstrap.is_initialized():
        return bootstrap.world_size(), bootstrap.process_index()
    cfg = get_config()
    return int(cfg.num_processes), int(cfg.process_id)


def _rank() -> int:
    return _place()[1]


def sink_path() -> Optional[str]:
    """The armed JSONL path for THIS process, or None when telemetry
    logging is off.  Multi-process worlds get a per-rank suffix so
    concurrent writers never interleave inside one file."""
    path = get_config().telemetry_log
    if not path:
        return None
    processes, rank = _place()
    if processes > 1:
        return f"{path}.rank{rank}"
    return path


def _write_lines(path: str, records: List[Dict[str, Any]]) -> None:
    # the lock serializes appends into one sink file: the write is the
    # critical section
    with _lock, open(path, "a") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")


def register_shutdown() -> None:
    """Register :func:`shutdown` as the process's ONE exit hook
    (idempotent).  Called by the first sink emit and by the fleet
    endpoint arm — whichever exit-sensitive subsystem wakes first."""
    global _shutdown_registered
    if _shutdown_registered:
        return
    _shutdown_registered = True
    atexit.register(shutdown)


def shutdown() -> None:
    """The ordered interpreter-exit sequence (the atexit contract):

    1. drain the flight recorder + append the final metrics snapshot to
       the JSONL sink (one batch, so the tail and the snapshot land
       together and post-mortem tooling sees a complete stream);
    2. stop the fleet metrics endpoint LAST — a scraper can read the
       final state up to the moment the process stops answering.

    Each step is isolated: a failed sink write must not strand the
    server, and a failed teardown must not mask the exit."""
    try:
        _emit_final_snapshot()
    finally:
        from oap_mllib_tpu_torch.telemetry import fleet as _fleet

        _fleet.stop_server()


def _emit_final_snapshot() -> None:
    path = sink_path()
    if path is None:
        return
    from oap_mllib_tpu_torch.telemetry import flightrec

    records: List[Dict[str, Any]] = []
    events = flightrec.drain_new()
    if events:
        records.append({
            "type": "flightrec",
            "final": True,
            "rank": _rank(),
            "seq": next(_seq),
            "events": events,
        })
    records.append({
        "type": "metrics",
        "final": True,
        "rank": _rank(),
        "seq": next(_seq),
        "metrics": _metrics.snapshot(),
    })
    try:
        _write_lines(path, records)
    except OSError:
        pass  # a torn-down filesystem at exit must not mask the real exit


def emit_requests(records: List[Dict[str, Any]]) -> int:
    """Append finalized request-ledger records as ``type: "request"``
    lines; returns the number written (0 with the sink off, and on an
    ``OSError``: the sink is a diagnosis channel, never a liveness
    one)."""
    path = sink_path()
    if path is None or not records:
        return 0
    register_shutdown()
    rank = _rank()
    out = [
        dict(rec, type="request", rank=rank, seq=next(_seq))
        for rec in records
    ]
    try:
        _write_lines(path, out)
    except OSError:
        return 0
    return len(out)


def emit_fit(root: Span) -> None:
    """Append one record per span in ``root``'s tree (depth-first) plus
    a registry snapshot — the per-fit JSONL batch.  No-op when the sink
    is off (one config-string check)."""
    path = sink_path()
    if path is None:
        return
    register_shutdown()
    rank = _rank()
    records: List[Dict[str, Any]] = []
    for span_path, sp in root.walk():
        rec: Dict[str, Any] = {
            "type": "span",
            "fit": root.name,
            "path": span_path,
            "name": sp.name,
            "duration_s": sp.duration_s,
            "count": sp.count,
            "rank": rank,
            "seq": next(_seq),
        }
        if sp.attrs:
            rec["attrs"] = sp.attrs
        records.append(rec)
    # the flight recorder's events since the last drain ride the sink
    # as one batch: a per-process timeline of span opens and closes and
    # collective signatures
    from oap_mllib_tpu_torch.telemetry import flightrec

    events = flightrec.drain_new()
    if events:
        records.append({
            "type": "flightrec",
            "fit": root.name,
            "rank": rank,
            "seq": next(_seq),
            "events": events,
        })
    records.append({
        "type": "metrics",
        "fit": root.name,
        "rank": rank,
        "seq": next(_seq),
        "metrics": _metrics.snapshot(),
    })
    _write_lines(path, records)


# -- fit-summary attachment ---------------------------------------------------


def _summary_get(summary, key: str):
    if summary is None:
        return None
    if isinstance(summary, dict):
        return summary.get(key)
    return getattr(summary, key, None)


def finalize_fit(summary) -> None:
    """Close out one fit's telemetry: fill the root span's wall (sum of
    its top-level phases when the fit body was not itself timed), attach
    ``summary["telemetry"]`` = ``{fit, rank, spans, metrics}`` (dict
    summaries get the key, object summaries the attribute — the
    ``resilience.merge_stats`` convention), and flush the JSONL batch
    when the sink is armed.  Every fit route calls this once, at its
    outermost return."""
    timings = _summary_get(summary, "timings")
    if timings is None or summary is None:
        return
    # the sanitizers' boundary (utils/sanitizers.py): the armed set and
    # the fit's collective fingerprint, cross-checked across processes
    # (a tail divergence).  One config-string check when off.
    from oap_mllib_tpu_torch.utils import sanitizers as _san

    _san.finalize_fit_sanitizers(summary)
    root = timings.root
    if root.count == 0:
        root.duration_s = sum(c.duration_s for c in root.children)
    # the fleet boundary (telemetry/fleet.py): the fleet block and span,
    # the /healthz state, the live endpoint when metrics_port is set.
    from oap_mllib_tpu_torch.telemetry import fleet as _fleet

    _fleet.finalize_fit(summary, root)
    # the balance boundary (parallel/balance.py): a ``balance`` child
    # span for the block the fit landed.
    from oap_mllib_tpu_torch.parallel import balance as _balance

    _balance.finalize_fit(summary, root)
    _metrics.counter(
        "oap_fit_total", {"fit": root.name},
        help="Completed fits by root span name",
    ).inc()
    _metrics.histogram(
        "oap_fit_seconds", {"fit": root.name},
        help="Fit wall per root span",
    ).observe(root.duration_s)
    payload = {
        "fit": root.name,
        "rank": _rank(),
        "spans": root.as_dict(),
        "metrics": _metrics.snapshot(),
    }
    if isinstance(summary, dict):
        summary["telemetry"] = payload
    else:
        summary.telemetry = payload
    emit_fit(root)


# -- human-readable report ----------------------------------------------------


def _fmt_s(v: float) -> str:
    return f"{v * 1e3:.1f} ms" if v < 1.0 else f"{v:.3f} s"


def _span_lines(sp: Span, depth: int, out: List[str]) -> None:
    pad = "  " * depth
    extra = ""
    if sp.count > 1:
        extra += f"  x{sp.count}"
    coll = sp.attrs.get("collectives")
    if coll:
        ops = sum(c["ops"] for c in coll.values())
        byt = sum(c["bytes"] for c in coll.values())
        extra += f"  [collectives: {ops} ops, {byt} B]"
    out.append(f"{pad}{sp.name:<24s} {_fmt_s(sp.duration_s):>10s}{extra}")
    for c in sp.children:
        _span_lines(c, depth + 1, out)


def report(summary=None) -> str:
    """Render a per-fit telemetry report (span tree + the counters that
    matter), or — with no summary — a process-wide metrics digest."""
    if summary is None:
        return _process_report()
    timings = _summary_get(summary, "timings")
    lines: List[str] = []
    if timings is not None:
        root = timings.root
        if root.count == 0:
            root.duration_s = sum(c.duration_s for c in root.children)
        lines.append(f"== telemetry: {root.name} ==")
        _span_lines(root, 0, lines)
        for phase in [c.name for c in root.children]:
            eff = timings.overlap_efficiency(phase)
            if eff is not None:
                lines.append(
                    f"  {phase}: overlap efficiency "
                    f"{eff:.1%} (staging hidden behind compute)"
                )
            split = timings.compile_split(phase)
            if split is not None:
                lines.append(
                    f"  {phase}: compile {_fmt_s(split['compile'])}, "
                    f"execute {_fmt_s(split['execute'])}"
                )
    pc = _summary_get(summary, "progcache")
    if pc:
        rate = pc.get("hit_rate")
        lines.append(
            f"  progcache: {pc.get('hits', 0)} hits / "
            f"{pc.get('misses', 0)} misses"
            + (f" ({rate:.0%} hit rate)" if rate is not None else "")
        )
    rs = _summary_get(summary, "resilience")
    if rs and (rs.get("faults") or rs.get("retries")):
        lines.append(
            f"  resilience: {rs.get('faults', 0)} faults, "
            f"{rs.get('retries', 0)} retries, "
            f"{rs.get('degradations', 0)} degradations "
            f"({rs.get('backoff_s', 0.0):.2f}s backoff)"
        )
    return "\n".join(lines)


def _series_total(snap: Dict[str, Any], name: str) -> float:
    series = snap.get(name, {})
    total = 0.0
    for v in series.values():
        total += v["sum"] if isinstance(v, dict) else v
    return total


def _process_report() -> str:
    snap = _metrics.snapshot()
    lines = ["== telemetry: process metrics =="]
    rows = [
        ("fits completed", _series_total(snap, "oap_fit_total"), "d"),
        ("kernel builds", _series_total(snap, "oap_xla_compiles_total"), "d"),
        ("kernel build wall",
         _series_total(snap, "oap_xla_compile_seconds_total"), "s"),
        ("progcache hits", _series_total(snap, "oap_progcache_hits_total"), "d"),
        ("progcache misses",
         _series_total(snap, "oap_progcache_misses_total"), "d"),
        ("collective ops", _series_total(snap, "oap_collective_ops_total"), "d"),
        ("collective bytes",
         _series_total(snap, "oap_collective_bytes_total"), "d"),
        ("streamed chunks", _series_total(snap, "oap_prefetch_chunks_total"), "d"),
        ("streamed rows", _series_total(snap, "oap_stream_rows_total"), "d"),
        ("bytes staged", _series_total(snap, "oap_stream_bytes_staged_total"), "d"),
        ("resilience faults",
         _series_total(snap, "oap_resilience_faults_total"), "d"),
        ("kernel launches", _series_total(snap, "oap_kernel_launches_total"), "d"),
    ]
    for label, v, kind in rows:
        val = _fmt_s(v) if kind == "s" else str(int(v))
        lines.append(f"  {label:<20s} {val}")
    return "\n".join(lines)
