"""Fleet rollups and the live endpoint (the JAX package's
``telemetry/fleet.py``).

After each streamed pass every process contributes one fixed-shape frame
(:data:`FRAME_FIELDS`, float64) to one gather over the host collectives
(ops/stream_ops._fleet_pass); every process then holds the same
``(world, fields)`` frames and folds them here into the fit's window:
the skew ratio (the slowest process's pass wall over the mean), the
slowest process, per-process totals and the imbalance trend.  A fit's
summary gains a ``fleet`` block (:func:`finalize_fit`).  The straggler
controller (parallel/balance.observe_pass) reads the same frames, so
every process takes the same decision without another collective.

Whether a fit collects is a pure function of ``Config.fleet_stats`` and
the world's size (:func:`armed`), so every process issues the same
gathers.  This module issues no collective itself.

Process 0 folds each pass's frames into the ``oap_fleet_*`` gauges and
histograms.  The frame keeps all nine fields in the JAX order:
``retries`` is the process's transient retries over every fit so far
(utils/resilience.retries_total), ``kernel_dispatch_s`` the host
dispatch wall of every kernel launch so far (the
``oap_kernel_dispatch_seconds`` family, ops/cuda/_tiers.book_launch).

**The live endpoint** (``Config.metrics_port`` > 0): one stdlib
``http.server`` daemon thread a process on ``metrics_port +
process_id`` serves ``GET /metrics`` (the registry's Prometheus text,
telemetry/metrics.py) and ``GET /healthz`` (the JAX package's keys: fit
root, phase, step, ladder, last completed collective, flight-recorder
seq, capability, rows processed, and the ``serving`` block of
serving/traffic.serving_health_block) and ``GET /sloz`` (the SLO
engine's state, serving/slo.py).  It starts at the first fit boundary
or folded pass and stops in :func:`stop_server` (the exit hook,
telemetry/export.shutdown).  A port that cannot be bound raises
(the JAX package warns and serves nothing): an endpoint that was asked
for is never skipped in silence.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import locktrace, resilience

log = logging.getLogger("oap_mllib_tpu_torch")

# one float64 per field; walls and bytes are the pass's, rows the rows
# this process staged in it, capability its weight (0 = not known yet)
FRAME_FIELDS = (
    "pass_wall_s",
    "stage_s",
    "transfer_s",
    "compute_s",
    "bytes_staged",
    "retries",
    "kernel_dispatch_s",
    "rows",
    "capability",
)

# metric family per frame field
_FIELD_METRICS = {
    "pass_wall_s": "oap_fleet_pass_seconds",
    "stage_s": "oap_fleet_stage_seconds",
    "transfer_s": "oap_fleet_transfer_seconds",
    "compute_s": "oap_fleet_compute_seconds",
    "bytes_staged": "oap_fleet_bytes_staged",
    "retries": "oap_fleet_retries",
    "kernel_dispatch_s": "oap_fleet_kernel_dispatch_seconds",
    "rows": "oap_fleet_rows",
    "capability": "oap_fleet_capability",
}

_STATS = ("min", "max", "mean", "p99")

# passes whose raw frames a fit keeps; later passes still count in the
# totals
_WINDOW_CAP = 512


def fleet_stats_cfg(cfg=None) -> str:
    """Validated ``Config.fleet_stats``: a typo raises."""
    cfg = cfg or get_config()
    mode = cfg.fleet_stats
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fleet_stats must be auto|on|off, got {mode!r}")
    return mode


def metrics_port_cfg(cfg=None) -> int:
    """Validated ``Config.metrics_port``: negative raises."""
    cfg = cfg or get_config()
    port = int(cfg.metrics_port)
    if port < 0:
        raise ValueError(f"metrics_port must be >= 0 (0 = no live endpoint), got {port}")
    return port


def _rank() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.process_index()


def _world() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.world_size()


def armed(world: int, cfg=None) -> bool:
    """Whether a fit in a world of ``world`` processes collects the
    rollups: "on" always, "off" never, "auto" with several processes."""
    mode = fleet_stats_cfg(cfg)
    if mode == "off":
        return False
    return mode == "on" or world > 1


def local_frame(stats, pass_wall_s: float) -> np.ndarray:
    """This process's frame for one finished pass, from the pass's
    ``PrefetchStats``: shape ``(len(FRAME_FIELDS),)`` float64.  It reads
    the capability already gathered or pinned and never probes."""
    from oap_mllib_tpu_torch.parallel import balance

    return np.asarray([
        float(pass_wall_s),
        float(stats.stage_s),
        float(stats.transfer_s),
        max(float(pass_wall_s) - float(stats.wait_s), 0.0),
        float(stats.bytes_staged),
        float(resilience.retries_total()),
        _tm.registry().family_total("oap_kernel_dispatch_seconds"),
        float(stats.rows),
        balance.cached_capability(),
    ], np.float64)


# the /healthz handler thread reads under this lock while passes write
_state_lock = locktrace.TrackedLock("fleet.state", threading.Lock())
_window: List[Dict[str, Any]] = []
_passes = 0
_wall_totals: Optional[np.ndarray] = None
_row_totals: Optional[np.ndarray] = None
_capability: Optional[np.ndarray] = None
_health: Dict[str, Any] = {"fit": "", "step": 0, "ladder": "", "phase": ""}


def note_state(**kw) -> None:
    """Merge fields into the /healthz state (fit root, ladder, ...)."""
    with _state_lock:
        _health.update(kw)


def fold_pass(phase: str, frames) -> Dict[str, Any]:
    """Fold one pass's gathered frames, ``(world, len(FRAME_FIELDS))``,
    into the fit's window; returns the pass's record."""
    global _passes, _wall_totals, _row_totals, _capability
    frames = np.asarray(frames, np.float64)
    if frames.ndim != 2 or frames.shape[1] != len(FRAME_FIELDS):
        raise ValueError(f"fleet frame shape {frames.shape} != (world, {len(FRAME_FIELDS)})")
    world = frames.shape[0]
    walls = frames[:, 0]
    mean_wall = float(walls.mean())
    rec = {
        "phase": phase,
        "world": world,
        "skew_ratio": float(walls.max() / mean_wall) if mean_wall > 0 else 1.0,
        "slowest_rank": int(np.argmax(walls)),
        "frames": frames.tolist(),
        "fields": {f: {"min": float(frames[:, i].min()), "max": float(frames[:, i].max()),
                       "mean": float(frames[:, i].mean()),
                       "p99": float(np.percentile(frames[:, i], 99))}
                   for i, f in enumerate(FRAME_FIELDS)},
    }
    with _state_lock:
        _passes += 1
        if _wall_totals is None or len(_wall_totals) != world:
            _wall_totals = np.zeros((world,), np.float64)
            _row_totals = np.zeros((world,), np.float64)
        _wall_totals += walls
        _row_totals += frames[:, FRAME_FIELDS.index("rows")]
        _capability = frames[:, FRAME_FIELDS.index("capability")].copy()
        if len(_window) < _WINDOW_CAP:
            _window.append(rec)
        _health["step"] = _passes
        _health["phase"] = phase
    if _rank() == 0:
        for i, f in enumerate(FRAME_FIELDS):
            for stat in _STATS:
                _tm.gauge(_FIELD_METRICS[f], {"stat": stat},
                          help=f"Fleet rollup of per-rank {f} (last pass, across ranks)",
                          ).set(rec["fields"][f][stat])
        _tm.gauge("oap_fleet_skew_ratio",
                  help="Max/mean per-rank pass wall of the last rolled-up pass",
                  ).set(rec["skew_ratio"])
        _tm.gauge("oap_fleet_slowest_rank",
                  help="Rank with the largest pass wall in the last rollup",
                  ).set(rec["slowest_rank"])
        _tm.counter("oap_fleet_passes_total",
                    help="Streamed passes folded into fleet rollups").inc()
        hist = _tm.histogram("oap_fleet_pass_wall_seconds",
                             help="Per-rank pass walls observed by fleet rollups")
        for w in walls:
            hist.observe(float(w))
    maybe_serve()
    return rec


def _trend(skews: List[float]) -> str:
    """The imbalance trend of a fit's passes: the mean skew of the second
    half against the first's, "rising" above 1.1x, "falling" below
    0.9x, else "flat" (also with fewer than four passes)."""
    if len(skews) < 4:
        return "flat"
    half = len(skews) // 2
    first = float(np.mean(skews[:half]))
    second = float(np.mean(skews[half:]))
    if first <= 0:
        return "flat"
    ratio = second / first
    if ratio > 1.1:
        return "rising"
    if ratio < 0.9:
        return "falling"
    return "flat"


def summary_block() -> Optional[Dict[str, Any]]:
    """The fit's ``fleet`` block, or None when no pass was folded."""
    with _state_lock:
        if _passes == 0:
            return None
        window = list(_window)
        passes = _passes
        totals = None if _wall_totals is None else np.array(_wall_totals)
        rows = None if _row_totals is None else np.array(_row_totals)
        caps = None if _capability is None else np.array(_capability)
    world = window[-1]["world"] if window else 1
    skews = [w["skew_ratio"] for w in window]
    block: Dict[str, Any] = {
        "world": world,
        "passes": passes,
        "skew_ratio": skews[-1] if skews else 1.0,
        "imbalance_trend": _trend(skews),
        "window_truncated": passes > len(window),
    }
    if totals is not None and len(totals) == world:
        mean = float(totals.mean())
        block["slowest_rank"] = int(np.argmax(totals))
        block["per_rank_pass_s"] = [round(float(t), 6) for t in totals]
        block["fit_skew_ratio"] = float(totals.max() / mean) if mean > 0 else 1.0
    if rows is not None and len(rows) == world:
        block["per_rank_rows"] = [int(r) for r in rows]
    if caps is not None and len(caps) == world:
        block["per_rank_capability"] = [round(float(c), 4) for c in caps]
    return block


def last_window() -> List[Dict[str, Any]]:
    """The current fit's per-pass records."""
    with _state_lock:
        return list(_window)


def land_block(summary, world: int) -> None:
    """At a streamed fit's end (ops/stream_ops.end_fit): put the
    ``fleet`` block in ``summary`` (a dict's key, else an attribute) when
    the rollups are armed, then reset the window.  Disarmed, one config
    check."""
    if not armed(world):
        return
    block = summary_block()
    reset_fit()
    if summary is None:
        return
    block = dict(block or {"world": world, "passes": 0}, enabled=True)
    if isinstance(summary, dict):
        summary["fleet"] = block
    else:
        summary.fleet = block


def _summary_get(summary, key: str):
    if summary is None:
        return None
    if isinstance(summary, dict):
        return summary.get(key)
    return getattr(summary, key, None)


def finalize_fit(summary, root) -> None:
    """The fit-boundary hook (telemetry/export.finalize_fit): start the
    live endpoint when ``metrics_port`` is set; armed, land the ``fleet``
    block (a streamed attempt landed its own already; a fit with no
    streamed pass gets ``passes`` 0), give the root a ``fleet`` child
    span with the straggler figures, and update the /healthz state.
    One config check each when the plane is off."""
    cfg = get_config()
    world = _world()
    if cfg.metrics_port:
        maybe_serve(cfg)
    if not armed(world, cfg):
        return
    block = _summary_get(summary, "fleet")
    if block is None:
        land_block(summary, world)
        block = _summary_get(summary, "fleet")
    if summary is None or block is None:
        return
    if root is not None:
        root.node("fleet").attrs.update({
            k: block[k] for k in ("world", "passes", "skew_ratio", "slowest_rank",
                                  "imbalance_trend", "fit_skew_ratio") if k in block})
    res = _summary_get(summary, "resilience")
    note_state(fit=getattr(root, "name", "") if root is not None else "",
               ladder=(res.get("ladder") if isinstance(res, dict) else None) or "")


def reset_fit() -> None:
    """Drop the current fit's window."""
    global _passes, _wall_totals, _row_totals, _capability
    with _state_lock:
        _window.clear()
        _passes = 0
        _wall_totals = _row_totals = _capability = None


# -- the live endpoint -----------------------------------------------------------

_server_lock = locktrace.TrackedLock("fleet.server", threading.Lock())
_server: Optional[http.server.ThreadingHTTPServer] = None
_server_port: Optional[int] = None


def _healthz_payload() -> Dict[str, Any]:
    from oap_mllib_tpu_torch.parallel import balance
    from oap_mllib_tpu_torch.telemetry import flightrec
    from oap_mllib_tpu_torch.utils import recovery

    cfg = get_config()
    rank = int(cfg.process_id)
    with _state_lock:
        health = dict(_health)
        rows_done = (int(_row_totals[rank]) if _row_totals is not None
                     and rank < len(_row_totals) else 0)
    payload = {
        "ok": True,
        "rank": rank,
        "world": int(cfg.num_processes),
        "fit": health.get("fit", ""),
        "phase": health.get("phase", ""),
        "step": health.get("step", 0),
        "ladder": health.get("ladder", ""),
        "last_collective": recovery.last_completed(),
        "flight_recorder_seq": flightrec.last_seq(),
        "fleet_passes": health.get("step", 0),
        "capability": balance.cached_capability(),
        "rows_processed": rows_done,
    }
    try:
        from oap_mllib_tpu_torch.serving import traffic

        payload["serving"] = traffic.serving_health_block()
    except Exception:  # noqa: BLE001 -- health renders regardless
        payload["serving"] = {}
    return payload


def _sloz_payload() -> Dict[str, Any]:
    """``GET /sloz``: the SLO engine's state (``{"armed": false}`` with
    ``serve_slo_p99_ms`` 0)."""
    from oap_mllib_tpu_torch.serving import slo

    return slo.state()


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 -- the stdlib handler's name
        path = self.path.split("?")[0]
        if path == "/metrics":
            body = _tm.render_prometheus().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/healthz":
            body = (json.dumps(_healthz_payload(), sort_keys=True) + "\n").encode()
            ctype = "application/json"
        elif path == "/sloz":
            body = (json.dumps(_sloz_payload(), sort_keys=True) + "\n").encode()
            ctype = "application/json"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence the stdlib's request log
        pass


def maybe_serve(cfg=None) -> Optional[int]:
    """Start (once) this process's endpoint when ``Config.metrics_port``
    > 0, on ``metrics_port + process_id``; returns the bound port, or
    None when off.  A port that cannot be bound raises ``OSError``.  The
    lock covers only the swap: a stale server is detached under it and
    shut down after release."""
    global _server, _server_port
    cfg = cfg or get_config()
    base = metrics_port_cfg(cfg)
    if base == 0:
        return None
    port = base + int(cfg.process_id)
    stale = None
    with _server_lock:
        if _server is not None and _server_port == port:
            return port
        if _server is not None:
            stale, _server, _server_port = _server, None, None
    _stop_http(stale)
    try:
        srv = http.server.ThreadingHTTPServer(("", port), _Handler)
    except OSError as e:
        raise OSError(e.errno, f"metrics endpoint: cannot bind port {port} "
                               f"(metrics_port {base} + process {cfg.process_id}): {e}") from e
    srv.daemon_threads = True
    thread = threading.Thread(target=srv.serve_forever, daemon=True, name=f"oap-metrics-{port}")
    loser = None
    with _server_lock:
        if _server is not None:
            loser = srv  # a racing arm won
        else:
            _server, _server_port = srv, port
            thread.start()
    if loser is not None:
        loser.server_close()
        return server_port()
    from oap_mllib_tpu_torch.telemetry import export as _export

    _export.register_shutdown()
    log.info("fleet: serving /metrics, /healthz and /sloz on port %d", port)
    return port


def server_port() -> Optional[int]:
    with _server_lock:
        return _server_port


def _stop_http(srv) -> None:
    """Shut a detached server down (no lock held: ``shutdown`` waits for
    the serve loop)."""
    if srv is None:
        return
    srv.shutdown()
    srv.server_close()


def stop_server() -> None:
    """Stop the endpoint: detach under the lock, shut down after."""
    global _server, _server_port
    with _server_lock:
        srv, _server, _server_port = _server, None, None
    _stop_http(srv)


def _reset_for_tests() -> None:
    stop_server()
    reset_fit()
    with _state_lock:
        _health.update({"fit": "", "step": 0, "ladder": "", "phase": ""})
