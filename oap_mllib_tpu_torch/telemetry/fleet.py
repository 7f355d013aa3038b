"""Fleet rollups: per-pass statistics of every process of a world (the
rollup half of the JAX package's ``telemetry/fleet.py``).

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

Not ported here: the JAX package's ``oap_fleet_*`` metrics, its HTTP
``/metrics`` and ``/healthz`` endpoints and its flight-recorder events
(ROADMAP A8).  The frame keeps all nine fields in the JAX order;
``retries`` is the process's transient retries over every fit so far
(utils/resilience.retries_total), and ``kernel_dispatch_s`` reads 0
until A8 ports the metrics registry it counts.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.utils import resilience

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
        0.0,  # kernel_dispatch_s: the metrics registry is not ported (A8)
        float(stats.rows),
        balance.cached_capability(),
    ], np.float64)


_state_lock = threading.Lock()
_window: List[Dict[str, Any]] = []
_passes = 0
_wall_totals: Optional[np.ndarray] = None
_row_totals: Optional[np.ndarray] = None
_capability: Optional[np.ndarray] = None


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


def finalize_fit(summary, world: int) -> None:
    """At a fit's end: put the ``fleet`` block in ``summary`` (a dict's
    key, else an attribute) when the rollups are armed, then reset the
    window.  Disarmed, one config check."""
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


def reset_fit() -> None:
    """Drop the current fit's window."""
    global _passes, _wall_totals, _row_totals, _capability
    with _state_lock:
        _window.clear()
        _passes = 0
        _wall_totals = _row_totals = _capability = None
