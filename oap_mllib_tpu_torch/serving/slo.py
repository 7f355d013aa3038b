"""The SLO / error-budget engine: multi-window burn rates over the
request ledgers (the port of the JAX package's ``serving/slo.py``).

Armed by ``Config.serve_slo_p99_ms`` > 0, every finalized ledger
(serving/reqtrace.finalize) is one observation: bad when the request
failed or was shed, or its wall passed the p99 target.  Two sliding
windows, the slow one ``Config.serve_slo_window_s`` and the fast one a
twelfth of it, give:

- the **burn rate** of each window: the bad fraction over the error
  budget (1 - ``Config.serve_slo_availability``); 1.0 spends the budget
  exactly over the window;
- the **error budget remaining** over the slow window, floored at 0;
- **breach** when both windows burn above 1.0.

The state is observed, never acted on: the ``oap_slo_burn_rate{window=}``
and ``oap_slo_error_budget_remaining`` gauges, ``serving_summary()
["slo"]``, ``GET /sloz`` (telemetry/fleet.py), and :func:`brief`, which
the scale and brownout controllers record with each decision.  The
engine's clock is injectable; the singleton is rebuilt when a knob
changes.  Disarmed, :func:`observe_request` is one config check.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import locktrace

_LOCK = locktrace.TrackedLock("serving.slo")
_ENGINE: Optional["SLOEngine"] = None

# the fast window is the slow window / 12 (the SRE 5m-against-1h pair)
FAST_DIVISOR = 12.0


def slo_cfg(cfg=None) -> Dict[str, float]:
    """Validated SLO knobs; a typo raises when the engine is consulted."""
    cfg = cfg or get_config()
    p99_ms = float(cfg.serve_slo_p99_ms)
    if p99_ms < 0:
        raise ValueError(
            f"serve_slo_p99_ms must be >= 0 (0 = SLO engine off), got "
            f"{p99_ms}"
        )
    availability = float(cfg.serve_slo_availability)
    if not 0.0 < availability < 1.0:
        raise ValueError(
            f"serve_slo_availability must be in (0, 1), got "
            f"{availability}"
        )
    window_s = float(cfg.serve_slo_window_s)
    if window_s <= 0:
        raise ValueError(
            f"serve_slo_window_s must be > 0, got {window_s}"
        )
    return {
        "p99_ms": p99_ms,
        "availability": availability,
        "window_s": window_s,
    }


def armed() -> bool:
    """One config check: the off-path cost at ledger finalization."""
    return get_config().serve_slo_p99_ms > 0


class SLOEngine:
    """Sliding-window burn-rate accounting over (t, bad) samples.  The
    slow window prunes lazily; every mutation runs under the engine's
    lock (the dispatcher's finalizations race ``/sloz`` scrapes)."""

    def __init__(self, p99_ms: float, availability: float,
                 window_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.p99_ms = float(p99_ms)
        self.availability = float(availability)
        self.window_s = float(window_s)
        self.fast_window_s = self.window_s / FAST_DIVISOR
        self.budget_frac = 1.0 - self.availability
        self._clock = clock
        self._lock = locktrace.TrackedLock("serving.slo.engine")
        self._samples: deque = deque()  # (t, bad), slow-window pruned
        self.total = 0
        self.bad = 0

    # -- ingestion ------------------------------------------------------------

    def observe(self, wall_s: float, ok: bool,
                t: Optional[float] = None) -> None:
        """Fold one finished request: bad when it failed or passed the
        p99 target."""
        now = self._clock() if t is None else float(t)
        bad = (not ok) or (
            self.p99_ms > 0 and float(wall_s) * 1e3 > self.p99_ms
        )
        with self._lock:
            self._samples.append((now, bad))
            self.total += 1
            if bad:
                self.bad += 1
            self._prune(now)
        self._gauges(now)

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        samples = self._samples
        while samples and samples[0][0] < cutoff:
            samples.popleft()

    # -- reads ----------------------------------------------------------------

    def _window_counts(self, now: float, window_s: float) -> tuple:
        cutoff = now - window_s
        total = bad = 0
        for t, b in self._samples:
            if t >= cutoff:
                total += 1
                if b:
                    bad += 1
        return total, bad

    def burn_rate(self, window_s: float,
                  t: Optional[float] = None) -> float:
        """(bad fraction over the window) / (error-budget fraction)."""
        now = self._clock() if t is None else float(t)
        with self._lock:
            self._prune(now)
            total, bad = self._window_counts(now, window_s)
        if total == 0:
            return 0.0
        return (bad / total) / self.budget_frac

    def budget_remaining(self, t: Optional[float] = None) -> float:
        """Share of the slow window's error budget left, floored at 0."""
        now = self._clock() if t is None else float(t)
        with self._lock:
            self._prune(now)
            total, bad = self._window_counts(now, self.window_s)
        if total == 0:
            return 1.0
        allowed = total * self.budget_frac
        return max(0.0, 1.0 - bad / allowed) if allowed > 0 else 0.0

    def state(self, t: Optional[float] = None) -> Dict[str, Any]:
        """The ``/sloz`` and summary payload."""
        now = self._clock() if t is None else float(t)
        fast = self.burn_rate(self.fast_window_s, t=now)
        slow = self.burn_rate(self.window_s, t=now)
        with self._lock:
            total, bad = self._window_counts(now, self.window_s)
            lifetime_total, lifetime_bad = self.total, self.bad
        return {
            "armed": True,
            "p99_ms": self.p99_ms,
            "availability": self.availability,
            "window_s": self.window_s,
            "fast_window_s": self.fast_window_s,
            "requests": total,
            "bad": bad,
            "lifetime_requests": lifetime_total,
            "lifetime_bad": lifetime_bad,
            "burn_rate_fast": round(fast, 4),
            "burn_rate_slow": round(slow, 4),
            "error_budget_remaining": round(
                self.budget_remaining(t=now), 4
            ),
            "breach": fast > 1.0 and slow > 1.0,
        }

    def brief(self, t: Optional[float] = None) -> Dict[str, Any]:
        """What a scale or brownout decision records."""
        s = self.state(t=t)
        return {
            "burn_rate_fast": s["burn_rate_fast"],
            "burn_rate_slow": s["burn_rate_slow"],
            "error_budget_remaining": s["error_budget_remaining"],
            "breach": s["breach"],
        }

    def _gauges(self, now: float) -> None:
        _tm.gauge(
            "oap_slo_burn_rate", {"window": "fast"},
            help="Error-budget burn rate (bad fraction / budget "
                 "fraction) over the fast window",
        ).set(self.burn_rate(self.fast_window_s, t=now))
        _tm.gauge(
            "oap_slo_burn_rate", {"window": "slow"},
            help="Error-budget burn rate over the slow window "
                 "(serve_slo_window_s)",
        ).set(self.burn_rate(self.window_s, t=now))
        _tm.gauge(
            "oap_slo_error_budget_remaining",
            help="Fraction of the slow window's error budget left "
                 "(0 = exhausted)",
        ).set(self.budget_remaining(t=now))


def engine() -> Optional[SLOEngine]:
    """The process's engine, rebuilt when a knob changes; None when
    disarmed."""
    global _ENGINE
    if not armed():
        return None
    knobs = slo_cfg()
    key = (knobs["p99_ms"], knobs["availability"], knobs["window_s"])
    with _LOCK:
        e = _ENGINE
        if (e is None or (e.p99_ms, e.availability, e.window_s) != key):
            e = SLOEngine(*key)
            _ENGINE = e
    return e


def observe_request(wall_s: float, ok: bool,
                    t: Optional[float] = None) -> None:
    """The ledger-finalization hook; one config check when disarmed."""
    e = engine()
    if e is not None:
        e.observe(wall_s, ok, t=t)


def brief() -> Dict[str, Any]:
    """The decision-record dict ({} when disarmed)."""
    e = engine()
    return e.brief() if e is not None else {}


def state() -> Dict[str, Any]:
    """The ``/sloz`` payload (``{"armed": False}`` when disarmed)."""
    e = engine()
    return e.state() if e is not None else {"armed": False}


def summary_block() -> Dict[str, Any]:
    """``serving_summary()["slo"]`` ({} when disarmed)."""
    e = engine()
    return e.state() if e is not None else {}


# the package-level spelling (serving.slo_state)
slo_state = state


def _reset_for_tests() -> None:
    global _ENGINE
    with _LOCK:
        _ENGINE = None
