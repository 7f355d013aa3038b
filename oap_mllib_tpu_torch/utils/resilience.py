"""Fault classification, retries with backoff, and the degradation
ladder of a fit: the port of the JAX package's ``utils/resilience.py``.

A fault after the fit has started (a transient read error, a device OOM
mid-fit, a coordinator not up yet) is classified, retried with backoff,
degraded, counted and, through utils/faults.py, injectable in tests.
The ladder of a fit in one process::

    fit attempt
      | transient fault (I/O error, refused connection, Unavailable)
      +--> retry under RetryPolicy (exponential backoff, deterministic
      |    jitter, bounded by a count AND a deadline)
      | host OOM (a bare MemoryError)
      +--> the SPILL rung: the table is staged to a disk spill
      |    (data/io.SpillWriter, atomic) and the fit re-enters the
      |    streamed route reading from disk; a failed spill falls
      |    through to the rungs below
      | device OOM (torch.cuda.OutOfMemoryError, "out of memory")
      +--> the HALVING rungs: the chunk width halves per rung (a source
      |    re-chunks at chunk_rows / 2^level down to
      |    OOM_CHUNK_FLOOR_ROWS; the in-memory K-Means doubles its Lloyd
      |    chunk count; ALS re-enters the streamed route at halved
      |    upload blocks), bounded by retry_limit and the caller's
      |    headroom; the divisors land in ``ResilienceStats.halvings``
      | non-finite iterate under a reduced policy (bf16 / tf32)
      +--> the PRECISION rung: one retry with every policy pinned to
      |    f32 (utils/precision.force_f32)
      | still failing, retries spent, or non-finite at f32 under
      | nonfinite_policy="fallback"
      +--> ResilienceError carrying the fault history.

**No CPU rung.**  The JAX package's last rung runs its CPU/NumPy path
when ``Config.fallback`` is on.  The port has no such field and nothing
falls back to the CPU on its own (utils/dispatch.resolve_device): where
the JAX package would call its fallback, the port raises
:class:`ResilienceError`, the JAX package's behaviour under
``fallback=False``.  ``nonfinite_policy="fallback"`` therefore means
"escalate to the end of the ladder".

Non-faults (``ValueError``, ``TypeError``, API misuse, a kernel that
does not build, a sticky CUDA error that leaves the context dead)
propagate unchanged from the first attempt.

A world of several processes bypasses the ladder
(``ladder="bypassed(static-world)"``): a rank-local retry would desync
the collectives, so a fault fails every process together.  With
``Config.crash_dir`` set the ladder reads ``"supervised"``: a fatal
fault writes this process's crash record (utils/recovery.record_fatal)
and the supervisor relaunches the world (utils/supervisor.py).  Fits on an
in-process mesh run their one attempt too (``"bypassed(mesh)"``).

:func:`retries_total` counts the process's transient retries over
every fit (the fleet frame's ``retries``, telemetry/fleet.py).
"""

from __future__ import annotations

import contextlib
import gc
import logging
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.telemetry import flightrec
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils.faults import FaultInjected

log = logging.getLogger("oap_mllib_tpu_torch")

# fault kinds (classify_fault's values)
TRANSIENT = "transient"
OOM = "oom"  # device memory
OOM_HOST = "oom-host"  # host memory: the spill rung
NONFINITE = "nonfinite"

# a streamed chunk never halves below this many rows: smaller chunks
# cannot be what exhausts a card, and only multiply passes
OOM_CHUNK_FLOOR_ROWS = 64

LADDER_ACTIVE = "active"
LADDER_STATIC_WORLD = "bypassed(static-world)"
LADDER_SUPERVISED = "supervised"
LADDER_MESH = "bypassed(mesh)"

# transient retries taken in this process, every fit
_retries_lock = threading.Lock()
_retries = 0


def retries_total() -> int:
    with _retries_lock:
        return _retries


def halvings_available(chunk_rows: int, floor: int = OOM_CHUNK_FLOOR_ROWS) -> int:
    """How often ``chunk_rows`` can halve before crossing ``floor``, at
    least 1: the bound a streamed fit hands the halving rungs."""
    n = 0
    rows = int(chunk_rows)
    while rows // 2 >= floor:
        rows //= 2
        n += 1
    return max(n, 1)


def halved_rows(chunk_rows: int, level: int) -> int:
    """The chunk width of halving level ``level``: ``chunk_rows /
    2^level``, never below :data:`OOM_CHUNK_FLOOR_ROWS` (nor above
    ``chunk_rows``)."""
    return max(int(chunk_rows) // (2 ** int(level)),
               min(OOM_CHUNK_FLOOR_ROWS, int(chunk_rows)), 1)


# faults that name themselves only in their text
_OOM_MARKERS = (
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "allocation failure",
    "failed to allocate",
)
_TRANSIENT_MARKERS = (
    "unavailable",
    "connection refused",
    "connection reset",
    "deadline_exceeded",
    "deadline exceeded",
    "temporarily unavailable",
    "broken pipe",
    "socket closed",
)
# CUDA errors after which the context is dead: a retry on the same
# device cannot pass, so they are not faults to the ladder
_STICKY_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "misaligned address",
    "device-side assert",
)


class NonFiniteError(FloatingPointError):
    """NaN or Inf in a training iterate (K-Means centroids, ALS factors,
    the PCA column sums or Gram), found by a streamed pass's check."""


class ResilienceError(RuntimeError):
    """A fit went down the whole ladder.  ``history`` is the recorded
    fault sequence (``site[kind]: message``)."""

    def __init__(self, algo: str, history: List[str]):
        self.history = list(history)
        trail = "; ".join(history) if history else "no faults recorded"
        super().__init__(
            f"{algo}: the fit failed after exhausting the degradation ladder, "
            f"which has no CPU rung; fault history: {trail}"
        )


def _build_failure(exc: BaseException) -> bool:
    """A kernel or host library that did not build (ops/cuda/_build.py,
    ops/host_prep.py): a retry cannot help."""
    import subprocess

    if isinstance(exc, subprocess.CalledProcessError):
        return True
    text = str(exc).lower()
    return "nvcc" in text or "build failed" in text or "cannot be built" in text


def classify_fault(exc: BaseException) -> Optional[str]:
    """The fault kind of ``exc``, or None for a non-fault.

    - Injected faults (utils/faults.py) carry their kind.
    - :class:`NonFiniteError` is NONFINITE.
    - Sticky CUDA errors and kernel build failures are None.
    - ``torch.cuda.OutOfMemoryError`` and an "out of memory" /
      RESOURCE_EXHAUSTED message are OOM (device memory).
    - A bare ``MemoryError`` is OOM_HOST (the spill rung).
    - ``ConnectionError``, ``TimeoutError``, ``OSError`` and
      Unavailable-style messages are TRANSIENT.
    - Everything else is None: the ladder re-raises it unchanged.
    """
    if isinstance(exc, FaultInjected):
        from oap_mllib_tpu_torch.utils import faults

        return {
            faults.KIND_FAIL: TRANSIENT,
            faults.KIND_OOM: OOM,
            faults.KIND_HOST_OOM: OOM_HOST,
            faults.KIND_NONFINITE: NONFINITE,
        }.get(exc.kind)
    if isinstance(exc, NonFiniteError):
        return NONFINITE
    msg = str(exc).lower()
    if any(m in msg for m in _STICKY_MARKERS) or _build_failure(exc):
        return None
    if isinstance(exc, torch.cuda.OutOfMemoryError) or any(m in msg for m in _OOM_MARKERS):
        return OOM
    if isinstance(exc, MemoryError):
        return OOM_HOST
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return TRANSIENT
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return TRANSIENT
    return None


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter and a deadline:
    ``max_retries`` bounds the count, ``deadline_s`` the wall.  The
    jitter hashes (site, attempt), so a schedule repeats exactly."""

    max_retries: int = 5
    backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    deadline_s: float = 30.0
    jitter: float = 0.1

    @classmethod
    def from_config(cls) -> "RetryPolicy":
        cfg = get_config()
        return cls(
            max_retries=max(int(cfg.retry_limit), 0),
            backoff_s=max(float(cfg.retry_backoff), 0.0),
            deadline_s=max(float(cfg.retry_deadline), 0.0),
        )

    @classmethod
    def for_serving(cls) -> "RetryPolicy":
        """The traffic plane's durable-future envelope
        (``Config.serve_retry_limit`` / ``serve_retry_backoff``): the same
        jitter, a backoff capped at 0.5 s, and no deadline of its own
        (each request carries one)."""
        cfg = get_config()
        return cls(
            max_retries=max(int(cfg.serve_retry_limit), 0),
            backoff_s=max(float(cfg.serve_retry_backoff), 0.0),
            max_backoff_s=0.5,
            deadline_s=float("inf"),
        )

    def delay_s(self, attempt: int, site: str = "") -> float:
        """The wait before retry ``attempt`` (0-based), jittered."""
        base = min(self.backoff_s * (self.multiplier ** attempt), self.max_backoff_s)
        frac = zlib.crc32(f"{site}:{attempt}".encode()) / 0xFFFFFFFF
        return base * (1.0 + self.jitter * frac)


class ResilienceStats:
    """One fit's fault accounting, merged into its summary
    (:func:`merge_stats`)."""

    __slots__ = ("retries", "degradations", "faults", "backoff_s", "history",
                 "ladder", "halvings", "spilled")

    def __init__(self) -> None:
        self.retries = 0  # transient retries taken
        self.degradations = 0  # rungs stepped: spill, halving, precision
        self.faults = 0  # classified exceptions seen
        self.backoff_s = 0.0  # wall slept in backoff
        self.history: List[str] = []  # "<site>[<kind>]: <message>"
        self.halvings: List[int] = []  # the chunk divisor of each halving rung
        self.spilled = False  # the spill rung moved the fit to a disk spill
        self.ladder = LADDER_ACTIVE

    def record(self, site: str, kind: Optional[str], exc: BaseException) -> None:
        self.faults += 1
        self.history.append(f"{site}[{kind or 'unclassified'}]: {exc}")
        if flightrec.enabled():
            flightrec.record("fault", site, kind or "unclassified")
        _tm.counter("oap_resilience_faults_total", {"kind": kind or "unclassified"},
                    help="Classified exceptions observed by the resilience layer").inc()

    def note_retry(self, delay_s: float) -> None:
        global _retries
        self.retries += 1
        self.backoff_s += delay_s
        with _retries_lock:
            _retries += 1
        if flightrec.enabled():
            flightrec.record("retry", "transient", f"{delay_s:.3f}s")
        _tm.counter("oap_resilience_retries_total", help="Transient-fault retries taken").inc()
        _tm.counter("oap_resilience_backoff_seconds_total",
                    help="Wall slept in retry backoff").inc(delay_s)

    def note_degradation(self) -> None:
        self.degradations += 1
        if flightrec.enabled():
            flightrec.record("degrade", "ladder")
        _tm.counter("oap_resilience_degradations_total",
                    help="Degradation-ladder rungs stepped").inc()

    def as_dict(self) -> dict:
        return {
            "retries": self.retries,
            "degradations": self.degradations,
            "faults": self.faults,
            "backoff_s": self.backoff_s,
            "history": list(self.history),
            "ladder": self.ladder,
            "halvings": list(self.halvings),
            "spilled": self.spilled,
        }


def merge_stats(summary, stats: ResilienceStats) -> None:
    """A fit's counters into its summary: a ``"resilience"`` key of a
    dict summary (PCA, ALS), a ``.resilience`` attribute otherwise."""
    if summary is None:
        return
    if isinstance(summary, dict):
        summary["resilience"] = stats.as_dict()
    else:
        summary.resilience = stats.as_dict()


def nonfinite_policy_cfg() -> str:
    """The validated ``Config.nonfinite_policy``: a typo raises."""
    policy = get_config().nonfinite_policy
    if policy not in ("raise", "fallback"):
        raise ValueError(f"nonfinite_policy must be raise|fallback, got {policy!r}")
    return policy


def check_finite(value: torch.Tensor, what: str) -> None:
    """Raise :class:`NonFiniteError` naming ``what`` when the tensor
    ``value`` holds a NaN or an Inf: one device-to-host read of one
    bool."""
    nonfinite_policy_cfg()  # a typo'd policy fails at the first check
    if torch.isfinite(value).all().item():
        return
    raise NonFiniteError(
        f"non-finite values detected in {what} (nonfinite_policy governs whether "
        "this raises or goes down the ladder)"
    )


def _world() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.world_size()


def run_with_retry(fn: Callable[[], object], *, policy: Optional[RetryPolicy] = None,
                   stats: Optional[ResilienceStats] = None, site: str = ""):
    """``fn()``, retrying TRANSIENT faults under ``policy``; anything else
    propagates at once.  A world of several processes runs ``fn`` once."""
    policy = policy or RetryPolicy.from_config()
    stats = stats or ResilienceStats()
    if _world() > 1:
        return fn()
    deadline = time.monotonic() + policy.deadline_s
    while True:
        try:
            return fn()
        except Exception as e:
            kind = classify_fault(e)
            stats.record(site, kind, e)
            delay = policy.delay_s(stats.retries, site)
            if (kind != TRANSIENT or stats.retries >= policy.max_retries
                    or time.monotonic() + delay > deadline):
                raise
            stats.note_retry(delay)
            log.warning("%s: transient fault (%s); retry %d/%d in %.2fs",
                        site or "retry", str(e), stats.retries, policy.max_retries, delay)
            time.sleep(delay)


def resilient_fit(algo: str, attempt: Callable[[int], object], *,
                  stats: Optional[ResilienceStats] = None,
                  policy: Optional[RetryPolicy] = None,
                  spill: Optional[Callable[[], bool]] = None,
                  max_halvings: Optional[int] = None,
                  bypass: Optional[str] = None):
    """Run ``attempt(level)`` under the ladder (module docstring).

    ``level`` is the halving rung (0: full chunks, n: chunk width / 2^n;
    a route without a chunk knob runs the same program again).
    ``max_halvings`` bounds the halving walk (None: one rung), capped by
    ``policy.max_retries``.  ``spill()`` is the host-OOM rung: it moves
    the fit's table to a disk spill and returns True, or returns False
    or raises to fall through.  ``bypass`` (or a world of several
    processes) runs ``attempt(0)`` once and labels the ladder with it.
    """
    from oap_mllib_tpu_torch.utils import precision as _precision

    stats = stats or ResilienceStats()
    if _world() > 1:
        # the static-world contract: no process-local rung fires.  With
        # the recovery sideband armed (Config.crash_dir, which the
        # supervisor sets) recovery is supervised: a fatal fault poisons
        # the peers and the supervisor relaunches the world, resume=auto
        # restoring the last durable checkpoint (utils/recovery.py)
        stats.ladder = LADDER_SUPERVISED if get_config().crash_dir else LADDER_STATIC_WORLD
        try:
            return attempt(0)
        except Exception as e:
            from oap_mllib_tpu_torch.utils import recovery

            recovery.record_fatal(f"{algo}.fit", e)
            raise
    if bypass is not None:
        stats.ladder = bypass
        return attempt(0)
    stats.ladder = LADDER_ACTIVE
    policy = policy or RetryPolicy.from_config()
    deadline = time.monotonic() + policy.deadline_s
    halving_limit = min(1 if max_halvings is None else max(int(max_halvings), 0),
                        max(policy.max_retries, 1))
    degraded = 0
    precision_degraded = False
    spilled = False
    reclaim = False
    while True:
        if reclaim:
            # a failed attempt's tensors stay referenced from its
            # traceback's frames, which form cycles (a pass guard holds
            # the error that holds its frame): collect them, or a
            # memory fault's retry runs with the failed attempt's
            # device memory still allocated
            gc.collect()
        try:
            _precision.begin_attempt()
            scope = _precision.force_f32() if precision_degraded else contextlib.nullcontext()
            with scope:
                return attempt(degraded)
        except Exception as e:
            kind = classify_fault(e)
            if kind is None:
                raise  # not a fault: never masked
            site = f"{algo}.fit" + (".degraded" if degraded else "")
            stats.record(site, kind, e)
            # the log gets the text, not the error: a handler that keeps
            # records would keep the failed attempt's frames alive
            msg = str(e)
            reclaim = kind in (OOM, OOM_HOST)
            if kind == TRANSIENT and stats.retries < policy.max_retries:
                delay = policy.delay_s(stats.retries, site)
                if time.monotonic() + delay <= deadline:
                    stats.note_retry(delay)
                    log.warning("%s: transient fault (%s); retry %d/%d in %.2fs",
                                site, msg, stats.retries, policy.max_retries, delay)
                    time.sleep(delay)
                    continue
            if kind == OOM_HOST and spill is not None and not spilled:
                spilled = True
                stats.note_degradation()
                ok = False
                try:
                    ok = bool(spill())
                except Exception as spill_err:  # noqa: BLE001 -- the rung falls through
                    log.warning("%s: spill to disk raised (%s); falling through the ladder",
                                site, str(spill_err))
                if ok:
                    stats.spilled = True
                    log.warning("%s: host OOM (%s); spilled the table to disk and "
                                "re-entering the streamed route", site, msg)
                    continue
                log.warning("%s: host OOM (%s) and the spill rung failed; continuing "
                            "down the ladder", site, msg)
            if kind in (OOM, OOM_HOST) and degraded < halving_limit:
                degraded += 1
                stats.note_degradation()
                stats.halvings.append(2 ** degraded)
                log.warning("%s: OOM (%s); retrying at chunk width /%d (halving %d/%d)",
                            site, msg, 2 ** degraded, degraded, halving_limit)
                continue
            if kind == NONFINITE and not precision_degraded and _precision.reduced_active():
                precision_degraded = True
                stats.note_degradation()
                log.warning("%s: non-finite iterate under a reduced precision policy (%s); "
                            "retrying once at f32", site, msg)
                continue
            if kind == NONFINITE and nonfinite_policy_cfg() == "raise":
                raise
            raise ResilienceError(algo, stats.history) from e


def fit_with_ladder(algo: str, attempt: Callable[[int], object], launches, **ladder):
    """:func:`resilient_fit`, then the fit's ``resilience`` counters and
    its ``kernels``: the launches of every attempt, failed ones
    included, taken from the wrappers' ``launches`` tables (dicts of
    kernel name to count), so the summary equals the counters zeroed
    before the fit.  Returns the model."""
    before = {name: n for table in launches for name, n in table.items()}
    stats = ladder.pop("stats", None) or ResilienceStats()
    model = resilient_fit(algo, attempt, stats=stats, **ladder)
    summary = model.summary
    kernels = {name: n - before.get(name, 0)
               for table in launches for name, n in table.items()}
    if isinstance(summary, dict):
        summary["kernels"] = kernels
    else:
        summary.kernels = kernels
    merge_stats(summary, stats)
    return model
