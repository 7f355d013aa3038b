"""The live-world recovery plane: collective deadlines and coordinated
abort, the port of the JAX package's ``utils/recovery.py``.

A peer that is gone (a preempted host, a SIGKILLed worker, a hung card)
must turn into a prompt, machine-readable exit on every survivor, not a
hang until gloo's own timeout.  Two mechanisms:

- **The watcher** (``Config.collective_timeout`` > 0, in a world of
  several processes): every host collective across processes
  (parallel/collective.py: ``_all_gather_host``, ``all_to_all``,
  ``barrier``, ``agree``; the shuffles, the streamed passes' reductions,
  K5's IPC handshakes and the checkpoint agreements all go through
  them) runs under :func:`guarded_dispatch`: the blocking call moves to
  a daemon thread and the caller waits with a deadline, polling the
  crash sideband.  Expiry raises :class:`CollectiveTimeoutError` naming
  the op, axis, elapsed wall and the last completed dispatch.
- **Coordinated abort** (``Config.crash_dir`` non-empty): a process's
  fatal fault writes a crash record (``crash.rank<r>.json``: rank,
  site, fault class, last durable checkpoint step) into the sideband;
  a peer blocked in a watched collective sees it and raises
  :class:`PeerAbortError`.  The supervisor (utils/supervisor.py) reads
  the records to classify the exit and relaunch or shrink.

Where the port differs from the JAX package:

- **gloo raises on its own.**  A peer that dies closes its sockets, so
  the survivor's gloo call fails at once ("Connection closed by peer"),
  where the JAX package's survivor only times out.  Inside a guarded
  dispatch gloo's connection errors become :class:`PeerAbortError` and
  its timeouts :class:`CollectiveTimeoutError`, each naming the op,
  axis, elapsed time and last completed dispatch and each writing this
  process's crash record, so the supervisor sees victims as it does in
  the JAX package.  The mapping holds with the watcher disarmed too.
- **The watcher arms by default**: the port's ``collective_timeout``
  is 600 s (the JAX package's is 0).  gloo's own timeout is set
  :data:`GLOO_MARGIN_S` past the deadline (parallel/bootstrap.py), so
  the watcher fires first.
- **The abandoned thread.**  After an abort the watched thread may stay
  blocked in gloo, and ``destroy_process_group`` can then hang at exit:
  :func:`abandoned` counts such threads, parallel/bootstrap.shutdown
  skips the teardown when there are any, and a worker that failed
  leaves through :func:`exit_now`; the supervisor's reap kills
  stragglers.

Crash records are version 2 with ``flight_recorder`` ``[]`` and
``sanitizer_fingerprint`` ``""``, what the JAX package writes with those
planes off.  :func:`stats` holds the JAX package's ``oap_recovery_*``
counts.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

from oap_mllib_tpu_torch.config import get_config

log = logging.getLogger("oap_mllib_tpu_torch")

CRASH_RECORD_VERSION = 2
_CRASH_PREFIX = "crash.rank"

# the sideband poll while blocked in a guarded dispatch: a poisoned
# world aborts well inside a second, and the listdir stays invisible
# next to a real collective
_POLL_S = 0.05

# gloo's own timeout runs this far past the watcher's deadline
GLOO_MARGIN_S = 10.0

FAULT_TIMEOUT = "collective_timeout"
FAULT_PEER_ABORT = "peer_abort"

# gloo's messages for a peer that closed its end, and for its own
# timeout (torch.distributed raises DistBackendError / RuntimeError)
_CLOSED_MARKERS = ("closed by peer", "connection reset", "broken pipe", "connection refused",
                   "read error", "write error", "socket closed", "end of file")
_TIMEOUT_MARKERS = ("timed out", "timeout")


def _fresh_stats() -> Dict[str, Any]:
    return {"aborts": {}, "peer_aborts": 0, "timeouts": {}, "abandoned_threads": 0,
            "relaunches": 0, "restart_budget_spent": 0, "world_shrinks": 0,
            "time_to_recovery_s": []}


_lock = threading.Lock()
_STATS: Dict[str, Any] = _fresh_stats()
_completed = {"count": 0, "last": ""}
_local = threading.local()


def stats() -> Dict[str, Any]:
    """The process's recovery counts (the JAX package's
    ``oap_recovery_*`` counters): crash records written by fault class
    (``aborts``), dispatches aborted by a peer (``peer_aborts``) or the
    deadline (``timeouts``, by op), watched threads left blocked, and the
    supervisor's relaunches, restart budget spent, world shrinks and
    detection-to-respawn walls."""
    with _lock:
        return {k: (dict(v) if isinstance(v, dict) else list(v) if isinstance(v, list) else v)
                for k, v in _STATS.items()}


def reset_stats() -> None:
    with _lock:
        _STATS.clear()
        _STATS.update(_fresh_stats())
        _completed.update(count=0, last="")


def _bump(key: str, sub: Optional[str] = None, value=1) -> None:
    with _lock:
        if sub is None:
            _STATS[key] += value
        else:
            _STATS[key][sub] = _STATS[key].get(sub, 0) + value


def note_recovery(seconds: float) -> None:
    """One relaunch's detection-to-respawn wall (the supervisor's)."""
    with _lock:
        _STATS["time_to_recovery_s"].append(float(seconds))


class RecoveryError(RuntimeError):
    """Base class of the recovery plane's aborts."""


class CollectiveTimeoutError(RecoveryError):
    """A peer did not arrive at a collective within the deadline.
    ``op`` / ``axis`` / ``elapsed_s`` name the dispatch;
    ``last_completed`` is (count, signature) of the newest dispatch this
    process finished."""

    def __init__(self, msg: str, *, op: str = "", axis: str = "", elapsed_s: float = 0.0,
                 last_completed=None):
        super().__init__(msg)
        self.op = op
        self.axis = axis
        self.elapsed_s = elapsed_s
        self.last_completed = last_completed


class PeerAbortError(RecoveryError):
    """A peer aborted while this process waited in a collective: its
    crash record appeared, or it closed its connection.  ``record`` is
    the peer's parsed crash record ({} when it left none); ``op`` /
    ``axis`` / ``elapsed_s`` / ``last_completed`` as for the timeout."""

    def __init__(self, msg: str, record: Optional[Dict[str, Any]] = None, *, op: str = "",
                 axis: str = "", elapsed_s: float = 0.0, last_completed=None):
        super().__init__(msg)
        self.record = dict(record or {})
        self.op = op
        self.axis = axis
        self.elapsed_s = elapsed_s
        self.last_completed = last_completed


def collective_timeout_cfg(cfg=None) -> float:
    """Validated ``Config.collective_timeout``: negative raises."""
    timeout = float((cfg or get_config()).collective_timeout)
    if timeout < 0:
        raise ValueError(f"collective_timeout must be >= 0 seconds (0 = disarmed), "
                         f"got {timeout}")
    return timeout


def gloo_timeout_s(cfg=None) -> float:
    """gloo's own timeout for the world: :data:`GLOO_MARGIN_S` past the
    watcher's deadline, or 0 (gloo's default) when it is disarmed."""
    timeout = collective_timeout_cfg(cfg)
    return timeout + GLOO_MARGIN_S if timeout > 0 else 0.0


def _world() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.world_size()


def _rank() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.process_index()


def _note_completed(sig: str) -> None:
    with _lock:
        _completed["count"] += 1
        _completed["last"] = sig


def last_completed() -> Dict[str, Any]:
    """(count, signature) of the newest guarded dispatch this process
    completed."""
    with _lock:
        return dict(_completed)


def abandoned() -> int:
    """Watched threads left blocked in a collective after an abort."""
    with _lock:
        return _STATS["abandoned_threads"]


def exit_now(code: int) -> None:
    """Leave the process at once with ``code``, stdio flushed: no atexit
    hook and no process-group teardown, which a thread still blocked in
    gloo could hang."""
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except (OSError, ValueError):
            pass
    os._exit(code)


# -- crash records and the sideband -------------------------------------------------


def crash_record_path(crash_dir: str, rank: int) -> str:
    return os.path.join(crash_dir, f"{_CRASH_PREFIX}{rank}.json")


def write_crash_record(site: str, fault_class: str, error: str, *, op: str = "",
                       elapsed_s: float = 0.0) -> Optional[str]:
    """Write this process's crash record into the sideband (tmp +
    rename, never torn); None when ``Config.crash_dir`` is empty.  Never
    raises: the record reports a fault already in flight."""
    cfg = get_config()
    if not cfg.crash_dir:
        return None
    try:
        from oap_mllib_tpu_torch.data import io as _io
        from oap_mllib_tpu_torch.utils import checkpoint as _ckpt

        rank = _rank()
        _bump("aborts", fault_class)
        record = {
            "version": CRASH_RECORD_VERSION,
            "rank": rank,
            "world": _world(),
            "site": site,
            "fault_class": fault_class,
            "error": str(error)[:4000],
            "op": op,
            "elapsed_s": round(float(elapsed_s), 3),
            "last_completed": last_completed(),
            "sanitizer_fingerprint": "",
            "last_checkpoint_step": _ckpt.last_durable_step(),
            "flight_recorder": [],
            "telemetry": {"recovery": stats(), "checkpoint": _ckpt.stats()},
        }
        os.makedirs(cfg.crash_dir, exist_ok=True)
        path = crash_record_path(cfg.crash_dir, rank)
        _io.atomic_write_json(path, record)
        return path
    except Exception as e:  # noqa: BLE001
        log.warning("recovery: failed to write crash record (%s)", e)
        return None


def check_poison(crash_dir: str, my_rank: int) -> Optional[Dict[str, Any]]:
    """The first PEER crash record in the sideband, parsed (a torn record
    still counts, with only its rank), or None."""
    try:
        names = os.listdir(crash_dir)
    except OSError:
        return None
    for name in sorted(names):
        if not (name.startswith(_CRASH_PREFIX) and name.endswith(".json")):
            continue
        try:
            rank = int(name[len(_CRASH_PREFIX):-len(".json")])
        except ValueError:
            continue
        if rank == my_rank:
            continue
        try:
            with open(os.path.join(crash_dir, name)) as f:
                return json.load(f)
        except Exception:  # noqa: BLE001 - torn or corrupt: the peer is dead anyway
            return {"rank": rank}
    return None


def clear_crash_records(crash_dir: str) -> int:
    """Remove every crash record in the sideband (between attempts);
    returns how many."""
    removed = 0
    try:
        for name in os.listdir(crash_dir):
            if name.startswith(_CRASH_PREFIX) and name.endswith(".json"):
                os.unlink(os.path.join(crash_dir, name))
                removed += 1
    except OSError:
        pass
    return removed


def list_crash_records(crash_dir: str) -> list:
    """Paths of every crash record in the sideband, by file name."""
    try:
        names = os.listdir(crash_dir)
    except OSError:
        return []
    return [os.path.join(crash_dir, name) for name in sorted(names)
            if name.startswith(_CRASH_PREFIX) and name.endswith(".json")]


def record_fatal(site: str, exc: BaseException) -> None:
    """Coordinated abort of a fatal fault outside any collective: classify
    it (utils/resilience.classify_fault) and poison the world through the
    sideband.  A no-op with ``Config.crash_dir`` empty, in one process,
    and for a :class:`RecoveryError` (its record is written)."""
    if not get_config().crash_dir or _world() <= 1:
        return
    if isinstance(exc, RecoveryError):
        return
    from oap_mllib_tpu_torch.utils.resilience import classify_fault

    write_crash_record(site, classify_fault(exc) or "unclassified", repr(exc))


# -- the watcher ----------------------------------------------------------------------


def _gloo_kind(exc: BaseException) -> Optional[str]:
    """FAULT_PEER_ABORT for gloo's closed-connection errors,
    FAULT_TIMEOUT for its timeouts, None for anything else."""
    if not isinstance(exc, (RuntimeError, ConnectionError, TimeoutError)):
        return None
    if isinstance(exc, RecoveryError):
        return None
    if isinstance(exc, ConnectionError):
        return FAULT_PEER_ABORT
    text = str(exc).lower()
    if any(m in text for m in _CLOSED_MARKERS):
        return FAULT_PEER_ABORT
    if isinstance(exc, TimeoutError) or any(m in text for m in _TIMEOUT_MARKERS):
        return FAULT_TIMEOUT
    return None


def _describe_last() -> str:
    last = last_completed()
    return f"#{last['count']}" + (f" [{last['last']}]" if last["last"] else " (none)")


def _peer_abort(op: str, axis: str, elapsed: float, peer: Dict[str, Any],
                cause: str) -> PeerAbortError:
    """Write this process's record and build the peer-abort error."""
    _bump("peer_aborts")
    who = f"rank {peer.get('rank')}" if peer else "a peer"
    write_crash_record("collective.dispatch", FAULT_PEER_ABORT,
                       f"{who} aborted: {peer.get('fault_class', cause)} at "
                       f"{peer.get('site', op)}", op=op, elapsed_s=elapsed)
    detail = (f"{peer.get('fault_class', 'unknown fault')} at {peer.get('site', '?')}: "
              f"{str(peer.get('error', 'no detail'))[:500]}; its last durable checkpoint "
              f"step was {peer.get('last_checkpoint_step', -1)}") if peer else cause
    return PeerAbortError(
        f"collective '{op}' over axis '{axis}' aborted after {elapsed:.1f}s: {who} "
        f"poisoned the world ({detail}).  Last completed dispatch on this process: "
        f"{_describe_last()}", record=peer, op=op, axis=axis, elapsed_s=elapsed,
        last_completed=last_completed())


def _timeout(op: str, axis: str, elapsed: float, timeout: float,
             cause: str = "") -> CollectiveTimeoutError:
    """Write this process's record and build the timeout error."""
    _bump("timeouts", op)
    write_crash_record("collective.dispatch", FAULT_TIMEOUT,
                       f"{op} over '{axis}' exceeded collective_timeout={timeout}s"
                       + (f" ({cause})" if cause else ""), op=op, elapsed_s=elapsed)
    return CollectiveTimeoutError(
        f"collective '{op}' over axis '{axis}' did not complete within "
        f"collective_timeout={timeout}s (elapsed {elapsed:.1f}s, rank {_rank()} of "
        f"{_world()}): a peer likely died or hung.  Last completed dispatch on this "
        f"process: {_describe_last()}.  Recovery: relaunch under utils/supervisor "
        "(resume=auto restores the last durable checkpoint).",
        op=op, axis=axis, elapsed_s=elapsed, last_completed=last_completed())


def _mapped(exc: BaseException, op: str, axis: str, elapsed: float, timeout: float,
            crash_dir: str) -> Optional[RecoveryError]:
    """The recovery error a gloo failure maps to, or None to re-raise it
    as it is."""
    kind = _gloo_kind(exc)
    if kind is None:
        return None
    if kind == FAULT_TIMEOUT:
        return _timeout(op, axis, elapsed, timeout, str(exc)[:300])
    peer = check_poison(crash_dir, _rank()) if crash_dir else None
    return _peer_abort(op, axis, elapsed, peer or {}, f"connection closed: {str(exc)[:300]}")


def guarded_dispatch(op: str, axis: str, fn):
    """Run one host collective across processes under the recovery plane.

    In one process, or nested inside another guarded dispatch, this is
    ``fn()``.  With ``collective_timeout == 0`` ``fn`` runs here and only
    gloo's errors are mapped.  Armed, ``fn`` runs in a daemon thread
    while this thread waits with the deadline, polling the sideband: the
    dispatch completing wins; a peer's crash record raises
    :class:`PeerAbortError`; expiry raises :class:`CollectiveTimeoutError`;
    a gloo connection error or timeout from ``fn`` maps to the same two.
    Each abort writes this process's crash record.  After an abort the
    blocked thread is abandoned (:func:`abandoned`)."""
    cfg = get_config()
    timeout = collective_timeout_cfg(cfg)
    if _world() <= 1 or getattr(_local, "inside", False):
        return fn()
    crash_dir = cfg.crash_dir
    sig = f"{op}|{axis}"
    t0 = time.monotonic()
    if timeout == 0:
        _local.inside = True
        try:
            out = fn()
        except Exception as e:
            err = _mapped(e, op, axis, time.monotonic() - t0, timeout, crash_dir)
            if err is None:
                raise
            raise err from e
        finally:
            _local.inside = False
        _note_completed(sig)
        return out
    done = threading.Event()
    box: Dict[str, Any] = {"out": None, "exc": None}

    def _run():
        _local.inside = True
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            box["exc"] = e
        finally:
            done.set()

    worker = threading.Thread(target=_run, daemon=True, name=f"oap-collective-{op}")
    my_rank = _rank()
    worker.start()
    while not done.wait(_POLL_S):
        elapsed = time.monotonic() - t0
        if crash_dir:
            peer = check_poison(crash_dir, my_rank)
            if peer is not None:
                _bump("abandoned_threads")
                raise _peer_abort(op, axis, elapsed, peer, "crash record")
        if elapsed >= timeout:
            _bump("abandoned_threads")
            raise _timeout(op, axis, elapsed, timeout)
    if box["exc"] is not None:
        err = _mapped(box["exc"], op, axis, time.monotonic() - t0, timeout, crash_dir)
        if err is None:
            raise box["exc"]
        raise err from box["exc"]
    _note_completed(sig)
    return box["out"]
