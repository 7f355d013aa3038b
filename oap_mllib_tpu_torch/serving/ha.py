"""Serving availability: replica heartbeats and eviction (the port of the
JAX package's ``serving/ha.py``).

- :func:`heartbeat`: a fixed-shape frame of (rank, requests answered,
  queue depth) gathered across the world's processes through
  ``ops/stream_ops._allgather_host``, so it runs under the recovery
  plane's watcher (utils/recovery.guarded_dispatch): a replica that dies
  or misses ``Config.collective_timeout`` turns every survivor's wait
  into a ``PeerAbortError`` or ``CollectiveTimeoutError``.  One process
  answers its own view with no collective.
- :class:`ReplicaGuard`: serving legs run under :meth:`ReplicaGuard.leg`;
  a recovery-plane error there evicts the fleet view (the survivor
  flips to local-only and keeps answering from its own pins), books
  ``oap_serve_evictions_total`` and records the fault; the supervisor
  (utils/supervisor.py) relaunches the lost replica from the crash
  records.  :meth:`ReplicaGuard.release` drains the attached traffic
  queue before the replica lets go.

:func:`fleet_evicted` is the flag the JAX package's factor-sharded ring
sweep reads before it dispatches onto a mesh spanning the old world;
that sweep waits for a later slice of the port (its models keep a live
sharded layout, the port's gather their factors to the host), so only
the flag is here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import recovery

# set once a ReplicaGuard of this process evicted: collectives over the
# old world are doomed (a dead peer never arrives)
_EVICTED = False


def fleet_evicted() -> bool:
    """True once a replica was evicted in this process."""
    return _EVICTED


def _reset_for_tests() -> None:
    global _EVICTED
    _EVICTED = False


def heartbeat(requests: Optional[int] = None,
              queue_depth: Optional[int] = None) -> Dict[str, Any]:
    """One fleet heartbeat: (rank, requests, queue depth) gathered across
    the world; returns the view (``world``, ``rank``, ``requests`` and
    ``queue_depth`` lists by rank).  ``requests`` defaults to this
    process's ``oap_serve_requests_total``, ``queue_depth`` to the live
    traffic-queue depth."""
    from oap_mllib_tpu_torch.ops.stream_ops import _allgather_host
    from oap_mllib_tpu_torch.parallel import bootstrap

    if requests is None:
        requests = int(_tm.family_total("oap_serve_requests_total"))
    if queue_depth is None:
        from oap_mllib_tpu_torch.serving import registry

        queue_depth = registry.queue_depth()
    rank = bootstrap.process_index()
    frame = np.asarray(
        [float(rank), float(requests), float(queue_depth)], np.float64
    )
    # the gather adds the process axis with one process too
    (stacked,) = _allgather_host([frame])
    stacked = np.asarray(stacked).reshape(-1, 3)
    view = {
        "world": stacked.shape[0],
        "rank": rank,
        "requests": [int(v) for v in stacked[:, 1]],
        "queue_depth": [int(v) for v in stacked[:, 2]],
    }
    _tm.counter(
        "oap_serve_heartbeats_total",
        help="Serving fleet heartbeats completed",
    ).inc()
    return view


class ReplicaGuard:
    """The eviction wrapper of serving legs::

        guard = ReplicaGuard(queue=q)
        with guard.leg():
            serving.heartbeat()      # the fleet rendezvous

    A recovery-plane error inside a leg is recorded, flips the guard to
    ``local_only`` and is absorbed: the leg returns and the replica
    keeps answering with the same results (its pins are local).  Any
    other error propagates.  :meth:`release` drains and closes the
    attached ``queue`` (every accepted future resolves first)."""

    def __init__(self, queue=None):
        self.local_only = False
        self.evictions = 0
        self.last_error: Optional[BaseException] = None
        self.queue = queue

    def leg(self):
        return _Leg(self)

    def release(self, timeout_s: float = 5.0) -> Optional[Dict[str, Any]]:
        """Drain and close the attached queue; returns the drain's stats
        (None without a queue), with the SLO state it let go under."""
        stats = None
        q = self.queue
        if q is not None:
            stats = q.drain(timeout_s)
            q.close()
            from oap_mllib_tpu_torch.serving import slo
            from oap_mllib_tpu_torch.telemetry import flightrec

            brief = slo.brief()
            if brief:
                stats["slo"] = brief
            flightrec.record(
                "serve", "release",
                f"replica released: answered={stats['answered']} "
                f"failed={stats['failed']}",
            )
        return stats

    def _evict(self, exc: BaseException) -> None:
        global _EVICTED
        self.local_only = True
        self.evictions += 1
        self.last_error = exc
        _EVICTED = True
        _tm.counter(
            "oap_serve_evictions_total",
            help="Serving replicas evicted after recovery-plane errors",
        ).inc()
        # the watcher already wrote this process's crash record for a
        # recovery-plane error; record_fatal covers any other class
        recovery.record_fatal("serve.heartbeat", exc)


class _Leg:
    def __init__(self, guard: ReplicaGuard):
        self._g = guard

    def __enter__(self):
        return self._g

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None and isinstance(exc, recovery.RecoveryError):
            self._g._evict(exc)
            return True  # absorbed: the survivor keeps serving
        return False
