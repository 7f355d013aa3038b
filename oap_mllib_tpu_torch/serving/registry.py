"""Device registry of served models: the port of the JAX package's
``serving/registry.py`` (its one-process part).

:func:`serve` pins a fitted model's state (centers, components, factor
tables) on its device once, keyed like the program cache (serving the
same model object again returns the same handle), and every request
then goes through the batcher (serving/batcher.py) against the pinned
tensors.  A handle scores on the device its model resolves
(``utils/dispatch.resolve_device`` of ``model.device``): a missing card
raises, nothing moves to the CPU by itself.

:func:`pin` is also the models' own device cache: keyed by the host
array's identity, it holds the array it staged and compares with
``is``, so a replaced array (a refit, an online commit) re-stages
exactly once and a freed array's id, which CPython reuses, can never
answer for a new one.  The cache holds one device copy per pin name,
and a handle pins into its model's cache under the model's own names
(``centers``, ``components``, ``targets:item``): a served model holds
one device copy of its state, shared by the handle and the model.

Per-request telemetry goes to the process registry under the JAX
package's families: ``oap_serve_requests_total`` / ``_rows_total`` /
``_batches_total`` / ``_pad_rows_total`` / ``_queue_depth`` and the
``oap_serve_request_seconds`` latency histogram; :func:`serving_summary`
renders the "serving" block.  Online commits (online/delta.py) re-pin
the handles of their model in place through :func:`repin_model`.

Three seams reach the traffic plane (serving/traffic.py) and request
tracing (serving/reqtrace.py): ``pin`` answers from the previous pin at
the brownout ladder's stale rung, a traced flush pins a sampled trace
id to the latency histogram as an exemplar, and :func:`serving_summary`
carries the traffic keys (sheds, futures, brownout, scale, attribution,
SLO).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from oap_mllib_tpu_torch.serving import reqtrace
from oap_mllib_tpu_torch.telemetry import flightrec
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import locktrace
from oap_mllib_tpu_torch.utils.dispatch import resolve_device

# tracked (utils/locktrace.py): the registry lock nests the telemetry
# registry's lock (gauge bookings under registration)
_LOCK = locktrace.TrackedLock("serving.registry", threading.RLock())
_SERVED: Dict[tuple, "ServedModel"] = {}

# the queue-depth gauge is folded as a delta under its own lock, so two
# threads moving it never clobber each other
_DEPTH_LOCK = locktrace.TrackedLock("serving.queue_depth")
_queue_depth = 0


def note_queue_depth(delta: int) -> int:
    """Fold ``delta`` into the live queue-depth gauge; returns the new
    depth."""
    global _queue_depth
    with _DEPTH_LOCK:
        _queue_depth = max(0, _queue_depth + int(delta))
        depth = _queue_depth
        _tm.gauge(
            "oap_serve_queue_depth",
            help="Serving requests pending in the traffic queue or "
                 "coalesced into the in-flight batch",
        ).set(depth)
    return depth


def queue_depth() -> int:
    """The live queue depth (requests coalesced into in-flight flushes)."""
    with _DEPTH_LOCK:
        return _queue_depth


def pin(cache: dict, name: str, host_array, device=None, *,
        allow_stale: bool = False) -> torch.Tensor:
    """The f32 device copy of ``host_array`` on ``device`` (None:
    ``Config.device``), cached in ``cache[name]`` as ``(host_array,
    tensor)``: the same array object on the same device returns the same
    tensor, anything else stages once, by one explicit host-to-device
    copy, and replaces the entry.  The copy is synchronous
    (``non_blocking=False``), so a pin swapped in by one thread is whole
    before another thread's flush reads it.

    ``allow_stale``: at the brownout ladder's ``stale`` rung
    (``traffic.brownout_stale_ok``) a replaced array answers from the
    previous pin instead of waiting for its copy, booked in
    ``oap_serve_stale_pins_total``; the new array stages at the next
    call off the rung."""
    dev = resolve_device(device) if not isinstance(device, torch.device) else device
    ent = cache.get(name)
    if ent is not None and ent[1].device == dev:
        if ent[0] is host_array:
            return ent[1]
        if allow_stale:
            from oap_mllib_tpu_torch.serving import traffic

            if traffic.brownout_stale_ok():
                _tm.counter(
                    "oap_serve_stale_pins_total",
                    help="Requests answered from a stale device pin under "
                         "the brownout ladder's stale rung",
                ).inc()
                return ent[1]
    host = np.asarray(host_array, np.float32)
    if dev.type == "cpu" or not host.flags.writeable:
        # a CPU pin must not alias the host array (its owner may write
        # it in place), and torch takes no read-only array
        host = host.copy()
    staged = torch.from_numpy(host).to(dev, non_blocking=False)
    cache[name] = (host_array, staged)
    return staged


def _observe_request(kind: str, wall_s: float, rows: int) -> None:
    lab = {"model": kind}
    _tm.counter(
        "oap_serve_requests_total", lab,
        help="Serving requests answered by model kind",
    ).inc()
    _tm.counter(
        "oap_serve_rows_total", lab,
        help="Request rows scored by the serving plane",
    ).inc(rows)
    # a traced flush pins one of its sampled trace ids to the latency
    # bucket as an exemplar (serving/reqtrace.py)
    tid = reqtrace.exemplar_trace_id()
    _tm.histogram(
        "oap_serve_request_seconds", lab,
        help="Per-request serving latency (staging + scoring + fetch)",
    ).observe(wall_s, exemplar={"trace_id": tid} if tid is not None else None)


class ServedModel:
    """One pinned model and its request accounting.  Subclasses expose
    the estimator's scoring surface; every public request runs under
    :meth:`_request`, which books the latency histogram and counters.

    A handle carries a ``model_version`` (bumped by :meth:`repin` on
    every committed delta, online/delta.py) and a staleness clock
    (seconds since the pinned state last changed)."""

    kind = "model"

    def __init__(self, model):
        self.model = model
        self.requests = 0
        self.model_version = 1
        self._committed_at = time.monotonic()

    @property
    def device(self) -> torch.device:
        """The device the handle scores on: the model's, resolved now."""
        return resolve_device(getattr(self.model, "device", None))

    # -- request accounting -------------------------------------------------
    def _request(self, rows: int, fn):
        t0 = time.perf_counter()
        out = fn()
        _observe_request(self.kind, time.perf_counter() - t0, rows)
        self.requests += 1
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "requests": self.requests,
            "model_version": self.model_version,
            "staleness_seconds": round(self.staleness_seconds(), 3),
        }

    # -- in-place update (delta commits) --------------------------------------
    def staleness_seconds(self) -> float:
        """Seconds since this handle's pinned state last changed."""
        return max(0.0, time.monotonic() - self._committed_at)

    def touch_staleness(self) -> float:
        """Refresh and return the handle's staleness gauge."""
        s = self.staleness_seconds()
        _tm.gauge(
            "oap_serve_model_staleness_seconds", {"model": self.kind},
            help="Seconds since the served model's pinned state last "
                 "changed (a delta commit re-pin resets it)",
        ).set(s)
        return s

    def repin(self) -> int:
        """Refresh the pins from the model's current host arrays and bump
        the version: the in-place half of a delta commit.  The pins
        refresh OUTSIDE the registry lock (a pin may reach locks whose
        holders call back into the registry); only the version and clock
        bump runs under it, atomic against serve() / unserve().  The
        handle is never evicted: a request racing the refresh answers
        through whichever pin generation it holds, both committed."""
        self._repin_pins()
        with _LOCK:
            self.model_version += 1
            self._committed_at = time.monotonic()
            version = self.model_version
        _tm.gauge(
            "oap_serve_model_version", {"model": self.kind},
            help="Version of the served model's pinned state (bumped "
                 "by every committed delta fit)",
        ).set(version)
        self.touch_staleness()
        _tm.counter(
            "oap_serve_repins_total", {"model": self.kind},
            help="In-place serving re-pins (committed delta fits)",
        ).inc()
        if flightrec.enabled():
            flightrec.record("serve", "repin", f"kind={self.kind} version={version}")
        return version

    def _repin_pins(self) -> None:
        """Refresh the subclass's pins from the model's cache
        (identity-keyed: a swapped array re-stages once, an unchanged one
        is free, and one the model's own call re-staged is shared)."""

    # -- micro-batch coalescing ---------------------------------------------
    def _flush_many(self, batches, score_rows):
        """Score a queue of small requests as ONE bucketed batch: rows
        concatenated, scored once, the result split back per request.
        The ``serve.batch`` fault site fires first; a non-finite row
        fails the whole flush."""
        batches = [np.atleast_2d(np.asarray(b)) for b in batches]
        if not batches:
            return []
        from oap_mllib_tpu_torch.utils import faults

        faults.maybe_fault("serve.batch")
        note_queue_depth(len(batches))
        try:
            joined = np.concatenate(batches, axis=0)
            if (np.issubdtype(joined.dtype, np.floating)
                    and not np.isfinite(joined).all()):
                from oap_mllib_tpu_torch.utils.resilience import NonFiniteError

                raise NonFiniteError(
                    "coalesced serving flush contains nonfinite input "
                    "rows (poison request in the batch)"
                )
            out = score_rows(joined)
        finally:
            note_queue_depth(-len(batches))
        parts = []
        lo = 0
        for b in batches:
            parts.append(out[lo:lo + b.shape[0]])
            lo += b.shape[0]
        # the caller's _request books the flush wall and the summed rows
        # as one request; the others count here
        for _ in batches[1:]:
            _observe_request(self.kind, 0.0, 0)
            self.requests += 1
        return parts

    # -- pre-warm -------------------------------------------------------------
    def warmup(self, max_rows: int) -> int:
        """Run the scoring program once at every bucket of request sizes
        up to ``max_rows``; afterwards a storm of any sizes <= max_rows
        meets no program-cache miss.  Returns the number of buckets."""
        from oap_mllib_tpu_torch.serving import batcher

        sizes = batcher.warm_sizes(max_rows)
        for b in sizes:
            self._warm_one(b)
        return len(sizes)

    def _warm_one(self, rows: int) -> None:
        raise NotImplementedError


class ServedKMeans(ServedModel):
    kind = "kmeans"

    def __init__(self, model):
        super().__init__(model)
        self._repin_pins()

    def _repin_pins(self) -> None:
        self.centers_dev = pin(self.model._dev_cache, "centers", self.model.cluster_centers_,
                               self.device)

    def predict(self, x) -> np.ndarray:
        from oap_mllib_tpu_torch.serving import batcher

        x = np.atleast_2d(np.asarray(x))
        return self._request(
            x.shape[0], lambda: batcher.assign_kmeans(self.centers_dev, x, self.kind))

    transform = predict

    def predict_many(self, batches):
        """Answer a queue of requests with one coalesced batch
        (:meth:`ServedModel._flush_many`)."""
        from oap_mllib_tpu_torch.serving import batcher

        return self._request(
            sum(np.atleast_2d(np.asarray(b)).shape[0] for b in batches),
            lambda: self._flush_many(
                batches, lambda x: batcher.assign_kmeans(self.centers_dev, x, self.kind)),
        )

    def _warm_one(self, rows: int) -> None:
        from oap_mllib_tpu_torch.serving import batcher

        d = int(self.model.cluster_centers_.shape[1])
        batcher.assign_kmeans(self.centers_dev, np.zeros((rows, d), np.float32), self.kind)


class ServedPCA(ServedModel):
    kind = "pca"

    def __init__(self, model):
        super().__init__(model)
        self._repin_pins()

    def _repin_pins(self) -> None:
        self.components_dev = pin(self.model._dev_cache, "components", self.model.components_,
                                  self.device)

    def transform(self, x) -> np.ndarray:
        from oap_mllib_tpu_torch.serving import batcher

        x = np.atleast_2d(np.asarray(x))
        return self._request(
            x.shape[0], lambda: batcher.project_pca(self.components_dev, x, self.kind))

    def _warm_one(self, rows: int) -> None:
        from oap_mllib_tpu_torch.serving import batcher

        d = int(self.model.components_.shape[0])
        batcher.project_pca(self.components_dev, np.zeros((rows, d), np.float32), self.kind)


class ServedALS(ServedModel):
    """The pinned ALS item table (the port's models keep host factors):
    every request scores user rows against it; the user table stays on
    the host, whence a request gathers its rows."""

    kind = "als"

    def __init__(self, model):
        super().__init__(model)
        self._repin_pins()

    def _repin_pins(self) -> None:
        self.item_dev = pin(self.model._dev_cache, "targets:item", self.model.item_factors_,
                            self.device)

    def predict(self, users, items) -> np.ndarray:
        return self._request(len(np.atleast_1d(users)),
                             lambda: self.model.predict(users, items))

    def recommend_for_users(self, user_ids, num_items: int, with_scores: bool = False):
        """Top-``num_items`` for a subset of users against the pinned item
        table (ids validated by the model's table)."""
        from oap_mllib_tpu_torch.serving import batcher

        user_ids = np.asarray(user_ids, np.int64)

        def run():
            q = self.model.user_factors_[user_ids]
            ids, scores = batcher.topk_scores(q, self.item_dev, num_items, self.kind)
            return (ids, scores) if with_scores else ids

        return self._request(len(user_ids), run)

    def recommend_for_all_users(self, num_items: int, with_scores: bool = False,
                                chunk_rows: int = 0):
        """The full-sweep top-k (serving/sweep.py): the user table
        streamed in chunks, the score matrix never built."""
        from oap_mllib_tpu_torch.serving import sweep

        n_users = int(self.model.user_factors_.shape[0])
        return self._request(
            n_users,
            lambda: sweep.recommend_for_all_users(
                self.model, num_items, with_scores=with_scores,
                chunk_rows=chunk_rows, handle=self),
        )

    def _warm_one(self, rows: int) -> None:
        from oap_mllib_tpu_torch.serving import batcher

        r = int(self.model.user_factors_.shape[1])
        batcher.topk_scores(np.zeros((rows, r), np.float32), self.item_dev, 1, self.kind)


def serve(model, key: Optional[str] = None) -> ServedModel:
    """Pin ``model`` on its device and return its serving handle.
    Serving the SAME model object again returns the existing handle; an
    explicit ``key`` names the entry.  Dispatch is structural (centers,
    components, factor tables)."""
    with _LOCK:
        reg_key = (key,) if key is not None else ("id", id(model))
        existing = _SERVED.get(reg_key)
        if existing is not None and existing.model is model:
            return existing
    if hasattr(model, "cluster_centers_"):
        handle: ServedModel = ServedKMeans(model)
    elif hasattr(model, "components_"):
        handle = ServedPCA(model)
    elif hasattr(model, "user_factors_") and hasattr(model, "item_factors_"):
        handle = ServedALS(model)
    else:
        raise TypeError(
            f"cannot serve {type(model).__name__}: expected a fitted "
            "KMeansModel, PCAModel, or ALSModel surface"
        )
    with _LOCK:
        _SERVED[reg_key] = handle
        _tm.gauge(
            "oap_serve_models_pinned",
            help="Models currently pinned in the serving registry",
        ).set(len(_SERVED))
    return handle


def unserve(model_or_key) -> bool:
    """Drop a served model from the registry (its pins free with the
    handle).  Accepts the model object or the explicit key."""
    with _LOCK:
        for k in (("id", id(model_or_key)), (model_or_key,)):
            if k in _SERVED:
                del _SERVED[k]
                _tm.gauge("oap_serve_models_pinned").set(len(_SERVED))
                return True
    return False


def served_models() -> Dict[tuple, ServedModel]:
    with _LOCK:
        return dict(_SERVED)


def repin_model(model) -> int:
    """Re-pin every handle serving ``model`` in place (version bump,
    staleness reset, no eviction); returns how many (0 when the model is
    not served)."""
    with _LOCK:
        handles = [h for h in _SERVED.values() if h.model is model]
    for h in handles:
        h.repin()
    return len(handles)


def clear() -> None:
    """Drop every handle (tests)."""
    global _queue_depth
    with _LOCK:
        _SERVED.clear()
        _tm.gauge("oap_serve_models_pinned").set(0)
    with _DEPTH_LOCK:
        _queue_depth = 0


def serving_summary() -> Dict[str, Any]:
    """The ``serving`` block: request, batch, pad-row and row totals,
    p50 / p99 latency from the log-bucket histogram (upper-bound bucket
    quantiles), each handle's version and staleness, the queue depth,
    and the traffic plane's keys (``traffic.summary_block``)."""
    reqs = _tm.family_total("oap_serve_requests_total")
    block: Dict[str, Any] = {
        "models_pinned": len(_SERVED),
        "requests": int(reqs),
        "batches": int(_tm.family_total("oap_serve_batches_total")),
        "pad_rows": int(_tm.family_total("oap_serve_pad_rows_total")),
        "rows": int(_tm.family_total("oap_serve_rows_total")),
        "evictions": int(_tm.family_total("oap_serve_evictions_total")),
    }
    if reqs:
        block["latency_p50_s"], block["latency_p99_s"] = _latency_quantiles()
    with _LOCK:
        handles = list(_SERVED.values())
    if handles:
        block["models"] = [
            {"kind": h.kind, "model_version": h.model_version,
             "staleness_seconds": round(h.touch_staleness(), 3),
             "requests": h.requests}
            for h in handles
        ]
    with _DEPTH_LOCK:
        block["queue_depth"] = _queue_depth
    from oap_mllib_tpu_torch.serving import traffic

    block.update(traffic.summary_block())
    return block


def _latency_quantiles() -> tuple:
    """(p50, p99) over every model kind's latency histogram, merged
    bucket by bucket (same bounds)."""
    reg = _tm.registry()
    merged: Optional[_tm.Histogram] = None
    with _tm._LOCK:
        series = [m for (name, _), m in reg._metrics.items()
                  if name == "oap_serve_request_seconds"]
        for h in series:
            if merged is None:
                merged = _tm.Histogram(h.bounds)
            for i, c in enumerate(h.counts):
                merged.counts[i] += c
            merged.sum += h.sum
            merged.count += h.count
    if merged is None or merged.count == 0:
        return (0.0, 0.0)
    return (_tm.histogram_quantile(merged, 0.50), _tm.histogram_quantile(merged, 0.99))
