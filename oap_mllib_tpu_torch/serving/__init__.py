"""Serving plane: fitted models as a request workload (the port of the
JAX package's ``serving/``, one process a replica).

- :mod:`~oap_mllib_tpu_torch.serving.registry`: ``serve(model)`` pins a
  fitted model's tensors on its device once; per-request telemetry in
  the ``oap_serve_*`` families; in-place re-pins on online commits.
- :mod:`~oap_mllib_tpu_torch.serving.batcher`: requests round up onto
  the geometric row buckets and score through program-cache-registered
  programs, the same the models' own predict, transform and top-k run.
- :mod:`~oap_mllib_tpu_torch.serving.sweep`: the full-sweep top-k over
  the whole user base, streamed, never building the score matrix.
- :mod:`~oap_mllib_tpu_torch.serving.traffic`: the async front
  (``TrafficQueue``): deadline-ordered coalesced flushes, admission
  that sheds loudly (``ShedError``), durable futures (retries, poison
  bisection, drain; ``ServeError``), the brownout ladder and the scale
  controller.
- :mod:`~oap_mllib_tpu_torch.serving.reqtrace`: the per-request
  deadline-budget ledger (``Config.serve_trace_sample``).
- :mod:`~oap_mllib_tpu_torch.serving.slo`: burn rates and the error
  budget over the ledgers (``Config.serve_slo_p99_ms``).
- :mod:`~oap_mllib_tpu_torch.serving.ha`: replica heartbeats over the
  watched host collective, eviction, release.

The JAX package's factor-sharded ring sweep (``shard_factors``,
``shard_factors_local``, the eviction ``reform`` hook) is not here: it
serves models that keep a live sharded layout (A5 slice 3).

Usage::

    handle = serving.serve(model)   # pins the model's tensors once
    handle.warmup(4096)             # one batch at every bucket
    ids = handle.predict(batch)     # bit-equal to model.predict(batch)

    with serving.TrafficQueue(handle) as q:          # the async front
        futs = [q.submit(b, deadline_ms=50) for b in storm]
        ids = [f.result() for f in futs]             # or ShedError
"""

from oap_mllib_tpu_torch.serving.registry import (  # noqa: F401
    ServedALS,
    ServedKMeans,
    ServedModel,
    ServedPCA,
    serve,
    served_models,
    serving_summary,
    unserve,
)
from oap_mllib_tpu_torch.serving.ha import (  # noqa: F401
    ReplicaGuard,
    fleet_evicted,
    heartbeat,
)
from oap_mllib_tpu_torch.serving.traffic import (  # noqa: F401
    BrownoutController,
    ScaleController,
    ServeError,
    ShedError,
    TrafficQueue,
    brownout,
    brownout_stale_ok,
    brownout_topk,
    serving_health_block,
    write_scale_hint,
)
from oap_mllib_tpu_torch.serving.reqtrace import (  # noqa: F401
    Ledger,
    TraceContext,
    attribution_block,
    is_sampled,
    ledger_of,
    make_trace_id,
)
from oap_mllib_tpu_torch.serving.slo import (  # noqa: F401
    SLOEngine,
    slo_state,
)
