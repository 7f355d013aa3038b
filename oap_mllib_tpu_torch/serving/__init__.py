"""Serving plane: fitted models as a request workload (the one-process
core of the JAX package's ``serving/``).

- :mod:`~oap_mllib_tpu_torch.serving.registry`: ``serve(model)`` pins a
  fitted model's tensors on its device once; per-request telemetry in
  the ``oap_serve_*`` families; in-place re-pins on online commits.
- :mod:`~oap_mllib_tpu_torch.serving.batcher`: requests round up onto
  the geometric row buckets and score through program-cache-registered
  programs, the same the models' own predict, transform and top-k run.
- :mod:`~oap_mllib_tpu_torch.serving.sweep`: the full-sweep top-k over
  the whole user base, streamed, never building the score matrix.

Usage::

    handle = serving.serve(model)   # pins the model's tensors once
    handle.warmup(4096)             # one batch at every bucket
    ids = handle.predict(batch)     # bit-equal to model.predict(batch)
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
