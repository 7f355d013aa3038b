"""Mini-batch Lloyd: decayed incremental K-Means updates (the port of the
JAX package's ``online/minibatch.py``).

One ``partial_fit`` = ONE assignment pass over the arriving chunks
through the streamed fit's own pass (ops/stream_ops.streamed_accumulate:
the prefetch pipeline, K1 on every chunk in loop mode, the moments
reduced across the processes of a world), folded into the model by the
count-weighted mini-batch rule (Sculley 2010):

    c_new = (n_eff * c_old + batch_sum) / (n_eff + batch_count)

with ``n_eff = online_decay * n_accum`` the decayed per-center count
carried across deltas, seeded from the batch fit's cluster sizes.  The
fold runs on the host in float64.  No re-init, no convergence loop.

Compute-then-swap: the pass accumulates into fresh buffers and the
centers array is REPLACED (never written in place) only after the pass
finished and the new centers passed the finite check, so the
``delta.ingest`` fault site, which fires before any accumulation, and
any error mid-pass leave the model and its served pin as they were.
"""

from __future__ import annotations

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.online import delta
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.faults import maybe_fault


def _seed_counts(model, k: int) -> np.ndarray:
    """The per-center counts a delta starts from: the last delta's, else
    the batch fit's cluster sizes, else zeros (a zero-count center takes
    the first batch mean that reaches it)."""
    counts = getattr(model, "_online_counts", None)
    if counts is not None:
        return np.asarray(counts, np.float64)
    sizes = getattr(model.summary, "cluster_sizes", None)
    if sizes is not None and np.asarray(sizes).shape == (k,):
        return np.asarray(sizes, np.float64)
    return np.zeros((k,), np.float64)


def partial_fit_kmeans(model, x, sample_weight=None):
    """One decayed mini-batch Lloyd delta over ``x`` (an array or a
    ``ChunkSource``; optional per-row weights) folded into ``model``, on
    the model's device; commits through :func:`online.delta.commit`.
    Returns the model."""
    from oap_mllib_tpu_torch.data.stream import ChunkSource
    from oap_mllib_tpu_torch.ops import stream_ops
    from oap_mllib_tpu_torch.utils.dispatch import resolve_device
    from oap_mllib_tpu_torch.utils.resilience import check_finite

    decay = delta.decay_cfg()  # a typo'd knob raises before the fault site
    # before any accumulation or mutation: an injected failure is as if
    # the delta never arrived
    maybe_fault("delta.ingest")
    if model.distance_measure != "euclidean":
        raise NotImplementedError(
            "partial_fit requires distance_measure='euclidean' (the "
            "streamed assignment pass is euclidean-only)"
        )
    cfg = get_config()
    dev = resolve_device(model.device)
    # the fit's dtype: float64 on the x64 lane (the JAX package's
    # minibatch.py), the centers cast to it and the fold's result too
    dtype = np.float64 if psn.compute_dtype("kmeans", cfg) == torch.float64 else np.float32
    centers_old = np.asarray(model.cluster_centers_, dtype)
    k, d = centers_old.shape
    if not isinstance(x, ChunkSource):
        x = ChunkSource.from_array(np.atleast_2d(np.asarray(x)))
    if x.n_features != d:
        raise ValueError(f"partial_fit chunk width {x.n_features} != model dimensionality {d}")
    if sample_weight is not None and not isinstance(sample_weight, ChunkSource):
        sample_weight = ChunkSource.from_array(
            np.asarray(sample_weight, dtype).reshape(-1, 1), chunk_rows=x.chunk_rows)
    if sample_weight is not None:
        stream_ops._checked_entry(lambda: stream_ops._check_weight_source(x, sample_weight))
    pol = psn.resolve("kmeans")
    tier = psn.kernel_tier(pol, cfg.matmul_precision, "kmeans")
    sums, counts, _ = stream_ops.streamed_accumulate(
        x, torch.as_tensor(centers_old).to(dev), tier, need_cost=False,
        weights=sample_weight, phase="partial_fit", policy=pol)
    sums = sums.cpu().numpy().astype(np.float64)
    counts = counts.cpu().numpy().astype(np.float64)
    # the decayed count-weighted fold, on the reduced pass moments (the
    # same on every process, so the swap is too)
    n_eff = decay * _seed_counts(model, k)
    denom = n_eff + counts
    new_centers = np.where(
        denom[:, None] > 0,
        (centers_old.astype(np.float64) * n_eff[:, None] + sums)
        / np.maximum(denom[:, None], 1e-300),
        centers_old,
    ).astype(dtype)
    check_finite(torch.from_numpy(new_centers), "K-Means centroids (partial_fit delta)")
    rows = float(counts.sum())
    # compute-then-swap: nothing above touched the model
    model.cluster_centers_ = new_centers
    model._online_counts = denom
    _tm.counter(
        "oap_online_delta_rows_total", {"model": "kmeans"},
        help="Rows ingested by incremental-fit deltas.",
    ).inc(rows)
    delta.commit(model, "kmeans", detail=f"rows={rows:g}")
    return model
