"""Full-sweep top-k of a host-factor model: the one-device part of the
JAX package's ``serving/sweep.py``.

``recommend_for_all_users`` over the whole user base scores an
(n_users, r) x (r, n_items) product whose naive form builds the
(n_users, n_items) score matrix (38.4 GB at ML-25M's 162,541 x 59,047).
:func:`sweep_streamed` never builds it: it walks the user table in
fixed-width row chunks, the last one padded to its row bucket, folding
each chunk's top-k against the PINNED item table (serving/registry.pin)
into a preallocated (n_users, k) output.  Its loop is the models' own
(``batcher.topk_chunked``), at the models' chunk width
(``batcher.topk_chunk_rows``; ``Config.sweep_chunk_rows`` overrides
it), so the sweep equals ``ALSModel.recommend_for_all_users`` bit for
bit.  Unlike the JAX package's sweep it stages the chunks on the calling
thread, not through the prefetch pipeline: a chunk is a few KB of query
rows against a product that takes longer than its copy, and handing
each one to a staging thread measured slower than the plain loop.

The JAX package's factor-sharded ring sweep, ``shard_factors`` /
``shard_factors_local`` and the eviction ``reform`` hook (with its
``ha.fleet_evicted`` check) serve models that keep a live sharded
layout; the port's models gather their factors to the host, so every
model here takes the streamed sweep.  They wait for a later slice (A5
slice 3 in ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.telemetry import metrics as _tm


def _sweep_chunk_rows(n_targets: int, r: int) -> int:
    """Rows a sweep chunk scores: ``Config.sweep_chunk_rows`` when set
    (> 0), else the models' top-k chunk width.  Negative raises."""
    from oap_mllib_tpu_torch.serving.batcher import topk_chunk_rows

    cfg_rows = int(get_config().sweep_chunk_rows)
    if cfg_rows < 0:
        raise ValueError(f"sweep_chunk_rows must be >= 0, got {cfg_rows}")
    return cfg_rows or topk_chunk_rows(n_targets, r)


def recommend_for_all_users(model, num_items: int, *, with_scores: bool = False,
                            chunk_rows: int = 0, handle=None):
    """Top-``num_items`` item ids (and, with ``with_scores``, scores) for
    EVERY user of ``model``, streamed; equal to
    ``model.recommend_for_all_users`` bit for bit at the default chunk
    width.  ``handle`` is a serving handle whose pinned item table to
    score against."""
    if num_items < 0:
        raise ValueError(f"top-k count must be >= 0, got {num_items}")
    ids, scores = sweep_streamed(
        model.user_factors_, _pinned_targets(model, handle), int(num_items),
        with_scores=with_scores, chunk_rows=chunk_rows)
    return (ids, scores) if with_scores else ids


def _pinned_targets(model, handle) -> torch.Tensor:
    """The pinned item table: the handle's generation when there is one
    (a handle with ``online_repin`` off keeps its own until re-pinned),
    else the model's (one device copy either way).  At the brownout
    ladder's stale rung a replaced table answers from its previous pin
    (``registry.pin``'s ``allow_stale``)."""
    if handle is not None:
        return handle.item_dev
    from oap_mllib_tpu_torch.serving.registry import pin

    return pin(model._dev_cache, "targets:item", model.item_factors_, model.device,
               allow_stale=True)


def sweep_streamed(query, targets_dev: torch.Tensor, n: int, *, with_scores: bool = False,
                   chunk_rows: int = 0,
                   kind: str = "als") -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Top-``n`` of ``query @ targets.T`` for every query row, in chunks
    of ``chunk_rows`` rows (0: :func:`_sweep_chunk_rows`); host memory is
    the (n_query, n) output plus one chunk."""
    from oap_mllib_tpu_torch.serving import batcher

    rows = int(chunk_rows) or _sweep_chunk_rows(int(targets_dev.shape[0]), query.shape[1])
    out = batcher.topk_chunked(query, targets_dev, n, rows, with_scores=with_scores, kind=kind)
    _tm.counter(
        "oap_serve_sweep_rows_total", {"model": kind},
        help="Query rows swept by full-sweep top-k",
    ).inc(int(query.shape[0]))
    return out
