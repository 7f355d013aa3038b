"""Request batching: bucketed, program-cache-registered scoring (the port
of the JAX package's ``serving/batcher.py``).

Every request batch rounds UP onto the geometric row buckets of
data/bucketing.py (multiples of :data:`SERVE_ROW_MULTIPLE`); the padding
rows are zeros, scored and sliced off, never aggregated.  The scoring
programs register in utils/progcache.py under the JAX package's names
(``serve.assign``, ``serve.project``, ``serve.topk``), keyed by the
policy and the staged shapes, so a storm of jittered sizes after
:meth:`~oap_mllib_tpu_torch.serving.registry.ServedModel.warmup` meets
no miss.  The port compiles no program per shape; the counterpart of the
JAX package's XLA compile count is the program cache's kernel-library
builds and loads (``progcache.xla_compile_count``), which scoring never
moves.

The models' own scoring goes through the same programs, so a served
answer is bit-equal to the model's call on the same rows: both pad to
the same bucket and run the same products.  Scoring products follow
``Config.serving_precision`` (empty inherits the algorithm's policy;
the f32 default keeps the products the models always ran).

``assign_kmeans`` is ``pairwise_sq_dists`` and ``argmin`` in plain
torch, as the JAX package runs its XLA program there (no Pallas
kernel).  ``topk_pairs`` ranks by :func:`topk_keys`, whose ties go to
the lowest id, as ``lax.top_k``'s do.  Each scoring batch is the
``serve.request`` fault site.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.data.bucketing import bucket_rows
from oap_mllib_tpu_torch.ops import kmeans_ops
from oap_mllib_tpu_torch.serving import reqtrace
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils import progcache
from oap_mllib_tpu_torch.utils.faults import maybe_fault

# request rows bucket on the x2 series over multiples of 8
SERVE_ROW_MULTIPLE = 8

_SERVING_CHOICES = ("", "f32", "tf32", "bf16", "auto")


class ServingPolicy(NamedTuple):
    """A resolved serving policy: its name and the tier its products
    run at."""

    name: str
    dot_tier: str


def resolve_policy(algo: str) -> ServingPolicy:
    """The serving-time policy of ``algo``'s scoring products:
    ``Config.serving_precision`` empty inherits the algorithm's resolved
    policy, a value overrides it with the same vocabulary.  A typo
    raises at request time.

    The brownout ladder's ``bf16`` rung
    (``traffic.brownout_precision_override``) folds in here, only with
    no ``serving_precision`` pin and only for an algorithm with a
    parity bound: an operator's pin beats a degradation rung."""
    cfg = get_config()
    raw = cfg.serving_precision
    if raw not in _SERVING_CHOICES:
        raise ValueError(
            "serving_precision must be one of "
            f"{'|'.join(v or '<empty>' for v in _SERVING_CHOICES)}, "
            f"got {raw!r}"
        )
    if not raw:
        from oap_mllib_tpu_torch.serving import traffic

        raw = traffic.brownout_precision_override(algo)
    if raw:
        cfg = dataclasses.replace(cfg, compute_precision=raw, kmeans_precision="",
                                  pca_precision="", als_precision="")
    name = psn.resolve(algo, cfg, record=False)
    return ServingPolicy(name, psn.kernel_tier(name, cfg.matmul_precision))


def bucket_batch(x, multiple: int = SERVE_ROW_MULTIPLE):
    """``(padded, n)``: ``x`` (an array or a tensor) with zero rows
    appended up to ``bucket_rows(n, multiple)``; every consumer slices
    its result back to ``n``.  The pad's wall folds into the request
    ledgers of a traced flush (``reqtrace.note_flush``; a thread-local
    miss otherwise)."""
    t0 = time.perf_counter()
    if isinstance(x, torch.Tensor):
        x = x if x.dim() == 2 else x.reshape(1, -1)
        n = x.shape[0]
        b = bucket_rows(max(n, 1), multiple)
        if b != n:
            x = torch.cat([x, x.new_zeros((b - n, x.shape[1]))])
    else:
        x = np.ascontiguousarray(np.atleast_2d(x))
        n = x.shape[0]
        b = bucket_rows(max(n, 1), multiple)
        if b != n:
            x = np.concatenate([x, np.zeros((b - n, x.shape[1]), x.dtype)], axis=0)
    reqtrace.note_flush("bucket_pad", time.perf_counter() - t0)
    return x, n


def slice_rows(budget_rows: int, multiple: int = SERVE_ROW_MULTIPLE) -> int:
    """The largest row bucket within ``budget_rows`` (at least
    ``multiple``): the width of a model's scoring slices, so a full
    slice runs at its own bucket and pads nothing; only the tail pads."""
    rows = multiple
    while bucket_rows(rows + 1, multiple) <= budget_rows:
        rows = bucket_rows(rows + 1, multiple)
    return rows


def stage(x, device) -> torch.Tensor:
    """One request payload as an f32 tensor on ``device``, by one
    explicit host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32)).to(device, non_blocking=False)


def _book(kind: str, pad: int) -> None:
    # every scoring batch is the serve.request fault site
    maybe_fault("serve.request")
    lab = {"model": kind}
    _tm.counter(
        "oap_serve_batches_total", lab,
        help="Scoring batches launched by the serving plane",
    ).inc()
    _tm.counter(
        "oap_serve_pad_rows_total", lab,
        help="Bucket-padding rows added to serving batches "
             "(masked, sliced off results)",
    ).inc(pad)


def _program(algo: str, pol: ServingPolicy, dev: torch.device, build):
    return progcache.get_or_build(
        algo, (progcache.backend_fingerprint(dev), pol.name, pol.dot_tier), build)


# -- scoring programs -----------------------------------------------------------


def _build_assign(tier: str):
    def assign(xb: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        return torch.argmin(kmeans_ops.pairwise_sq_dists(xb, centers, tier), dim=1)

    return assign


def assign_kmeans(centers_dev: torch.Tensor, x, kind: str = "kmeans") -> np.ndarray:
    """Nearest pinned center of every row of ``x``: padded to its row
    bucket, staged, the registered assignment program, labels sliced
    back as int32, the JAX package's program's dtype."""
    pol = resolve_policy("kmeans")
    xb, n = bucket_batch(x)
    _book(kind, xb.shape[0] - n)
    fn = _program("serve.assign", pol, centers_dev.device, lambda: _build_assign(pol.dot_tier))
    staged = stage(xb, centers_dev.device)
    progcache.note("serve.assign",
                   (pol.name, pol.dot_tier, progcache.array_key(staged, centers_dev)))
    return fn(staged, centers_dev).to(torch.int32).cpu().numpy()[:n]


def _build_project(policy: str, tier: str):
    def project(xb: torch.Tensor, components: torch.Tensor) -> torch.Tensor:
        return psn.pdot(xb, components, policy, tier)

    return project


def project_pca(components_dev: torch.Tensor, x, kind: str = "pca") -> np.ndarray:
    """Rows of ``x`` in the pinned (d, k) component basis, no centering
    (Spark parity), bucketed like :func:`assign_kmeans`."""
    pol = resolve_policy("pca")
    xb, n = bucket_batch(x)
    _book(kind, xb.shape[0] - n)
    fn = _program("serve.project", pol, components_dev.device,
                  lambda: _build_project(pol.name, pol.dot_tier))
    staged = stage(xb, components_dev.device)
    progcache.note("serve.project",
                   (pol.name, pol.dot_tier, progcache.array_key(staged, components_dev)))
    return fn(staged, components_dev).cpu().numpy()[:n]


def topk_keys(scores: torch.Tensor, ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 keys whose order is (score descending, id ascending): the
    f32 bits mapped to an order-preserving int32, shifted up, and the
    complemented id below (``ids``, non-negative int32 broadcast against
    the scores; None: the column index).  ``torch.topk`` on them breaks
    ties to the lowest id, as ``lax.top_k`` does."""
    bits = scores.contiguous().view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    if ids is None:
        ids = torch.arange(scores.shape[1], device=scores.device, dtype=torch.int64)
    # in place: one int64 (rows, n_targets) buffer beside the scores
    return keys.mul_(1 << 32).add_((1 << 32) - 1 - ids.to(torch.int64))


def _build_topk(policy: str, tier: str):
    def topk(q: torch.Tensor, targets: torch.Tensor, n: int):
        s = psn.pdot(q, targets.T, policy, tier)
        idx = torch.topk(topk_keys(s), n, dim=1).indices
        return s.gather(1, idx), idx.to(torch.int32)

    return topk


def topk_pairs(q_dev: torch.Tensor, targets_dev: torch.Tensor, n: int, kind: str = "als"):
    """Top-``n`` ``(scores, ids)`` of every staged query row against the
    pinned target table, device tensors: the program the chunked top-k
    (:func:`topk_chunked`) and a served request share."""
    pol = resolve_policy("als")
    fn = _program("serve.topk", pol, targets_dev.device,
                  lambda: _build_topk(pol.name, pol.dot_tier))
    progcache.note("serve.topk",
                   (pol.name, pol.dot_tier, int(n), progcache.array_key(q_dev, targets_dev)))
    return fn(q_dev, targets_dev, int(n))


def topk_chunk_rows(n_targets: int, r: int) -> int:
    """Query rows a top-k chunk scores: the scoring budget over the
    (rows, n_targets) scores and the query rows, a third of it, because
    the keys take two more words a score."""
    return max(1, kmeans_ops.rows_per_chunk(n_targets, r) // 3)


def topk_chunked(query, targets_dev: torch.Tensor, n: int, rows: int, *,
                 with_scores: bool = True,
                 kind: str = "als") -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Top-``n`` ``(ids int32, scores f32 or None)`` of every row of the
    host table ``query`` against the pinned targets, ``rows`` query rows
    a chunk: the loop the models' top-k and the full sweep share.  A
    chunk shorter than ``rows`` pads to its row bucket (one padded chunk
    when the table is narrower than the width), so the products run at
    two shapes however the table is sized; the (n_query, n_targets)
    score matrix is never built, and host memory is the preallocated
    output plus one chunk."""
    n = min(int(n), int(targets_dev.shape[0]))
    nq = int(query.shape[0])
    out_ids = np.empty((nq, n), np.int32)
    out_scores = np.empty((nq, n), np.float32) if with_scores else None
    if nq == 0 or n == 0:
        return out_ids, out_scores
    rows = max(1, int(rows))
    for lo in range(0, nq, rows):
        q = np.asarray(query[lo:lo + rows], np.float32)
        nv = q.shape[0]
        if nv < rows:
            q, _ = bucket_batch(q)
        s, i = topk_pairs(stage(q, targets_dev.device), targets_dev, n, kind=kind)
        out_ids[lo:lo + nv] = i.cpu().numpy()[:nv]
        if with_scores:
            out_scores[lo:lo + nv] = s.cpu().numpy()[:nv]
    return out_ids, out_scores


def topk_scores(query, targets_dev: torch.Tensor, n: int,
                kind: str = "als") -> Tuple[np.ndarray, np.ndarray]:
    """Bucketed one-batch top-k of a request's query rows: ``(ids int32,
    scores f32)`` on the host."""
    n = min(int(n), int(targets_dev.shape[0]))
    qb, rows = bucket_batch(np.asarray(query, np.float32))
    _book(kind, qb.shape[0] - rows)
    s, i = topk_pairs(stage(qb, targets_dev.device), targets_dev, n, kind=kind)
    return i.cpu().numpy()[:rows], s.cpu().numpy()[:rows]


def warm_sizes(max_rows: int, multiple: int = SERVE_ROW_MULTIPLE) -> list:
    """The bucket family that covers request sizes up to ``max_rows``."""
    out = []
    n = 1
    while True:
        b = bucket_rows(n, multiple)
        if not out or b != out[-1]:
            out.append(b)
        if b >= max_rows:
            break
        n = b + 1
    return out


def xla_snapshot() -> int:
    """The kernel-library builds and loads so far
    (``progcache.xla_compile_count``, the port's counterpart of the JAX
    package's XLA compile count): a steady-state storm moves it by 0."""
    return progcache.xla_compile_count()
