"""Streamed (out-of-core) K-Means and PCA over a ``ChunkSource``: the
single-process part of the JAX package's ``ops/stream_ops.py``.

Device memory is O(chunk x d) while the fits make whole-table passes.
Every pass walks the source once through the prefetch pipeline
(data/prefetch.py), which stages chunk N+1 into pinned memory and copies
it to the card on a side stream while chunk N's kernel runs; each pass
records its stage / transfer / compute split in the fit's timings.

- K-Means: :func:`lloyd_run_streamed` makes one pass per Lloyd
  iteration, the fused accumulate kernel (K1,
  ops/cuda/kmeans_kernel.lloyd_accumulate) on every chunk in loop mode,
  the chunks' sums, counts and cost added in chunk order; then one cost
  pass at f32 staging and the ``highest`` tier.  So a fit launches K1
  chunks x (iterations + 1) times.
- k-means|| init: :func:`reservoir_sample` (one pass, Algorithm R) and
  :func:`init_kmeans_parallel_streamed` (a distance pass, ``init_steps``
  sampling passes, an ownership pass), with the JAX package's two numpy
  generators, so the candidates and the final k-means++ draws are the
  JAX package's for the same data.
- PCA: :func:`covariance_streamed` makes two passes, column sums then
  the centred Gram, each chunk through the moments kernel (K2,
  ops/cuda/pca_kernel.pca_moments): 2 x chunks launches.  Under the
  ``bf16`` policy chunks stage at bfloat16 and the cross-chunk sums are
  Kahan-compensated, as in the JAX package.

Padded tail rows carry weight 0 through K1 and K2, cost included.

Each Lloyd pass and each PCA moment pass is the ``fit.execute`` fault
site before its kernels launch (utils/faults.py).  After every Lloyd
pass the centroids, after the PCA passes the column sums and the Gram
are checked finite (utils/resilience.check_finite, the JAX package's
checks and messages): a NaN or Inf raises ``NonFiniteError``.

Across processes (the multi-process half of the JAX package's module)
each process streams its OWN shard, and every pass ends in a reduction
that every process reaches (:func:`_psum_host`, :func:`_allgather_host`),
even one whose source raised: :class:`_PassGuard` swallows the error,
its flag rides in front of the payload, and every process raises
together.  The f32 moments of a pass (sums, counts and cost; the column
sums; the Gram) reduce through ONE packed ring across the processes,
K5 over CUDA IPC (:func:`_ring_reduce_f32`), when ``Config.ring_reduction``
allows it; the flag and the other payloads (row counts, phi, the
candidates' weights) take the host gather, first, so a failed process
aborts the world before the ring.  The route is a pure function of the
config and the dtypes, so every process issues the same collectives.
With one process the reductions are the identity.

After every pass's reduction, :func:`_fleet_pass` gathers one frame of
the pass's statistics from every process (telemetry/fleet.py, when
``Config.fleet_stats`` arms it) and hands the same frames to the
straggler controller (parallel/balance.observe_pass), which may re-plan
the extents of balanced sources before the next pass;
:func:`capability_sync` is the capability balancer's one gather at its
first plan.  Both ride :func:`_allgather_host`, so every process issues
the same collectives.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from oap_mllib_tpu_torch.data.prefetch import Prefetcher, PrefetchStats
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.ops import kmeans_ops
from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel, pca_kernel, ring_kernel
from oap_mllib_tpu_torch.parallel import balance, bootstrap, collective
from oap_mllib_tpu_torch.telemetry import fleet
from oap_mllib_tpu_torch.utils import faults
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.resilience import check_finite
from oap_mllib_tpu_torch.utils.dispatch import resolve_device
from oap_mllib_tpu_torch.utils.timing import tick


def _chunk_weights(n_valid: int, chunk_rows: int) -> np.ndarray:
    w = np.zeros((chunk_rows,), np.float32)
    w[:n_valid] = 1.0
    return w


def _iter_weighted(source: ChunkSource, weights):
    """``(chunk, n_valid, w)`` with ``w`` the (chunk_rows,) f32 row
    weights, 0 on the padding.  ``weights`` is None (all ones) or a
    width-1 source walked in lockstep, whose valid counts must match."""
    if weights is None:
        for chunk, n_valid in source:
            yield chunk, n_valid, _chunk_weights(n_valid, source.chunk_rows)
        return
    wit = iter(weights)
    for chunk, n_valid in source:
        wpair = next(wit, None)
        if wpair is None:
            raise ValueError(
                "sample_weight source ran out of chunks before the data source; "
                "the two must be chunked identically"
            )
        wchunk, wn = wpair
        if wn != n_valid:
            raise ValueError(
                f"sample_weight source yielded {wn} valid rows where the data source "
                f"yielded {n_valid}; the two must be chunked identically"
            )
        w = np.asarray(wchunk, np.float32).reshape(-1)[:source.chunk_rows].copy()
        w[n_valid:] = 0.0
        yield chunk, n_valid, w
    if next(wit, None) is not None:
        raise ValueError(
            "sample_weight source has more chunks than the data source; the two "
            "must be chunked identically"
        )


def _check_weight_source(source: ChunkSource, weights) -> None:
    if weights is None:
        return
    if not isinstance(weights, ChunkSource):
        raise TypeError("sample_weight for a streamed fit must be a ChunkSource")
    if weights.n_features != 1:
        raise ValueError("sample_weight source must have width 1")
    if weights.chunk_rows != source.chunk_rows:
        raise ValueError(
            f"sample_weight chunk_rows {weights.chunk_rows} != data chunk_rows "
            f"{source.chunk_rows}"
        )
    if (weights.n_rows is not None and source.n_rows is not None
            and weights.n_rows != source.n_rows):
        raise ValueError(f"sample_weight rows {weights.n_rows} != data rows {source.n_rows}")


def _stage(stage_dtype: torch.dtype):
    """The producer's stage of one weighted chunk: the data chunk as a
    host tensor at ``stage_dtype`` (f32, or bfloat16 cast here, in the
    producer thread, under the bf16 policy) and its weights; the host
    chunk rides along for the init passes, which pick rows from it."""

    def stage(item):
        chunk, n_valid, w = item
        x = torch.from_numpy(np.ascontiguousarray(chunk))
        x = x.to(stage_dtype) if x.dtype != stage_dtype else x
        return (chunk, n_valid, w), (x, torch.from_numpy(w))

    return stage


def _staged_chunks(source, weights, device, stats: PrefetchStats,
                   stage_dtype: torch.dtype = torch.float32) -> Prefetcher:
    """``((host chunk, n_valid, host w), (x, w))`` over a (weighted)
    source, ``x`` and ``w`` on ``device``."""
    return Prefetcher(_iter_weighted(source, weights), stage=_stage(stage_dtype),
                      device=device, stats=stats)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """A staged chunk as the f32 operand the kernels take (bfloat16 chunks
    widen exactly)."""
    return x if x.dtype == torch.float32 else x.float()


# -- across processes ----------------------------------------------------------------


def _world() -> int:
    return bootstrap.world_size()


class _PassGuard:
    """Capture a source error during a local pass so the next
    cross-process reduction still runs on EVERY process.

    Without it a process whose source raises mid-pass exits before its
    gather while its peers wait in theirs until the collective timeout.
    With it the error is swallowed, the reduction gathers an error flag
    with the data, and every process raises together (the local error
    chained on the process that saw it).  With one process the original
    exception is raised unchanged at the reduction::

        guard = _PassGuard()
        with guard:
            for chunk, n_valid in source: ...accumulate...
        out = _psum_host([...], guard=guard)
    """

    def __init__(self):
        self.err = None

    def __enter__(self) -> "_PassGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None and isinstance(exc, Exception):
            self.err = exc
            return True  # swallowed; the next reduction raises on every process
        return False


def _gather_with_guard(arrays, guard):
    """``collective.process_allgather`` with the guard's error flag in
    front of the payload, so every process fails together when any
    process's pass failed.  Returns the per-process stacked arrays, or
    None in one process (the guard's error raised)."""
    if _world() == 1:
        if guard is not None and guard.err is not None:
            raise guard.err
        return None
    if guard is not None:
        arrays = [np.asarray([0 if guard.err is None else 1], np.int64)] + list(arrays)
    gathered = collective.process_allgather(arrays)
    if guard is not None:
        if int(gathered[0].sum()) > 0:
            raise RuntimeError("streamed pass failed on at least one process") from guard.err
        gathered = gathered[1:]
    return gathered


def _materialize(arrays, guard):
    """The accumulators on the host, under the guard: fetching a device
    value is where an asynchronous device error surfaces, and it must
    reach the collective like a source error.  A failed fetch sends
    zeros of the same shapes (the flag aborts the world first)."""
    def fetch():
        return [a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                for a in arrays]

    if guard is None:
        return fetch()
    with guard:
        return fetch()
    return [np.zeros(tuple(a.shape), np.float32 if isinstance(a, torch.Tensor)
                     else np.asarray(a).dtype) for a in arrays]


def _ring_armed() -> bool:
    """Whether the f32 moments of a streamed pass reduce through the ring
    across the processes: several processes, no model axis (the JAX
    package's condition) and ``Config.ring_reduction`` not "off"."""
    from oap_mllib_tpu_torch.config import get_config

    cfg = get_config()
    return (_world() > 1 and cfg.model_parallel == 1
            and kmeans_ops.ring_mode_cfg(cfg) != "off")


def _ring_reduce_f32(arrays, device):
    """Sum f32 host arrays across the processes through ONE packed ring:
    the payloads flatten into a (P, ceil(total / P)) sheet, one slot per
    process (each ring segment a real chunk of the moments), the ring of
    the P processes sums it (K5 over IPC on the card,
    ring_kernel.ring_allreduce_groups), and the sums come back on every
    process."""
    world = _world()
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    total = flat.size
    cols = max(1, -(-total // world))
    sheet = np.zeros((world, cols), np.float32)
    sheet.ravel()[:total] = flat
    me = bootstrap.process_index()
    out = ring_kernel.ring_allreduce_groups(
        {me: torch.from_numpy(sheet).to(device)}, [list(range(world))], lambda p: p)
    summed = out[me].cpu().numpy().ravel()[:total]
    res, off = [], 0
    for a in arrays:
        n = int(np.asarray(a).size)
        res.append(summed[off:off + n].reshape(np.shape(a)))
        off += n
    return res


def _psum_host(arrays, guard=None, device=None):
    """Each array summed across the processes, the same on every process
    (host numpy arrays; tensors and arrays in, the identity with one
    process).  ``guard``: see :class:`_PassGuard`.  With the ring armed
    the f32 payloads reduce through one packed ring on ``device`` after
    the host gather of the flag and the rest."""
    arrays = _materialize(arrays, guard)
    if _world() == 1:
        if guard is not None and guard.err is not None:
            raise guard.err
        return arrays
    f32 = [i for i, a in enumerate(arrays) if a.dtype == np.float32]
    if not _ring_armed() or not f32:
        return [g.sum(axis=0) for g in _gather_with_guard(arrays, guard)]
    rest = [i for i in range(len(arrays)) if i not in f32]
    gathered = (_gather_with_guard([arrays[i] for i in rest], guard)
                if rest or guard is not None else [])
    ringed = _ring_reduce_f32([arrays[i] for i in f32],
                              torch.device("cpu") if device is None else device)
    out = [None] * len(arrays)
    for j, i in enumerate(f32):
        out[i] = ringed[j]
    for j, i in enumerate(rest):
        out[i] = gathered[j].sum(axis=0)
    return out


def _allgather_host(arrays, guard=None):
    """Each array gathered across the processes along a new leading
    (process) axis; the axis is added with one process too."""
    arrays = _materialize(arrays, guard)
    gathered = _gather_with_guard(arrays, guard)
    return [a[None] for a in arrays] if gathered is None else gathered


def _fleet_pass(phase: str, stats: PrefetchStats, pass_wall_s: float, timings=None) -> None:
    """The fleet rollup of one finished pass: when the rollups are armed
    (a pure function of the config and the world's size, so every process
    agrees), gather every process's frame, fold it into the fit's window
    and hand the same frames to the straggler controller.  The gather's
    seconds land in ``timings`` under ``fleet``."""
    if not fleet.armed(_world()):
        return
    elapsed = tick()
    (gathered,) = _allgather_host([fleet.local_frame(stats, pass_wall_s)])
    fleet.fold_pass(phase, gathered)
    balance.observe_pass(phase, gathered)
    if timings is not None:
        timings.add("fleet", elapsed())


def capability_sync(frame: np.ndarray) -> np.ndarray:
    """The capability balancer's gather: every process's ``[capability,
    origin, card budget, host budget, hardware class, devices]`` frame,
    ``(world, 6)`` float64, the same on every process."""
    (gathered,) = _allgather_host([np.asarray(frame, np.float64)])
    return gathered


def begin_fit(source: ChunkSource) -> None:
    """At a streamed fit's start: the plan of a balanced view
    (parallel/balance.BalancedView) becomes the controller's live plan,
    any other source leaves none live, and the controller's and the
    rollups' per-fit state start empty."""
    balance.reset_fit()
    fleet.reset_fit()
    if isinstance(source, balance.BalancedView):
        balance.activate(source.plan)
    else:
        balance.deactivate()


def abort_fit() -> None:
    """After a failed streamed attempt: no plan live and the controller's
    and the rollups' per-fit state empty, so a retry, or the next fit,
    starts clean."""
    balance.reset_fit()
    fleet.reset_fit()
    balance.deactivate()


def end_fit(summary) -> None:
    """At a streamed fit's end: the ``fleet`` block when the rollups are
    armed and the ``balance`` block when a plan is live, into
    ``summary``."""
    fleet.finalize_fit(summary, _world())
    balance.finalize_fit(summary)


def _checked_entry(validate) -> None:
    """Run an entry check under a guard and agree on its outcome across
    the processes (one scalar gather), so a process whose check fails
    does not leave its peers waiting in the first pass."""
    guard = _PassGuard()
    with guard:
        validate()
    _psum_host([np.zeros((), np.int64)], guard=guard)


def _reduce_pass(tensors, guard, dev):
    """A pass's device accumulators reduced across the processes and
    back on ``dev`` (the identity with one process, the guard's error
    raised)."""
    if _world() == 1:
        if guard.err is not None:
            raise guard.err
        return tensors
    return [torch.as_tensor(a).to(dev) for a in _psum_host(tensors, guard, dev)]


# -- K-Means ----------------------------------------------------------------------


def streamed_accumulate(source: ChunkSource, centers: torch.Tensor, precision: str,
                        need_cost: bool, weights=None, timings=None,
                        phase: str = "lloyd_loop", policy: str = "f32"):
    """One assignment pass: ``(sums (k, d), counts (k,), cost)`` on the
    centers' device, K1 launched on every chunk (``cost`` None in loop
    mode).  The split lands in ``timings`` under ``phase``."""
    k, d = centers.shape
    dev = centers.device
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((k,), dtype=torch.float32, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev) if need_cost else None
    stats = PrefetchStats()
    elapsed = tick()
    guard = _PassGuard()
    with guard:
        faults.maybe_fault("fit.execute")
        with _staged_chunks(source, weights, dev, stats, psn.staging_dtype(policy)) as pf:
            for _, (x, w) in pf:
                s, c, t = kmeans_kernel.lloyd_accumulate(_f32(x), w, centers, precision,
                                                         need_cost)
                sums += s
                counts += c
                if need_cost:
                    cost += t
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    pass_wall = elapsed()
    stats.finalize(timings, phase, pass_wall)
    if cost is None:
        sums, counts = _reduce_pass([sums, counts], guard, dev)
    else:
        sums, counts, cost = _reduce_pass([sums, counts, cost], guard, dev)
    _fleet_pass(phase, stats, pass_wall, timings)
    return sums, counts, cost


def lloyd_run_streamed(source: ChunkSource, init_centers, max_iter: int, tol: float,
                       precision: str = "highest", weights=None, validated: bool = False,
                       timings=None, policy: str = "f32", device=None, checkpoint=None,
                       resume=None):
    """The streamed Lloyd loop: ``(centers, n_iter, cost, counts)``, as
    ``kmeans_kernel.lloyd_run_kernel`` returns them, on ``device``
    (None: the device of ``init_centers`` if a tensor, else
    ``Config.device``).  Stops when every center moved at most ``tol``
    (squared moves against ``tol ** 2`` in f64, the JAX streamed loop's
    test) or at ``max_iter``; empty clusters keep their center.  ``weights`` is an
    optional width-1 source walked in lockstep; ``validated`` skips its
    check when the caller ran it.

    ``resume`` (utils/checkpoint.RestoreResult) re-enters the loop at
    its recorded pass, the caller having passed its centers as
    ``init_centers``; ``checkpoint`` writes the centers, the pass and the
    converged flag every ``checkpoint_interval`` passes (and at
    convergence).  The pass arithmetic is unchanged, so a resume in the
    same world is bit-equal to the uninterrupted fit."""
    if weights is not None and not validated:
        _checked_entry(lambda: _check_weight_source(source, weights))
    if device is None and isinstance(init_centers, torch.Tensor):
        device = init_centers.device
    else:
        device = resolve_device(device)
    centers = torch.as_tensor(np.asarray(init_centers, np.float32)
                              if not isinstance(init_centers, torch.Tensor) else init_centers,
                              dtype=torch.float32).to(device).contiguous()
    tol_sq = float(tol) ** 2
    n_iter = 0
    converged = False
    if resume is not None and resume.found:
        n_iter = min(int(resume.step), max_iter)
        converged = bool(resume.extra.get("converged", False))
    while n_iter < max_iter and not converged:
        sums, counts, _ = streamed_accumulate(source, centers, precision, False, weights,
                                              timings, policy=policy)
        new_centers = kmeans_ops._new_centers(sums, counts, centers)
        max_moved = float(torch.max(kmeans_ops._moved_sq(new_centers, centers)))
        centers = new_centers.contiguous()
        n_iter += 1
        # a NaN or Inf centroid poisons every later pass: stop at the
        # pass that made it (Config.nonfinite_policy)
        check_finite(centers, f"K-Means centroids (streamed pass {n_iter})")
        converged = max_moved <= tol_sq
        if checkpoint is not None:
            checkpoint.maybe_write(n_iter, {"centers": centers}, extra={"converged": converged},
                                   force=converged)
    # the cost pass stages f32 and ranks at highest whatever the policy:
    # the reported objective must not carry a reduced tier's rounding
    _, counts, cost = streamed_accumulate(source, centers, "highest", True, weights, timings,
                                          policy="f32")
    return centers, n_iter, cost, counts


# -- K-Means init ------------------------------------------------------------------


def reservoir_sample(source: ChunkSource, k: int, seed: int, timings=None) -> np.ndarray:
    """A uniform sample of k rows in one pass (Algorithm R, one generator
    draw per chunk, a Python loop only over the reservoir's hits), with
    the JAX package's numpy draws.  The pass is prefetched without a
    device: file reads overlap the host updates."""
    rng = np.random.default_rng(seed)
    sample: List[np.ndarray] = []
    seen = 0
    stats = PrefetchStats()
    elapsed = tick()
    guard = _PassGuard()
    with guard, Prefetcher(source, stats=stats) as pf:
        for chunk, n_valid in pf:
            start = 0
            if len(sample) < k:
                take = min(k - len(sample), n_valid)
                sample.extend(chunk[i].copy() for i in range(take))
                start = take
            if start < n_valid:
                # the row at global index g replaces slot j ~ U[0, g] if j < k
                highs = np.arange(seen + start + 1, seen + n_valid + 1)
                j = rng.integers(0, highs)
                for i in np.nonzero(j < k)[0]:
                    sample[j[i]] = chunk[start + i].copy()
            seen += n_valid
    stats.finalize(timings, "init_centers", elapsed())
    if guard.err is not None and _world() == 1:
        raise guard.err
    if _world() > 1:
        sample, seen = _merge_reservoirs(sample, seen, k, source.n_features, seed, guard)
    if not sample:
        raise ValueError("empty source")
    while len(sample) < k:  # fewer rows than clusters: duplicate
        sample.append(sample[len(sample) % max(1, seen)])
    return np.stack(sample)


def _merge_reservoirs(sample, seen: int, k: int, d: int, seed: int, guard):
    """The processes' reservoirs merged into one sample of k rows, the
    same on every process: weighted sampling without replacement
    (Efraimidis-Spirakis keys, each reservoir row standing for
    seen_p / |reservoir_p| rows), from one stream shared by every
    process, as the JAX package merges them."""
    local = np.zeros((k, d))
    if sample:
        local[:len(sample)] = np.stack(sample)
    rows_g, nv_g, seen_g = _allgather_host(
        [local, np.asarray([len(sample)], np.int64), np.asarray([seen], np.int64)],
        guard=guard)
    rows = rows_g.reshape(-1, d)  # (processes * k, d), process-major
    nv = nv_g.ravel()
    weights = np.zeros(len(rows))
    for p in range(len(nv)):
        if nv[p]:
            weights[p * k:p * k + nv[p]] = seen_g.ravel()[p] / nv[p]
    valid = weights > 0
    if not valid.any():
        raise ValueError("empty source (all processes)")
    merge_rng = np.random.default_rng(seed + 1000003)
    keys = np.where(valid, merge_rng.random(len(rows)) ** (1.0 / np.maximum(weights, 1e-300)),
                    -1.0)
    top = np.argsort(-keys, kind="stable")[:min(k, int(valid.sum()))]
    return [rows[t] for t in top], int(seen_g.sum())


def _chunk_min_d2(x: torch.Tensor, dmin: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """The chunk's running min distance with the candidates folded in."""
    return torch.minimum(dmin, torch.min(kmeans_ops.pairwise_sq_dists(x, cands), dim=1).values)


def _chunk_ownership(x: torch.Tensor, w: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """(n_cand,) row weight each candidate owns in the chunk."""
    owner = torch.argmin(kmeans_ops.pairwise_sq_dists(x, cands), dim=1)
    return torch.zeros((cands.shape[0],), dtype=w.dtype, device=w.device).index_add_(0, owner, w)


def init_kmeans_parallel_streamed(source: ChunkSource, k: int, seed: int, init_steps: int,
                                  weights=None, validated: bool = False, timings=None,
                                  policy: str = "f32", device=None) -> np.ndarray:
    """Streamed k-means|| (Bahmani), host-driven, the JAX package's
    algorithm and draws: the per-row min distance lives on the host (one
    f32 a row); each pass folds the previous round's picks into it on
    the device and samples this round's with the previous pass's phi
    (one round stale); then an ownership pass weighs the candidates and
    a weighted k-means++ on the host picks k.  ``weights`` scales the
    sampling cost and the ownership.  ``device`` None is
    ``Config.device``."""
    if weights is not None and not validated:
        _checked_entry(lambda: _check_weight_source(source, weights))
    dev = resolve_device(device)
    l = 2.0 * k
    d = source.n_features
    cap = 4 * k  # a process's picks a round gathered across processes
    stage_dtype = psn.staging_dtype(policy)
    # the sampling stream of this process's rows (seed + 31 x its process
    # index, as in the JAX package) and the final k-means++ stream, the
    # same on every process
    samp_rng = np.random.default_rng(seed + 31 * bootstrap.process_index())
    final_rng = np.random.default_rng(seed + 7777)

    c0 = reservoir_sample(source, 1, seed, timings=timings)
    cands = [c0[0]]
    new_block = c0
    dmin_chunks: List[np.ndarray] = []
    phi = 0.0
    for rnd in range(init_steps + 1):
        sampling = rnd > 0
        if sampling and phi <= 0.0:
            break
        cands_dev = (torch.as_tensor(np.asarray(new_block, np.float32), device=dev)
                     if len(new_block) else None)
        picks: List[np.ndarray] = []
        new_phi = 0.0
        stats = PrefetchStats()
        elapsed = tick()
        guard = _PassGuard()
        with guard, _staged_chunks(source, weights, dev, stats, stage_dtype) as pf:
            for ci, ((chunk, n_valid, wv), (x, _)) in enumerate(pf):
                if cands_dev is not None:
                    prev = (torch.as_tensor(dmin_chunks[ci], device=dev) if rnd > 0
                            else torch.full((source.chunk_rows,), torch.inf, device=dev))
                    h = _chunk_min_d2(_f32(x), prev, cands_dev).cpu().numpy()
                    h[n_valid:] = 0.0  # padded rows carry no cost
                    if rnd > 0:
                        dmin_chunks[ci] = h
                    else:
                        dmin_chunks.append(h)
                else:
                    h = dmin_chunks[ci]
                hw = h * wv
                new_phi += float(hw.sum())
                if sampling:
                    prob = np.minimum(l * hw / max(phi, 1e-300), 1.0)
                    hit = samp_rng.random(source.chunk_rows) < prob
                    hit[n_valid:] = False
                    for i in np.nonzero(hit)[0]:
                        picks.append(chunk[i].copy())
        stats.finalize(timings, "init_centers", elapsed())
        (phi_arr,) = _psum_host([np.asarray([new_phi])], guard=guard)
        phi = float(phi_arr[0])
        if _world() > 1:
            # each process's picks, fixed-shape and process-major, so
            # every process extends the candidates alike; picks past cap
            # drop, like the in-memory slots
            local = np.zeros((cap, d))
            n_local = min(len(picks), cap)
            if n_local:
                local[:n_local] = np.stack(picks[:n_local])
            rows_g, cnt_g = _allgather_host([local, np.asarray([n_local], np.int64)])
            picks = [rows_g[p, i] for p in range(rows_g.shape[0])
                     for i in range(int(cnt_g.ravel()[p]))]
        cands.extend(picks)
        new_block = np.stack(picks) if picks else np.zeros((0, d))

    cand_arr = np.stack(cands)
    if cand_arr.shape[0] <= k:
        extra = reservoir_sample(source, k - cand_arr.shape[0] + 1, seed + 1, timings=timings)
        return np.concatenate([cand_arr, extra], axis=0)[:k]
    cands_dev = torch.as_tensor(cand_arr.astype(np.float32), device=dev)
    own = np.zeros((cand_arr.shape[0],), np.float64)
    stats = PrefetchStats()
    elapsed = tick()
    guard = _PassGuard()
    with guard, _staged_chunks(source, weights, dev, stats, stage_dtype) as pf:
        for _, (x, w) in pf:
            own += _chunk_ownership(_f32(x), w, cands_dev).cpu().numpy()
    stats.finalize(timings, "init_centers", elapsed())
    (own,) = _psum_host([own], guard=guard)
    return kmeans_ops._weighted_kmeans_pp(cand_arr, own, k, final_rng)


# -- PCA ---------------------------------------------------------------------------


def _kahan_add(total: torch.Tensor, comp: torch.Tensor, value: torch.Tensor) -> None:
    """``total += value`` with the Neumaier/Kahan compensation ``comp``
    carrying the bits each f32 add drops (in place)."""
    y = value - comp
    t = total + y
    comp.copy_((t - total) - y)
    total.copy_(t)


def _colsum_pass(source: ChunkSource, precision: str, timings, dev, stage_dtype,
                 compensated: bool):
    """The streamed covariance's first pass: the column sums and the row
    count, reduced across the processes."""
    d = source.n_features
    total = torch.zeros((d,), dtype=torch.float32, device=dev)
    comp = torch.zeros_like(total)
    n = 0
    stats = PrefetchStats()
    elapsed = tick()
    guard = _PassGuard()
    with guard:
        faults.maybe_fault("fit.execute")
        with _staged_chunks(source, None, dev, stats, stage_dtype) as pf:
            for (_, n_valid, _), (x, w) in pf:
                _, s, _ = pca_kernel.pca_moments(_f32(x), w, None, precision, need_gram=False)
                if compensated:
                    _kahan_add(total, comp, s)
                else:
                    total += s
                n += n_valid
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    pass_wall = elapsed()
    stats.finalize(timings, "covariance_streamed", pass_wall)
    if _world() > 1:
        total, n_arr = _psum_host([total, np.asarray([n], np.int64)], guard, dev)
        total, n = torch.as_tensor(total).to(dev), int(n_arr[0])
    elif guard.err is not None:
        raise guard.err
    _fleet_pass("covariance_streamed", stats, pass_wall, timings)
    # an overflowed f32 sum or Gram turns into NaN eigenvectors later:
    # stop at the pass that made it (Config.nonfinite_policy)
    check_finite(total, "PCA column sums (streamed mean pass)")
    return total, n


def covariance_streamed(source: ChunkSource, precision: str = "highest", timings=None,
                        policy: str = "f32", device=None, checkpoint=None):
    """Two-pass streamed covariance: ``(cov (d, d), mean (d,), n_rows)``
    on ``device`` (None: ``Config.device``).  Pass 1 sums the columns
    (the mean), pass 2 the centred Gram at ``precision``, K2 on every
    chunk of each; the two-pass form of ``pca_ops.covariance``.  Under
    the ``bf16`` policy the chunks stage at bfloat16 and both
    cross-chunk sums are Kahan-compensated; f32 adds plainly, in chunk
    order.

    ``checkpoint`` (utils/checkpoint.py): after the column-sum pass the
    reduced sums and the row count are written (step 1), and a fit that
    restores them starts at the Gram pass.  They are the same on every
    process, so the restore fits any world."""
    dev = resolve_device(device)
    d = source.n_features
    stage_dtype = psn.staging_dtype(policy)
    compensated = policy == "bf16"
    resume = checkpoint.restore() if checkpoint is not None else None
    if resume is not None and resume.found and resume.extra.get("stage") == "colsum":
        total = torch.as_tensor(np.asarray(resume.arrays["colsum"], np.float32)).to(dev)
        n = int(resume.extra["n_rows"])
    else:
        total, n = _colsum_pass(source, precision, timings, dev, stage_dtype, compensated)
        if checkpoint is not None:
            checkpoint.maybe_write(1, {"colsum": total}, extra={"stage": "colsum", "n_rows": n},
                                   force=True)
    if n < 1:
        raise ValueError("empty source")
    mean = total / n
    gram = torch.zeros((d, d), dtype=torch.float32, device=dev)
    gcomp = torch.zeros_like(gram)
    stats = PrefetchStats()
    elapsed = tick()
    guard = _PassGuard()
    with guard:
        faults.maybe_fault("fit.execute")
        with _staged_chunks(source, None, dev, stats, stage_dtype) as pf:
            for _, (x, w) in pf:
                g, _, _ = pca_kernel.pca_moments(_f32(x), w, mean, precision, need_sums=False)
                if compensated:
                    _kahan_add(gram, gcomp, g)
                else:
                    gram += g
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    pass_wall = elapsed()
    stats.finalize(timings, "covariance_streamed", pass_wall)
    (gram,) = _reduce_pass([gram], guard, dev)
    _fleet_pass("covariance_streamed", stats, pass_wall, timings)
    check_finite(gram, "PCA Gram accumulator (streamed Gram pass)")
    cov = gram / max(n - 1.0, 1.0)
    return 0.5 * (cov + cov.T), mean, n
