"""K-Means in plain PyTorch: distances, the plain Lloyd route, the loop
skeleton, the data-parallel and model-sharded Lloyd on a mesh and
initialisation.  The port of the JAX package's ``ops/kmeans_ops.py``.

Eager code: the Lloyd loop is a Python loop that reads the convergence
flag once per iteration, where the JAX package ran a ``lax.while_loop``
inside one jitted program.  The hot loop of a fit runs the Hopper kernel
(ops/cuda/kmeans_kernel.lloyd_run_kernel); :func:`lloyd_run` here is the
plain route of the JAX package's XLA Lloyd, kept as a reference.

Initialisation: ``init_random`` and the host side of k-means|| draw from
``np.random.default_rng(seed)`` exactly as the JAX package does, so a
random-init fit starts from the same centers in both packages.  The
k-means|| sampling rounds draw from a ``torch.Generator`` seeded from
``seed`` where the JAX package used ``jax.random``: the draws differ.

Across processes (parallel/bootstrap.py) the init runs on this
process's part of a table that spans the world
(data/table.DenseTable.from_process_local): every sampling draw is a
function of (seed, round, global valid row) alone, one stream of
``torch.rand`` over the world's valid rows of which each process keeps
its slice, so a fit draws the same rows however the table is split; the
first center, phi, the picks' prefix positions, the picked rows and the
candidates' weights cross through ``collective.process_allgather``, and
every process ends each round with the same candidates.  The Lloyd
loops on a mesh whose ranks span processes run each process's ranks,
the psums and the ring reaching the other processes'.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.data.table import DenseTable
from oap_mllib_tpu_torch.ops.cuda import ring_kernel
from oap_mllib_tpu_torch.ops.cuda._tiers import check_mode, tiered_dot
from oap_mllib_tpu_torch.parallel import collective
from oap_mllib_tpu_torch.parallel.mesh import Mesh, Rank
from oap_mllib_tpu_torch.utils import faults
from oap_mllib_tpu_torch.utils import precision as psn

# live-buffer element budget of every row-chunking site (training
# accumulate, predict/cost scoring): 32M f32 = 128 MB
SCORE_BUDGET_ELEMS = 1 << 25


def rows_per_chunk(*widths: int, budget: int = SCORE_BUDGET_ELEMS) -> int:
    """Rows per chunk such that the SUM of live (rows, width) buffers
    stays within ``budget`` elements."""
    return max(1, budget // max(1, sum(widths)))


def auto_row_chunks(n: int, k: int, budget_elems: int = SCORE_BUDGET_ELEMS) -> int:
    """Chunk count (a power of two) keeping the live (chunk, k) distance
    buffer under ``budget_elems``; :func:`lloyd_run` pads the rows."""
    chunks = 1
    while chunks < max(n, 1) and (-(-n // chunks)) * k > budget_elems:
        chunks *= 2
    return chunks


def _assign_prec(precision: str) -> str:
    """The assignment matmul of the "high" tier runs at bf16 (argmin is a
    discrete decision); "highest" stays f32 throughout."""
    return "default" if precision == "high" else precision


def pairwise_sq_dists(x: torch.Tensor, centers: torch.Tensor,
                      precision: str = "highest") -> torch.Tensor:
    """(n, k) squared euclidean distances via ``|x|^2 + |c|^2 - 2 x.c``."""
    x_sq = torch.sum(x * x, dim=1, keepdim=True)
    c_sq = torch.sum(centers * centers, dim=1)
    cross = tiered_dot(x, centers.T, precision)
    return torch.clamp_min(x_sq + c_sq[None, :] - 2.0 * cross, 0.0)


def _accumulate(x, weights, centers, precision: str = "highest",
                need_cost: bool = True):
    """One assignment pass: ``(sums (k, d), counts (k,), cost)``.  Loop
    mode (``need_cost=False``) ranks on the half-score
    ``|c|^2 / 2 - x.c`` and returns a zero cost."""
    precision = check_mode(precision)
    k = centers.shape[0]
    if need_cost:
        d2 = pairwise_sq_dists(x, centers, _assign_prec(precision))
        assign = torch.argmin(d2, dim=1)
        min_d2 = d2.gather(1, assign[:, None])[:, 0]
        cost = torch.sum(min_d2 * weights)
    else:
        c_sq = torch.sum(centers * centers, dim=1)
        cross = tiered_dot(x, centers.T, _assign_prec(precision))
        assign = torch.argmin(0.5 * c_sq[None, :] - cross, dim=1)
        cost = torch.zeros((), dtype=weights.dtype, device=weights.device)
    one_hot = (
        torch.nn.functional.one_hot(assign, k).to(weights.dtype)
        * weights[:, None]
    )
    sums = tiered_dot(one_hot.T, x, precision)
    counts = torch.sum(one_hot, dim=0)
    return sums, counts, cost


def _accumulate_chunked(x, weights, centers, row_chunks: int,
                        precision: str = "highest", need_cost: bool = True):
    """:func:`_accumulate` over ``row_chunks`` equal row chunks, summed in
    chunk order, so the (rows, k) buffers stay bounded."""
    n = x.shape[0]
    if n % row_chunks != 0:
        raise ValueError(f"rows {n} not divisible by row_chunks={row_chunks}")
    cs = n // row_chunks
    sums = counts = cost = None
    for lo in range(0, n, cs):
        s, c, t = _accumulate(
            x[lo:lo + cs], weights[lo:lo + cs], centers, precision, need_cost
        )
        if sums is None:
            sums, counts, cost = s, c, t
        else:
            sums, counts, cost = sums + s, counts + c, cost + t
    return sums, counts, cost


def _each(fn, *args):
    """``fn`` over per-rank values: rank by rank for ``{rank: tensor}``
    dictionaries, once for tensors."""
    if isinstance(args[0], dict):
        return {r: fn(*(a[r] for a in args)) for r in args[0]}
    return fn(*args)


def _new_centers(sums, counts, centers):
    cc = counts[:, None]
    return torch.where(cc > 0, sums / torch.clamp_min(cc, 1e-30), centers)


def _moved_sq(new_centers, centers):
    return torch.sum((new_centers - centers) ** 2, dim=1)


def _lloyd_loop(accum: Callable, moved_reduce: Callable, init_centers,
                max_iter: int, tol: float):
    """Lloyd loop skeleton shared by the kernel route, the plain route and
    the model-sharded route.

    Stop when every center's squared move is <= tol^2 (f32), or at
    ``max_iter``.  Empty clusters keep their previous center.
    ``accum(centers, final)`` returns ``(sums, counts, cost)``: loop passes
    have ``final=False``; one pass with ``final=True`` after the loop
    computes cost and counts against the returned centers at full
    precision.  Every pass is the ``fit.execute`` fault site
    (utils/faults.py) before ``accum`` launches anything.  ``moved_reduce`` completes the per-center move (the
    identity, or a psum over the model axis for feature-sharded centers).
    Centers, sums and counts are tensors, or ``{rank: tensor}`` on a mesh,
    where every rank updates its own block.  Returns
    ``(centers, n_iter, cost, counts)``."""
    centers = init_centers
    tol_sq = float(np.float32(tol) * np.float32(tol))
    n_iter = 0
    while n_iter < max_iter:
        faults.maybe_fault("fit.execute")
        sums, counts, _ = accum(centers, False)
        new_centers = _each(_new_centers, sums, counts, centers)
        moved_sq = moved_reduce(_each(_moved_sq, new_centers, centers))
        centers = new_centers
        n_iter += 1
        # the loop's one host read per iteration (per rank on a mesh,
        # where every rank holds the same flag)
        moves = moved_sq.values() if isinstance(moved_sq, dict) else [moved_sq]
        if all(bool(torch.all(m <= tol_sq)) for m in moves):
            break
    faults.maybe_fault("fit.execute")
    _, counts, cost = accum(centers, True)
    return centers, n_iter, cost, counts


def lloyd_run(x, weights, init_centers, max_iter: int, tol: float,
              row_chunks: int = 1, precision: str = "highest"
              ) -> Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """The plain Lloyd route: ``(centers, n_iter, cost, counts)``.  Rows
    that do not divide ``row_chunks`` are padded with weight-0 rows."""
    precision = check_mode(precision)
    pad = (-x.shape[0]) % row_chunks
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        weights = torch.cat([weights, weights.new_zeros((pad,))])

    def accum(centers, final):
        p = "highest" if final else precision
        if row_chunks > 1:
            return _accumulate_chunked(x, weights, centers, row_chunks, p, final)
        return _accumulate(x, weights, centers, p, final)

    return _lloyd_loop(accum, lambda m: m, init_centers, max_iter, tol)


def ring_mode_cfg(cfg=None) -> str:
    """Validated ``Config.ring_reduction``; every K-Means fit on a mesh
    reads it, so a typo raises whether or not the ring would run."""
    from oap_mllib_tpu_torch.config import get_config

    mode = (cfg or get_config()).ring_reduction
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"ring_reduction must be auto|on|off, got {mode!r}")
    return mode


def ring_enabled(mesh: Mesh, data_axis: str, dtype=torch.float32, cfg=None) -> bool:
    """Whether the moments reduce with the ring: "auto" and "on" run it
    when the data axis has two ranks or more and the table is f32 (the
    ring packs f32); below that, or with "off", three psums."""
    return (ring_mode_cfg(cfg) != "off" and mesh.shape[data_axis] >= 2
            and dtype == torch.float32)


def _sharded_accumulate(x, w, c, mesh: Mesh, dax: str, max_: str, final: bool,
                        precision: str, policy: str, ring: bool,
                        ring_segments: int):
    """One pass of the model-sharded Lloyd over per-rank tiles ``x``
    (n_loc, d_loc), weights ``w`` (n_loc,) and center blocks ``c``
    (k, d_loc): ``(sums, counts, cost)`` per rank, reduced over the data
    axis.  Loop passes (``final`` False) rank on the half score at the
    fit's precision; the final pass ranks on d2 at ``highest``."""
    aprec, sprec, pol = (("highest", "highest", "f32") if final
                         else (_assign_prec(precision), precision, policy))
    part = {}
    for r in mesh.local_ranks:
        c_sq = torch.sum(c[r] * c[r], dim=1)
        cross = psn.pdot(x[r], c[r].T, pol, aprec)
        if final:
            x_sq = torch.sum(x[r] * x[r], dim=1, keepdim=True)
            part[r] = x_sq + c_sq[None, :] - 2.0 * cross
        else:
            part[r] = 0.5 * c_sq[None, :] - cross
        del cross
    # one psum over the model axis carries every feature block's share
    score = collective.psum(part, mesh, max_)
    del part
    sums, counts, cost = {}, {}, {}
    for r in mesh.local_ranks:
        k = c[r].shape[0]
        if final:
            d2 = torch.clamp_min(score[r], 0.0)
            assign = torch.argmin(d2, dim=1)
            cost[r] = torch.sum(d2.gather(1, assign[:, None])[:, 0] * w[r])
            del d2
        else:
            assign = torch.argmin(score[r], dim=1)
            cost[r] = torch.zeros((), dtype=w[r].dtype, device=w[r].device)
        # one_hot(assign) * w, made in place: w where the row's label is
        one_hot = torch.zeros((x[r].shape[0], k), dtype=w[r].dtype, device=w[r].device)
        one_hot.scatter_(1, assign[:, None], w[r][:, None])
        sums[r] = psn.pdot(one_hot.T, x[r], pol, sprec)  # (k, d_loc)
        counts[r] = torch.sum(one_hot, dim=0)
        del one_hot
    del score
    if not ring:
        sums = collective.psum(sums, mesh, dax)
        counts = collective.psum(counts, mesh, dax)
        if final:
            cost = collective.psum(cost, mesh, dax)
        return sums, counts, cost
    # ONE packed ring reduction per model column instead of three psums:
    # columns [0, d_loc) sums, d_loc counts, d_loc + 1 the cost (row 0,
    # zero elsewhere so the sum is exact)
    packed = {}
    for r in mesh.local_ranks:
        extra = torch.zeros((counts[r].shape[0], 2), dtype=torch.float32,
                            device=counts[r].device)
        extra[:, 0] = counts[r]
        if final:
            extra[0, 1] = cost[r]
        packed[r] = torch.cat([sums[r], extra], dim=1)
    # one ring per group of the data axis, across processes when the
    # axis spans them
    for r, red in ring_kernel.ring_allreduce_mesh(packed, mesh, dax, ring_segments).items():
        d_loc = red.shape[1] - 2
        sums[r], counts[r] = red[:, :d_loc], red[:, d_loc]
        if final:
            cost[r] = red[0, d_loc + 1]
    return sums, counts, cost


def lloyd_run_model_sharded(x: Dict[Rank, torch.Tensor], weights: Dict[Rank, torch.Tensor],
                            init_centers, max_iter: int, tol: float, mesh: Mesh,
                            data_axis: str, model_axis: str, precision: str = "highest",
                            policy: str = "f32", ring_segments: int = 1
                            ) -> Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """Lloyd loop with the centers feature-sharded over the model axis:
    ``(centers, n_iter, cost, counts)`` on the mesh's first device, the
    return contract of :func:`lloyd_run`.

    Rank ``(i, j)`` holds the tile ``x[(i, j)]`` (rows of shard ``i``,
    features of shard ``j``; ``d`` a multiple of the model axis, the
    estimator zero-pads), its rows' ``weights[(i, j)]`` and the centers'
    feature block ``j``.  Squared distances add up over feature blocks,
    so the assignment needs one psum of the (n_loc, k) partial scores
    over the model axis; the sums stay feature-local and reduce over
    the data axis: with one ring per model column of the packed
    ``[sums | counts | cost]`` buffer when :func:`ring_enabled`, else
    with three psums.  The per-center move completes with a psum over
    the model axis.  The JAX package's ``_build_lloyd_model_sharded``,
    step for step."""
    precision = check_mode(precision)
    ring = ring_enabled(mesh, data_axis)
    ring_segments = max(1, int(ring_segments)) if ring else 1
    n_model = mesh.shape[model_axis]
    c0 = torch.as_tensor(init_centers, dtype=torch.float32)
    d_loc = c0.shape[1] // n_model
    centers = {(i, j): c0[:, j * d_loc:(j + 1) * d_loc].to(mesh.device((i, j))).contiguous()
               for i, j in mesh.local_ranks}

    def accum(c, final):
        return _sharded_accumulate(x, weights, c, mesh, data_axis, model_axis, final,
                                   precision, policy, ring, ring_segments)

    centers, n_iter, cost, counts = _lloyd_loop(
        accum, lambda m: collective.psum(m, mesh, model_axis), centers, max_iter, tol)
    # this process's first row of ranks holds every feature block
    row = mesh.local_ranks[0][0]
    first = mesh.device((row, 0))
    full = torch.cat([centers[(row, j)].to(first) for j in range(n_model)], dim=1)
    return full, n_iter, cost[(row, 0)], counts[(row, 0)]


def lloyd_run_data_parallel(x: Dict[Rank, torch.Tensor], weights: Dict[Rank, torch.Tensor],
                            init_centers, max_iter: int, tol: float, mesh: Mesh,
                            data_axis: str, mode: str = "highest",
                            accumulate: Callable = None
                            ) -> Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """Lloyd loop with the rows sharded over the data axis and the centers
    replicated: ``(centers, n_iter, cost, counts)`` on the first rank's
    device, the return contract of :func:`lloyd_run`.

    Rank ``(i, 0)`` of a mesh whose model axis is 1 holds the row tile
    ``x[(i, 0)]`` and its weights.  Each pass runs the fused kernel
    (``accumulate``, default ``kmeans_kernel.lloyd_accumulate``) on every
    rank's tile, then sums, counts and, in the final pass, the cost are
    psum-ed over the data axis in rank order: the JAX package's GSPMD
    ``lloyd_run`` on a data-parallel mesh, whose psum is XLA's and not the
    ring.  The center update and the tolerance test are
    :func:`_lloyd_loop`'s, on every rank's copy of the centers."""
    from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel

    accumulate = accumulate or kmeans_kernel.lloyd_accumulate
    mode = check_mode(mode)
    if mesh.shape[mesh.axis_names[1]] != 1:
        raise ValueError(f"the data-parallel Lloyd runs on a model axis of 1, got {mesh.shape}")
    c0 = torch.as_tensor(init_centers, dtype=torch.float32)
    centers = {r: c0.to(mesh.device(r)).contiguous() for r in mesh.local_ranks}

    def accum(c, final):
        part = {r: accumulate(x[r], weights[r], c[r], "highest" if final else mode, final)
                for r in mesh.local_ranks}
        moments = [{r: p[j] for r, p in part.items()} for j in range(3 if final else 2)]
        reduced = collective.psum_many(moments, mesh, data_axis)
        return reduced[0], reduced[1], reduced[2] if final else None

    centers, n_iter, cost, counts = _lloyd_loop(accum, lambda m: m, centers, max_iter, tol)
    first = mesh.local_ranks[0]
    return centers[first], n_iter, cost[first], counts[first]


def total_cost(x, weights, centers) -> torch.Tensor:
    return _accumulate(x, weights, centers)[2]


def min_sq_dists(x, centers) -> torch.Tensor:
    return torch.min(pairwise_sq_dists(x, centers), dim=1).values


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _gather_rows(x, idx: np.ndarray) -> np.ndarray:
    """Rows ``x[idx]`` on the host, for a tensor, an ndarray or a table
    (its padded-layout rows, gathered from their processes)."""
    if isinstance(x, DenseTable):
        return x.gather_rows(idx)
    if isinstance(x, torch.Tensor):
        sel = torch.as_tensor(np.asarray(idx, np.int64), device=x.device)
        return x[sel].cpu().numpy()
    return np.asarray(x[idx])


def init_random(x, n_valid: int, k: int, seed: int, index_map=None) -> np.ndarray:
    """Sample k distinct valid rows uniformly (numpy-seeded, so the same
    rows as the JAX package's ``init_random`` for the same seed).  ``x``
    may be a table spanning processes (a collective: every process
    draws the same rows and gets them from their owners)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(n_valid, size=min(k, n_valid), replace=False)
    if len(idx) < k:  # fewer points than clusters: duplicate (degenerate case)
        idx = np.resize(idx, k)
    if index_map is not None:
        idx = index_map(idx)
    return _gather_rows(x, idx)


def _slot_chunk_size(cap: int, target: int = 1024) -> int:
    """Largest divisor of ``cap`` that is <= target."""
    if cap <= target:
        return max(cap, 1)
    best = 1
    d = 1
    while d * d <= cap:
        if cap % d == 0:
            if best < d <= target:
                best = d
            q = cap // d
            if best < q <= target:
                best = q
        d += 1
    return best


def _world_sum_f32(value: torch.Tensor, cross: bool) -> torch.Tensor:
    """A scalar summed over the processes in process order, in f32 (the
    same bits on every process); itself in one process."""
    if not cross:
        return value
    (vals,) = collective.process_allgather([value.reshape(1)])
    acc = np.float32(0.0)
    for v in vals[:, 0]:
        acc = np.float32(acc + v)
    return torch.tensor(float(acc), dtype=value.dtype, device=value.device)


def _pll_round(x, w, dmin, amin, base_id: int, draws, l: float,
               cap: int, chunk: int, cross: bool = False):
    """One k-means|| sampling round: sample each row with probability
    ``min(l * cost / phi, 1)`` (``draws`` its uniforms), place the picked
    rows into ``cap`` slots by their picked-prefix position (overflow
    dropped), then fold the new slots into the running (min distance,
    nearest candidate) state, slot chunk by slot chunk and row chunk by
    row chunk.  ``cross``: the rows are this process's part of a table
    spanning processes, phi and the prefix positions are the world's and
    the slots are filled by every process.
    Returns ``(slots, slot_valid, dmin, amin, phi)``."""
    n, d = x.shape
    cost = dmin * w
    phi = _world_sum_f32(torch.sum(cost), cross)
    prob = torch.clamp_max(l * cost / torch.clamp_min(phi, 1e-30), 1.0)
    picked = draws < prob
    pos = torch.cumsum(picked.to(torch.int64), dim=0) - 1
    if cross:
        from oap_mllib_tpu_torch.parallel import bootstrap

        (counts,) = collective.process_allgather(
            [np.asarray([int(picked.sum())], np.int64)])
        pos = pos + int(counts[:bootstrap.process_index(), 0].sum())
    keep = picked & (pos < cap)
    slots = x.new_zeros((cap, d))
    slot_valid = x.new_zeros((cap,))
    slots[pos[keep]] = x[keep]
    slot_valid[pos[keep]] = 1.0
    if cross:
        # each slot is filled by one process: take it from that one
        got, valid = collective.process_allgather([slots, slot_valid])
        owner = np.argmax(valid > 0, axis=0)
        slots = torch.from_numpy(got[owner, np.arange(cap)]).to(x.device)
        slot_valid = torch.from_numpy(valid.max(axis=0)).to(x.device)

    rows = rows_per_chunk(chunk, d)
    dmin, amin = dmin.clone(), amin.clone()
    for q0 in range(0, cap, chunk):
        s, v = slots[q0:q0 + chunk], slot_valid[q0:q0 + chunk]
        for lo in range(0, n, rows):
            d2 = pairwise_sq_dists(x[lo:lo + rows], s)
            d2 = torch.where(v[None, :] > 0, d2, torch.inf)
            ca = torch.argmin(d2, dim=1)
            cm = d2.gather(1, ca[:, None])[:, 0]
            ca = ca + (base_id + q0)
            better = cm < dmin[lo:lo + rows]
            dmin[lo:lo + rows] = torch.where(better, cm, dmin[lo:lo + rows])
            amin[lo:lo + rows] = torch.where(better, ca, amin[lo:lo + rows])
    return slots, slot_valid, dmin, amin, phi


def _candidate_weights(w, amin, n_cand: int, cross: bool = False) -> np.ndarray:
    """Total row weight owned by each candidate, summed on the host in
    row order (then over the processes in process order) so that the
    result, and the k-means++ draws it weights, do not depend on the
    order of device atomics."""
    own = np.bincount(
        amin.cpu().numpy(), weights=w.cpu().numpy().astype(np.float64),
        minlength=n_cand,
    )
    if cross:
        (own_all,) = collective.process_allgather([own])
        own = own_all[0].copy()
        for o in own_all[1:]:
            own = own + o
    return own


def _row_draws(generator, n_valid: int, offset: int, n_local: int, n: int, like):
    """One round's uniforms of this process's ``n`` rows: the slice
    ``[offset, offset + n_local)`` of one stream over the world's
    ``n_valid`` rows, 1 (never picked) on the padding rows."""
    draws = torch.rand((n_valid,), generator=generator, dtype=like.dtype, device=like.device)
    out = torch.ones((n,), dtype=like.dtype, device=like.device)
    out[:n_local] = draws[offset:offset + n_local]
    return out


def init_kmeans_parallel(x, weights, n_valid: int, k: int, seed: int,
                         init_steps: int = 2, index_map=None) -> np.ndarray:
    """k-means|| (Bahmani et al.) with oversampling l = 2k, Spark defaults:
    the sampling rounds on the device, then a weighted k-means++ on the
    host over the candidates, each weighted by the row weight it owns.
    ``x`` is a tensor of the ``n_valid`` rows, or a table (this
    process's part of a table spanning the world; a collective)."""
    table = x if isinstance(x, DenseTable) else None
    data = table.data if table is not None else x
    cross = table is not None and table.per_process_valid is not None
    rng = np.random.default_rng(seed)
    n, d = data.shape
    offset = table.row_offset if table is not None else 0
    n_local = table.local_valid if cross else min(n, n_valid)

    first = np.asarray([rng.integers(n_valid)])
    if index_map is not None:
        first = np.asarray(index_map(first))
    c0 = _gather_rows(x, first)  # (1, d)

    l = 2.0 * k
    cap = 4 * k
    chunk = _slot_chunk_size(cap)
    generator = torch.Generator(device=data.device)
    generator.manual_seed(int(seed))

    dmin = pairwise_sq_dists(data, torch.as_tensor(c0, device=data.device))[:, 0]
    amin = torch.zeros((n,), dtype=torch.int64, device=data.device)

    all_slots = [c0]
    all_valid = [np.ones((1,), np.float32)]
    base = 1
    for _ in range(init_steps):
        draws = _row_draws(generator, n_valid, offset, n_local, n, dmin)
        slots, slot_valid, dmin, amin, phi = _pll_round(
            data, weights, dmin, amin, base, draws, l, cap, chunk, cross,
        )
        if float(phi) <= 0.0:
            break
        all_slots.append(slots.cpu().numpy())
        all_valid.append(slot_valid.cpu().numpy())
        base += cap

    cand = np.concatenate(all_slots, axis=0)
    valid = np.concatenate(all_valid, axis=0) > 0
    cand_w = _candidate_weights(weights, amin, base, cross)[: len(cand)]
    cand, cand_w = cand[valid], cand_w[valid]

    if cand.shape[0] <= k:
        # not enough candidates: top up with random rows
        extra = init_random(x, n_valid, k - cand.shape[0] + 1, seed + 1, index_map)
        cand = np.concatenate([cand, extra], axis=0)[: max(k, 1)]
        return (
            cand[:k]
            if cand.shape[0] >= k
            else np.resize(cand, (k, cand.shape[1]))
        )

    return _weighted_kmeans_pp(cand, cand_w, k, rng)


def _weighted_kmeans_pp(points: np.ndarray, weights: np.ndarray, k: int, rng) -> np.ndarray:
    """Host-side weighted k-means++ over the small candidate set."""
    n = points.shape[0]
    total = weights.sum()
    if total <= 0:
        weights = np.ones(n)
        total = float(n)
    centers = [points[rng.choice(n, p=weights / total)]]
    d2 = np.sum((points - centers[0]) ** 2, axis=1)
    for _ in range(1, k):
        p = d2 * weights
        s = p.sum()
        if s <= 0:
            idx = int(rng.integers(n))
        else:
            idx = int(rng.choice(n, p=p / s))
        centers.append(points[idx])
        d2 = np.minimum(d2, np.sum((points - points[idx]) ** 2, axis=1))
    return np.stack(centers)
