"""ALS fold-in: incremental user or item rows against a frozen table (the
port of the JAX package's ``online/foldin.py``).

Holding the item table Y fixed, a user's optimal factor row is the same
regularized normal-equation solve a training half-iteration runs,

    x_u = (Y_u^T C_u Y_u + reg * n_u * I [+ Y^T Y])^{-1} Y_u^T c_u

so a delta of new or changed rows needs ONE batched solve against the
frozen table, not a refit.  The solve is the training half-update's own
code on the COO layout: the moments of ``als_ops.CooSide.partials``
(Spark's weighting, f32 segment sums by destination), the factor Gram
``als_ops._factor_gram`` (K4, implicit feedback only) and
``als_ops.regularized_solve`` (K3 at r <= 32), one launch of each a
batch.  The fold-in takes the COO layout, not the grouped one the fits
prefer, because its edges arrive as a delta of triples: the grouped
layout's host prep (a counting sort into padded groups) would cost more
than the delta's solve.  A folded row is therefore bit-equal to the
port's COO half-update of the same edges against the same frozen
table, and lies within f32 rounding of the grouped half-update, whose
moments sum in float64.

Shapes bucket as in the JAX package: the edges pad to a power of two
>= 256, the destination rows to one >= 64, the padded edges of weight
0 (``valid`` 0) and destination the last padded row, after every real
edge, so they add exact zeros and move no real edge's place.
``Config.online_foldin_batch`` chunks a large delta by destination
rows; the edge chunks keep the whole delta's cut points (every batch
cuts its edges where the one-launch solve does), so a batched fold-in
gives the one-launch rows bit for bit.

The destination axis may GROW: ids past the table extend it, the grown
tail at the deterministic init (fallback/als_np.init_factors_rows, the
user stream at ``seed``, the item stream at ``seed + 1``), so an
unrated new row equals a fit's init.  Rows whose delta holds no
reg-counted rating keep their factors.

Compute-then-swap: every solve lands in a private copy of the table,
and the model's array is replaced only after every batch succeeded; the
``delta.ingest`` (entry) and ``delta.solve`` (before each launch) fault
sites, or any error, leave the model and its served pins as they were.
"""

from __future__ import annotations

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.online import delta
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils import progcache
from oap_mllib_tpu_torch.utils.faults import maybe_fault
from oap_mllib_tpu_torch.utils.timing import tick

EDGE_BUCKET_FLOOR = 256
ROW_BUCKET_FLOOR = 64


def _bucket(n: int, floor: int) -> int:
    """The next power of two >= max(n, floor): the fold-in shape bucket."""
    b = int(floor)
    while b < n:
        b *= 2
    return b


def _resolve_params(model, reg, alpha, implicit, seed):
    """The fit's ``summary["params"]`` for what the caller leaves None.
    ``reg`` has no fallback: folding in under another lambda than the
    table was trained with skews every solved row."""
    params = model.summary.get("params", {}) if isinstance(model.summary, dict) else {}
    if reg is None:
        reg = params.get("reg")
    if reg is None:
        raise ValueError(
            "fold_in needs reg= (the model summary carries no fit "
            "params — pass the base fit's reg_param explicitly)"
        )
    if implicit is None:
        implicit = bool(params.get("implicit", False))
    if alpha is None:
        alpha = float(params.get("alpha", 1.0))
    if seed is None:
        seed = int(params.get("seed", get_config().seed))
    return float(reg), float(alpha), bool(implicit), int(seed)


def _edge_chunk(rank: int) -> int:
    """Edges a COO moment chunk takes (``als_ops.prepare_coo``'s width)."""
    from oap_mllib_tpu_torch.ops import als_ops

    return max(1, als_ops._EDGE_BUDGET_ELEMS // (rank * rank))


def _batch_side(dst, src, conf, cuts, n_dst_pad: int, nnz_pad: int, rank: int, dev):
    """One batch's COO side on ``dev``: its destination-sorted edges (local
    ``dst``), then ``nnz_pad - len(dst)`` padded edges of weight 0 on row
    ``n_dst_pad - 1``; the real edges chunked at ``cuts`` (offsets into
    them), the padding in chunks of the same width."""
    from oap_mllib_tpu_torch.ops import als_ops

    e = len(dst)
    pad = nnz_pad - e
    keys = np.concatenate([dst, np.full(pad, n_dst_pad - 1, np.int64)])
    bounds = [0, *cuts, e] + list(range(e + _edge_chunk(rank), nnz_pad, _edge_chunk(rank)))
    if pad:
        bounds.append(nnz_pad)
    chunks = [(e0, e1, *als_ops._segment_plan(keys, e0, e1, dev))
              for e0, e1 in zip(bounds[:-1], bounds[1:]) if e1 > e0]

    def staged(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    return als_ops.CooSide(
        staged(np.concatenate([src, np.zeros(pad, np.int64)]), torch.int32),
        staged(np.concatenate([conf, np.zeros(pad, np.float32)]), torch.float32),
        staged(np.concatenate([np.ones(e, np.float32), np.zeros(pad, np.float32)]),
               torch.float32),
        int(n_dst_pad), chunks)


def fold_in(model, users, items, ratings, *, side: str = "user",
            reg=None, alpha=None, implicit=None, seed=None) -> dict:
    """Solve a delta of new or changed rows on ``side`` against the frozen
    opposite table and swap them into ``model``: the
    ``ALSModel.fold_in_users`` / ``fold_in_items`` implementation.  The
    triples are the touched rows' FULL current ratings.  Returns
    ``{"side", "rows_solved", "grown", "repinned"}``."""
    from oap_mllib_tpu_torch.fallback import als_np
    from oap_mllib_tpu_torch.ops import als_ops
    from oap_mllib_tpu_torch.serving.registry import pin

    if side not in ("user", "item"):
        raise ValueError(f"side must be user|item, got {side!r}")
    batch_rows = delta.foldin_batch_cfg()
    # before any compute or mutation
    maybe_fault("delta.ingest")
    users = np.asarray(users).reshape(-1)
    items = np.asarray(items).reshape(-1)
    ratings = np.asarray(ratings, np.float32).reshape(-1)
    if not (len(users) == len(items) == len(ratings)):
        raise ValueError(
            f"users/items/ratings lengths differ: {len(users)}/{len(items)}/{len(ratings)}")
    if len(users) == 0:
        raise ValueError("fold_in needs at least one rating")
    reg, alpha, implicit, seed = _resolve_params(model, reg, alpha, implicit, seed)
    r = model.rank
    if side == "user":
        dst, src = users.astype(np.int64), items.astype(np.int64)
        frozen_host, frozen_name = model.item_factors_, "targets:item"
        table = model.user_factors_
        seed_side = seed  # the user table's init stream
    else:
        dst, src = items.astype(np.int64), users.astype(np.int64)
        frozen_host, frozen_name = model.user_factors_, "targets:user"
        table = model.item_factors_
        seed_side = seed + 1  # the item table's init stream
    if dst.min() < 0:
        raise ValueError(f"{side} ids must be >= 0, got {dst.min()}")
    if src.min() < 0 or src.max() >= frozen_host.shape[0]:
        raise ValueError(
            f"frozen-side ids must be in [0, {frozen_host.shape[0]}); got "
            f"range [{src.min()}, {src.max()}] — the fold-in axis is "
            f"{side!r}, the opposite table cannot grow in the same delta"
        )
    uniq, inv = np.unique(dst, return_inverse=True)
    inv = inv.reshape(-1)
    n_old = table.shape[0]
    n_new = max(n_old, int(uniq.max()) + 1)
    # the private working copy, the grown tail at the deterministic init
    new_table = np.empty((n_new, r), np.float32)
    new_table[:n_old] = table
    if n_new > n_old:
        new_table[n_old:] = als_np.init_factors_rows(n_old, n_new, r, seed_side)
    pol = psn.resolve("als")
    frozen = pin(model._dev_cache, frozen_name, frozen_host, model.device)
    dev = frozen.device
    # the edges sorted by destination once; every batch is a contiguous
    # run of them and keeps the whole delta's chunk cuts
    order = np.argsort(inv, kind="stable")
    inv_s, src_s, conf_s = inv[order], src[order], ratings[order]
    cut_all = np.arange(_edge_chunk(r), len(inv_s), _edge_chunk(r))
    elapsed = tick()
    rows_solved = 0
    step = batch_rows or len(uniq)
    gram = None
    # K3 / K4 at the geometry the fit's cache holds (ops/cuda/autotune.py,
    # this process alone): a fold-in after a tuned fit sweeps nothing
    solve_k, gram_k = als_ops.tuned_kernels(r, implicit, dev, world=False)
    for lo in range(0, len(uniq), step):
        hi = min(lo + step, len(uniq))
        e_lo, e_hi = np.searchsorted(inv_s, [lo, hi])
        nnz_pad = _bucket(e_hi - e_lo, EDGE_BUCKET_FLOOR)
        n_dst_pad = _bucket(hi - lo, ROW_BUCKET_FLOOR)
        cuts = cut_all[(cut_all > e_lo) & (cut_all < e_hi)] - e_lo
        side_b = _batch_side(inv_s[e_lo:e_hi] - lo, src_s[e_lo:e_hi], conf_s[e_lo:e_hi],
                             cuts.tolist(), n_dst_pad, nnz_pad, r, dev)
        key = (progcache.backend_fingerprint(dev), (nnz_pad, n_dst_pad, r), implicit, pol)
        # the fold-in solve fault site: right before the batch's launches
        maybe_fault("delta.solve")
        with progcache.launch("online.foldin_solve", key):
            a, b, n_reg = side_b.partials(frozen, alpha, implicit, pol)
            # the frozen table's Gram is the same every batch, but each
            # batch's launch set is whole (K4 with K3), as a half-update's
            gram = als_ops._factor_gram(frozen, gram_k) if implicit else None
            solved = als_ops.regularized_solve(a, b, n_reg, reg, gram, solve_k)
        solved = solved[:hi - lo].cpu().numpy()
        n_reg = n_reg[:hi - lo].cpu().numpy()
        take = n_reg > 0  # rows with no reg-counted rating keep their factors
        new_table[uniq[lo:hi][take]] = solved[take]
        rows_solved += int(take.sum())
    wall = elapsed()
    # compute-then-swap: a fresh array, which re-stages the pins once
    if side == "user":
        model.user_factors_ = new_table
    else:
        model.item_factors_ = new_table
    grown = [int(n_old), int(n_new)] if n_new > n_old else None
    _tm.counter(
        "oap_online_foldin_rows_total", {"side": side},
        help="Destination rows solved by ALS fold-in deltas.",
    ).inc(rows_solved)
    _tm.histogram(
        "oap_online_foldin_seconds", {"side": side},
        help="Wall time of ALS fold-in delta commits.",
    ).observe(wall)
    out = delta.commit(model, "als", detail=f"side={side} rows={rows_solved} grown={grown}")
    return {"side": side, "rows_solved": rows_solved, "grown": grown,
            "repinned": out["repinned"]}
