"""ALS estimator with Spark-MLlib-compatible parameters: the port of the
JAX package's ``models/als.py``.

``ALS(...).fit(users, items, ratings)`` builds the grouped or the COO
edge layout (the JAX package's choice, ``_grouped_ok_single``), runs the
alternating half-updates (ops/als_ops.run_sides: moments, the factor-Gram
kernel for implicit feedback, the solve kernel) and returns an
:class:`ALSModel`.  It runs on ``device="cuda"`` unless the caller
passes ``device="cpu"``, where the kernel wrappers take their plain
versions; a missing card raises.  Ids are dense non-negative ints;
n_users / n_items default to max + 1.  Regularisation follows Spark's
ALS-WR convention (lambda x each row's rating count).

Routes, as in the JAX package:

- a device list (``device="cuda:0,cuda:1,cuda:2,cuda:3"``) takes the
  block-parallel route (ops/als_block.py): one user block per rank of
  the data axis, ``num_user_blocks`` capping that axis, the item
  factors replicated.  ``num_user_blocks=1`` (or one device) keeps the
  single-device route, on the list's first device.  With
  ``Config.als_item_layout="sharded"`` (or "auto" past the JAX
  package's crossover) the item factors are block-sharded too, the 2-D
  layout (summary ``item_layout`` "sharded").
- ``nonnegative=True`` runs the numpy NNLS route
  (fallback/als_np.als_np) with ``accelerated`` False and the reason
  ``"nonnegative=True"`` in the summary: the reference accelerates only
  the unconstrained solver.

Out of core (the JAX package's ``ops/als_stream.py`` route): the route
planner (utils/membudget.plan_als) prices the resident layouts against
the card's budget, and a one-device fit it routes "streamed" keeps the
grouped layouts in host memory and streams them through the card every
half-iteration (K3 and K4 as in memory; summary ``streamed``).  ``fit``
also takes a width-3 (user, item, rating) ``ChunkSource``, ingested to
host arrays, whose natural route is that streamed one.  On a device
list (``num_user_blocks`` not 1) or across processes a source takes the
streamed block route (ops/als_block_stream.py, the planner's
"streamed-block"): each rank keeps its block's grouped layouts in host
memory and streams them through its card, with the block route's
psums and gathers (summary ``streamed`` and ``block_parallel``), in
either item layout.  An array fit on a device list takes it when
``Config.scale_policy`` is "pin:streamed-block".  A degree distribution
the grouped guard rejects runs the resident block fit instead, the
downgrade recorded on the route plan.

On the replicated item layout the resident and the streamed block
routes ask parallel/balance.block_offsets for capability-weighted user
blocks; a world of processes on equal hardware (their probes made
equal, parallel/balance.equal_classes) or of weights inside the
planner's deadband keeps the uniform blocks, bit for bit.  The
summary's ``balance`` records the decision.

A fitted model scores on one device: a mesh fit's on the first rank's.
A block fit (resident or streamed, in either item layout) hands its
live blocks to its model instead of gathering them: the user table as
``sharded_user``, the item table as ``sharded_item`` on the 2-D layout
(summary ``sharded_factors``).  The model gathers a table to the host
on first access of ``user_factors_`` / ``item_factors_`` (a collective
across processes), and the full sweep (serving/sweep.py) serves the
blocks where they lie.

In a world of several processes (``Config.num_processes > 1``) the
triples passed to ``fit`` (or the rows of its source) are THIS
process's ratings: the id maxima are allgathered (``n_users`` /
``n_items`` default to the world's max + 1), the fit takes the block
route on the mesh spanning every process's devices (either item
layout), the shuffle moves each rating to the process that holds its
user block (parallel/shuffle.py), and every process returns the same
factors.  ``nonnegative=True`` raises there (its numpy route would fit
one shard).

With ``Config.checkpoint_dir`` set every route checkpoints its factors
(utils/checkpoint.py, the JAX package's format and signature, the id
axes ``n_users`` / ``n_items`` growable): the one-device loop runs in
``checkpoint_interval``-sized segments with both tables written between
them (``_run_segmented``), the streamed loop writes every interval, and
the block routes write each process's blocks' valid rows
(``_run_block_segmented``, ops/als_block_stream.py).  A restore onto
another block layout or world redistributes the rows
(parallel/shuffle.reshard_factor_rows, decision "resharded"), a block
world's checkpoint restores onto one device and the other way round,
and a grown id space's tail takes the deterministic init
(``_fill_grown``).

The one-device fit runs under the resilience ladder
(utils/resilience.py): transient faults retry, a device OOM re-enters
the streamed route with half the upload blocks (a COO layout runs
again), and past the last rung ``ResilienceError``; a source's triples
are read under ``run_with_retry``, its retries counted in the same
``resilience`` block.  Block routes run one attempt.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from oap_mllib_tpu_torch import native
from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.ops import als_block, als_block_stream, als_ops, als_stream
from oap_mllib_tpu_torch.ops.cuda import als_kernel, autotune
from oap_mllib_tpu_torch.parallel import balance, bootstrap, collective
from oap_mllib_tpu_torch.parallel.mesh import Mesh, get_mesh
from oap_mllib_tpu_torch.telemetry import export as telemetry
from oap_mllib_tpu_torch.utils import checkpoint as ckpt_mod
from oap_mllib_tpu_torch.utils import membudget, progcache, resilience
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.dispatch import model_device, resolve_device, resolve_devices
from oap_mllib_tpu_torch.utils.profiling import maybe_trace
from oap_mllib_tpu_torch.utils.timing import Timings, phase_timer


class ALSModel:
    """Trained factors: ``user_factors_`` (n_users, r) and
    ``item_factors_`` (n_items, r), scored on ``device``.

    A block fit keeps its factors where they were fitted: the user
    table as ``sharded_user`` (an ``als_block.Shard``, the blocks on the
    ranks' devices with their offsets, the reference's ALSResult
    cUserOffset bookkeeping), the item table as ``sharded_item`` on the
    2-D layout, else on the host.  Pass exactly one form of each table.
    A sharded table gathers to the host on first access of its
    property; across processes that gather is a COLLECTIVE, so every
    process touches ``user_factors_`` (or ``predict`` / ``save`` / the
    subset top-k) together.  ``rank`` never gathers, and the full sweep
    (serving/sweep.recommend_for_all_users) serves the live blocks.
    Assigning a table (the fold-in's commit) replaces that side's
    shard: the sweep then serves the assigned table."""

    def __init__(self, user_factors, item_factors, summary: Optional[dict] = None,
                 device: Optional[str] = None, *,
                 sharded_user: Optional[als_block.Shard] = None,
                 sharded_item: Optional[als_block.Shard] = None):
        if (user_factors is None) == (sharded_user is None):
            raise ValueError("pass exactly one of user_factors / sharded_user")
        if (item_factors is None) == (sharded_item is None):
            raise ValueError("pass exactly one of item_factors / sharded_item")
        self._user_factors = None if user_factors is None else np.asarray(user_factors)
        self._item_factors = None if item_factors is None else np.asarray(item_factors)
        self._sharded_user = sharded_user
        self._sharded_item = sharded_item
        self.summary = summary or {}
        # None = Config.device, resolved at every scoring call
        self.device = device
        # the device copies of the factor tables (serving/registry.pin),
        # keyed by the host array's identity: at most "targets:user" and
        # "targets:item", across top-k chunks and calls
        self._dev_cache: dict = {}

    @property
    def user_factors_(self) -> np.ndarray:
        if self._user_factors is None:
            self._user_factors = _gather(self._sharded_user)
        return self._user_factors

    @user_factors_.setter
    def user_factors_(self, table) -> None:
        self._user_factors = np.asarray(table)
        self._sharded_user = None

    @property
    def item_factors_(self) -> np.ndarray:
        if self._item_factors is None:
            self._item_factors = _gather(self._sharded_item)
        return self._item_factors

    @item_factors_.setter
    def item_factors_(self, table) -> None:
        self._item_factors = np.asarray(table)
        self._sharded_item = None

    @property
    def rank(self) -> int:
        if self._item_factors is not None:
            return self._item_factors.shape[1]
        return int(next(iter(self._sharded_item.blocks.values())).shape[1])

    def _pinned(self, table: np.ndarray) -> torch.Tensor:
        """The pinned device copy of a factor table of this model (a
        foreign table stages once per call, unpinned)."""
        from oap_mllib_tpu_torch.serving import batcher
        from oap_mllib_tpu_torch.serving.registry import pin

        if table is self.item_factors_:
            return pin(self._dev_cache, "targets:item", table, self.device)
        if table is self.user_factors_:
            return pin(self._dev_cache, "targets:user", table, self.device)
        return batcher.stage(table, resolve_device(self.device))

    def predict(self, users, items) -> np.ndarray:
        """Predicted preference/rating of (user, item) pairs."""
        x = self._pinned(self.user_factors_)
        y = self._pinned(self.item_factors_)
        u = torch.as_tensor(np.asarray(users, np.int64), device=x.device)
        i = torch.as_tensor(np.asarray(items, np.int64), device=x.device)
        return als_ops.predict_pairs(x, y, u, i).cpu().numpy()

    def _top_k_scores(self, query, targets: np.ndarray, n: int,
                      with_scores: bool = True):
        """Top-n (ids, scores) per query row through the chunked serving
        program (serving/batcher.topk_chunked) against the pinned target
        table, the (rows, n_targets) score block bounded by
        ``batcher.topk_chunk_rows``.  ``n`` is clamped to the target
        count; ties go to the lowest id."""
        from oap_mllib_tpu_torch.serving import batcher

        if n < 0:
            raise ValueError(f"top-k count must be >= 0, got {n}")
        return batcher.topk_chunked(
            query, self._pinned(targets), n,
            batcher.topk_chunk_rows(targets.shape[0], query.shape[1]), with_scores=with_scores)

    def recommend_for_all_users(self, num_items: int, with_scores: bool = False):
        """Top-N item ids per user (with ``with_scores``, the (ids, scores)
        pair, scores descending)."""
        ids, scores = self._top_k_scores(self.user_factors_, self.item_factors_, num_items,
                                         with_scores)
        return (ids, scores) if with_scores else ids

    def recommend_for_all_items(self, num_users: int, with_scores: bool = False):
        """Top-N user ids per item."""
        ids, scores = self._top_k_scores(self.item_factors_, self.user_factors_, num_users,
                                         with_scores)
        return (ids, scores) if with_scores else ids

    def _recommend_subset(self, query_ids, query_table: np.ndarray,
                          target_table: np.ndarray, n: int, with_scores: bool,
                          what: str):
        query_ids = np.asarray(query_ids, np.int64)
        n_q = query_table.shape[0]
        if len(query_ids) and (query_ids.min() < 0 or query_ids.max() >= n_q):
            raise ValueError(
                f"{what} ids must be in [0, {n_q}); got range "
                f"[{query_ids.min()}, {query_ids.max()}]"
            )
        ids, scores = self._top_k_scores(query_table[query_ids], target_table, n, with_scores)
        return (ids, scores) if with_scores else ids

    def recommend_for_users(self, user_ids, num_items: int, with_scores: bool = False):
        """Top-N item ids for a subset of users; row j is for user_ids[j]."""
        return self._recommend_subset(user_ids, self.user_factors_,
                                      self.item_factors_, num_items, with_scores, "user")

    def recommend_for_items(self, item_ids, num_users: int, with_scores: bool = False):
        """Top-N user ids for a subset of items; row j is for item_ids[j]."""
        return self._recommend_subset(item_ids, self.item_factors_,
                                      self.user_factors_, num_users, with_scores, "item")

    def fold_in_users(self, users, items, ratings, **kw) -> dict:
        """Fold new or changed USER rows in against the frozen item table
        (online/foldin.py): one batched normal-equation solve a delta (K3,
        and K4 for implicit feedback), then an in-place serving re-pin.
        The triples are the touched users' FULL current ratings.  The
        user axis may grow: ids past the table extend it, untouched new
        rows at the deterministic init.  ``reg`` / ``alpha`` /
        ``implicit`` / ``seed`` default to the fit's ``summary["params"]``.
        Returns ``{"side", "rows_solved", "grown", "repinned"}``."""
        from oap_mllib_tpu_torch.online import foldin

        return foldin.fold_in(self, users, items, ratings, side="user", **kw)

    def fold_in_items(self, users, items, ratings, **kw) -> dict:
        """Fold ITEM rows in against the frozen user table; see
        :meth:`fold_in_users`."""
        from oap_mllib_tpu_torch.online import foldin

        return foldin.fold_in(self, users, items, ratings, side="item", **kw)

    # -- persistence: the JAX package's format (metadata.json + .npy) -------
    def save(self, path: str) -> None:
        """Atomic per-file writes, metadata last."""
        from oap_mllib_tpu_torch.data import io as _io

        os.makedirs(path, exist_ok=True)
        _io.atomic_save_npy(os.path.join(path, "user_factors.npy"), self.user_factors_)
        _io.atomic_save_npy(os.path.join(path, "item_factors.npy"), self.item_factors_)
        _io.atomic_write_json(
            os.path.join(path, "metadata.json"),
            {"type": "ALSModel", "rank": int(self.rank),
             "user_shape": [int(v) for v in self.user_factors_.shape],
             "item_shape": [int(v) for v in self.item_factors_.shape],
             "version": 1},
        )

    @classmethod
    def load(cls, path: str, device: Optional[str] = None) -> "ALSModel":
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        if meta.get("type") != "ALSModel":
            raise ValueError(f"not an ALSModel directory: {path}")
        uf = np.load(os.path.join(path, "user_factors.npy"))
        itf = np.load(os.path.join(path, "item_factors.npy"))
        for name, arr in (("user_factors.npy", uf), ("item_factors.npy", itf)):
            expect = meta.get(name.replace("_factors.npy", "_shape"), [None, meta["rank"]])
            if arr.ndim != 2 or int(arr.shape[1]) != int(expect[1]) or (
                    expect[0] is not None and int(arr.shape[0]) != int(expect[0])):
                raise ValueError(
                    f"{os.path.join(path, name)}: factors have shape "
                    f"{tuple(arr.shape)}, metadata expects {tuple(expect)}: the "
                    "model directory is torn or mixed from two saves"
                )
        return cls(uf, itf, device=device)


def _gather(shard: als_block.Shard) -> np.ndarray:
    """The host (n, r) table of a block-sharded one: a collective when
    its mesh spans processes."""
    return als_block.gather_user_factors(shard.blocks, shard.mesh, shard.offsets)


def _grouped_ok_single(kernel: str, users, items, n_users: int, n_items: int) -> bool:
    """Grouped-vs-COO decision (the JAX package's rule): "auto" takes the
    grouped layout unless its padded edges exceed GROUPED_MAX_BLOWUP x
    nnz."""
    if kernel != "auto":
        return kernel == "grouped"
    padded = (als_ops.grouped_padded_edges(users, n_users)
              + als_ops.grouped_padded_edges(items, n_items))
    return padded <= als_ops.GROUPED_MAX_BLOWUP * max(len(users), 1)


def _traced(attempt):
    """``attempt`` under ``Config.profile_dir``'s profiler trace
    (utils/profiling.maybe_trace), one trace an attempt."""
    def run(level):
        with maybe_trace():
            return attempt(level)

    return run


def _als_kernel_cfg() -> str:
    kernel = get_config().als_kernel
    if kernel not in ("auto", "grouped", "coo"):
        raise ValueError(f"als_kernel must be auto|grouped|coo, got {kernel!r}")
    return kernel


class ALS:
    """ALS estimator.  Param parity with Spark ML ALS defaults: rank=10,
    max_iter=10, reg_param=0.1, implicit_prefs=False, alpha=1.0; ``seed``
    None takes ``Config.seed``; ``device`` None takes ``Config.device``
    ("cuda").  ``num_user_blocks`` caps the data axis of a mesh fit
    (Spark's numUserBlocks); ``num_item_blocks`` is recorded in the
    summary, the item layout being ``Config.als_item_layout``'s."""

    def __init__(self, rank: int = 10, max_iter: int = 10, reg_param: float = 0.1,
                 implicit_prefs: bool = False, alpha: float = 1.0,
                 seed: Optional[int] = None, nonnegative: bool = False,
                 num_user_blocks: Optional[int] = None,
                 num_item_blocks: Optional[int] = None,
                 device: Optional[str] = None):
        if rank < 1:
            raise ValueError("rank must be >= 1")
        if max_iter < 0:
            raise ValueError("max_iter must be >= 0")
        if reg_param < 0:
            raise ValueError("reg_param must be >= 0")
        if alpha < 0:
            raise ValueError("alpha must be >= 0")
        if num_user_blocks is not None and num_user_blocks < 1:
            raise ValueError("num_user_blocks must be >= 1")
        if num_item_blocks is not None and num_item_blocks < 1:
            raise ValueError("num_item_blocks must be >= 1")
        self.rank = rank
        self.max_iter = max_iter
        self.reg_param = reg_param
        self.implicit_prefs = implicit_prefs
        self.alpha = alpha
        self.seed = get_config().seed if seed is None else seed
        self.nonnegative = nonnegative
        self.num_user_blocks = num_user_blocks
        self.num_item_blocks = num_item_blocks
        self.device = device

    def fit(self, users, items=None, ratings=None, n_users: Optional[int] = None,
            n_items: Optional[int] = None, init: Optional[tuple] = None) -> ALSModel:
        """Fit factors from (user, item, rating) triples: three arrays, or
        ``users`` a width-3 ``ChunkSource`` of (user, item, rating) rows
        (``items`` and ``ratings`` None).  ``init`` is an optional
        (x0, y0) pair of initial factors."""
        autotune.check_config()  # a Config.tuning typo raises here
        if isinstance(users, ChunkSource):
            if items is not None or ratings is not None:
                raise ValueError("pass EITHER a triples ChunkSource OR explicit "
                                 "users/items/ratings arrays")
            model = self._fit_source(users, n_users, n_items, init)
        elif items is None or ratings is None:
            raise TypeError("fit needs items and ratings arrays")
        else:
            model = self._fit_arrays(users, items, ratings, n_users, n_items, init)
        telemetry.finalize_fit(model.summary)
        return model

    def _fit_arrays(self, users, items, ratings, n_users, n_items, init,
                    plan: Optional[membudget.RoutePlan] = None,
                    devices=None, stats=None) -> ALSModel:
        users, items, ratings, n_users, n_items = _validate_resolve(
            users, items, ratings, n_users, n_items)
        kernel = _als_kernel_cfg()
        als_block.als_item_layout_cfg()  # a typo raises on every route
        x0, y0 = self._init_arrays(init, n_users, n_items)
        if self.nonnegative:
            if bootstrap.world_size() > 1:
                raise NotImplementedError(
                    "nonnegative=True runs the numpy NNLS route on one process's "
                    "ratings; it does not fit across a world of processes")
            return self._fit_fallback_np(users, items, ratings, n_users, n_items, x0, y0)
        devices = devices or resolve_devices(self.device)
        mesh = self._block_mesh(devices)
        if mesh is not None:
            if membudget.scale_policy_cfg() == ("pin", membudget.ROUTE_STREAMED_BLOCK):
                world = mesh.shape[mesh.axis_names[0]]
                plan = membudget.plan_als(len(users), n_users, n_items, self.rank, world=world,
                                          device=devices[0])
                model = self._one_attempt(lambda level: self._fit_source_block(
                    users, items, ratings, n_users, n_items, x0, y0, mesh, kernel, plan), stats)
                membudget.record_plan(model.summary, plan)
                return model
            return self._one_attempt(lambda level: self._fit_block_parallel(
                users, items, ratings, n_users, n_items, x0, y0, mesh, kernel), stats)
        if plan is None:
            plan = membudget.plan_als(len(users), n_users, n_items, self.rank,
                                      device=devices[0])
        # the edges in (user, item) order, ties in input order, as a block
        # route's shuffle orders a block (parallel/shuffle.bucket): the two
        # routes' fits then group and sum every side alike.  Each array is
        # gathered in its dtype and replaces its unsorted copy at once, so
        # where validation copied the caller's arrays the host peak is the
        # records and the permutation's 16 bytes an edge (its sort keys and
        # itself), and no unsorted copy lives into the grouped build
        _, perm = native.shuffle_perm(users, items, 1, 1)
        users = native.gather(users, perm)
        items = native.gather(items, perm)
        ratings = native.gather(ratings, perm)
        del perm
        # the ladder (utils/resilience.py): transient faults retry; a
        # device OOM re-enters the streamed route at halved upload blocks
        # (the COO layout has no such knob and runs again)
        model = resilience.fit_with_ladder(
            "ALS", _traced(lambda level: self._fit_single_device(
                users, items, ratings, n_users, n_items, x0, y0, devices[0], kernel, plan,
                level)),
            [als_kernel.LAUNCHES], stats=stats)
        membudget.record_plan(model.summary, plan)
        return model

    def _one_attempt(self, attempt, stats=None) -> ALSModel:
        """A block-route fit: one attempt, across processes or on an
        in-process mesh (utils/resilience.py)."""
        return resilience.fit_with_ladder("ALS", _traced(attempt), [als_kernel.LAUNCHES],
                                          stats=stats, bypass=resilience.LADDER_MESH)

    def _block_mesh(self, devices) -> Optional[Mesh]:
        """The mesh of a block-route fit, or None for the one-device route:
        across processes the mesh of every process's devices (one user
        block a data rank); in one process a device list whose
        ``num_user_blocks`` is not 1, the data axis capped at it."""
        if bootstrap.world_size() > 1:
            mesh = get_mesh(devices=devices)
            world = mesh.shape[mesh.axis_names[0]]
            if self.num_user_blocks is not None and self.num_user_blocks != world:
                raise ValueError(
                    f"num_user_blocks={self.num_user_blocks}: across processes the "
                    f"block ALS runs one user block per data rank of the world ({world})")
            return mesh
        if len(devices) > 1 and self.num_user_blocks != 1:
            mesh = get_mesh(devices=devices)
            world = mesh.shape[mesh.axis_names[0]]
            if self.num_user_blocks is not None and self.num_user_blocks < world:
                # fewer user blocks = a smaller data axis, one block a rank
                mp = mesh.shape[mesh.axis_names[1]]
                mesh = get_mesh(devices=devices[: self.num_user_blocks * mp])
                world = mesh.shape[mesh.axis_names[0]]
            if world > 1:
                return mesh
        return None

    def _fit_source(self, source: ChunkSource, n_users, n_items, init) -> ALSModel:
        """The fit of a width-3 (user, item, rating) source (the JAX
        package's ``_fit_source``): the triples
        are read to host arrays (host memory O(nnz), as the reference's
        executors hold their partitions; across processes this process's
        rows), the read retrying transient faults
        (``resilience.run_with_retry``, counted in the fit's
        ``resilience``), then the route plan with the source's natural
        route: streamed on one device, the streamed block route on a
        mesh."""
        if source.n_features != 3:
            raise ValueError("ALS source must have width 3 (user, item, rating); "
                             f"got {source.n_features}")

        def ingest():
            us, its, rs = [], [], []
            for chunk, n_valid in source:
                us.append(np.asarray(chunk[:n_valid, 0], np.int64))
                its.append(np.asarray(chunk[:n_valid, 1], np.int64))
                rs.append(np.asarray(chunk[:n_valid, 2], np.float32))
            return (np.concatenate(us) if us else np.zeros((0,), np.int64),
                    np.concatenate(its) if its else np.zeros((0,), np.int64),
                    np.concatenate(rs) if rs else np.zeros((0,), np.float32))

        stats = resilience.ResilienceStats()
        users, items, ratings = resilience.run_with_retry(ingest, stats=stats,
                                                          site="ALS.ingest")
        if self.nonnegative:
            return self._fit_arrays(users, items, ratings, n_users, n_items, init)
        devices = resolve_devices(self.device)
        mesh = self._block_mesh(devices)
        if mesh is not None:
            users, items, ratings, n_users, n_items = _validate_resolve(
                users, items, ratings, n_users, n_items)
            kernel = _als_kernel_cfg()
            als_block.als_item_layout_cfg()
            x0, y0 = self._init_arrays(init, n_users, n_items)
            plan = membudget.plan_als(len(users), n_users, n_items, self.rank,
                                      world=mesh.shape[mesh.axis_names[0]],
                                      source_backing=source.backing, device=devices[0])
            model = self._one_attempt(lambda level: self._fit_source_block(
                users, items, ratings, n_users, n_items, x0, y0, mesh, kernel, plan), stats)
            membudget.record_plan(model.summary, plan)
            return model
        _, _, _, n_users, n_items = _validate_resolve(users, items, ratings, n_users, n_items)
        plan = membudget.plan_als(len(users), n_users, n_items, self.rank,
                                  source_backing=source.backing, device=devices[0])
        return self._fit_arrays(users, items, ratings, n_users, n_items, init, plan,
                                devices[:1], stats)

    def _init_arrays(self, init, n_users: int, n_items: int):
        """``(x0, y0)`` f32 copies of a given ``init`` pair, checked
        against the fit's shapes, or ``(None, None)``."""
        if init is None:
            return None, None
        x0, y0 = np.array(init[0], np.float32), np.array(init[1], np.float32)
        if x0.shape != (n_users, self.rank) or y0.shape != (n_items, self.rank):
            raise ValueError(
                f"init factors have shapes {x0.shape} and {y0.shape}, the fit "
                f"needs ({n_users}, {self.rank}) and ({n_items}, {self.rank})"
            )
        return x0, y0

    def _summary(self, timings, pol, before, extra, cache_before=None,
                 tune_before=None) -> dict:
        out = {
            "timings": timings,
            "accelerated": True,
            **extra,
            "solve_kernel": "cuda" if self.rank <= als_kernel.MAX_RANK else "torch.linalg",
            "gram_route": als_ops.gram_route(self.rank) if self.implicit_prefs else None,
            "precision": pol,
            "kernels": {
                name: als_kernel.LAUNCHES[name] - before.get(name, 0)
                for name in als_kernel.LAUNCHES
            },
            "params": {
                "rank": int(self.rank), "reg": float(self.reg_param),
                "alpha": float(self.alpha), "implicit": bool(self.implicit_prefs),
                "seed": int(self.seed),
            },
        }
        if cache_before is not None:
            out["progcache"] = progcache.delta(cache_before)
        if tune_before is not None:
            out["tuning"] = autotune.delta(tune_before)
        return out

    # the id axes may GROW across restores (utils/checkpoint.py): an
    # older checkpoint warm-starts a fit over a larger id space, its rows
    # restoring exactly and the grown tail taking the deterministic init
    _GROWABLE = ("n_users", "n_items")

    def _ckpt_signature(self, n_users: int, n_items: int) -> dict:
        """The checkpoint identity, the JAX package's dict key for key:
        the solver parameters and the id space.  The world, the block
        layout, the kernels, the chunking and the precision policy may
        change across a preemption and stay out."""
        return {"rank": self.rank, "implicit": bool(self.implicit_prefs),
                "reg": float(self.reg_param), "alpha": float(self.alpha),
                "seed": int(self.seed), "n_users": int(n_users), "n_items": int(n_items)}

    def _open_checkpoint(self, n_users: int, n_items: int, timings):
        return ckpt_mod.maybe_open("als", self._ckpt_signature(n_users, n_items),
                                   timings=timings, growable=self._GROWABLE)

    def _fill_grown(self, grown: dict, x=None, y=None):
        """The grown tail of restored tables: rows ``[old, new)`` of a
        grown axis restore as zeros and take the position-addressable
        init instead, the rows a fit of the grown id space starts from."""
        if x is not None and "n_users" in grown:
            lo, hi = grown["n_users"]
            x = np.asarray(x, np.float32)
            x[lo:hi] = als_np.init_factors_rows(lo, hi, self.rank, self.seed)
        if y is not None and "n_items" in grown:
            lo, hi = grown["n_items"]
            y = np.asarray(y, np.float32)
            y[lo:hi] = als_np.init_factors_rows(lo, hi, self.rank, self.seed + 1)
        return x, y

    def _run_segmented(self, ckpt, x0, y0, run_iters, n_users: int, n_items: int):
        """The checkpoint-armed one-device loop: ``checkpoint_interval``-
        sized segments of ``run_iters(x, y, iters)``, both tables written
        between them.  An iteration is a function of the tables alone, so
        segments are bit-equal to one loop; a block world's sharded
        checkpoint restores here too (marked resharded)."""
        resume = ckpt.restore()
        done = 0
        x, y = x0, y0
        if resume.found:
            x = ckpt_mod.factors_from_result(resume, "x", n_users)
            y = ckpt_mod.factors_from_result(resume, "y", n_items)
            if resume.grown:
                x, y = self._fill_grown(resume.grown, x, y)
            done = min(int(resume.step), self.max_iter)
            if "x" not in resume.arrays:
                ckpt.mark_resharded()  # sharded state onto one device
        while done < self.max_iter:
            seg = min(ckpt.interval, self.max_iter - done)
            x, y = run_iters(x, y, seg)
            done += seg
            ckpt.maybe_write(done, {"x": x, "y": y}, force=True)
        return torch.as_tensor(x), torch.as_tensor(y)

    def _run_block_segmented(self, ckpt, run_iters, x0, y0, mesh: Mesh, layout: dict,
                             n_items: int):
        """The checkpoint-armed block loop: segments of ``run_iters(x, y,
        iters)`` with each process's blocks' valid rows written between
        them; a restore redistributes what the relaunched world read onto
        the live blocks (ops/als_block.restore_block_factors)."""
        done, x, y = als_block.restore_block_factors(ckpt, mesh, layout, n_items,
                                                     self.max_iter, x0, y0, self._fill_grown)
        while done < self.max_iter:
            seg = min(ckpt.interval, self.max_iter - done)
            x, y = run_iters(x, y, seg)
            done += seg
            als_block.write_block_factors(ckpt, done, x, y, mesh, layout, force=True)
        return x, y

    def _fit_single_device(self, users, items, ratings, n_users, n_items, x0, y0,
                           dev: torch.device, kernel: str,
                           plan: membudget.RoutePlan, level: int = 0) -> ALSModel:
        """The one-device fit: the resident grouped or COO layouts, or, when
        ``plan`` routes it "streamed", the host-resident grouped layouts
        streamed every half-iteration (ops/als_stream.py).  Streaming is
        grouped only: a degree distribution the grouped guard rejects
        moves the plan back to in-memory, on the record (strict raises).
        ``level`` > 0 (the ladder's halving rung) streams the grouped
        layouts at half the upload blocks; the COO layout runs again."""
        streamed = plan.route == membudget.ROUTE_STREAMED
        pol = psn.resolve("als")
        # the Grams and solves are f32 under every policy, and the moment
        # products' f32 (and bf16-split) operands need TF32 off
        psn.apply_matmul_flags("highest")
        timings = Timings("als.fit")
        before = dict(als_kernel.LAUNCHES)
        cache_before = progcache.stats()
        tune_before = autotune.mark()
        if x0 is None:
            x0 = als_np.init_factors(n_users, self.rank, self.seed)
            y0 = als_np.init_factors(n_items, self.rank, self.seed + 1)
        with phase_timer(timings, "table_convert", dev):
            grouped = _grouped_ok_single(kernel, users, items, n_users, n_items)
            if streamed and not grouped:
                plan.downgrade(membudget.ROUTE_IN_MEMORY, "grouped guard rejected the "
                               "degree distribution (COO streaming unsupported)")
                streamed = False
            streamed = streamed or (bool(level) and grouped)
            if streamed:
                by_user = als_ops.build_grouped_edges(users, items, ratings, n_users)
                by_item = als_ops.build_grouped_edges(items, users, ratings, n_items)
            else:
                user_side, item_side = als_ops.prepare_sides(
                    grouped, users, items, ratings, n_users, n_items, self.rank, dev, timings)
                x0, y0 = torch.from_numpy(x0).to(dev), torch.from_numpy(y0).to(dev)
        ckpt = self._open_checkpoint(n_users, n_items, timings)
        if streamed:
            with phase_timer(timings, "als_iterations", dev):
                x, y = als_stream.als_run_streamed(
                    by_user, by_item, x0, y0, n_users, n_items, self.max_iter,
                    self.reg_param, self.alpha, self.implicit_prefs, timings, pol, dev,
                    degraded=bool(level), checkpoint=ckpt, grown_fill=self._fill_grown)
        else:
            def run_iters(xa, ya, iters):
                return als_ops.run_sides(
                    user_side, item_side, torch.as_tensor(xa).to(dev),
                    torch.as_tensor(ya).to(dev), iters, self.reg_param,
                    self.alpha if self.implicit_prefs else 0.0, self.implicit_prefs, pol)

            with phase_timer(timings, "als_iterations", dev):
                if ckpt is None:
                    x, y = run_iters(x0, y0, self.max_iter)
                else:
                    x, y = self._run_segmented(ckpt, x0, y0, run_iters, n_users, n_items)
                x, y = x.cpu().numpy(), y.cpu().numpy()
        extra = {"als_kernel": "grouped" if grouped else "coo", "item_layout": "replicated",
                 **self._block_summary(1)}
        if streamed:
            extra["streamed"] = True
        summary = self._summary(timings, pol, before, extra, cache_before, tune_before)
        if ckpt is not None:
            ckpt.record(summary)
        return ALSModel(x, y, summary, device=self._scoring_device(dev))

    def _scoring_device(self, dev) -> Optional[str]:
        return model_device(self.device, dev)

    def _fit_fallback_np(self, users, items, ratings, n_users, n_items, x0, y0) -> ALSModel:
        """The numpy route of ``nonnegative=True`` (the JAX package's
        ``_fit_fallback_np``): the NNLS solve per row, from the absolute
        values of the initial factors, so the factors are >= 0 even at
        ``max_iter=0`` or from a signed init."""
        timings = Timings("als.fit")
        if x0 is None:
            x0 = als_np.init_factors(n_users, self.rank, self.seed)
            y0 = als_np.init_factors(n_items, self.rank, self.seed + 1)
        x0, y0 = np.abs(x0), np.abs(y0)
        with phase_timer(timings, "als_np"):
            x, y = als_np.als_np(
                users, items, ratings, n_users, n_items, self.rank, self.max_iter,
                self.reg_param, self.alpha, self.implicit_prefs, self.seed,
                init=(x0, y0), nonnegative=True,
            )
        summary = {"timings": timings, "accelerated": False, "reason": "nonnegative=True",
                   "item_layout": "replicated", **self._block_summary(1)}
        name = get_config().device if self.device is None else str(self.device)
        return ALSModel(x, y, summary, device=self._scoring_device(name.split(",")[0].strip()))

    def _block_summary(self, effective_user_blocks: int) -> dict:
        """Requested and effective block layout, for the summary."""
        out = {"num_user_blocks": effective_user_blocks}
        if self.num_user_blocks is not None:
            out["num_user_blocks_requested"] = self.num_user_blocks
        if self.num_item_blocks is not None:
            out["num_item_blocks_requested"] = self.num_item_blocks
        return out

    def _block_dispatch(self, users, items, n_users: int, n_items: int, world: int,
                        kernel: str, mesh: Mesh):
        """``(item_sharded, use_grouped, sizes)``, the block route's one
        decision point: the item layout, then the grouped-vs-COO guard
        priced before the shuffle (``sizes`` its group sizes, None when
        ``Config.als_kernel`` forces the layout), on the world's counts
        when the mesh spans processes."""
        item_sharded = als_block.item_layout_sharded(n_items, self.rank, world, n_users)
        if kernel != "auto":
            return item_sharded, kernel == "grouped", None
        guard = (als_block.block_grouped_guard_2d if item_sharded
                 else als_block.block_grouped_guard)
        use_grouped, sizes = guard(users, items, n_users, n_items, world, mesh=mesh)
        return item_sharded, use_grouped, sizes

    def _place_block_factors(self, mesh: Mesh, offsets: np.ndarray, per: int,
                             init_full: Optional[np.ndarray], seed: int):
        """Each data rank's (per, rank) user block on its device: rows
        ``[offsets[b], offsets[b + 1])`` of the given init, else of the
        position-addressable init (bit-equal to the global
        ``init_factors`` rows), zero below them."""
        out = {}
        for b, q in als_block._local_blocks(mesh):
            lo, hi = int(offsets[b]), int(offsets[b + 1])
            blk = np.zeros((per, self.rank), np.float32)
            blk[: hi - lo] = (init_full[lo:hi] if init_full is not None
                              else als_np.init_factors_rows(lo, hi, self.rank, seed))
            out[q] = torch.from_numpy(blk).to(mesh.device(q))
        return out

    def _fit_block_parallel(self, users, items, ratings, n_users, n_items, x0, y0,
                            mesh: Mesh, kernel: str) -> ALSModel:
        """The block-parallel route (the JAX package's
        ``_fit_block_parallel``): the shuffle by user block (and, in the
        2-D layout, a second one by item block), each rank's edge
        layouts staged on its device, the block-local factor init, then
        ops/als_block's iterations.  The capability-weighted block
        offsets (parallel/balance.block_offsets, the replicated layout
        only) are None on a world of equal processes: the blocks are then
        uniform."""
        world = mesh.shape[mesh.axis_names[0]]
        ranks = [q for q in als_block.data_ranks(mesh) if mesh.is_local(q)]
        devs = list(dict.fromkeys(mesh.device(q) for q in ranks))
        pol = psn.resolve("als")
        psn.apply_matmul_flags("highest")
        item_sharded, use_grouped, sizes = self._block_dispatch(
            users, items, n_users, n_items, world, kernel, mesh)
        offsets, bal = self._block_balance(n_users, world, item_sharded)
        timings = Timings("als.fit")
        before = dict(als_kernel.LAUNCHES)
        cache_before = progcache.stats()
        tune_before = autotune.mark()
        with phase_timer(timings, "ratings_shuffle", devs):
            edges = als_block.prepare_block_inputs(users, items, ratings, world, n_users, mesh,
                                                   offsets=offsets)
            if item_sharded:
                # the second shuffle, by item block: the same exchange with
                # the roles swapped (local item ids, global user ids)
                by_item = als_block.prepare_block_inputs(items, users, ratings, world,
                                                         n_items, mesh)
                sides = (als_block.prepare_grouped_inputs_2d(edges, by_item, mesh, self.rank,
                                                             sizes) if use_grouped
                         else als_block.prepare_coo_inputs_2d(edges, by_item, mesh,
                                                              self.rank))
            elif use_grouped:
                sides = als_block.prepare_grouped_inputs(edges, mesh, n_items, self.rank, sizes)
            else:
                sides = als_block.prepare_coo_inputs(edges, mesh, n_items, self.rank)
        with phase_timer(timings, "table_convert", devs):
            x0_dev = self._place_block_factors(mesh, edges.offsets, edges.upb, x0, self.seed)
            if item_sharded:
                # Y's blocks from the same rows the replicated init would
                # hold, padding zero (which keeps the psum of block Grams
                # exact)
                y0_dev = self._place_block_factors(mesh, by_item.offsets, by_item.upb, y0,
                                                   self.seed + 1)
            else:
                y0_host = (y0 if y0 is not None
                           else als_np.init_factors(n_items, self.rank, self.seed + 1))
                staged = {dev: torch.from_numpy(y0_host).to(dev) for dev in devs}
                y0_dev = {q: staged[mesh.device(q)] for q in ranks}
        if item_sharded:
            run = (als_block.als_block_run_grouped_2d if use_grouped
                   else als_block.als_block_run_2d)
        else:
            run = als_block.als_block_run_grouped if use_grouped else als_block.als_block_run

        def run_iters(xa, ya, iters):
            return run(sides, xa, ya, iters, self.reg_param, self.alpha, mesh,
                       implicit=self.implicit_prefs, policy=pol)

        ckpt = self._open_checkpoint(n_users, n_items, timings)
        with phase_timer(timings, "als_iterations", devs):
            if ckpt is None:
                x_blocks, y = run_iters(x0_dev, y0_dev, self.max_iter)
            else:
                layout = als_block.block_ckpt_layout(
                    edges.offsets, edges.upb, item_sharded,
                    by_item.offsets if item_sharded else None,
                    by_item.upb if item_sharded else None)
                x_blocks, y = self._run_block_segmented(ckpt, run_iters, x0_dev, y0_dev, mesh,
                                                        layout, n_items)
        summary = self._summary(timings, pol, before, cache_before=cache_before,
                                tune_before=tune_before, extra={
            "block_parallel": True, "sharded_factors": True,
            "als_kernel": "grouped" if use_grouped else "coo",
            "item_layout": "sharded" if item_sharded else "replicated",
            "mesh": dict(mesh.shape), "processes": mesh.processes,
            "process_id": mesh.process, "balance": bal, **self._block_summary(world)})
        if ckpt is not None:
            ckpt.record(summary)
        return _sharded_model(x_blocks, y, summary, mesh, ranks, edges.offsets, edges.upb,
                              by_item if item_sharded else None)

    def _block_balance(self, n_users: int, world: int, item_sharded: bool):
        """``(offsets, block)``: the capability-weighted user-block offsets
        of a block fit on the replicated item layout (None: uniform
        blocks), each key priced at its factor row and moment rows
        (``4 (r + (r+1)(r+2))`` bytes), and the summary's ``balance``
        record of the decision."""
        if item_sharded:
            return None, balance.block_summary(None, world, None, "2-D item layout")
        cw = balance.block_capabilities()
        offsets = balance.block_offsets(
            n_users, world, bytes_per_key=4 * (self.rank + (self.rank + 1) * (self.rank + 2)),
            capworld=cw) if cw is not None else None
        return offsets, balance.block_summary(offsets, world, cw)

    def _fit_source_block(self, users, items, ratings, n_users, n_items, x0, y0,
                          mesh: Mesh, kernel: str, plan: membudget.RoutePlan) -> ALSModel:
        """The streamed block route (the JAX package's ``_fit_source_block``,
        ops/als_block_stream.py): the shuffle, each local rank's grouped
        layouts kept in host memory, the block-local factor init, then
        the block iterations with every side streamed through its rank's
        card.  A degree distribution the grouped guard rejects runs the
        resident block fit, the downgrade recorded on ``plan``."""
        world = mesh.shape[mesh.axis_names[0]]
        item_sharded, use_grouped, sizes = self._block_dispatch(
            users, items, n_users, n_items, world, kernel, mesh)
        if not use_grouped:
            plan.downgrade(membudget.ROUTE_IN_MEMORY, "grouped guard rejected the degree "
                           "distribution (COO streaming unsupported)")
            return self._fit_block_parallel(users, items, ratings, n_users, n_items, x0, y0,
                                            mesh, kernel)
        ranks = [q for q in als_block.data_ranks(mesh) if mesh.is_local(q)]
        devs = list(dict.fromkeys(mesh.device(q) for q in ranks))
        pol = psn.resolve("als")
        psn.apply_matmul_flags("highest")
        offsets, bal = self._block_balance(n_users, world, item_sharded)
        timings = Timings("als.fit")
        before = dict(als_kernel.LAUNCHES)
        cache_before = progcache.stats()
        tune_before = autotune.mark()
        with phase_timer(timings, "table_convert", devs):
            lay = als_block_stream.prepare_streamed_block_layouts(
                users, items, ratings, n_users, n_items, mesh, self.rank,
                item_sharded=item_sharded, sizes=sizes, offsets=offsets)
            x0_dev = self._place_block_factors(mesh, lay.offsets_u, lay.upb, x0, self.seed)
            if item_sharded:
                y0_dev = self._place_block_factors(mesh, lay.by_item.offsets, lay.by_item.upb,
                                                   y0, self.seed + 1)
            else:
                y0_host = (y0 if y0 is not None
                           else als_np.init_factors(n_items, self.rank, self.seed + 1))
                staged = {dev: torch.from_numpy(y0_host).to(dev) for dev in devs}
                y0_dev = {q: staged[mesh.device(q)] for q in ranks}
        ckpt = self._open_checkpoint(n_users, n_items, timings)
        with phase_timer(timings, "als_iterations", devs):
            x_blocks, y = als_block_stream.als_block_run_streamed(
                lay, x0_dev, y0_dev, self.max_iter, self.reg_param, self.alpha, mesh,
                implicit=self.implicit_prefs, timings=timings, policy=pol, checkpoint=ckpt)
        summary = self._summary(timings, pol, before, cache_before=cache_before,
                                tune_before=tune_before, extra={
            "streamed": True, "block_parallel": True, "sharded_factors": True,
            "als_kernel": "grouped",
            "item_layout": "sharded" if item_sharded else "replicated",
            "mesh": dict(mesh.shape), "processes": mesh.processes,
            "process_id": mesh.process, "balance": bal, **self._block_summary(world)})
        if ckpt is not None:
            ckpt.record(summary)
        return _sharded_model(x_blocks, y, summary, mesh, ranks, lay.offsets_u, lay.upb,
                              lay.by_item if item_sharded else None)


def _sharded_model(x_blocks, y, summary: dict, mesh: Mesh, ranks, offsets_u, upb: int,
                   by_item) -> ALSModel:
    """A block fit's model on its live layout (the JAX package's): the
    user blocks as ``sharded_user``, the item blocks as ``sharded_item``
    on the 2-D layout (``by_item`` its item-block edges), else the
    replicated item table on the host.  Nothing gathers here."""
    user = als_block.Shard(x_blocks, np.asarray(offsets_u), int(upb), mesh)
    device = str(mesh.device(ranks[0]))
    if by_item is not None:
        item = als_block.Shard(y, np.asarray(by_item.offsets), int(by_item.upb), mesh)
        return ALSModel(None, None, summary, device=device, sharded_user=user, sharded_item=item)
    return ALSModel(None, y[ranks[0]].cpu().numpy(), summary, device=device, sharded_user=user)


def _validate_resolve(users, items, ratings, n_users, n_items):
    """Triple validation and id-space resolution (the JAX package's):
    across processes the id maxima are the world's (one allgather), so
    every process sizes the same factor tables."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    ratings = np.asarray(ratings, dtype=np.float32)
    if not (len(users) == len(items) == len(ratings)):
        raise ValueError("users/items/ratings must have equal length")
    if len(users) == 0:
        raise ValueError("empty ratings")
    if users.min() < 0 or items.min() < 0:
        raise ValueError("ids must be non-negative")
    if bootstrap.world_size() > 1:
        (maxes,) = collective.process_allgather(
            [np.asarray([users.max(), items.max()], np.int64)])
        if n_users is None:
            n_users = int(maxes[:, 0].max()) + 1
        if n_items is None:
            n_items = int(maxes[:, 1].max()) + 1
    if n_users is None:
        n_users = int(users.max()) + 1
    elif int(users.max()) >= n_users:
        raise ValueError(f"user id {int(users.max())} out of range for n_users={n_users}")
    if n_items is None:
        n_items = int(items.max()) + 1
    elif int(items.max()) >= n_items:
        raise ValueError(f"item id {int(items.max())} out of range for n_items={n_items}")
    return users, items, ratings, n_users, n_items
