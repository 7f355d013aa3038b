"""ALS estimator with Spark-MLlib-compatible parameters: the port of the
JAX package's ``models/als.py`` (its in-memory, single-device route, in
both feedback modes).

``ALS(...).fit(users, items, ratings)`` builds the grouped or the COO
edge layout (the JAX package's choice, ``_grouped_ok_single``), runs the
alternating half-updates (ops/als_ops.run_sides: moments, the factor-Gram
kernel for implicit feedback, the solve kernel) and returns an
:class:`ALSModel`.  It runs on ``device="cuda"`` unless the caller
passes ``device="cpu"``, where the kernel wrappers take their plain
versions; a missing card raises.  Ids are dense non-negative ints;
n_users / n_items default to max + 1.  Regularisation follows Spark's
ALS-WR convention (lambda x each row's rating count).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.ops import als_ops, kmeans_ops
from oap_mllib_tpu_torch.ops.cuda import als_kernel
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.dispatch import resolve_device
from oap_mllib_tpu_torch.utils.timing import Timings, phase_timer


def _topk_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is (score descending, id ascending): the
    f32 bits mapped to an order-preserving int32, shifted up, and the
    complemented column id below.  ``torch.topk`` on them breaks ties to
    the lowest id, as ``lax.top_k`` does."""
    bits = scores.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    ids = torch.arange(scores.shape[1], device=scores.device, dtype=torch.int64)
    return ordered * (1 << 32) + ((1 << 32) - 1 - ids)


class ALSModel:
    """Trained factors: ``user_factors_`` (n_users, r) and
    ``item_factors_`` (n_items, r), scored on ``device``."""

    def __init__(self, user_factors, item_factors, summary: Optional[dict] = None,
                 device: Optional[str] = None):
        self.user_factors_ = np.asarray(user_factors)
        self.item_factors_ = np.asarray(item_factors)
        self.summary = summary or {}
        # None = Config.device, resolved at the first scoring call
        self.device = device
        self._staged = {}  # id(array) -> (device, tensor)

    @property
    def rank(self) -> int:
        return self.item_factors_.shape[1]

    def _on_device(self, table: np.ndarray) -> torch.Tensor:
        """A factor table on the model's device, staged once per array."""
        dev = resolve_device(self.device)
        hit = self._staged.get(id(table))
        if hit is None or hit[0] != str(dev) or hit[1] is not table:
            hit = (str(dev), table, torch.tensor(np.asarray(table, np.float32), device=dev))
            self._staged[id(table)] = hit
        return hit[2]

    def predict(self, users, items) -> np.ndarray:
        """Predicted preference/rating of (user, item) pairs."""
        x = self._on_device(self.user_factors_)
        y = self._on_device(self.item_factors_)
        u = torch.as_tensor(np.asarray(users, np.int64), device=x.device)
        i = torch.as_tensor(np.asarray(items, np.int64), device=x.device)
        return als_ops.predict_pairs(x, y, u, i).cpu().numpy()

    def _top_k_scores(self, query, targets: np.ndarray, n: int,
                      with_scores: bool = True):
        """Top-n (ids, scores) per query row, chunked over query rows so
        the (rows, n_targets) score block stays bounded.  ``n`` is
        clamped to the target count; ties go to the lowest id."""
        if n < 0:
            raise ValueError(f"top-k count must be >= 0, got {n}")
        n = min(int(n), targets.shape[0])
        nq = query.shape[0]
        if nq == 0 or n == 0:
            return (np.zeros((nq, n), np.int32),
                    np.zeros((nq, n), np.float32) if with_scores else None)
        t = self._on_device(targets)
        # scores (4 bytes) and keys (8 bytes) per element: budget x 1/3
        rows = max(1, kmeans_ops.rows_per_chunk(targets.shape[0], query.shape[1]) // 3)
        ids, scores = [], []
        for lo in range(0, nq, rows):
            q = query[lo:lo + rows]
            q = q.to(t.device) if isinstance(q, torch.Tensor) else torch.as_tensor(
                np.asarray(q, np.float32)).to(t.device)
            s = q @ t.T
            idx = torch.topk(_topk_keys(s), n, dim=1).indices
            ids.append(idx.to(torch.int32).cpu().numpy())
            if with_scores:
                scores.append(s.gather(1, idx).cpu().numpy())
        return (np.concatenate(ids), np.concatenate(scores) if with_scores else None)

    def recommend_for_all_users(self, num_items: int, with_scores: bool = False):
        """Top-N item ids per user (with ``with_scores``, the (ids, scores)
        pair, scores descending)."""
        ids, scores = self._top_k_scores(
            self._on_device(self.user_factors_), self.item_factors_, num_items,
            with_scores)
        return (ids, scores) if with_scores else ids

    def recommend_for_all_items(self, num_users: int, with_scores: bool = False):
        """Top-N user ids per item."""
        ids, scores = self._top_k_scores(
            self._on_device(self.item_factors_), self.user_factors_, num_users,
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
        table = self._on_device(query_table)
        q = table[torch.as_tensor(query_ids, device=table.device)]
        ids, scores = self._top_k_scores(q, target_table, n, with_scores)
        return (ids, scores) if with_scores else ids

    def recommend_for_users(self, user_ids, num_items: int, with_scores: bool = False):
        """Top-N item ids for a subset of users; row j is for user_ids[j]."""
        return self._recommend_subset(user_ids, self.user_factors_,
                                      self.item_factors_, num_items, with_scores, "user")

    def recommend_for_items(self, item_ids, num_users: int, with_scores: bool = False):
        """Top-N user ids for a subset of items; row j is for item_ids[j]."""
        return self._recommend_subset(item_ids, self.item_factors_,
                                      self.user_factors_, num_users, with_scores, "item")

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


def _grouped_ok_single(kernel: str, users, items, n_users: int, n_items: int) -> bool:
    """Grouped-vs-COO decision (the JAX package's rule): "auto" takes the
    grouped layout unless its padded edges exceed GROUPED_MAX_BLOWUP x
    nnz."""
    if kernel != "auto":
        return kernel == "grouped"
    padded = (als_ops.grouped_padded_edges(users, n_users)
              + als_ops.grouped_padded_edges(items, n_items))
    return padded <= als_ops.GROUPED_MAX_BLOWUP * max(len(users), 1)


def _als_kernel_cfg() -> str:
    kernel = get_config().als_kernel
    if kernel not in ("auto", "grouped", "coo"):
        raise ValueError(f"als_kernel must be auto|grouped|coo, got {kernel!r}")
    return kernel


class ALS:
    """ALS estimator.  Param parity with Spark ML ALS defaults: rank=10,
    max_iter=10, reg_param=0.1, implicit_prefs=False, alpha=1.0; ``seed``
    None takes ``Config.seed``; ``device`` None takes ``Config.device``
    ("cuda")."""

    def __init__(self, rank: int = 10, max_iter: int = 10, reg_param: float = 0.1,
                 implicit_prefs: bool = False, alpha: float = 1.0,
                 seed: Optional[int] = None, nonnegative: bool = False,
                 device: Optional[str] = None):
        if rank < 1:
            raise ValueError("rank must be >= 1")
        if max_iter < 0:
            raise ValueError("max_iter must be >= 0")
        if reg_param < 0:
            raise ValueError("reg_param must be >= 0")
        if alpha < 0:
            raise ValueError("alpha must be >= 0")
        if nonnegative:
            raise NotImplementedError(
                "nonnegative=True (the NNLS solve) is not ported yet "
                "(ROADMAP A3, nonnegative ALS)"
            )
        self.rank = rank
        self.max_iter = max_iter
        self.reg_param = reg_param
        self.implicit_prefs = implicit_prefs
        self.alpha = alpha
        self.seed = get_config().seed if seed is None else seed
        self.device = device

    def fit(self, users, items, ratings, n_users: Optional[int] = None,
            n_items: Optional[int] = None, init: Optional[tuple] = None) -> ALSModel:
        """Fit factors from (user, item, rating) triples.  ``init`` is an
        optional (x0, y0) pair of initial factors."""
        users, items, ratings, n_users, n_items = _validate_resolve(
            users, items, ratings, n_users, n_items)
        kernel = _als_kernel_cfg()
        dev = resolve_device(self.device)
        pol = psn.resolve("als")
        # the Grams and solves are f32 under every policy, and the moment
        # products' f32 (and bf16-split) operands need TF32 off
        psn.apply_matmul_flags("highest")
        timings = Timings("als.fit")
        before = dict(als_kernel.LAUNCHES)
        if init is not None:
            x0, y0 = np.array(init[0], np.float32), np.array(init[1], np.float32)
            if x0.shape != (n_users, self.rank) or y0.shape != (n_items, self.rank):
                raise ValueError(
                    f"init factors have shapes {x0.shape} and {y0.shape}, the fit "
                    f"needs ({n_users}, {self.rank}) and ({n_items}, {self.rank})"
                )
        else:
            x0 = als_np.init_factors(n_users, self.rank, self.seed)
            y0 = als_np.init_factors(n_items, self.rank, self.seed + 1)
        with phase_timer(timings, "table_convert", dev):
            grouped = _grouped_ok_single(kernel, users, items, n_users, n_items)
            user_side, item_side = als_ops.prepare_sides(
                grouped, users, items, ratings, n_users, n_items, self.rank, dev)
            x0, y0 = torch.from_numpy(x0).to(dev), torch.from_numpy(y0).to(dev)
        with phase_timer(timings, "als_iterations", dev):
            x, y = als_ops.run_sides(
                user_side, item_side, x0, y0, self.max_iter, self.reg_param,
                self.alpha if self.implicit_prefs else 0.0, self.implicit_prefs, pol,
            )
            x, y = x.cpu().numpy(), y.cpu().numpy()
        summary = {
            "timings": timings,
            "accelerated": True,
            "als_kernel": "grouped" if grouped else "coo",
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
        return ALSModel(x, y, summary, device=self.device)


def _validate_resolve(users, items, ratings, n_users, n_items):
    """Triple validation and id-space resolution (the JAX package's, for
    one process)."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    ratings = np.asarray(ratings, dtype=np.float32)
    if not (len(users) == len(items) == len(ratings)):
        raise ValueError("users/items/ratings must have equal length")
    if len(users) == 0:
        raise ValueError("empty ratings")
    if users.min() < 0 or items.min() < 0:
        raise ValueError("ids must be non-negative")
    if n_users is None:
        n_users = int(users.max()) + 1
    elif int(users.max()) >= n_users:
        raise ValueError(f"user id {int(users.max())} out of range for n_users={n_users}")
    if n_items is None:
        n_items = int(items.max()) + 1
    elif int(items.max()) >= n_items:
        raise ValueError(f"item id {int(items.max())} out of range for n_items={n_items}")
    return users, items, ratings, n_users, n_items
