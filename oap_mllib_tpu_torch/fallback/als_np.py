"""NumPy ALS: a copy of the JAX package's ``fallback/als_np.py``.

``init_factors`` / ``init_factors_rows`` are the deterministic factor
init every fit starts from (bit-identical to the JAX package's);
``als_np`` is the oracle of the tests, and the route of
``ALS(nonnegative=True)``, whose per-row solve is the NNLS of
:func:`_nnls_spd` (Spark's ``nonnegative=true``).

Covers both explicit ALS (the case the reference's DAL path declines —
accelerated only when implicitPrefs, spark-3.1.1/ml/recommendation/
ALS.scala:925) and implicit-feedback ALS (Hu/Koren/Volinsky), the
algorithm the reference accelerates via oneDAL's 4-step distributed scheme
(native/ALSDALImpl.cpp).

Normal equations (rank r, regularization lambda, confidence c = 1 + alpha*r):
  implicit:  A_u = Y^T Y + sum_{i in R(u)} alpha*r_ui * y_i y_i^T + lambda I
             b_u = sum_{i in R(u)} (1 + alpha*r_ui) * y_i
  explicit:  A_u = sum_{i in R(u)} y_i y_i^T + lambda I
             b_u = sum_{i in R(u)} r_ui * y_i
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


_U64 = np.uint64


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 hash on uint64 arrays (wraps mod 2^64)."""
    x = (x + _U64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def init_factors_rows(lo: int, hi: int, rank: int, seed: int) -> np.ndarray:
    """Rows [lo, hi) of the deterministic factor init, position-addressable.

    Counter-based (splitmix64 per element + Box-Muller), so a process can
    generate ONLY its block's rows and get bit-identical values to the
    global ``init_factors`` — the sharded multi-host ALS init never
    materializes (n_users, rank) on any host (the per-rank init the
    reference gets from per-rank seed offsets, ALSDALImpl.cpp:165-169,
    but reproducible across world sizes).  Rows are signed gaussian,
    normalized to unit L2 norm (Spark ALS.initialize style; all-positive
    init is a trap — it sits in a positive-orthant local minimum for
    signed low-rank data).
    """
    rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
    cols = np.arange(rank, dtype=np.uint64)[None, :]
    idx = rows * _U64(rank) + cols
    base = _splitmix64(np.uint64(np.int64(seed)).reshape(1, 1))
    h1 = _splitmix64(idx ^ base)
    h2 = _splitmix64(h1)
    # 53-bit mantissa uniforms in (0, 1]; Box-Muller to gaussians
    u1 = ((h1 >> _U64(11)).astype(np.float64) + 1.0) * (2.0 ** -53)
    u2 = (h2 >> _U64(11)).astype(np.float64) * (2.0 ** -53)
    f = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    norms = np.linalg.norm(f, axis=1, keepdims=True)
    return (f / np.maximum(norms, 1e-12)).astype(np.float32)


def init_factors(n: int, rank: int, seed: int) -> np.ndarray:
    """Deterministic factor init for rows [0, n) — see init_factors_rows."""
    return init_factors_rows(0, n, rank, seed)


def _nnls_spd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Nonnegative solve of the SPD normal-equation system a x = b
    (min x^T a x - 2 b^T x s.t. x >= 0) — Spark's nonnegative=true NNLS
    analog.  Reduced to standard NNLS via the Cholesky factor:
    a = L L^T  =>  min ||L^T x - L^{-1} b||."""
    try:
        from scipy.optimize import nnls

        l = np.linalg.cholesky(a)
        d = np.linalg.solve(l, b)
        x, _ = nnls(l.T, d)
        return x
    except ImportError:
        # crude fallback: projected gradient on the quadratic
        x = np.maximum(np.linalg.solve(a, b), 0.0)
        step = 1.0 / np.linalg.eigvalsh(a).max()
        for _ in range(200):
            x = np.maximum(x - step * (a @ x - b), 0.0)
        return x


def _solve_side(
    dst_n: int,
    dst_idx: np.ndarray,
    src_idx: np.ndarray,
    ratings: np.ndarray,
    src_factors: np.ndarray,
    rank: int,
    reg: float,
    alpha: float,
    implicit: bool,
    nonnegative: bool = False,
) -> np.ndarray:
    out = np.zeros((dst_n, rank), dtype=np.float32)
    eye = np.eye(rank, dtype=np.float64)
    gram = src_factors.astype(np.float64).T @ src_factors.astype(np.float64) if implicit else None
    order = np.argsort(dst_idx, kind="stable")
    dst_sorted = dst_idx[order]
    bounds = np.searchsorted(dst_sorted, np.arange(dst_n + 1))
    for u in range(dst_n):
        sel = order[bounds[u] : bounds[u + 1]]
        if len(sel) == 0:
            continue
        ys = src_factors[src_idx[sel]].astype(np.float64)  # (m, r)
        rs = ratings[sel].astype(np.float64)  # (m,)
        # Spark parity (reference ALS.scala:1781-1795): implicit uses
        # c1 = alpha*|r| for A (PSD even for non-positive ratings), adds b
        # only for r > 0, and ALS-WR scales lambda by the per-row rating
        # count (numExplicits * regParam) — r > 0 count for implicit,
        # all-ratings count for explicit
        if implicit:
            c1 = alpha * np.abs(rs)
            pos = rs > 0
            n_reg = float(pos.sum())
            a = gram + ys.T @ (ys * c1[:, None]) + reg * n_reg * eye
            b = ((1.0 + c1)[:, None] * ys)[pos].sum(axis=0)
            if n_reg == 0.0:
                continue  # no positive ratings: zero factors (b == 0)
        else:
            n_reg = float(len(sel))
            a = ys.T @ ys + reg * n_reg * eye
            b = (rs[:, None] * ys).sum(axis=0)
        if nonnegative:
            out[u] = _nnls_spd(a, b).astype(np.float32)
        else:
            out[u] = np.linalg.solve(a, b).astype(np.float32)
    return out


def als_np(
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    rank: int = 10,
    max_iter: int = 10,
    reg: float = 0.1,
    alpha: float = 1.0,
    implicit: bool = False,
    seed: int = 0,
    init: Tuple[np.ndarray, np.ndarray] = None,
    nonnegative: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Alternating updates; returns (user_factors, item_factors)."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    ratings = np.asarray(ratings, dtype=np.float32)
    if init is not None:
        x, y = np.array(init[0], np.float32), np.array(init[1], np.float32)
    else:
        x = init_factors(n_users, rank, seed)
        y = init_factors(n_items, rank, seed + 1)
        if nonnegative:
            x, y = np.abs(x), np.abs(y)
    for _ in range(max_iter):
        x = _solve_side(n_users, users, items, ratings, y, rank, reg, alpha,
                        implicit, nonnegative)
        y = _solve_side(n_items, items, users, ratings, x, rank, reg, alpha,
                        implicit, nonnegative)
    return x, y


def predict_np(x: np.ndarray, y: np.ndarray, users: np.ndarray, items: np.ndarray) -> np.ndarray:
    return np.sum(x[users] * y[items], axis=1)


def rmse_np(x, y, users, items, ratings) -> float:
    pred = predict_np(x, y, users, items)
    return float(np.sqrt(np.mean((pred - ratings) ** 2)))
