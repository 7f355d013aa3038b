"""NumPy K-Means (Lloyd) — fallback path.

Supports euclidean and cosine distance and row weights, matching what
vanilla Spark MLlib handles when the reference's DAL path declines
(spark-3.1.1/ml/clustering/KMeans.scala:349-351).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _normalize(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def _sq_dists(x: np.ndarray, centers: np.ndarray, measure: str) -> np.ndarray:
    if measure == "euclidean":
        x_sq = np.sum(x * x, axis=1, keepdims=True)
        c_sq = np.sum(centers * centers, axis=1)
        return np.maximum(x_sq + c_sq[None, :] - 2.0 * x @ centers.T, 0.0)
    elif measure == "cosine":
        # Spark's cosine distance: 1 - cos similarity
        return 1.0 - _normalize(x) @ _normalize(centers).T
    raise ValueError(f"unknown distance measure {measure!r}")


def lloyd_np(
    x: np.ndarray,
    init_centers: np.ndarray,
    max_iter: int,
    tol: float,
    weights: Optional[np.ndarray] = None,
    distance_measure: str = "euclidean",
) -> Tuple[np.ndarray, int, float]:
    """Returns (centers, n_iter, cost). Same convergence rule as the
    accelerated kernel: all centers' squared moves <= tol^2."""
    w = np.ones(x.shape[0]) if weights is None else np.asarray(weights, dtype=x.dtype)
    centers = np.array(init_centers, dtype=x.dtype)
    k = centers.shape[0]
    n_iter = 0
    for _ in range(max_iter):
        d2 = _sq_dists(x, centers, distance_measure)
        assign = np.argmin(d2, axis=1)
        new_centers = centers.copy()
        for j in range(k):
            sel = assign == j
            wj = w[sel]
            if wj.sum() > 0:
                pts = x[sel]
                if distance_measure == "cosine":
                    # Spark averages then re-normalizes for cosine
                    c = (pts * wj[:, None]).sum(axis=0) / wj.sum()
                    nrm = np.linalg.norm(c)
                    new_centers[j] = c / nrm if nrm > 0 else c
                else:
                    new_centers[j] = (pts * wj[:, None]).sum(axis=0) / wj.sum()
        moved_sq = np.sum((new_centers - centers) ** 2, axis=1)
        centers = new_centers
        n_iter += 1
        if np.all(moved_sq <= tol * tol):
            break
    d2 = _sq_dists(x, centers, distance_measure)
    cost = float(np.sum(np.min(d2, axis=1) * w))
    return centers, n_iter, cost


def predict_np(
    x: np.ndarray, centers: np.ndarray, distance_measure: str = "euclidean"
) -> np.ndarray:
    return np.argmin(_sq_dists(x, centers, distance_measure), axis=1)
