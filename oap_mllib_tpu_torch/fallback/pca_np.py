"""NumPy PCA: a copy of the JAX package's ``fallback/pca_np.py`` (the
vanilla ``mllib.feature.PCA`` analog).  The port runs no numpy route of
its own; this is the oracle the tests and ``chip_smoke.py`` hold the
fit against."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pca_np(x: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (components (d, k), explained_variance_ratio (k,)).

    Covariance eigendecomposition, matching Spark's
    RowMatrix.computePrincipalComponentsAndExplainedVariance semantics:
    ratios normalized by the TOTAL variance (sum over all d eigenvalues).
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    mean = x.mean(axis=0)
    xc = x - mean
    cov = (xc.T @ xc) / max(n - 1, 1)
    vals, vecs = np.linalg.eigh(cov)
    vals = vals[::-1]
    vecs = vecs[:, ::-1]
    total = vals.sum()
    ratio = vals[:k] / total if total > 0 else np.zeros(k)
    return vecs[:, :k], ratio
