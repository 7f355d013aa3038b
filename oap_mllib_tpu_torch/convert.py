"""Carry fitted parameters over from the JAX package.

The two packages share the on-disk model format, so each port model's
``load`` reads a directory that the JAX package's model of the same name
saved, and the JAX package loads one this package wrote.  In memory, the
JAX models' parameters are plain numpy arrays (``cluster_centers_``;
``components_`` and ``explained_variance_``; ``user_factors_`` and
``item_factors_``), which the functions below take as they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from oap_mllib_tpu_torch.models.als import ALSModel
from oap_mllib_tpu_torch.models.kmeans import KMeansModel
from oap_mllib_tpu_torch.models.pca import PCAModel


def kmeans_model_from_arrays(centers: np.ndarray,
                             distance_measure: str = "euclidean",
                             device: Optional[str] = None) -> KMeansModel:
    """A port model from (k, d) centers (e.g. a JAX model's
    ``cluster_centers_``), scoring on ``device``."""
    centers = np.asarray(centers)
    if centers.ndim != 2:
        raise ValueError(f"centers must be (k, d), got shape {centers.shape}")
    if distance_measure not in ("euclidean", "cosine"):
        raise ValueError("distance_measure must be 'euclidean' or 'cosine'")
    return KMeansModel(centers, distance_measure, device=device)


def pca_model_from_arrays(components: np.ndarray, explained_variance: np.ndarray,
                          device: Optional[str] = None) -> PCAModel:
    """A port model from (d, k) components and (k,) variance ratios (a
    JAX model's ``components_`` and ``explained_variance_``)."""
    components = np.asarray(components)
    explained_variance = np.asarray(explained_variance)
    if components.ndim != 2:
        raise ValueError(f"components must be (d, k), got shape {components.shape}")
    if explained_variance.shape != (components.shape[1],):
        raise ValueError(
            f"explained_variance must be ({components.shape[1]},), got "
            f"shape {explained_variance.shape}"
        )
    return PCAModel(components, explained_variance, device=device)


def als_model_from_arrays(user_factors: np.ndarray, item_factors: np.ndarray,
                          device: Optional[str] = None) -> ALSModel:
    """A port model from (n_users, r) and (n_items, r) factors (a JAX
    model's ``user_factors_`` and ``item_factors_``)."""
    user_factors, item_factors = np.asarray(user_factors), np.asarray(item_factors)
    if user_factors.ndim != 2 or item_factors.ndim != 2 or (
            user_factors.shape[1] != item_factors.shape[1]):
        raise ValueError(
            f"factors must be (n, r) of one rank, got {user_factors.shape} "
            f"and {item_factors.shape}"
        )
    return ALSModel(user_factors, item_factors, device=device)
