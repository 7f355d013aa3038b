"""Carry fitted parameters over from the JAX package.

The two packages share the on-disk model format, so
``KMeansModel.load`` reads a directory that
``oap_mllib_tpu.models.kmeans.KMeansModel.save`` wrote, and the JAX
package loads one this package wrote.  In memory, the JAX model's
parameters are plain numpy arrays (``cluster_centers_``), which
:func:`kmeans_model_from_arrays` takes as they are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from oap_mllib_tpu_torch.models.kmeans import KMeansModel


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
