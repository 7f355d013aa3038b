"""PCA in plain PyTorch around the moments kernel: covariance,
eigendecomposition and projection.  The port of the JAX package's
``ops/pca_ops.py`` (its single-device functions; the model-sharded
covariance is not ported).

:func:`covariance` is the two-pass mean-centered form at every tier: the
mean pass (column sums), then the centered Gram.  The one-pass
raw-moment form ``(X^T X - n mu mu^T) / (n - 1)`` cancels
catastrophically on large-mean data and stays banned, as in the JAX
package.  Both passes run the moments kernel (ops/cuda/pca_kernel).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from oap_mllib_tpu_torch.ops.cuda import pca_kernel
from oap_mllib_tpu_torch.utils import precision as psn


def covariance(x: torch.Tensor, mask: torch.Tensor, n_rows: float,
               precision: str = "highest",
               moments: Callable = pca_kernel.pca_moments
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample covariance (d, d) and mean (d,) of the rows ``mask``
    weighs in.  ``precision`` is the Gram's kernel tier; the column sums
    are f32 at every tier.  ``moments`` is the kernel wrapper; the card
    check passes the plain version to compare fits."""
    _, colsum, _ = moments(x, mask, None, precision, need_gram=False)
    mean = colsum / float(n_rows)
    gram, _, _ = moments(x, mask, mean, precision, need_sums=False)
    cov = gram / max(float(n_rows) - 1.0, 1.0)
    # numerical symmetry guard before eigh, as in the JAX package (the
    # kernel's Gram is bit-symmetric already; the plain one need not be)
    return 0.5 * (cov + cov.T), mean


def eigh_descending(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (descending) and matching eigenvectors (columns) of a
    symmetric matrix."""
    vals, vecs = torch.linalg.eigh(cov)  # ascending
    return torch.flip(vals, dims=(0,)), torch.flip(vecs, dims=(1,))


def project(x: torch.Tensor, components: torch.Tensor,
            policy: str = "f32") -> torch.Tensor:
    """Rows in the component basis: (n, d) @ (d, k).  No mean-centering,
    for Spark parity (Spark's PCAModel.transform does not center)."""
    return psn.pdot(x, components, policy)
