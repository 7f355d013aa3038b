"""PCA in plain PyTorch around the moments kernel: covariance on one
device and on a mesh and the eigendecomposition (the projection is the
serving batcher's, serving/batcher.project_pca).  The port of
the JAX package's ``ops/pca_ops.py``.

:func:`covariance` is the two-pass mean-centered form at every tier: the
mean pass (column sums), then the centered Gram.  The one-pass
raw-moment form ``(X^T X - n mu mu^T) / (n - 1)`` cancels
catastrophically on large-mean data and stays banned for the fits, as
in the JAX package (online/ipca.py takes it on purpose).  Both passes run the moments kernel (ops/cuda/pca_kernel).

On a mesh (parallel/mesh.py), as the JAX package computes on its:

- :func:`covariance_data_parallel` (model axis 1): each rank runs both
  passes of the kernel on its rows, the column sums psum-ed into the
  global mean before the Gram pass, the Grams psum-ed after it, over
  the data axis in rank order;
- :func:`covariance_model_sharded` (model axis above 1): the JAX
  package's model-sharded program, step for step: column sums psum-ed
  over the data axis, the centred column tiles all-gathered over the
  model axis, a (d_loc, n_loc) x (n_loc, d) product (a library call in
  both packages: this route launches no kernel), psum-ed over the data
  axis.

Either returns the (d, d) covariance on the mesh's first device, where
the eigensolve runs.  Across processes (a mesh whose ranks span them,
parallel/mesh.py) each process runs its own ranks, the psums reach the
other processes' ranks and every process returns the covariance on its
first rank's device.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from oap_mllib_tpu_torch.ops.cuda import autotune, pca_kernel
from oap_mllib_tpu_torch.parallel import collective
from oap_mllib_tpu_torch.parallel.mesh import Mesh, Rank
from oap_mllib_tpu_torch.utils import progcache
from oap_mllib_tpu_torch.utils import precision as psn


def tuned_moments(d: int, precision: str, device) -> Callable:
    """K2's wrapper at the geometry the autotuner resolves for width ``d``
    at ``precision`` (ops/cuda/autotune.py, the same on every process)."""
    geometry = autotune.resolve_world("pca", autotune.shape_bucket(d), precision, device)
    return functools.partial(pca_kernel.pca_moments, geometry=geometry)


def covariance(x: torch.Tensor, mask: torch.Tensor, n_rows: float,
               precision: str = "highest", moments: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample covariance (d, d) and mean (d,) of the rows ``mask``
    weighs in.  ``precision`` is the Gram's kernel tier; the column sums
    are f32 at every tier.  ``moments`` is the kernel wrapper, None for
    :func:`tuned_moments`; the card check passes the plain version to
    compare fits.  Each pass is the ``fit.execute`` fault site
    (utils/faults.py), as on the mesh, and one launch of its program
    (utils/progcache.py)."""
    if moments is None:
        moments = tuned_moments(x.shape[1], precision, x.device)
    key = (progcache.array_key(x, mask), precision)
    progcache.count_launch("pca.mean_pass", key)
    _, colsum, _ = moments(x, mask, None, precision, need_gram=False)
    mean = colsum / float(n_rows)
    progcache.count_launch("pca.gram_pass", key)
    gram, _, _ = moments(x, mask, mean, precision, need_sums=False)
    cov = gram / max(float(n_rows) - 1.0, 1.0)
    # numerical symmetry guard before eigh, as in the JAX package (the
    # kernel's Gram is bit-symmetric already; the plain one need not be)
    return 0.5 * (cov + cov.T), mean


def covariance_data_parallel(x: Dict[Rank, torch.Tensor], mask: Dict[Rank, torch.Tensor],
                             n_rows: float, mesh: Mesh, precision: str = "highest",
                             moments: Optional[Callable] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`covariance` of row tiles on a mesh whose model axis is 1:
    the mean pass on every rank, its column sums psum-ed over the data
    axis into the global mean, then the centred Gram pass on every rank
    with that mean, the Grams psum-ed.  Two kernel launches a rank.
    Returns ``(cov, mean)`` on the first rank's device."""
    dax = mesh.axis_names[0]
    if mesh.shape[mesh.axis_names[1]] != 1:
        raise ValueError(f"the data-parallel covariance runs on a model axis of 1, got {mesh.shape}")
    if moments is None:
        first = mesh.local_ranks[0]
        moments = tuned_moments(x[first].shape[1], precision, mesh.device(first))
    key = (progcache.mesh_fingerprint(mesh), progcache.array_key(x), precision)
    progcache.count_launch("pca.mean_pass_data_parallel", key)
    colsum = collective.psum(
        {r: moments(x[r], mask[r], None, precision, need_gram=False)[1] for r in mesh.local_ranks},
        mesh, dax)
    mean = {r: colsum[r] / float(n_rows) for r in mesh.local_ranks}
    progcache.count_launch("pca.gram_pass_data_parallel", key)
    gram = collective.psum(
        {r: moments(x[r], mask[r], mean[r], precision, need_sums=False)[0] for r in mesh.local_ranks},
        mesh, dax)
    first = mesh.local_ranks[0]
    cov = gram[first] / max(float(n_rows) - 1.0, 1.0)
    return 0.5 * (cov + cov.T), mean[first]


def covariance_model_sharded(x: Dict[Rank, torch.Tensor], mask: Dict[Rank, torch.Tensor],
                             n_rows: float, mesh: Mesh, precision: str = "highest",
                             policy: str = "f32") -> Tuple[torch.Tensor, torch.Tensor]:
    """Covariance with the (d, d) accumulation sharded over the model
    axis (the JAX package's ``covariance_model_sharded``): rank (i, j)
    holds the (n_loc, d_loc) tile of row shard i and feature shard j,
    ``d`` a multiple of the model axis (the caller zero-pads and demotes
    the padding with :func:`mark_padded_features`).  Each rank forms its
    (d_loc, d) rows of the Gram from the model axis' gathered centred
    columns; no rank holds more.  Returns ``(cov (d, d), mean (d,))`` on
    the first rank's device, symmetrised."""
    dax, max_ = mesh.axis_names
    key = (progcache.mesh_fingerprint(mesh), progcache.array_key(x), precision, policy)
    progcache.count_launch("pca.mean_pass_model_sharded", key)
    col_sum = collective.psum(
        {r: torch.sum(x[r] * mask[r][:, None], dim=0) for r in mesh.local_ranks}, mesh, dax)
    mean = {r: col_sum[r] / float(n_rows) for r in mesh.local_ranks}
    progcache.count_launch("pca.gram_pass_model_sharded", key)
    xc = {r: (x[r] - mean[r][None, :]) * mask[r][:, None] for r in mesh.local_ranks}
    xc_full = collective.all_gather(xc, mesh, max_, dim=1)  # (n_loc, d) a rank
    rows = collective.psum(
        {r: psn.pdot(xc[r].T, xc_full[r], policy, precision) for r in mesh.local_ranks}, mesh, dax)
    del xc, xc_full
    row = mesh.local_ranks[0][0]  # a row of ranks holds every feature block
    first = mesh.device((row, 0))
    n_model = mesh.shape[max_]
    cov = torch.cat([rows[(row, j)].to(first) for j in range(n_model)], dim=0)
    cov = cov / max(float(n_rows) - 1.0, 1.0)
    full_mean = torch.cat([mean[(row, j)].to(first) for j in range(n_model)])
    return 0.5 * (cov + cov.T), full_mean


def mark_padded_features(cov: torch.Tensor, d_valid: int) -> torch.Tensor:
    """The diagonal of the padded feature dims set to -1, so their
    eigenvalues sort below every genuine one (>= 0 up to roundoff) and a
    padded axis never enters the top k; the JAX package's function."""
    cov = cov.clone()
    idx = torch.arange(d_valid, cov.shape[0], device=cov.device)
    cov[idx, idx] = -1.0
    return cov


def eigh_descending(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (descending) and matching eigenvectors (columns) of a
    symmetric matrix."""
    vals, vecs = torch.linalg.eigh(cov)  # ascending
    return torch.flip(vals, dims=(0,)), torch.flip(vecs, dims=(1,))


def topk_eigh_randomized(cov: torch.Tensor, k: int, oversample: int = 16,
                         iters: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k eigenpairs of a symmetric positive semi-definite matrix by
    randomized subspace iteration (Halko, Martinsson, Tropp), the JAX
    package's ``topk_eigh_randomized``: a probe of ``p = min(d, k +
    oversample)`` columns, QR'd; ``iters`` times ``q = qr(cov @ q)``;
    then the (p, p) eigh of ``q^T cov q``, descending.  Returns
    ``(vals (k,), vecs (d, k))``.

    Each Ritz value closes on its eigenvalue like (lambda_p /
    lambda_i)^(2 iters): a decaying spectrum matches eigh to ~1e-4 at
    the defaults, a flat one is biased low and its top vectors are not
    defined.  The probe draws from a ``torch.Generator`` seeded with 0
    (on the CPU, then moved): the same covariance gives the same
    result, though not the JAX package's bits (its probe is a
    ``jax.random`` draw).  The products are ``torch.matmul`` at f32 and
    the QR ``torch.linalg.qr``: the JAX package computes them outside
    any kernel too."""
    d = cov.shape[0]
    p = min(d, k + oversample)
    gen = torch.Generator().manual_seed(0)
    probe = torch.randn((d, p), generator=gen, dtype=cov.dtype).to(cov.device)
    q, _ = torch.linalg.qr(probe)
    for _ in range(iters):
        q, _ = torch.linalg.qr(torch.matmul(cov, q))  # re-orthonormalise every step
    b = torch.matmul(q.T, torch.matmul(cov, q))
    w, v = torch.linalg.eigh(0.5 * (b + b.T))  # ascending
    w = torch.flip(w, dims=(0,))[:k]
    v = torch.flip(v, dims=(1,))[:, :k]
    return w, torch.matmul(q, v)
