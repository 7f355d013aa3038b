"""Incremental PCA: streamed raw moments, the spectrum solved at commit
(the port of the JAX package's ``online/ipca.py``).

The batch streamed fit (stream_ops.covariance_streamed) makes two
passes because it centres the Gram on the final mean, which an
incremental fit never sees.  This class accumulates the RAW (uncentred)
second moment and the column sums instead, one launch of the moments
kernel (K2, ops/cuda/pca_kernel.pca_moments, mean zero) a chunk giving
both, and folds them across chunks and deltas with Kahan compensation
(stream_ops._kahan_add), so the summation error stays bounded however
many deltas arrive.  Centring is algebraic, at commit time, in float64:

    cov = (G_raw - colsum colsum^T / n) / max(n - 1, 1)

symmetrised ``0.5 (cov + cov^T)``, then the batch estimator's own
spectrum solve (``PCA._finish``: the full eigh or the randomized top-k,
per ``Config.pca_solver``).  The JAX package bans this one-pass
raw-moment form for the batch fit (its ``ops/pallas/pca_kernel.py``
docstring: cancellation against a large mean), and uses it here on
purpose, as this port does: an incremental fit has no second pass.  A
table whose mean is large against its spread loses accuracy to that
cancellation.

Compute-then-swap at both levels: ``partial_fit`` accumulates into fresh
device buffers and stores the host state back only after the whole
delta succeeded (the ``delta.ingest`` fault site fires before any of
it), and ``commit`` replaces the published :class:`PCAModel`'s arrays
only after the solve; later commits replace them on the SAME model
object, so a served handle re-pins in place.

On the x64 parity lane (``Config.enable_x64``) the chunks stage at
float64, K2 runs its float64 form, the running moments are float64 and
the commit solves the f64 covariance (a stated departure: the JAX
package's commit solves in f32, and its moments, built outside an x64
scope, are f32 too).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.online import delta
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.faults import maybe_fault
from oap_mllib_tpu_torch.utils.timing import Timings


class IncrementalPCA:
    """Streaming PCA: ``partial_fit`` deltas fold into compensated raw
    moments on ``device`` (None: ``Config.device``); ``commit`` solves the
    spectrum and publishes (or updates in place) a
    :class:`~oap_mllib_tpu_torch.models.pca.PCAModel`."""

    def __init__(self, k: int, device: Optional[str] = None):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.device = device
        self._d: Optional[int] = None
        # host accumulators (value and Kahan compensation), swapped whole
        # at the end of each successful delta
        self._gram = self._gcomp = None
        self._colsum = self._ccomp = None
        self._n = 0.0
        self._commits = 0
        self.model = None  # the published PCAModel after the first commit

    def partial_fit(self, x) -> "IncrementalPCA":
        """Fold one delta (an array or a ``ChunkSource``) into the raw
        moments: K2 once a chunk, no eigensolve."""
        from oap_mllib_tpu_torch.data.prefetch import PrefetchStats
        from oap_mllib_tpu_torch.data.stream import ChunkSource
        from oap_mllib_tpu_torch.ops import stream_ops
        from oap_mllib_tpu_torch.ops.cuda import pca_kernel
        from oap_mllib_tpu_torch.utils.dispatch import resolve_device

        # before any accumulation: the running moments stay as they were
        maybe_fault("delta.ingest")
        if not isinstance(x, ChunkSource):
            x = ChunkSource.from_array(np.atleast_2d(np.asarray(x)))
        d = x.n_features
        if self._d is not None and d != self._d:
            raise ValueError(
                f"partial_fit chunk width {d} != accumulated dimensionality {self._d}")
        cfg = get_config()
        pol = psn.resolve("pca")
        tier = psn.kernel_tier(pol, cfg.matmul_precision, "pca")
        dev = resolve_device(self.device)

        # the running moments in the fit's dtype (float64 on the x64 lane,
        # the JAX package's ipca.py)
        dtype = psn.compute_dtype("pca", cfg)

        def fresh(host, shape):
            if host is None:
                return torch.zeros(shape, dtype=dtype, device=dev)
            return torch.tensor(host, dtype=dtype, device=dev)

        g, gc = fresh(self._gram, (d, d)), fresh(self._gcomp, (d, d))
        cs, cc = fresh(self._colsum, (d,)), fresh(self._ccomp, (d,))
        rows = 0
        with stream_ops._staged_chunks(x, None, dev, PrefetchStats(),
                                       psn.staging_dtype(pol)) as pf:
            for (_, n_valid, _), (xc, w) in pf:
                # the raw moments: mean zero, centring at commit
                gram, colsum, _ = pca_kernel.pca_moments(stream_ops._operand(xc), w, None, tier)
                stream_ops._kahan_add(cs, cc, colsum)
                stream_ops._kahan_add(g, gc, gram)
                rows += n_valid
        # compute-then-swap of the accumulator state
        self._gram, self._gcomp = g.cpu().numpy(), gc.cpu().numpy()
        self._colsum, self._ccomp = cs.cpu().numpy(), cc.cpu().numpy()
        self._d = d
        self._n += rows
        _tm.counter(
            "oap_online_delta_rows_total", {"model": "pca"},
            help="Rows ingested by incremental-fit deltas.",
        ).inc(rows)
        return self

    def _covariance(self) -> np.ndarray:
        """The centred, symmetrised float64 covariance of the rows so far."""
        n = self._n
        colsum = np.asarray(self._colsum, np.float64)
        gram = np.asarray(self._gram, np.float64)
        cov = (gram - np.outer(colsum, colsum) / n) / max(n - 1.0, 1.0)
        return 0.5 * (cov + cov.T)

    def commit(self):
        """Solve the spectrum of the moments so far and publish it: the
        first commit creates the PCAModel, later ones replace its
        component and variance arrays on the same object.  Returns the
        model."""
        from oap_mllib_tpu_torch.models.pca import PCA, PCAModel, _pca_solver_cfg
        from oap_mllib_tpu_torch.ops.cuda import pca_kernel
        from oap_mllib_tpu_torch.utils.dispatch import resolve_device

        if self._n <= 0 or self._gram is None:
            raise ValueError("commit() before any partial_fit delta — nothing to solve")
        d = int(self._d)
        if self.k > d:
            raise ValueError(f"k={self.k} exceeds data dimensionality {d}")
        solver = _pca_solver_cfg()
        dev = resolve_device(self.device)
        timings = Timings("pca.commit")
        # solved in the fit's dtype: float64 on the x64 lane (the JAX
        # package solves its commit in f32 even there; the port keeps the
        # f64 covariance through the eigensolve)
        cov = torch.as_tensor(self._covariance()).to(dev, psn.compute_dtype("pca"))
        solved = PCA(self.k, device=self.device)._finish(
            cov, d, timings, dev, solver, psn.resolve("pca"), dict(pca_kernel.LAUNCHES),
            self.device)
        self._commits += 1
        n = int(self._n)
        online = {"n_rows": n, "commits": self._commits, "pca_solver": solver}
        if self.model is None:
            self.model = PCAModel(
                solved.components_, solved.explained_variance_,
                {"timings": timings, "accelerated": True, "streamed": True,
                 "online": online, "n_rows": n, "pca_solver": solver},
                device=self.device)
        else:
            # fresh arrays on the SAME model object: the identity-keyed
            # pins re-stage them on the re-pin
            self.model.components_ = solved.components_
            self.model.explained_variance_ = solved.explained_variance_
            self.model.summary["online"] = online
        delta.commit(self.model, "pca", detail=f"rows={n} commits={self._commits}")
        return self.model
