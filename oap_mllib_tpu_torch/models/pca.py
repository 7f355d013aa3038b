"""PCA estimator with Spark-MLlib-compatible parameters: the port of the
JAX package's ``models/pca.py`` (its in-memory routes on one device and
on a device mesh).

``PCA(k).fit(x)`` runs table -> covariance (two passes of the Hopper
moments kernel, ops/cuda/pca_kernel) -> eigh -> :class:`PCAModel`, whose
``components_`` are the (d, k) principal axes and
``explained_variance_`` the top-k variance ratios over the total
variance.  ``transform`` projects without centering (Spark parity).  It
runs on ``device="cuda"`` unless the caller passes ``device="cpu"``,
where the kernel wrapper takes its plain version; a missing card raises.
The JAX package's d < 65535 guard raises here: there is no numpy route
to fall back to.

A device list (``device="cuda:0,cuda:1,cuda:2,cuda:3"``) fits on a
(data, model) mesh of ``Config.model_parallel`` model ranks: the rows
shard over the data axis, and with ``model_parallel > 1`` the features
over the model axis, zero-padded to a multiple of it and demoted before
the eigensolve (ops/pca_ops.covariance_data_parallel and
covariance_model_sharded).  The eigensolve runs on the mesh's first
device, where the model it returns projects.

Out of core (the JAX package's ``_fit_source``): ``fit`` takes a
``ChunkSource``, and an ndarray the route planner
(utils/membudget.plan_pca) prices past the card's budget streams the
same way: the two streamed moment passes of
ops/stream_ops.covariance_streamed, K2 on every chunk of each, on one
device (a device list's first).  SciPy sparse input stays sparse until
a chunk or the device table is filled.  ``PCAModel.transform`` takes a
source too.

In a world of several processes (``Config.num_processes > 1``) ``fit(x)``
treats ``x`` as this process's rows: the mesh spans every process's
devices, each process's ranks hold tiles of its own rows
(data/table.ShardedTable.from_process_local), the psums reach the other
processes, and every process solves the same covariance (summary
``processes``, ``process_id``, ``mesh_shape``).  ``fit(ChunkSource)``
streams this process's shard, the moments reduced across processes; a
capability-weighted shard (parallel/balance.local_sources) may move rows
between the processes between the two passes, and the summary then
carries ``balance`` and, when the rollups are armed, ``fleet``.

``Config.pca_solver="randomized"`` replaces the full eigh with the
top-k subspace iteration of ops/pca_ops.topk_eigh_randomized
(``pca_rand_oversample``, ``pca_rand_iters``); the summary's
``pca_solver`` names the solver that ran.  One-device fits run under
the resilience ladder (utils/resilience.py): transient faults retry, a
device OOM re-chunks a source at ``chunk_rows / 2^level`` (the
in-memory covariance runs again), a host OOM spills the table and
streams the two passes from disk; past the last rung
``ResilienceError``.  Mesh fits and worlds of processes run one
attempt; the summary's ``resilience`` holds the counters.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.data import sparse as _sparse
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.data.table import DenseTable, ShardedTable, as_float_tensor
from oap_mllib_tpu_torch.ops import kmeans_ops, pca_ops, stream_ops
from oap_mllib_tpu_torch.ops.cuda import pca_kernel
from oap_mllib_tpu_torch.parallel import bootstrap
from oap_mllib_tpu_torch.parallel.mesh import get_mesh
from oap_mllib_tpu_torch.utils import membudget, resilience
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.dispatch import (MAX_PCA_FEATURES, model_device, resolve_device,
                                                resolve_devices)
from oap_mllib_tpu_torch.utils.timing import Timings, phase_timer


class PCAModel:
    def __init__(self, components, explained_variance,
                 summary: Optional[dict] = None, device: Optional[str] = None):
        # components: (d, k), columns are principal axes (Spark's `pc`)
        self.components_ = np.asarray(components)
        self.explained_variance_ = np.asarray(explained_variance)
        self.summary = summary or {}
        # None = Config.device, resolved at the first transform
        self.device = device
        self._staged = None  # (key, components tensor) of the last device

    @property
    def k(self) -> int:
        return self.components_.shape[1]

    def transform(self, x) -> np.ndarray:
        """Project rows into the component basis (no centering), chunked
        over rows on the model's device; a ``ChunkSource`` chunk by
        chunk (the projection is O(n) host memory)."""
        if isinstance(x, ChunkSource):
            parts = [self.transform(np.asarray(c[:v], self.components_.dtype)) for c, v in x]
            return np.concatenate(parts) if parts else np.zeros((0, self.k), np.float32)
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        dev = resolve_device(self.device)
        key = (str(dev), id(self.components_))
        if self._staged is None or self._staged[0] != key:
            self._staged = (key, as_float_tensor(self.components_, dev))
        comp = self._staged[1]
        if len(x) == 0:
            return np.zeros((0, self.k), np.float32)
        rows = kmeans_ops.rows_per_chunk(self.k, self.components_.shape[0])
        return np.concatenate([
            pca_ops.project(as_float_tensor(x[lo:lo + rows], dev), comp).cpu().numpy()
            for lo in range(0, len(x), rows)
        ])

    # -- persistence: the JAX package's format (metadata.json + .npy) -------
    def save(self, path: str) -> None:
        """Atomic per-file writes, metadata last."""
        from oap_mllib_tpu_torch.data import io as _io

        os.makedirs(path, exist_ok=True)
        _io.atomic_save_npy(os.path.join(path, "components.npy"), self.components_)
        _io.atomic_save_npy(os.path.join(path, "explained_variance.npy"),
                            self.explained_variance_)
        _io.atomic_write_json(
            os.path.join(path, "metadata.json"),
            {"type": "PCAModel", "k": int(self.k),
             "shape": [int(v) for v in self.components_.shape],
             "version": 1},
        )

    @classmethod
    def load(cls, path: str, device: Optional[str] = None) -> "PCAModel":
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        if meta.get("type") != "PCAModel":
            raise ValueError(f"not a PCAModel directory: {path}")
        cpath = os.path.join(path, "components.npy")
        comps = np.load(cpath)
        var = np.load(os.path.join(path, "explained_variance.npy"))
        expect = meta.get("shape", [None, meta["k"]])
        if comps.ndim != 2 or int(comps.shape[1]) != int(expect[1]) or (
                expect[0] is not None and int(comps.shape[0]) != int(expect[0])):
            raise ValueError(
                f"{cpath}: components have shape {tuple(comps.shape)}, "
                f"metadata expects {tuple(expect)}: the model directory "
                "is torn or mixed from two saves"
            )
        if var.shape[0] != comps.shape[1]:
            raise ValueError(
                f"{os.path.join(path, 'explained_variance.npy')}: "
                f"{var.shape[0]} variance ratios for {comps.shape[1]} "
                "components: the model directory is torn or mixed from two saves"
            )
        return cls(comps, var, device=device)


def _pca_solver_cfg() -> str:
    """Validated ``Config.pca_solver``, the solver a fit runs: "auto" and
    "eigh" run the full eigendecomposition, "randomized" the top-k
    subspace iteration.  A typo, or a randomized knob below 1, raises
    at fit entry, before any pass."""
    cfg = get_config()
    solver = cfg.pca_solver
    if solver not in ("auto", "eigh", "randomized"):
        raise ValueError(f"pca_solver must be auto|eigh|randomized, got {solver!r}")
    if solver == "randomized":
        if cfg.pca_rand_oversample < 1 or cfg.pca_rand_iters < 1:
            raise ValueError("pca_rand_oversample and pca_rand_iters must be >= 1")
        return solver
    return "eigh"


class PCA:
    """PCA estimator.  Param parity: k (number of components); ``device``
    None takes ``Config.device`` ("cuda")."""

    def __init__(self, k: int, device: Optional[str] = None):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.device = device

    def fit(self, x) -> PCAModel:
        """Fit on ``x``, an (n, d) ndarray, tensor, SciPy sparse matrix or
        ``ChunkSource``."""
        solver = _pca_solver_cfg()
        if isinstance(x, ChunkSource):
            return self._fit_source(x, solver)
        if not isinstance(x, torch.Tensor) and not _sparse.is_sparse(x):
            x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"expected 2-D data, got shape {tuple(x.shape)}")
        n, d = x.shape
        if n < 1:
            raise ValueError("empty input")
        self._check_width(d)
        devices = resolve_devices(self.device)
        if (len(devices) > 1 or get_config().model_parallel > 1
                or bootstrap.world_size() > 1):
            if _sparse.is_sparse(x):
                x = x.toarray()
            # a mesh fit runs its one attempt (utils/resilience.py)
            return resilience.fit_with_ladder(
                "PCA", lambda level: self._fit_mesh(x, devices, solver),
                [pca_kernel.LAUNCHES], bypass=resilience.LADDER_MESH)
        # the route plan: a table whose working set exceeds the card's
        # budget streams the two moment passes instead
        plan = membudget.plan_pca(n, d, device=devices[0])
        host = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        if plan.route == membudget.ROUTE_STREAMED:
            source = ChunkSource.from_array(host, chunk_rows=plan.chunk_rows)
            return self._fit_source(source, solver, plan=plan)
        # the ladder (utils/resilience.py): transient faults retry, a
        # device OOM runs the covariance again (it has no chunk knob), a
        # host OOM spills the table and streams the two passes from disk
        dev = devices[0]
        holder = {}

        def attempt(level):
            if holder.get("source") is not None:
                return self._stream_attempt(holder["source"], level, dev, solver)
            return self._fit_device(x, dev, solver)

        model = resilience.fit_with_ladder(
            "PCA", attempt, [pca_kernel.LAUNCHES],
            spill=lambda: membudget.spill_array(holder, host, None, plan.chunk_rows, "PCA"))
        membudget.record_plan(model.summary, plan, spilled=model.summary["resilience"]["spilled"])
        return model

    def _check_width(self, d: int) -> None:
        if self.k > d:
            raise ValueError(f"k={self.k} exceeds n_features={d}")
        if d >= MAX_PCA_FEATURES:
            raise ValueError(
                f"n_features={d} is not below MAX_PCA_FEATURES="
                f"{MAX_PCA_FEATURES}, the PCA feature-count guard (the "
                "replicated (d, d) covariance); the port has no numpy route"
            )

    def _fit_source(self, source: ChunkSource, solver: str, plan=None) -> PCAModel:
        """The streamed fit of a ``ChunkSource`` (the JAX package's
        ``_fit_source``, without its checkpoints): device memory O(chunk
        + d^2), under the resilience ladder: transient faults retry, a
        device OOM re-chunks the source at ``chunk_rows / 2^level``, a
        host OOM spills a memory-backed source to disk."""
        d = source.n_features
        self._check_width(d)
        dev = resolve_devices(self.device)[0]
        if plan is None:
            plan = membudget.plan_pca(source.n_rows, d, source_backing=source.backing,
                                      chunk_rows=source.chunk_rows, device=dev)
        holder = {"source": source}
        spill = None
        if source.backing not in ("disk", "spill"):
            spill = lambda: membudget.spill_source(holder, "PCA")  # noqa: E731
        model = resilience.fit_with_ladder(
            "PCA", lambda level: self._stream_attempt(holder["source"], level, dev, solver),
            [pca_kernel.LAUNCHES], spill=spill,
            max_halvings=resilience.halvings_available(source.chunk_rows))
        membudget.record_plan(model.summary, plan, spilled=model.summary["resilience"]["spilled"])
        return model

    def _stream_attempt(self, source: ChunkSource, level: int, dev, solver: str) -> PCAModel:
        """One streamed attempt at halving level ``level`` (the source
        re-chunked at ``chunk_rows / 2^level``, floored)."""
        if level:
            rows = resilience.halved_rows(source.chunk_rows, level)
            source = source.with_chunk_rows(rows)
        stream_ops.begin_fit(source)
        try:
            return self._fit_stream_inner(source, dev, solver)
        except BaseException:
            stream_ops.abort_fit()
            raise

    def _fit_stream_inner(self, source: ChunkSource, dev, solver: str) -> PCAModel:
        d = source.n_features
        cfg = get_config()
        pol = psn.resolve("pca")
        tier = psn.kernel_tier(pol, cfg.matmul_precision)
        psn.apply_matmul_flags(tier)
        timings = Timings("pca.fit")
        before = dict(pca_kernel.LAUNCHES)
        with phase_timer(timings, "covariance_streamed", dev):
            cov, _, n = stream_ops.covariance_streamed(source, tier, timings, pol, dev)
        model = self._finish(cov, d, timings, dev, solver, pol, before,
                             model_device(self.device, dev))
        model.summary.update(streamed=True, n_rows=n)
        stream_ops.end_fit(model.summary)
        return model

    def _fit_device(self, x, dev: torch.device, solver: str) -> PCAModel:
        cfg = get_config()
        pol = psn.resolve("pca")
        tier = psn.kernel_tier(pol, cfg.matmul_precision)
        psn.apply_matmul_flags(tier)
        timings = Timings("pca.fit")
        before = dict(pca_kernel.LAUNCHES)
        with phase_timer(timings, "table_convert", dev):
            table = DenseTable.from_numpy(x, dev)
        with phase_timer(timings, "covariance", dev):
            cov, _ = pca_ops.covariance(table.data, table.mask, table.n_rows, tier)
        return self._finish(cov, x.shape[1], timings, dev, solver, pol, before, self.device)

    def _finish(self, cov, d: int, timings, dev, solver, pol, before, device,
                mesh_shape=None) -> PCAModel:
        """The eigensolve of ``cov`` (with ``d`` genuine features; a wider
        ``cov`` carries zero-padded ones, demoted below every genuine
        eigenvalue first, or sliced off for the randomized solver) and
        the model; ``solver`` is the one that runs (summary
        ``pca_solver``)."""
        if solver == "randomized":
            # padded feature dims are sliced off, not demoted: subspace
            # iteration ranks by |eigenvalue|, and the trace is the
            # eigenvalues' sum without the full spectrum
            with phase_timer(timings, "randomized_topk", dev):
                cfg = get_config()
                cov = cov[:d, :d]
                top, vecs = pca_ops.topk_eigh_randomized(
                    cov, self.k, oversample=cfg.pca_rand_oversample, iters=cfg.pca_rand_iters)
                top, vecs = top.cpu().numpy(), vecs.cpu().numpy()
                total = float(torch.trace(cov))
        else:
            with phase_timer(timings, "eigh", dev):
                if cov.shape[0] > d:
                    cov = pca_ops.mark_padded_features(cov, d)
                vals, vecs = pca_ops.eigh_descending(cov)
                vals = vals[:d].cpu().numpy()
                vecs = vecs[:d, : self.k].cpu().numpy()
            top, total = vals[: self.k], float(vals.sum())
        ratio = top / total if total > 0 else np.zeros(self.k)
        summary = {
            "timings": timings,
            "accelerated": True,
            "pca_solver": solver,
            "precision": pol,
            "mesh_shape": mesh_shape,
            "processes": bootstrap.world_size(),
            "process_id": bootstrap.process_index(),
            "kernels": {
                name: pca_kernel.LAUNCHES[name] - before.get(name, 0)
                for name in pca_kernel.LAUNCHES
            },
        }
        return PCAModel(vecs, ratio, summary, device=device)

    def _fit_mesh(self, x, devices, solver: str) -> PCAModel:
        """The mesh route of the JAX package's ``_fit_tpu_inner``: the
        table sharded over the mesh, the covariance of either mesh shape,
        the eigensolve on the first device."""
        cfg = get_config()
        pol = psn.resolve("pca")
        tier = psn.kernel_tier(pol, cfg.matmul_precision)
        psn.apply_matmul_flags(tier)
        mesh = get_mesh(devices=devices)
        mp = mesh.shape[cfg.model_axis]
        first = mesh.device(mesh.local_ranks[0])
        timings = Timings("pca.fit")
        before = dict(pca_kernel.LAUNCHES)
        n, d = x.shape
        with phase_timer(timings, "table_convert", mesh.distinct_devices()):
            if d % mp:
                # zero feature columns: zero eigenvalues, demoted before eigh
                pad = (-d) % mp
                x = (torch.nn.functional.pad(x, (0, pad)) if isinstance(x, torch.Tensor)
                     else np.pad(x, ((0, 0), (0, pad))))
            table = ShardedTable.from_process_local(x, mesh)
        with phase_timer(timings, "covariance", mesh.distinct_devices()):
            if mp > 1:
                cov, _ = pca_ops.covariance_model_sharded(
                    table.tiles, table.mask, table.n_rows, mesh, tier, pol)
            else:
                cov, _ = pca_ops.covariance_data_parallel(
                    table.tiles, table.mask, table.n_rows, mesh, tier)
            del table
        return self._finish(cov, d, timings, first, solver, pol, before, str(first),
                            dict(mesh.shape))
