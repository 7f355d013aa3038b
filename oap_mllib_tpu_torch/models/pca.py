"""PCA estimator with Spark-MLlib-compatible parameters: the port of the
JAX package's ``models/pca.py``.

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

With ``Config.checkpoint_dir`` set (utils/checkpoint.py, the JAX
package's format and signature) the streamed fit writes its reduced
column sums after the first pass and a restored fit starts at the Gram
pass; the in-memory and mesh fits write the covariance and a restored
fit goes straight to the eigensolve.  The summary's ``checkpoint``
records it.

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

``Config.enable_x64`` (the x64 parity lane, utils/precision.py) fits
every route in float64: the table or the staged chunks, both moment
passes (K2's float64 form on one device and on a (data, 1) mesh; the
model-sharded product in f64), the covariance, ``torch.linalg.eigh`` or
the randomized solver, and the checkpoint (signature ``"x64": True``,
restored in f64); ``components_`` and ``explained_variance_`` come back
float64.  ``transform`` stays f32 (its pin is float32), as the JAX
package's scoring after an x64 fit.
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
from oap_mllib_tpu_torch.data.table import DenseTable, ShardedTable
from oap_mllib_tpu_torch.ops import kmeans_ops, pca_ops, stream_ops
from oap_mllib_tpu_torch.ops.cuda import autotune, pca_kernel
from oap_mllib_tpu_torch.parallel import bootstrap
from oap_mllib_tpu_torch.parallel.mesh import get_mesh
from oap_mllib_tpu_torch.telemetry import export as telemetry
from oap_mllib_tpu_torch.utils import checkpoint as ckpt_mod
from oap_mllib_tpu_torch.utils import membudget, progcache, resilience
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.dispatch import MAX_PCA_FEATURES, model_device, resolve_devices
from oap_mllib_tpu_torch.utils.profiling import maybe_trace
from oap_mllib_tpu_torch.utils.timing import Timings, phase_timer


class PCAModel:
    def __init__(self, components, explained_variance,
                 summary: Optional[dict] = None, device: Optional[str] = None):
        # components: (d, k), columns are principal axes (Spark's `pc`)
        self.components_ = np.asarray(components)
        self.explained_variance_ = np.asarray(explained_variance)
        self.summary = summary or {}
        # None = Config.device, resolved at every transform
        self.device = device
        # the device copy of the components (serving/registry.pin), keyed
        # by the host array's identity
        self._dev_cache: dict = {}

    @property
    def k(self) -> int:
        return self.components_.shape[1]

    def transform(self, x) -> np.ndarray:
        """Project rows into the component basis (no centering) through
        the serving program (serving/batcher.project_pca) against the
        pinned components, in row slices of the largest row bucket
        within the scoring budget, the tail padded to its bucket; a
        ``ChunkSource`` chunk by chunk (the projection is O(n) host
        memory)."""
        from oap_mllib_tpu_torch.serving import batcher
        from oap_mllib_tpu_torch.serving.registry import pin

        if isinstance(x, ChunkSource):
            parts = [self.transform(np.asarray(c[:v], self.components_.dtype)) for c, v in x]
            return np.concatenate(parts) if parts else np.zeros((0, self.k), np.float32)
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        comp = pin(self._dev_cache, "components", self.components_, self.device)
        if len(x) == 0:
            return np.zeros((0, self.k), np.float32)
        rows = batcher.slice_rows(kmeans_ops.rows_per_chunk(self.k, self.components_.shape[0]))
        return np.concatenate([batcher.project_pca(comp, x[lo:lo + rows])
                               for lo in range(0, len(x), rows)])

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
        autotune.check_config()  # a Config.tuning typo raises here
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
            def mesh_attempt(level):
                with maybe_trace():
                    return self._fit_mesh(x, devices, solver)

            # a mesh fit runs its one attempt (utils/resilience.py)
            model = resilience.fit_with_ladder(
                "PCA", mesh_attempt, [pca_kernel.LAUNCHES], bypass=resilience.LADDER_MESH)
            telemetry.finalize_fit(model.summary)
            return model
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
            with maybe_trace():
                return self._fit_device(x, dev, solver)

        model = resilience.fit_with_ladder(
            "PCA", attempt, [pca_kernel.LAUNCHES],
            spill=lambda: membudget.spill_array(holder, host, None, plan.chunk_rows, "PCA"))
        membudget.record_plan(model.summary, plan, spilled=model.summary["resilience"]["spilled"])
        telemetry.finalize_fit(model.summary)
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
        ``_fit_source``): device memory O(chunk
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
        telemetry.finalize_fit(model.summary)
        return model

    def _stream_attempt(self, source: ChunkSource, level: int, dev, solver: str) -> PCAModel:
        """One streamed attempt at halving level ``level`` (the source
        re-chunked at ``chunk_rows / 2^level``, floored)."""
        if level:
            rows = resilience.halved_rows(source.chunk_rows, level)
            source = source.with_chunk_rows(rows)
        stream_ops.begin_fit(source)
        try:
            with maybe_trace():
                return self._fit_stream_inner(source, dev, solver)
        except BaseException:
            stream_ops.abort_fit()
            raise

    def _fit_stream_inner(self, source: ChunkSource, dev, solver: str) -> PCAModel:
        d = source.n_features
        cfg = get_config()
        pol = psn.resolve("pca")
        tier = psn.kernel_tier(pol, cfg.matmul_precision, "pca")
        psn.apply_matmul_flags(tier)
        timings = Timings("pca.fit")
        before = dict(pca_kernel.LAUNCHES)
        cache_before = progcache.stats()
        tune_before = autotune.mark()
        ckpt = ckpt_mod.maybe_open("pca", self._ckpt_signature(d, "colsum"), timings=timings)
        with phase_timer(timings, "covariance_streamed", dev):
            cov, _, n = stream_ops.covariance_streamed(source, tier, timings, pol, dev,
                                                       checkpoint=ckpt)
        model = self._finish(cov, d, timings, dev, solver, pol, before,
                             model_device(self.device, dev))
        model.summary.update(streamed=True, n_rows=n, progcache=progcache.delta(cache_before),
                             tuning=autotune.delta(tune_before))
        if ckpt is not None:
            ckpt.record(model.summary)
        stream_ops.end_fit(model.summary)
        return model

    @staticmethod
    def _ckpt_signature(d: int, moments: str) -> dict:
        """The checkpoint identity, the JAX package's dict key for key.
        ``moments`` names the state, "colsum" (the streamed first pass)
        or "cov" (the in-memory covariance), so neither route takes the
        other's; ``k`` is absent (the moments do not depend on it);
        ``x64`` is ``Config.enable_x64``, so an f64 fit and an f32 one
        never take each other's state."""
        return {"d": int(d), "moments": moments, "x64": bool(get_config().enable_x64)}

    def _restore_cov(self, d: int, timings, dev):
        """``(checkpointer, restored covariance or None)`` for the
        in-memory and mesh routes."""
        ckpt = ckpt_mod.maybe_open("pca", self._ckpt_signature(d, "cov"), timings=timings)
        if ckpt is None:
            return None, None
        resume = ckpt.restore()
        if resume.found and resume.extra.get("stage") == "cov":
            return ckpt, torch.as_tensor(resume.arrays["cov"]).to(dev, psn.compute_dtype("pca"))
        return ckpt, None

    @staticmethod
    def _write_cov(ckpt, cov, d: int) -> None:
        if ckpt is not None:
            ckpt.maybe_write(1, {"cov": ckpt_mod.fetch_replicated(cov)[:d, :d]},
                             extra={"stage": "cov"}, force=True)

    def _fit_device(self, x, dev: torch.device, solver: str) -> PCAModel:
        cfg = get_config()
        pol = psn.resolve("pca")
        tier = psn.kernel_tier(pol, cfg.matmul_precision, "pca")
        psn.apply_matmul_flags(tier)
        timings = Timings("pca.fit")
        before = dict(pca_kernel.LAUNCHES)
        cache_before = progcache.stats()
        tune_before = autotune.mark()
        ckpt, cov = self._restore_cov(x.shape[1], timings, dev)
        if cov is None:
            with phase_timer(timings, "table_convert", dev):
                table = DenseTable.from_numpy(x, dev, psn.compute_dtype("pca", cfg))
            with phase_timer(timings, "covariance", dev):
                cov, _ = pca_ops.covariance(table.data, table.mask, table.n_rows, tier)
            self._write_cov(ckpt, cov, x.shape[1])
        model = self._finish(cov, x.shape[1], timings, dev, solver, pol, before, self.device)
        model.summary["progcache"] = progcache.delta(cache_before)
        model.summary["tuning"] = autotune.delta(tune_before)
        if ckpt is not None:
            ckpt.record(model.summary)
        return model

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
        tier = psn.kernel_tier(pol, cfg.matmul_precision, "pca")
        psn.apply_matmul_flags(tier)
        mesh = get_mesh(devices=devices)
        mp = mesh.shape[cfg.model_axis]
        first = mesh.device(mesh.local_ranks[0])
        timings = Timings("pca.fit")
        before = dict(pca_kernel.LAUNCHES)
        cache_before = progcache.stats()
        tune_before = autotune.mark()
        n, d = x.shape
        # the covariance is stored unpadded: it restores onto any model
        # axis, and a restored fit skips the table and the moments
        ckpt, cov = self._restore_cov(d, timings, first)
        if cov is None:
            with phase_timer(timings, "table_convert", mesh.distinct_devices()):
                if d % mp:
                    # zero feature columns: zero eigenvalues, demoted before eigh
                    pad = (-d) % mp
                    x = (torch.nn.functional.pad(x, (0, pad)) if isinstance(x, torch.Tensor)
                         else np.pad(x, ((0, 0), (0, pad))))
                table = ShardedTable.from_process_local(x, mesh, psn.compute_dtype("pca", cfg))
            with phase_timer(timings, "covariance", mesh.distinct_devices()):
                if mp > 1:
                    cov, _ = pca_ops.covariance_model_sharded(
                        table.tiles, table.mask, table.n_rows, mesh, tier, pol)
                else:
                    cov, _ = pca_ops.covariance_data_parallel(
                        table.tiles, table.mask, table.n_rows, mesh, tier)
                del table
            self._write_cov(ckpt, cov, d)
        model = self._finish(cov, d, timings, first, solver, pol, before, str(first),
                             dict(mesh.shape))
        model.summary["progcache"] = progcache.delta(cache_before)
        model.summary["tuning"] = autotune.delta(tune_before)
        if ckpt is not None:
            ckpt.record(model.summary)
        return model
