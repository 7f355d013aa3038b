"""K-Means estimator with Spark-MLlib-compatible parameters: the port of
the JAX package's ``models/kmeans.py`` (its in-memory, uncheckpointed
routes on one device and on a model-sharded mesh).

``KMeans(...).fit(x)`` runs table -> init (random | k-means||) -> Lloyd
loop on the fused Hopper kernel (ops/cuda/kmeans_kernel.lloyd_run_kernel)
-> :class:`KMeansModel`.  It runs on ``device="cuda"`` unless the caller
passes ``device="cpu"``, where the kernel wrapper takes its plain
version; a missing card raises.  ``distance_measure="cosine"`` runs the
numpy reference (fallback/kmeans_np.py) with ``accelerated=False``, as
the JAX package does.

A device list (``device="cuda:0,cuda:1,cuda:2,cuda:3"``) fits on a
(data, model) mesh, init running on the full table on the mesh's first
device:

- with ``Config.model_parallel`` 1 (the default) the rows shard over the
  data axis and the centers are replicated: the Lloyd loop is
  ops/kmeans_ops.lloyd_run_data_parallel, the fused kernel on every
  rank's rows and the moments psum-ed over the data axis;
- with ``model_parallel > 1`` features zero-pad to a multiple of the
  model axis and the Lloyd loop is ops/kmeans_ops.lloyd_run_model_sharded,
  whose moments reduce over the data axis with the ring kernel
  (ops/cuda/ring_kernel.py).

The model it returns scores on the mesh's first device.

Out of core (the JAX package's ``_fit_source``): ``fit`` takes a
``ChunkSource`` (data/stream.py), and an ndarray whose in-memory
working set the route planner (utils/membudget.plan_kmeans) prices past
``Config.memory_budget_hbm`` streams the same way: init by reservoir
sampling or the streamed k-means||, then the streamed Lloyd loop
(ops/stream_ops.py), K1 on every chunk.  The summary records the plan
(``route``) and ``streamed``.  A source fits on one device, a device
list's first, as the JAX package streams on its default device; the
planner runs on the one-device route.  SciPy sparse input stays sparse
until a chunk or the device table is filled (data/sparse.py).
``KMeansModel.predict`` and ``compute_cost`` take a source too.

In a world of several processes (``Config.num_processes > 1``, joined
with parallel/bootstrap.initialize_distributed) ``fit(x)`` treats ``x``
as THIS process's rows (the JAX package's ``from_process_local`` route):
the mesh spans every process's devices, each process builds its tiles
from its own rows (data/table.ShardedTable.from_process_local), the init
draws from the table spanning the world, and sample weights are this
process's, aligned to the per-process padding.  Every process returns
the same model; the summary records ``processes``, ``process_id`` and
the mesh shape.  ``fit(ChunkSource)`` streams this process's shard,
every pass's moments reduced across the processes (ops/stream_ops.py).
A shard built by parallel/balance.local_sources is a capability-weighted
extent of a table every process holds: the straggler controller may
move rows between the processes between Lloyd passes, and the summary
carries ``balance`` (the plan and its re-plans) and, when the rollups
are armed, ``fleet`` (telemetry/fleet.py).  The k-means|| init of the
in-memory route draws one ``torch.rand`` stream over the world's valid
rows, each process its slice from the prefix sum of the gathered row
counts, so uneven shares leave it unchanged.

Every one-device fit runs under the resilience ladder
(utils/resilience.py, the JAX package's ``resilient_fit``): transient
faults retry; a device OOM doubles the in-memory Lloyd loop's row
chunks (K1 on 2^level row ranges a pass), or re-chunks a source at
``chunk_rows / 2^level``; a host OOM spills the table (a memory-backed
source, or the in-memory array) to disk and streams it from there; a
non-finite iterate under bf16 / tf32 retries once at f32; past the
last rung ``ResilienceError``, never a CPU fit.  Mesh fits and worlds
of processes run one attempt.  The summary's ``resilience`` holds the
counters and its ``kernels`` the launches of every attempt.
``KMeansModel.to_pmml`` writes the JAX package's PMML 4.3 document.
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
from oap_mllib_tpu_torch.fallback.kmeans_np import _sq_dists, lloyd_np, predict_np
from oap_mllib_tpu_torch.ops import kmeans_ops, stream_ops
from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel, ring_kernel
from oap_mllib_tpu_torch.parallel import bootstrap
from oap_mllib_tpu_torch.parallel.mesh import get_mesh
from oap_mllib_tpu_torch.utils import membudget, resilience
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.dispatch import model_device, resolve_device, resolve_devices
from oap_mllib_tpu_torch.utils.timing import Timings, phase_timer

INIT_RANDOM = "random"
INIT_PARALLEL = "k-means||"


class KMeansSummary:
    """Training summary.  ``kernels`` counts the CUDA kernel launches of
    the fit by kernel name (0 on the CPU, where the plain versions run);
    ``ring_reduce`` launches once per card per ring, and a mesh fit runs
    one ring per model column per pass, so (num_iter + 1) * model when
    every rank shares one card; the data-parallel route launches the
    accumulate once a rank a pass, (num_iter + 1) * data.  A fit on a
    mesh records its shape (``mesh``, axis name -> size) and whether the
    ring reduced its moments (``ring``, False on the data-parallel
    route); both are None on one device.  ``route`` is the route plan of
    a one-device or streamed fit (utils/membudget.record_plan), None on
    a mesh; ``streamed`` is True when the fit streamed its table.
    ``resilience`` holds the fit's ladder counters (retries,
    degradations, faults, halvings, spilled, ladder, history; the JAX
    package's keys); ``kernels`` then counts every attempt's launches,
    a failed attempt's included."""

    def __init__(self, training_cost: float, num_iter: int, timings: Timings,
                 accelerated: bool, cluster_sizes: Optional[np.ndarray] = None,
                 kernels: Optional[dict] = None, precision: str = "f32",
                 mesh: Optional[dict] = None, ring: Optional[bool] = None,
                 streamed: bool = False):
        self.training_cost = training_cost
        self.num_iter = num_iter
        self.timings = timings
        self.accelerated = accelerated
        self.cluster_sizes = cluster_sizes
        self.kernels = dict(kernels or {})
        self.precision = precision
        self.mesh = mesh
        self.ring = ring
        self.streamed = streamed
        self.route = None
        # a streamed fit's capability plan and fleet rollups
        # (parallel/balance.py, telemetry/fleet.py), when armed
        self.balance = None
        self.fleet = None
        # the resilience ladder's counters (utils/resilience.py)
        self.resilience = None
        # the world the fit ran in (parallel/bootstrap.py)
        self.processes = bootstrap.world_size()
        self.process_id = bootstrap.process_index()

    def __repr__(self) -> str:
        return (
            f"KMeansSummary(cost={self.training_cost:.6g}, iters={self.num_iter}, "
            f"accelerated={self.accelerated}, kernels={self.kernels})"
        )


class KMeansModel:
    def __init__(self, cluster_centers, distance_measure: str = "euclidean",
                 summary: Optional[KMeansSummary] = None,
                 device: Optional[str] = None):
        if isinstance(cluster_centers, torch.Tensor):
            cluster_centers = cluster_centers.cpu().numpy()
        self.cluster_centers_ = np.asarray(cluster_centers)
        self.distance_measure = distance_measure
        self.summary = summary
        # None = Config.device, resolved at the first scoring call
        self.device = device
        self._staged = None  # (key, centers tensor) of the last device

    @property
    def k(self) -> int:
        return self.cluster_centers_.shape[0]

    def _score_chunk_rows(self) -> int:
        return kmeans_ops.rows_per_chunk(self.k, self.cluster_centers_.shape[1])

    def _centers_dev(self, dev: torch.device) -> torch.Tensor:
        """The centers on ``dev``, staged once per (device, centers array)."""
        key = (str(dev), id(self.cluster_centers_))
        if self._staged is None or self._staged[0] != key:
            self._staged = (key, as_float_tensor(self.cluster_centers_, dev))
        return self._staged[1]

    def _chunks(self, x):
        """(device centers, row chunks of x as f32 tensors on the device)."""
        dev = resolve_device(self.device)
        c = self._centers_dev(dev)
        rows = self._score_chunk_rows()
        return c, (
            as_float_tensor(x[lo:lo + rows], dev)
            for lo in range(0, len(x), rows)
        )

    def predict(self, x) -> np.ndarray:
        """Nearest-center label of every row; a ``ChunkSource`` is scored
        chunk by chunk (the labels are O(n) host memory)."""
        if isinstance(x, ChunkSource):
            parts = [self.predict(np.asarray(c[:v], self.cluster_centers_.dtype))
                     for c, v in x]
            return np.concatenate(parts) if parts else np.zeros((0,), np.int64)
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if self.distance_measure != "euclidean":
            return predict_np(_host(x), self.cluster_centers_, self.distance_measure)
        if len(x) == 0:
            return np.zeros((0,), np.int64)
        c, chunks = self._chunks(x)
        return np.concatenate([
            torch.argmin(kmeans_ops.pairwise_sq_dists(xc, c), dim=1).cpu().numpy()
            for xc in chunks
        ])

    def transform(self, x) -> np.ndarray:
        return self.predict(x)

    def compute_cost(self, x) -> float:
        """Sum of squared distances of the rows to their nearest center (a
        ``ChunkSource`` summed chunk by chunk)."""
        if isinstance(x, ChunkSource):
            return float(sum(self.compute_cost(c[:v]) for c, v in x))
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if self.distance_measure != "euclidean":
            d = _sq_dists(_host(x), self.cluster_centers_, self.distance_measure)
            return float(np.sum(np.min(d, axis=1)))
        c, chunks = self._chunks(x)
        return float(sum(
            float(torch.sum(kmeans_ops.min_sq_dists(xc, c))) for xc in chunks
        ))

    def to_pmml(self, path: str) -> None:
        """Write the model as a PMML 4.3 ``ClusteringModel`` (Spark's
        ``KMeansModel`` PMML export): the JAX package's document, field
        for field, the centers as ``repr(float)``."""
        import xml.etree.ElementTree as ET

        d = self.cluster_centers_.shape[1]
        root = ET.Element("PMML", {"version": "4.3", "xmlns": "http://www.dmg.org/PMML-4_3"})
        header = ET.SubElement(root, "Header", {"description": "k-means clustering"})
        ET.SubElement(header, "Application", {"name": "oap-mllib-tpu"})
        dd = ET.SubElement(root, "DataDictionary", {"numberOfFields": str(d)})
        for j in range(d):
            ET.SubElement(dd, "DataField", {"name": f"field_{j}", "optype": "continuous",
                                            "dataType": "double"})
        cm = ET.SubElement(root, "ClusteringModel", {
            "modelName": "k-means", "functionName": "clustering",
            "modelClass": "centerBased", "numberOfClusters": str(self.k)})
        ms = ET.SubElement(cm, "MiningSchema")
        for j in range(d):
            ET.SubElement(ms, "MiningField", {"name": f"field_{j}"})
        ET.SubElement(cm, "ComparisonMeasure", {"kind": "distance"}).append(
            ET.Element("squaredEuclidean"))
        for j in range(d):
            ET.SubElement(cm, "ClusteringField", {"field": f"field_{j}",
                                                  "compareFunction": "absDiff"})
        for i, center in enumerate(self.cluster_centers_):
            cl = ET.SubElement(cm, "Cluster", {"name": f"cluster_{i}", "id": str(i)})
            arr = ET.SubElement(cl, "Array", {"n": str(d), "type": "real"})
            arr.text = " ".join(repr(float(v)) for v in center)
        ET.ElementTree(root).write(path, xml_declaration=True, encoding="utf-8")

    # -- persistence: the JAX package's format (metadata.json + centers.npy) --
    def save(self, path: str) -> None:
        """Atomic per-file writes, metadata last."""
        from oap_mllib_tpu_torch.data import io as _io

        os.makedirs(path, exist_ok=True)
        _io.atomic_save_npy(os.path.join(path, "centers.npy"), self.cluster_centers_)
        _io.atomic_write_json(
            os.path.join(path, "metadata.json"),
            {"type": "KMeansModel",
             "distance_measure": self.distance_measure,
             "k": int(self.k),
             "shape": [int(v) for v in self.cluster_centers_.shape],
             "version": 1},
        )

    @classmethod
    def load(cls, path: str, device: Optional[str] = None) -> "KMeansModel":
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        if meta.get("type") != "KMeansModel":
            raise ValueError(f"not a KMeansModel directory: {path}")
        cpath = os.path.join(path, "centers.npy")
        centers = np.load(cpath)
        expect = meta.get("shape", [meta["k"], None])
        if centers.ndim != 2 or int(centers.shape[0]) != int(expect[0]) or (
                expect[1] is not None
                and int(centers.shape[1]) != int(expect[1])):
            raise ValueError(
                f"{cpath}: centers have shape {tuple(centers.shape)}, "
                f"metadata expects {tuple(expect)}: the model directory "
                "is torn or mixed from two saves"
            )
        return cls(centers, meta["distance_measure"], device=device)


def _one_process(what: str) -> None:
    """Raise when a route that fits one process's data alone is asked
    for in a world of several."""
    if bootstrap.world_size() > 1:
        raise NotImplementedError(
            f"{what} runs the numpy reference on one process's data; in a world of "
            f"{bootstrap.world_size()} processes it would fit this shard alone"
        )


def _host(x):
    """``x`` on the host: a tensor's array, a sparse matrix as it is."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return x if _sparse.is_sparse(x) else np.asarray(x)


def _dense_host(x) -> np.ndarray:
    """``x`` as a dense host array (a sparse matrix densified)."""
    x = _host(x)
    return x.toarray() if _sparse.is_sparse(x) else x


class KMeans:
    """K-Means estimator.  Parameters and defaults as Spark ML's: k=2,
    max_iter=20, tol=1e-4, init_mode="k-means||", init_steps=2,
    distance_measure="euclidean"; ``seed`` None takes ``Config.seed``;
    ``device`` None takes ``Config.device`` ("cuda")."""

    def __init__(
        self,
        k: int = 2,
        max_iter: int = 20,
        tol: float = 1e-4,
        seed: Optional[int] = None,
        init_mode: str = INIT_PARALLEL,
        init_steps: int = 2,
        distance_measure: str = "euclidean",
        device: Optional[str] = None,
    ):
        if k < 1:
            raise ValueError("k must be >= 1")
        if max_iter < 0:
            raise ValueError("max_iter must be >= 0")
        if init_mode not in (INIT_RANDOM, INIT_PARALLEL):
            raise ValueError(f"init_mode must be '{INIT_RANDOM}' or '{INIT_PARALLEL}'")
        if distance_measure not in ("euclidean", "cosine"):
            raise ValueError("distance_measure must be 'euclidean' or 'cosine'")
        if init_steps < 1:
            raise ValueError("init_steps must be >= 1")
        self.k = k
        self.max_iter = max_iter
        self.tol = tol
        self.seed = get_config().seed if seed is None else seed
        self.init_mode = init_mode
        self.init_steps = init_steps
        self.distance_measure = distance_measure
        self.device = device

    def fit(self, x, sample_weight=None) -> KMeansModel:
        """Fit on ``x`` (an (n, d) ndarray, tensor, SciPy sparse matrix or
        ``ChunkSource``), optionally with row weights (for a source, a
        width-1 source chunked like it, or an array)."""
        if isinstance(x, ChunkSource):
            return self._fit_source(x, sample_weight)
        if not isinstance(x, torch.Tensor) and not _sparse.is_sparse(x):
            x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"expected 2-D data, got shape {tuple(x.shape)}")
        if x.shape[0] < 1:
            raise ValueError("empty input")
        if self.distance_measure != "euclidean":
            _one_process("distance_measure='cosine'")
            return self._fit_fallback(_dense_host(x), sample_weight)
        devices = resolve_devices(self.device)
        if (len(devices) > 1 or get_config().model_parallel > 1
                or bootstrap.world_size() > 1):
            x = _dense_host(x) if _sparse.is_sparse(x) else x
            # a mesh fit runs its one attempt (utils/resilience.py)
            return resilience.fit_with_ladder(
                "KMeans", lambda level: self._fit_mesh(x, sample_weight, devices),
                [kmeans_kernel.LAUNCHES, ring_kernel.LAUNCHES], bypass=resilience.LADDER_MESH)
        # the route plan: an array whose working set exceeds the card's
        # budget streams instead of assuming it fits
        plan = membudget.plan_kmeans(
            x.shape[0], x.shape[1], self.k,
            row_chunks_hint=kmeans_ops.auto_row_chunks(x.shape[0], self.k), device=devices[0])
        if plan.route == membudget.ROUTE_STREAMED:
            source = ChunkSource.from_array(_host(x), chunk_rows=plan.chunk_rows)
            return self._fit_source(source, sample_weight, plan=plan)
        # the ladder (utils/resilience.py): transient faults retry, a
        # device OOM doubles the Lloyd loop's row chunks, a host OOM
        # spills the table to disk and streams it from there
        dev = devices[0]
        holder = {}

        def attempt(level):
            if holder.get("source") is not None:
                return self._stream_attempt(holder["source"], holder.get("weights"), level, dev)
            return self._fit_device(x, sample_weight, dev, level)

        def spill():
            w = None if sample_weight is None else _host(sample_weight)
            return membudget.spill_array(holder, _host(x), w, plan.chunk_rows, "KMeans")

        model = resilience.fit_with_ladder("KMeans", attempt, [kmeans_kernel.LAUNCHES],
                                           spill=spill)
        membudget.record_plan(model.summary, plan, spilled=model.summary.resilience["spilled"])
        return model

    def _fit_source(self, source: ChunkSource, sample_weight, plan=None) -> KMeansModel:
        """The streamed fit of a ``ChunkSource`` (the JAX package's
        ``_fit_source``, without its checkpoints): device memory
        O(chunk), one pass per Lloyd iteration, under the resilience
        ladder: transient faults retry, a device OOM re-chunks the
        source (and its weights) at ``chunk_rows / 2^level``, a host OOM
        spills a memory-backed source to disk.  ``sample_weight``: a
        width-1 source chunked like ``source``, or an array (wrapped)."""
        if sample_weight is not None and not isinstance(sample_weight, ChunkSource):
            sample_weight = ChunkSource.from_array(
                np.asarray(_host(sample_weight)).reshape(-1, 1), chunk_rows=source.chunk_rows)
        stream_ops._checked_entry(lambda: stream_ops._check_weight_source(source, sample_weight))
        if self.distance_measure != "euclidean":
            _one_process("distance_measure='cosine'")
            w = sample_weight.to_array().reshape(-1) if sample_weight is not None else None
            return self._fit_fallback(source.to_array(), w)
        dev = resolve_devices(self.device)[0]
        if plan is None:
            plan = membudget.plan_kmeans(source.n_rows, source.n_features, self.k,
                                         source_backing=source.backing,
                                         chunk_rows=source.chunk_rows, device=dev)
        holder = {"source": source, "weights": sample_weight}
        spill = None
        if source.backing not in ("disk", "spill"):
            spill = lambda: membudget.spill_source(holder, "KMeans")  # noqa: E731
        model = resilience.fit_with_ladder(
            "KMeans",
            lambda level: self._stream_attempt(holder["source"], holder.get("weights"),
                                               level, dev),
            [kmeans_kernel.LAUNCHES], spill=spill,
            max_halvings=resilience.halvings_available(source.chunk_rows))
        membudget.record_plan(model.summary, plan, spilled=model.summary.resilience["spilled"])
        return model

    def _stream_attempt(self, source: ChunkSource, sample_weight, level: int,
                        dev) -> KMeansModel:
        """One streamed attempt at halving level ``level``: the source
        (and its weights) re-chunked at ``chunk_rows / 2^level``, never
        below ``OOM_CHUNK_FLOOR_ROWS`` (nor above the width it has)."""
        if level:
            rows = resilience.halved_rows(source.chunk_rows, level)
            source = source.with_chunk_rows(rows)
            if sample_weight is not None:
                sample_weight = sample_weight.with_chunk_rows(rows)
        stream_ops.begin_fit(source)
        try:
            return self._fit_stream_inner(source, sample_weight, dev)
        except BaseException:
            stream_ops.abort_fit()
            raise

    def _fit_stream_inner(self, source: ChunkSource, sample_weight, dev) -> KMeansModel:
        cfg = get_config()
        pol = psn.resolve("kmeans")
        tier = psn.kernel_tier(pol, cfg.matmul_precision)
        psn.apply_matmul_flags(tier)
        timings = Timings("kmeans.fit")
        before = dict(kmeans_kernel.LAUNCHES)
        with phase_timer(timings, "init_centers", dev):
            if self.init_mode == INIT_RANDOM:
                centers0 = stream_ops.reservoir_sample(source, self.k, self.seed, timings)
            else:
                centers0 = stream_ops.init_kmeans_parallel_streamed(
                    source, self.k, self.seed, self.init_steps, weights=sample_weight,
                    validated=True, timings=timings, policy=pol, device=dev)
        with phase_timer(timings, "lloyd_loop", dev):
            centers, n_iter, cost, counts = stream_ops.lloyd_run_streamed(
                source, as_float_tensor(centers0, dev), self.max_iter, self.tol, tier,
                weights=sample_weight, validated=True, timings=timings, policy=pol)
            centers = centers.cpu().numpy()
            cost = float(cost)
            counts = counts.cpu().numpy()
        summary = KMeansSummary(
            cost, int(n_iter), timings, accelerated=True, cluster_sizes=counts,
            kernels={name: kmeans_kernel.LAUNCHES[name] - before.get(name, 0)
                     for name in kmeans_kernel.LAUNCHES},
            precision=pol, streamed=True,
        )
        stream_ops.end_fit(summary)
        return KMeansModel(centers, self.distance_measure, summary,
                           device=model_device(self.device, dev))

    def _init_centers(self, table: DenseTable, weights, dev) -> torch.Tensor:
        if self.init_mode == INIT_RANDOM:
            centers0 = kmeans_ops.init_random(
                table, table.n_rows, self.k, self.seed,
                index_map=table.valid_to_padded,
            )
        else:
            centers0 = kmeans_ops.init_kmeans_parallel(
                table, weights, table.n_rows, self.k, self.seed,
                self.init_steps, index_map=table.valid_to_padded,
            )
        return as_float_tensor(centers0, dev).contiguous()

    def _fit_device(self, x, sample_weight, dev: torch.device, level: int = 0) -> KMeansModel:
        """The in-memory fit on one device; ``level`` (the halving rung)
        runs the Lloyd loop on 2^level row ranges a pass."""
        cfg = get_config()
        pol = psn.resolve("kmeans")
        tier = psn.kernel_tier(pol, cfg.matmul_precision)
        psn.apply_matmul_flags(tier)
        timings = Timings("kmeans.fit")
        before = dict(kmeans_kernel.LAUNCHES)
        with phase_timer(timings, "table_convert", dev):
            table = DenseTable.from_numpy(x, dev)
            weights = table.mask
            if sample_weight is not None:
                weights = table.align_weights(sample_weight)
        with phase_timer(timings, "init_centers", dev):
            centers0 = self._init_centers(table, weights, dev)
        with phase_timer(timings, "lloyd_loop", dev):
            centers, n_iter, cost, counts = kmeans_kernel.lloyd_run_kernel(
                table.data, weights, centers0, self.max_iter, self.tol, mode=tier,
                row_chunks=2 ** int(level),
            )
            centers = centers.cpu().numpy()
            cost = float(cost)
            counts = counts.cpu().numpy()
        kernels = {
            name: kmeans_kernel.LAUNCHES[name] - before.get(name, 0)
            for name in kmeans_kernel.LAUNCHES
        }
        summary = KMeansSummary(
            cost, int(n_iter), timings, accelerated=True,
            cluster_sizes=counts, kernels=kernels, precision=pol,
        )
        return KMeansModel(centers, self.distance_measure, summary, device=self.device)

    def _fit_mesh(self, x, sample_weight, devices) -> KMeansModel:
        """The mesh route of the JAX package's ``_fit_tpu_inner`` /
        ``_run_lloyd`` on a (data, model) mesh: the data-parallel Lloyd on
        a model axis of 1, the model-sharded one above it."""
        cfg = get_config()
        pol = psn.resolve("kmeans")
        tier = psn.kernel_tier(pol, cfg.matmul_precision)
        psn.apply_matmul_flags(tier)
        kmeans_ops.ring_mode_cfg(cfg)  # a typo raises on every mesh fit
        mesh = get_mesh(devices=devices)
        n_model = mesh.shape[cfg.model_axis]
        first = mesh.device(mesh.local_ranks[0])
        timings = Timings("kmeans.fit")
        before = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
        d_orig = x.shape[1]
        with phase_timer(timings, "table_convert", mesh.distinct_devices()):
            if d_orig % n_model:
                # zero feature columns add nothing to distances or moves,
                # and their center entries stay 0; sliced off below
                pad = (-d_orig) % n_model
                x = (torch.nn.functional.pad(x, (0, pad)) if isinstance(x, torch.Tensor)
                     else np.pad(x, ((0, 0), (0, pad))))
            if mesh.processes > 1:
                # this process's rows: its part of the init's table and
                # its ranks' tiles; weights are its rows' own
                table = DenseTable.from_process_local(x, first)
                sharded = ShardedTable.from_process_local(x, mesh)
            else:
                table = DenseTable.from_numpy(x, first)
                sharded = ShardedTable.from_numpy(table.data, mesh)
            weights, tile_weights = table.mask, sharded.mask
            if sample_weight is not None:
                weights = table.align_weights(sample_weight)
                tile_weights = sharded.align_weights(
                    weights if mesh.processes == 1 else _host(sample_weight))
        with phase_timer(timings, "init_centers", first):
            centers0 = self._init_centers(table, weights, first)
            del table, weights
        with phase_timer(timings, "lloyd_loop", mesh.distinct_devices()):
            if n_model == 1:
                centers, n_iter, cost, counts = kmeans_ops.lloyd_run_data_parallel(
                    sharded.tiles, tile_weights, centers0, self.max_iter, self.tol, mesh,
                    cfg.data_axis, mode=tier,
                )
            else:
                centers, n_iter, cost, counts = kmeans_ops.lloyd_run_model_sharded(
                    sharded.tiles, tile_weights, centers0, self.max_iter, self.tol, mesh,
                    cfg.data_axis, cfg.model_axis, precision=tier, policy=pol,
                )
            centers = centers[:, :d_orig].cpu().numpy()
            cost = float(cost)
            counts = counts.cpu().numpy()
        after = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
        summary = KMeansSummary(
            cost, int(n_iter), timings, accelerated=True, cluster_sizes=counts,
            kernels={name: after[name] - before.get(name, 0) for name in after},
            precision=pol, mesh=dict(mesh.shape),
            ring=n_model > 1 and kmeans_ops.ring_enabled(mesh, cfg.data_axis),
        )
        return KMeansModel(centers, self.distance_measure, summary, device=str(first))

    # -- numpy reference path (cosine distance) ------------------------------
    def _fit_fallback(self, x: np.ndarray, sample_weight) -> KMeansModel:
        timings = Timings("kmeans.fit")
        x = x.astype(np.float64)
        if sample_weight is not None:
            sample_weight = _host(sample_weight)
        with phase_timer(timings, "init_centers"):
            if self.init_mode == INIT_RANDOM:
                centers0 = kmeans_ops.init_random(x, x.shape[0], self.k, self.seed)
            else:
                # host k-means++ over full data as the || analog (small-data path)
                rng = np.random.default_rng(self.seed)
                w = np.ones(x.shape[0]) if sample_weight is None else np.asarray(sample_weight)
                centers0 = kmeans_ops._weighted_kmeans_pp(x, w, self.k, rng)
        with phase_timer(timings, "lloyd_loop"):
            centers, n_iter, cost = lloyd_np(
                x, centers0, self.max_iter, self.tol, sample_weight, self.distance_measure
            )
        assign = predict_np(x, centers, self.distance_measure)
        w = np.ones(len(x)) if sample_weight is None else np.asarray(sample_weight)
        sizes = np.zeros(self.k)
        np.add.at(sizes, assign, w)
        summary = KMeansSummary(cost, n_iter, timings, accelerated=False, cluster_sizes=sizes)
        return KMeansModel(centers, self.distance_measure, summary, device=self.device)
