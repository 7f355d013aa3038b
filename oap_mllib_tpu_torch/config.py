"""Configuration of the port: the fields of the JAX package's ``Config``
that the K-Means, PCA and ALS routes read, plus the device.

Env mapping, as in the JAX package: field ``foo_bar`` <- env
``OAP_MLLIB_TPU_FOO_BAR``.

- ``device``: ``"cuda"`` (default) or ``"cpu"``.  Entry points run on the
  card unless the caller asks for the CPU; a missing card raises
  (utils/dispatch.resolve_device), it is never a reason to run elsewhere.
  A comma-separated list (``"cuda:0,cuda:1,cuda:2,cuda:3"``,
  ``"cuda:0,cuda:0,cuda:0,cuda:0"``, ``"cpu,cpu,cpu,cpu"``) names the
  ranks of a device mesh, the counterpart of the JAX package's
  ``jax.devices()`` world (utils/dispatch.resolve_devices).
- ``data_axis`` / ``model_axis``: the mesh's axis names; ``model_parallel``
  the size of its model axis (parallel/mesh.get_mesh).  A K-Means or PCA
  fit on a mesh with ``model_parallel > 1`` shards the features over the
  model axis (ops/kmeans_ops.lloyd_run_model_sharded,
  ops/pca_ops.covariance_model_sharded); with 1 it shards the rows.
- ``ring_reduction``: "auto" / "on" reduce the per-pass K-Means moments
  over the data axis with one ring (ops/cuda/ring_kernel.ring_allreduce)
  when that axis has two ranks or more; "off" keeps three psums.
- ``seed``: the seed of estimators that do not set one.
- ``matmul_precision``: the f32 policy's kernel tier ("highest", "high",
  "default").
- ``compute_precision`` / ``kmeans_precision`` / ``pca_precision`` /
  ``als_precision``: the compute-precision policy ("f32", "tf32",
  "bf16"; "auto" resolves to "f32"); a per-algorithm override is empty
  to inherit.
- ``pca_solver``: "auto" or "eigh" (the full eigendecomposition), or
  "randomized" (ops/pca_ops.topk_eigh_randomized: subspace iteration
  on a probe of ``k + pca_rand_oversample`` columns, ``pca_rand_iters``
  products with a QR each); a typo raises at fit entry.
- ``pca_rand_oversample`` (16) / ``pca_rand_iters`` (8): the randomized
  solver's probe width beyond k and its iterations, each >= 1 (checked
  at fit entry when the solver is "randomized").
- ``als_kernel``: the ALS normal-equation layout, "auto" (grouped unless
  its padding blows up, as in the JAX package), "grouped" or "coo".
- ``als_item_layout``: the item factors of an ALS fit on a mesh,
  "replicated" (ops/als_block.py), "sharded" (the 2-D layout, both
  factor tables block-sharded) or "auto" (sharded only past the JAX
  package's payload crossover, ``als_block.ITEM_SHARD_AUTO_BYTES``).
- ``prefetch_depth``: chunks the streamed passes stage ahead of the
  consumer (data/prefetch.py); 2 (default) overlaps the next chunk's
  host staging and host-to-device copy with this chunk's kernel, 1 is
  the serial loop.
- ``memory_budget_hbm`` / ``memory_budget_host``: the budgets the route
  planner prices a fit against (utils/membudget.py): "" detects them
  (the card's memory, the host's RAM; 0 on the CPU, unbounded), "0" or
  "unlimited" is unbounded, else bytes with an optional K/M/G/T suffix.
- ``scale_policy``: "auto" takes the first route that fits the budgets
  and warns when that is not the fit's natural one, "strict" raises
  ``BudgetError`` instead, "pin:<route>" forces a route.
- ``num_processes`` / ``process_id``: the world of processes a fit
  spans (parallel/bootstrap.initialize_distributed); 1 is one process.
  With more, every fit treats its input as this process's shard, and
  ``device`` names this process's LOCAL devices.
- ``coordinator_address`` / ``coordinator_port``: where process 0 hosts
  the rendezvous (port 0 = 3000); empty on process 0 discovers its own
  address and a free port, and a non-zero process without one raises.
- ``bootstrap_timeout``: seconds the join retries a refused coordinator
  connection before it raises.
- ``collective_timeout``: seconds a cross-process collective may wait
  for its peers (600 by default; 0 disarms the watcher and leaves gloo
  its own default, 30 minutes; negative raises).  Above 0, in a world
  of several processes, every host collective runs under the recovery
  plane's watcher (utils/recovery.guarded_dispatch), which raises
  ``CollectiveTimeoutError`` at the deadline; gloo's own timeout is set
  ``recovery.GLOO_MARGIN_S`` past it, so the watcher fires first.  A
  process that exits closes its connections, and its peers' gloo calls
  fail at once: the watcher maps that to ``PeerAbortError``.  The JAX
  package defaults to 0 (disarmed).
- ``crash_dir``: the recovery sideband ("" = off).  Set, a fatal fault
  of a fit in a world of several processes writes this process's crash
  record (``crash.rank<r>.json``), peers blocked in a watched
  collective abort when one appears, and the ladder reads
  "supervised".  The supervisor (utils/supervisor.py) sets it for every
  process it launches.
- ``restart_budget`` (3) / ``restart_backoff`` (1.0 s) /
  ``shrink_after`` (2): the supervisor's relaunch budget, the base of
  its exponential backoff, and the consecutive failures blamed on one
  process before the world shrinks by one.
- ``checkpoint_dir``: "" (default) is off; set, every fit writes its
  iterate state every ``checkpoint_interval`` (1) steps
  (utils/checkpoint.py, the JAX package's on-disk format) and restores
  it under ``resume``: "auto" (default) resumes a matching checkpoint
  and starts fresh otherwise (a corrupt one with a warning),
  "require" raises ``CheckpointError`` unless one restores, "off"
  writes but never reads.
- ``capability_sharding``: "auto" (default) weighs each process's share
  by its capability in a world of several processes, "on" everywhere
  (one process plans the equal layout), "off" keeps equal shares
  (parallel/balance.py): the row extents of the streamed fits over
  ``balance.local_sources`` and the user blocks of the replicated-item
  block ALS.
- ``rank_capability``: "" probes each process's capability
  (utils/dispatch.throughput_probe); a bare float pins this process's,
  a map "0:1.0,1:0.5" pins by process index (absent ones probe).
  Values are > 0.
- ``probe_epoch``: the generation of the cached probe and capability
  gather; bumping it makes the next plan measure again.
- ``rebalance_threshold`` (> 1) and ``rebalance_patience`` (>= 1): the
  straggler controller re-plans the extents when a pass's skew ratio
  (the slowest process's pass wall over the mean) stays above the
  threshold for ``patience`` passes and is not falling.
- ``fleet_stats``: "auto" (default) gathers one frame of pass statistics
  a process after every streamed pass in a world of several processes,
  "on" also in one, "off" never (telemetry/fleet.py); the controller
  reads those frames.

The JAX package's ``pca_kernel`` and ``als_solve_kernel`` choose between
Pallas and XLA; the port has one device route, its CUDA kernels, so it
has neither field.  Its ``shape_bucketing`` sizes compiled programs;
the port compiles none per shape and buckets chunk widths at the JAX
default (data/bucketing.py).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

_ENV_PREFIX = "OAP_MLLIB_TPU_"
# env values read as the field's type (the annotations are strings here)
_COERCE = {"int": int, int: int, "float": float, float: float}


@dataclasses.dataclass
class Config:
    device: str = "cuda"
    seed: int = 0
    matmul_precision: str = "highest"
    compute_precision: str = "f32"
    kmeans_precision: str = ""
    pca_precision: str = ""
    als_precision: str = ""
    pca_solver: str = "auto"
    als_kernel: str = "auto"
    als_item_layout: str = "auto"
    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1
    ring_reduction: str = "auto"
    prefetch_depth: int = 2
    memory_budget_hbm: str = ""
    memory_budget_host: str = ""
    scale_policy: str = "auto"
    num_processes: int = 1
    process_id: int = 0
    coordinator_address: str = ""
    coordinator_port: int = 0
    bootstrap_timeout: float = 60.0
    collective_timeout: float = 600.0
    capability_sharding: str = "auto"
    rank_capability: str = ""
    probe_epoch: int = 0
    rebalance_threshold: float = 1.5
    rebalance_patience: int = 3
    fleet_stats: str = "auto"
    pca_rand_oversample: int = 16
    pca_rand_iters: int = 8
    nonfinite_policy: str = "raise"
    retry_limit: int = 5
    retry_backoff: float = 0.05
    retry_deadline: float = 30.0
    fault_spec: str = ""
    chaos: str = ""
    spill_dir: str = ""
    crash_dir: str = ""
    restart_budget: int = 3
    restart_backoff: float = 1.0
    shrink_after: int = 2
    checkpoint_dir: str = ""
    checkpoint_interval: int = 1
    resume: str = "auto"

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            raw = os.environ.get(_ENV_PREFIX + f.name.upper())
            if raw is None:
                continue
            setattr(cfg, f.name, _COERCE.get(f.type, str)(raw))
        return cfg


_lock = threading.Lock()
_config: Optional[Config] = None


def get_config() -> Config:
    """The process-global config, read from the environment on first use."""
    global _config
    with _lock:
        if _config is None:
            _config = Config.from_env()
        return _config


def set_config(**updates) -> Config:
    """Update the process-global config in place; returns it."""
    cfg = get_config()
    with _lock:
        for k, v in updates.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown config field: {k!r}")
            setattr(cfg, k, v)
    return cfg


def reset_config() -> None:
    """Drop the global config; the next read starts from the environment."""
    global _config
    with _lock:
        _config = None
