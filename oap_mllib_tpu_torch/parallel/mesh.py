"""Device mesh: the port of the JAX package's ``parallel/mesh.py``.

A :class:`Mesh` is a (data, model) grid of torch devices held by ONE
process, as the JAX package's mesh is one process driving several
devices:

- the ``data`` axis shards rows;
- the ``model`` axis shards features (the model-sharded K-Means Lloyd,
  ops/kmeans_ops.lloyd_run_model_sharded).

Rank ``(i, j)`` is the device at row ``i``, column ``j`` of the grid.
Per-rank values are dictionaries ``{(i, j): tensor}``, each tensor on
its rank's device; the collectives (parallel/collective.py and the ring,
ops/cuda/ring_kernel.py) reduce them along one axis.

A device may repeat in the grid: ``"cuda:0,cuda:0,cuda:0,cuda:0"`` is a
four-rank world on one card and ``"cpu,cpu,cpu,cpu"`` one on the CPU.
The ranks still hold separate buffers and run the same schedule, so a
one-card or CPU world computes what a world of distinct cards computes.

In a world of several processes (parallel/bootstrap.py) the grid spans
the world: it is built from every process's devices, gathered at the
join, process 0's first, exactly as one process's grid is built from
its list.  Each rank belongs to the process whose device it is
(:meth:`Mesh.process_of`); a process holds and computes only its
:attr:`Mesh.local_ranks`, so per-rank dictionaries hold the local ranks'
tensors, and the collectives reach the other processes' ranks.  A
process's ranks must fill whole rows of the grid (its device count a
multiple of ``model_parallel``): every process holds whole rows of its
own table shard.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.utils.dispatch import resolve_devices

Rank = Tuple[int, int]


class Mesh:
    """A (data, model) grid of torch devices.  ``shape[axis]`` is the
    size of an axis and ``axis_names`` their names, as on a JAX mesh."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 axis_names: Tuple[str, str],
                 owners: Optional[Sequence[Sequence[int]]] = None, process: int = 0):
        self.devices = [list(row) for row in devices]
        if not self.devices or any(len(r) != len(self.devices[0]) for r in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {
            axis_names[0]: len(self.devices), axis_names[1]: len(self.devices[0]),
        }
        # the process that holds each rank (all 0 in one process)
        self.owners = ([list(row) for row in owners] if owners is not None
                       else [[0] * len(r) for r in self.devices])
        self.process = process
        self.processes = 1 + max(max(row) for row in self.owners)

    def process_of(self, rank: Rank) -> int:
        """The process that holds ``rank``."""
        return self.owners[rank[0]][rank[1]]

    def is_local(self, rank: Rank) -> bool:
        return self.process_of(rank) == self.process

    @property
    def local_ranks(self) -> List[Rank]:
        """The ranks this process holds, row by row (every rank in one
        process)."""
        return [r for r in self.ranks if self.is_local(r)]

    def spans(self, ranks: Sequence[Rank]) -> bool:
        """Whether ``ranks`` lie in more than one process."""
        return len({self.process_of(r) for r in ranks}) > 1

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def ranks(self) -> List[Rank]:
        """Every rank, row by row."""
        return [(i, j) for i in range(len(self.devices))
                for j in range(len(self.devices[0]))]

    def device(self, rank: Rank) -> torch.device:
        return self.devices[rank[0]][rank[1]]

    def groups(self, axis: str) -> List[List[Rank]]:
        """The ranks that reduce together along ``axis``, group by group,
        each group in axis order."""
        d, m = len(self.devices), len(self.devices[0])
        if axis == self.axis_names[0]:
            return [[(i, j) for i in range(d)] for j in range(m)]
        if axis == self.axis_names[1]:
            return [[(i, j) for j in range(m)] for i in range(d)]
        raise ValueError(f"unknown mesh axis {axis!r}; the mesh has {self.axis_names}")

    def distinct_devices(self) -> List[torch.device]:
        """This process's distinct devices, in rank order."""
        out = []
        for rank in self.local_ranks:
            if self.device(rank) not in out:
                out.append(self.device(rank))
        return out


def get_mesh(n_devices: Optional[int] = None, model_parallel: Optional[int] = None,
             devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (None = the ranks of
    ``Config.device``), the first ``n_devices`` of them when given, with
    ``model_parallel`` (None = ``Config.model_parallel``) ranks on the
    model axis.

    In a world of several processes ``devices`` are this process's own
    (they must be the ones it joined with) and the grid spans every
    process's devices, in the order gathered at the join; ``n_devices``
    then counts the world's devices, a whole number of processes'."""
    from oap_mllib_tpu_torch.parallel import bootstrap

    cfg = get_config()
    if model_parallel is None:
        model_parallel = cfg.model_parallel
    if devices is None:
        devices = resolve_devices()
    devices = list(devices)
    owners = [0] * len(devices)
    process = 0
    if bootstrap.world_size() > 1:
        world = bootstrap.world_devices()
        process = bootstrap.process_index()
        if [str(d) for d in devices] != world[process]:
            raise ValueError(
                f"this process joined the world with devices {world[process]}; a fit "
                f"in the world runs on those, not on {[str(d) for d in devices]}"
            )
        # other processes' devices name their own cards: keep the names,
        # each rank's owner says whose they are
        devices = [torch.device(name) for names in world for name in names]
        owners = [p for p, names in enumerate(world) for _ in names]
        for p, names in enumerate(world):
            if len(names) % model_parallel:
                raise ValueError(
                    f"process {p} holds {len(names)} devices, not a multiple of "
                    f"model_parallel={model_parallel}: a process holds whole rows "
                    "of the mesh (its own rows of the table)"
                )
    if n_devices is not None:
        devices, owners = devices[:n_devices], owners[:n_devices]
        if process not in owners:
            raise ValueError(f"n_devices={n_devices} leaves out this process ({process})")
    n = len(devices)
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"device count {n} not divisible by model_parallel={model_parallel}"
        )
    grid = [devices[i:i + model_parallel] for i in range(0, n, model_parallel)]
    own = [owners[i:i + model_parallel] for i in range(0, n, model_parallel)]
    return Mesh(grid, (cfg.data_axis, cfg.model_axis), own, process)


def pad_rows(x: np.ndarray, multiple: int, fill: float = 0.0):
    """Pad the leading dim of ``x`` up to a multiple; returns
    ``(padded, n_valid)``."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    pad_width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill), n


def row_mask(n_valid: int, n_padded: int) -> np.ndarray:
    """Validity mask for padded rows (True for real rows)."""
    mask = np.zeros((n_padded,), dtype=bool)
    mask[:n_valid] = True
    return mask
