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
                 axis_names: Tuple[str, str]):
        self.devices = [list(row) for row in devices]
        if not self.devices or any(len(r) != len(self.devices[0]) for r in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {
            axis_names[0]: len(self.devices), axis_names[1]: len(self.devices[0]),
        }

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
        out = []
        for rank in self.ranks:
            if self.device(rank) not in out:
                out.append(self.device(rank))
        return out


def get_mesh(n_devices: Optional[int] = None, model_parallel: Optional[int] = None,
             devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (None = the ranks of
    ``Config.device``), the first ``n_devices`` of them when given, with
    ``model_parallel`` (None = ``Config.model_parallel``) ranks on the
    model axis."""
    cfg = get_config()
    if model_parallel is None:
        model_parallel = cfg.model_parallel
    if devices is None:
        devices = resolve_devices()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"device count {n} not divisible by model_parallel={model_parallel}"
        )
    grid = [devices[i:i + model_parallel] for i in range(0, n, model_parallel)]
    return Mesh(grid, (cfg.data_axis, cfg.model_axis))


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
