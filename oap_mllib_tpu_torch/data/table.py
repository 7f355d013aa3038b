"""Device-resident dense tables: the port of the JAX package's
``DenseTable.from_numpy``.

- :class:`DenseTable` lies on one device.  ``mask`` is the per-row
  weight vector (1.0 on every valid row).  The kernels mask ragged
  edges themselves, so the table needs no padding rows; the JAX
  package's shape bucketing serves its compile cache, which the eager
  port does not have.
- :class:`ShardedTable` lies on a mesh (parallel/mesh.py): rows pad as
  the JAX table pads them for its mesh, to a multiple of
  ``data * 256`` (the exact multiple, no bucketing), with a mask of
  the valid rows, and tile ``(i, j)`` (row shard ``i``, feature shard
  ``j``) lies on the device of rank ``(i, j)``.

In a world of several processes (parallel/bootstrap.py) no process
holds the whole table: each builds its tables from its own rows with
``from_process_local`` (the JAX package's
``DenseTable.from_process_local``, the reference's per-executor table
build).  Each process pads its shard on its own, the processes allgather
``[valid rows, padded rows]`` and every shard re-pads to the largest, so
the global layout is process-major with padding in the middle; the table
records ``local_valid`` and ``per_process_valid``, which map a global
valid-row index to the padded layout (``valid_to_padded``) and align
this process's row weights with it (``align_weights``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.parallel import collective
from oap_mllib_tpu_torch.parallel.mesh import Mesh, Rank, row_mask

# rows pad per data shard to this multiple, as in the JAX package
_ROW_MULTIPLE = 256


def as_float_tensor(x, device) -> torch.Tensor:
    """``x`` (an ndarray, array-like or tensor) as a float32 tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    a = np.asarray(x, dtype=np.float32)
    if not a.flags.writeable:  # torch.from_numpy needs a writable array
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _local_layout(x_local: np.ndarray, multiple: int) -> Tuple[int, np.ndarray, int]:
    """This process's shard padded to ``multiple``, then to the largest
    padded shard of the world: ``(local padded rows, every process's
    valid rows, this process's valid rows)``.  A collective."""
    n = int(x_local.shape[0])
    padded = -(-max(n, 1) // multiple) * multiple
    (gathered,) = collective.process_allgather([np.asarray([n, padded], np.int64)])
    return int(gathered[:, 1].max()), gathered[:, 0].copy(), n


def _host_rows(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class DenseTable:
    data: torch.Tensor  # (n, d) float32
    mask: torch.Tensor  # (n,) float32 row weights
    n_rows: int
    # several processes: this process's valid rows and every process's
    # (None for a table of one process)
    local_valid: Optional[int] = None
    per_process_valid: Optional[np.ndarray] = None

    @classmethod
    def from_process_local(cls, x_local, device, dtype=torch.float32) -> "DenseTable":
        """This process's rows as its part of a table spanning the world
        (a collective): padded at the end to the world's largest padded
        shard, ``n_rows`` the world's valid rows.  In one process it is
        :meth:`from_numpy`."""
        from oap_mllib_tpu_torch.parallel import bootstrap

        if bootstrap.world_size() == 1:
            return cls.from_numpy(x_local, device, dtype)
        x_local = _host_rows(x_local)
        if x_local.ndim != 2:
            raise ValueError(f"expected 2-D data, got shape {tuple(x_local.shape)}")
        target, counts, n = _local_layout(x_local, _ROW_MULTIPLE)
        data = torch.zeros((target, x_local.shape[1]), dtype=dtype, device=device)
        data[:n].copy_(torch.as_tensor(np.asarray(x_local, np.float32)))
        mask = torch.zeros((target,), dtype=dtype, device=device)
        mask[:n] = 1.0
        return cls(data=data, mask=mask, n_rows=int(counts.sum()), local_valid=n,
                   per_process_valid=counts)

    @property
    def row_offset(self) -> int:
        """The global valid index of this process's first row."""
        if self.per_process_valid is None:
            return 0
        from oap_mllib_tpu_torch.parallel import bootstrap

        return int(self.per_process_valid[:bootstrap.process_index()].sum())

    def gather_rows(self, idx) -> np.ndarray:
        """Rows at padded-layout indices ``idx`` (see
        :meth:`valid_to_padded`) on the host, on every process: each
        process contributes the rows it holds (a collective across
        processes)."""
        idx = np.asarray(idx, np.int64)
        if self.per_process_valid is None:
            sel = torch.as_tensor(idx, device=self.data.device)
            return self.data[sel].cpu().numpy()
        from oap_mllib_tpu_torch.parallel import bootstrap

        local_padded = self.data.shape[0]
        lo = bootstrap.process_index() * local_padded
        mine = (idx >= lo) & (idx < lo + local_padded)
        rows = np.zeros((len(idx), self.data.shape[1]), np.float32)
        if mine.any():
            sel = torch.as_tensor(idx[mine] - lo, device=self.data.device)
            rows[mine] = self.data[sel].float().cpu().numpy()
        gathered, owned = collective.process_allgather([rows, mine])
        return gathered[np.argmax(owned, axis=0), np.arange(len(idx))]

    @classmethod
    def from_numpy(cls, x, device, dtype=torch.float32) -> "DenseTable":
        """Table of ``x`` (an ndarray, a tensor or a SciPy sparse matrix,
        densified block by block into the host table, data/sparse.py) on
        ``device``."""
        from oap_mllib_tpu_torch.data import sparse as _sparse

        if _sparse.is_sparse(x):
            host = np.zeros(x.shape, np.float32)
            _sparse.densify_into(host, x, x.shape[0])
            x = host
        t = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
        if t.dim() != 2:
            raise ValueError(f"expected 2-D data, got shape {tuple(t.shape)}")
        t = t.to(device=device, dtype=dtype).contiguous()
        mask = torch.ones((t.shape[0],), dtype=dtype, device=t.device)
        return cls(data=t, mask=mask, n_rows=t.shape[0])

    def valid_to_padded(self, idx):
        """Valid-row indices ``[0, n_rows)`` to padded-layout indices: the
        identity for a table of one process; across processes the
        padding sits between the processes' rows."""
        idx = np.asarray(idx)
        if self.per_process_valid is None:
            return idx
        prefix = np.concatenate([[0], np.cumsum(self.per_process_valid)])
        proc = np.searchsorted(prefix, idx, side="right") - 1
        return proc * self.data.shape[0] + (idx - prefix[proc])

    def align_weights(self, w) -> torch.Tensor:
        """Per-row weights as a tensor on the table's device: all
        ``n_rows`` of them in one process, this process's
        ``local_valid`` across processes (zero on the padding)."""
        if not isinstance(w, torch.Tensor):
            w = torch.as_tensor(np.asarray(w))
        w = w.to(self.mask.dtype)
        want = self.n_rows if self.local_valid is None else self.local_valid
        if w.dim() != 1 or w.shape[0] != want:
            raise ValueError(
                f"sample_weight has shape {tuple(w.shape)}, "
                + (f"data has {self.n_rows} rows" if self.local_valid is None else
                   f"this process's local shard has {self.local_valid}")
            )
        if self.local_valid is None:
            return w.to(self.mask.device).contiguous()
        out = torch.zeros_like(self.mask)
        out[:want].copy_(w)
        return out


@dataclasses.dataclass
class ShardedTable:
    tiles: Dict[Rank, torch.Tensor]  # (n_padded / data, d / model) float32
    mask: Dict[Rank, torch.Tensor]  # (n_padded / data,) float32, 0 on padding
    n_rows: int
    n_padded: int
    mesh: Mesh
    local_valid: Optional[int] = None
    per_process_valid: Optional[np.ndarray] = None

    @classmethod
    def from_process_local(cls, x_local, mesh: Mesh) -> "ShardedTable":
        """This process's rows split over its own ranks (a collective
        across processes): the shard pads to a multiple of ``local data
        ranks * 256`` and then to the world's largest padded shard, and
        local data rank ``l`` holds its ``l``-th row block.  In a mesh of
        one process it is :meth:`from_numpy`."""
        if mesh.processes == 1:
            return cls.from_numpy(x_local, mesh)
        x_local = _host_rows(x_local)
        if x_local.ndim != 2:
            raise ValueError(f"expected 2-D data, got shape {tuple(x_local.shape)}")
        n_model = len(mesh.devices[0])
        d = x_local.shape[1]
        if d % n_model:
            raise ValueError(f"{d} features do not split over a model axis of {n_model}")
        rows = sorted({i for i, _ in mesh.local_ranks})
        target, counts, n = _local_layout(x_local, len(rows) * _ROW_MULTIPLE)
        n_loc, d_loc = target // len(rows), d // n_model
        valid = torch.from_numpy(row_mask(n, target).astype(np.float32))
        t = torch.as_tensor(np.asarray(x_local, np.float32))
        tiles, mask = {}, {}
        for i, j in mesh.local_ranks:
            dev = mesh.device((i, j))
            lo = rows.index(i) * n_loc
            hi = min(lo + n_loc, n)
            tile = torch.zeros((n_loc, d_loc), dtype=torch.float32, device=dev)
            if hi > lo:
                tile[:hi - lo].copy_(t[lo:hi, j * d_loc:(j + 1) * d_loc])
            tiles[(i, j)] = tile
            mask[(i, j)] = valid[lo:lo + n_loc].to(dev)
        return cls(tiles=tiles, mask=mask, n_rows=int(counts.sum()),
                   n_padded=target * mesh.processes, mesh=mesh, local_valid=n,
                   per_process_valid=counts)

    @classmethod
    def from_numpy(cls, x, mesh: Mesh) -> "ShardedTable":
        """Table of ``x`` (an ndarray or a tensor, ``d`` a multiple of the
        model axis) on ``mesh``: each tile is made on its rank's device
        from the valid rows it holds, zeros below them."""
        t = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
        if t.dim() != 2:
            raise ValueError(f"expected 2-D data, got shape {tuple(t.shape)}")
        n_data, n_model = len(mesh.devices), len(mesh.devices[0])
        n, d = t.shape
        if d % n_model:
            raise ValueError(f"{d} features do not split over a model axis of {n_model}")
        multiple = n_data * _ROW_MULTIPLE
        n_padded = -(-max(n, 1) // multiple) * multiple
        n_loc, d_loc = n_padded // n_data, d // n_model
        valid = torch.from_numpy(row_mask(n, n_padded).astype(np.float32))
        tiles, mask = {}, {}
        for i, j in mesh.local_ranks:
            dev = mesh.device((i, j))
            lo, hi = i * n_loc, min((i + 1) * n_loc, n)
            tile = torch.zeros((n_loc, d_loc), dtype=torch.float32, device=dev)
            if hi > lo:
                tile[:hi - lo].copy_(t[lo:hi, j * d_loc:(j + 1) * d_loc])
            tiles[(i, j)] = tile
            mask[(i, j)] = valid[i * n_loc:(i + 1) * n_loc].to(dev)
        return cls(tiles=tiles, mask=mask, n_rows=n, n_padded=n_padded, mesh=mesh)

    def align_weights(self, w) -> Dict[Rank, torch.Tensor]:
        """Per-row weights, one row shard per local rank, 0 on the padding
        rows: ``w`` covers the table's ``n_rows``, or across processes
        this process's ``local_valid``."""
        if not isinstance(w, torch.Tensor):
            w = torch.as_tensor(np.asarray(w))
        n_all = self.n_rows if self.local_valid is None else self.local_valid
        if w.dim() != 1 or w.shape[0] != n_all:
            raise ValueError(
                f"sample_weight has shape {tuple(w.shape)}, "
                + (f"data has {self.n_rows} rows" if self.local_valid is None else
                   f"this process's local shard has {self.local_valid}")
            )
        n_loc = self.n_padded // len(self.mesh.devices)
        rows = sorted({i for i, _ in self.mesh.local_ranks})
        out = {}
        for i, j in self.mesh.local_ranks:
            shard = torch.zeros((n_loc,), dtype=torch.float32, device=self.mesh.device((i, j)))
            lo = (rows.index(i) if self.local_valid is not None else i) * n_loc
            hi = min(lo + n_loc, n_all)
            if hi > lo:
                shard[:hi - lo].copy_(w[lo:hi])
            out[(i, j)] = shard
        return out
