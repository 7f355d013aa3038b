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
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

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


@dataclasses.dataclass
class DenseTable:
    data: torch.Tensor  # (n, d) float32
    mask: torch.Tensor  # (n,) float32 row weights
    n_rows: int

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
        """Valid-row indices to table-row indices: the identity on one
        device (the JAX package's multi-host tables pad mid-array)."""
        return np.asarray(idx)

    def align_weights(self, w) -> torch.Tensor:
        """Per-row weights as a tensor on the table's device."""
        if not isinstance(w, torch.Tensor):
            w = torch.as_tensor(np.asarray(w))
        w = w.to(self.mask.dtype)
        if w.dim() != 1 or w.shape[0] != self.n_rows:
            raise ValueError(
                f"sample_weight has shape {tuple(w.shape)}, data has "
                f"{self.n_rows} rows"
            )
        return w.to(self.mask.device).contiguous()


@dataclasses.dataclass
class ShardedTable:
    tiles: Dict[Rank, torch.Tensor]  # (n_padded / data, d / model) float32
    mask: Dict[Rank, torch.Tensor]  # (n_padded / data,) float32, 0 on padding
    n_rows: int
    n_padded: int
    mesh: Mesh

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
        for i, j in mesh.ranks:
            dev = mesh.device((i, j))
            lo, hi = i * n_loc, min((i + 1) * n_loc, n)
            tile = torch.zeros((n_loc, d_loc), dtype=torch.float32, device=dev)
            if hi > lo:
                tile[:hi - lo].copy_(t[lo:hi, j * d_loc:(j + 1) * d_loc])
            tiles[(i, j)] = tile
            mask[(i, j)] = valid[i * n_loc:(i + 1) * n_loc].to(dev)
        return cls(tiles=tiles, mask=mask, n_rows=n, n_padded=n_padded, mesh=mesh)

    def align_weights(self, w) -> Dict[Rank, torch.Tensor]:
        """Per-row weights, one row shard per rank, 0 on the padding rows."""
        if not isinstance(w, torch.Tensor):
            w = torch.as_tensor(np.asarray(w))
        if w.dim() != 1 or w.shape[0] != self.n_rows:
            raise ValueError(
                f"sample_weight has shape {tuple(w.shape)}, data has {self.n_rows} rows"
            )
        n_loc = self.n_padded // len(self.mesh.devices)
        out = {}
        for i, j in self.mesh.ranks:
            shard = torch.zeros((n_loc,), dtype=torch.float32, device=self.mesh.device((i, j)))
            lo, hi = i * n_loc, min((i + 1) * n_loc, self.n_rows)
            if hi > lo:
                shard[:hi - lo].copy_(w[lo:hi])
            out[(i, j)] = shard
        return out
