"""Device-resident dense table: the port of the JAX package's
``DenseTable.from_numpy`` for one device.

``mask`` is the per-row weight vector (1.0 on every valid row).  The
kernels mask ragged edges themselves, so the table needs no padding
rows; the JAX package's padding, mesh sharding and shape bucketing
serve its compile cache and mesh, which the eager single-device port
does not have.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
        """Table of ``x`` (an ndarray or a tensor) on ``device``."""
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
