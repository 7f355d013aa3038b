"""Debug table printers (the JAX package's ``utils/debug.py``): the
reference's ``Service.printNumericTable`` family, off the hot path.

Each printer fetches only the printed head: a tensor on a card moves its
first rows to the host, a ``DenseTable`` prints its valid rows, a
``ShardedTable`` (or a ``{rank: tile}`` dictionary) its first data rank's
tiles joined along the model axis.
"""

from __future__ import annotations

import numpy as np


def _head_and_shape(data, n: int):
    """``(first n rows as a host array, full shape)`` of a table."""
    import torch

    from oap_mllib_tpu_torch.data.table import DenseTable, ShardedTable

    if isinstance(data, DenseTable):
        rows = data.local_valid if data.local_valid is not None else data.n_rows
        return _head_and_shape(data.data[:rows], n)
    if isinstance(data, ShardedTable):
        head, _ = _head_and_shape(data.tiles, n)
        width = sum(t.shape[1] for (i, _), t in data.tiles.items() if i == 0)
        return head, (data.n_rows, width)
    if isinstance(data, dict):
        first = min(i for i, _ in data)
        tiles = [data[r] for r in sorted(data) if r[0] == first]
        head = np.concatenate([_head_and_shape(t, n)[0].reshape(min(n, t.shape[0]), -1)
                               for t in tiles], axis=1)
        rows = {i: t.shape[0] for (i, _), t in data.items()}
        return head, (sum(rows.values()), head.shape[1])
    if isinstance(data, torch.Tensor):
        return data[:n].detach().cpu().numpy(), tuple(data.shape)
    arr = np.asarray(data)
    return arr[:n], arr.shape


def format_table(data, title: str = "", max_rows: int = 10,
                 max_cols: int = 20, precision: int = 6) -> str:
    """A 2-D table as ``printNumericTable`` prints it: a title line with
    the shape, then the first rows and columns, fixed point."""
    head, full_shape = _head_and_shape(data, max_rows)
    head = np.asarray(head)
    if head.ndim == 1:
        head = head[:, None]
    n_rows = full_shape[0] if full_shape else 0
    n_cols = full_shape[1] if len(full_shape) > 1 else 1
    lines = [f"{title or 'table'} ({n_rows} x {n_cols})"]
    for r in head[:, :max_cols]:
        lines.append("  " + " ".join(f"{v: .{precision}f}" for v in r))
    trailer = []
    if head.shape[0] < n_rows:
        trailer.append(f"{n_rows - head.shape[0]} more rows")
    if head.shape[1] > max_cols:
        trailer.append(f"{head.shape[1] - max_cols} more cols")
    if trailer:
        lines.append(f"  ... ({', '.join(trailer)})")
    return "\n".join(lines)


def print_table(data, title: str = "", max_rows: int = 10,
                max_cols: int = 20, precision: int = 6) -> None:
    print(format_table(data, title, max_rows, max_cols, precision))


def _csr_parts(table):
    """``(row_offsets, cols, values, n_rows, n_cols, nnz)`` of a table with
    ``row_offsets`` / ``cols`` / ``values`` (the JAX package's CSRTable's
    fields) or a SciPy CSR matrix (``indptr`` / ``indices`` / ``data``)."""
    if hasattr(table, "indptr"):
        n_rows, n_cols = table.shape
        return table.indptr, table.indices, table.data, n_rows, n_cols, int(table.nnz)
    return (table.row_offsets, table.cols, table.values, int(table.n_rows),
            int(table.n_cols), int(table.nnz))


def format_csr(table, title: str = "", max_rows: int = 10, precision: int = 4) -> str:
    """A CSR table row by row (``printCSRNumericTable``): each row's
    ``col:value`` pairs from the row offsets.  Only the printed rows'
    offsets and entries are fetched."""
    offsets, cols, vals, n_rows, n_cols, nnz = _csr_parts(table)
    shown = min(max_rows, n_rows)
    offsets = _head_and_shape(offsets, shown + 1)[0]
    head_nnz = int(offsets[-1])
    cols = _head_and_shape(cols, head_nnz)[0]
    vals = _head_and_shape(vals, head_nnz)[0]
    lines = [f"{title or 'csr'} ({n_rows} x {n_cols}, nnz={nnz})"]
    for r in range(shown):
        lo, hi = int(offsets[r]), int(offsets[r + 1])
        pairs = " ".join(f"{int(c)}:{v:.{precision}f}" for c, v in zip(cols[lo:hi], vals[lo:hi]))
        lines.append(f"  [{r}] {pairs}")
    if n_rows > max_rows:
        lines.append(f"  ... ({n_rows - max_rows} more rows)")
    return "\n".join(lines)


def print_csr(table, title: str = "", max_rows: int = 10, precision: int = 4) -> None:
    print(format_csr(table, title, max_rows, precision))
