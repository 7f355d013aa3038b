"""SciPy sparse input, densified one block at a time (the JAX
package's ``data/sparse.py``, copied).

The fits take dense tables, so sparse input densifies somewhere: per
chunk when it streams (``ChunkSource.from_array``), or block by block
into the preallocated table of the in-memory route
(:func:`densify_into`), never as one whole dense copy beside the CSR.
SciPy stays optional: detection looks at the type's module, so the
package never imports scipy unless the caller passed a scipy object.
"""

from __future__ import annotations

import numpy as np

# rows densified per block when filling a dense table from CSR (8k rows
# of f32 at d = 256 is ~8 MB)
DENSIFY_BLOCK_ROWS = 8192


def is_sparse(x) -> bool:
    """True for scipy.sparse matrices and arrays of any format."""
    mod = type(x).__module__ or ""
    return mod.startswith("scipy.sparse") and hasattr(x, "tocsr")


def densify_into(out: np.ndarray, x, n_rows: int,
                 block_rows: int = DENSIFY_BLOCK_ROWS) -> None:
    """Fill ``out[:n_rows]`` with the dense rows of sparse ``x``, one
    ``block_rows`` slice at a time (a CSR row slice costs its nnz)."""
    csr = x.tocsr()
    for lo in range(0, n_rows, block_rows):
        hi = min(lo + block_rows, n_rows)
        out[lo:hi] = csr[lo:hi].toarray()


def nbytes(x) -> int:
    """Host bytes a sparse matrix occupies (data + indices + indptr)."""
    csr = x.tocsr()
    return int(csr.data.nbytes + csr.indices.nbytes + csr.indptr.nbytes)
