"""File I/O of the port (the JAX package's ``data/io.py``).

- Durable writes for model persistence: tmp file + ``os.replace``, so a
  reader never sees a torn file.
- The out-of-core readers behind the file-backed ``ChunkSource``
  constructors (data/stream.py): memory-mapped ``.npy`` row slices and
  parquet batches (pyarrow, imported when called).
- The eager readers of the example formats: libsvm (``label idx:val``,
  1-based), dense CSV and ``user::item::rating`` lines.  These are the
  JAX package's Python parsers; its native C++ parsers are not ported.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


def _atomic_write(path: str, mode: str, write) -> int:
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".",
        prefix=os.path.basename(path) + ".", suffix=".tmp",
    )
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        nbytes = os.path.getsize(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return nbytes


def atomic_write_json(path: str, payload: dict) -> int:
    """Durably write ``payload`` as JSON.  Returns bytes written."""
    data = json.dumps(payload, sort_keys=True)
    return _atomic_write(path, "w", lambda f: f.write(data))


def atomic_save_npy(path: str, array: np.ndarray) -> int:
    """Durably write one ``.npy`` array.  Returns bytes written."""
    return _atomic_write(path, "wb", lambda f: np.save(f, array))


# -- out-of-core readers ----------------------------------------------------------


def open_npy_mmap(path: str) -> np.ndarray:
    """A 2-D ``.npy`` file as a read-only memory map."""
    arr = np.load(path, mmap_mode="r")
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected a 2-D array, got shape {arr.shape}")
    return arr


def iter_npy_rows(path: str, chunk_rows: int) -> Iterator[np.ndarray]:
    """Row slices of a ``.npy`` file, ``chunk_rows`` at a time, each read
    from disk here (``np.asarray`` detaches it from the map).  The map
    lives for one walk; every walk reopens the file."""
    arr = open_npy_mmap(path)
    for lo in range(0, arr.shape[0], chunk_rows):
        yield np.asarray(arr[lo:lo + chunk_rows])


def _pyarrow_parquet():
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise RuntimeError(
            "parquet sources require pyarrow; use ChunkSource.from_npy or "
            "from_csv where it is not installed"
        ) from e
    return pq


def iter_parquet_rows(path: str, chunk_rows: int,
                      columns: Optional[Sequence[str]] = None) -> Iterator[np.ndarray]:
    """Dense (rows, columns) f64 blocks of a parquet file, ``chunk_rows``
    a batch (pyarrow ``iter_batches``: no row group is read whole)."""
    pq = _pyarrow_parquet()
    pf = pq.ParquetFile(path)
    cols = list(columns) if columns is not None else None
    for batch in pf.iter_batches(batch_size=chunk_rows, columns=cols):
        arrays = [np.asarray(batch.column(i), dtype=np.float64)
                  for i in range(batch.num_columns)]
        yield np.stack(arrays, axis=1)


def parquet_schema(path: str) -> Tuple[int, int]:
    """(rows, columns) of a parquet file, from its footer."""
    meta = _pyarrow_parquet().ParquetFile(path).metadata
    return int(meta.num_rows), int(meta.num_columns)


# -- eager readers of the example formats --------------------------------------------


def read_libsvm(path: str, n_features: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """A libsvm file as dense ``(labels, X)`` (f64; 1-based indices)."""
    labels = []
    rows = []
    max_idx = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            feats = {}
            for tok in parts[1:]:
                idx, val = tok.split(":")
                idx = int(idx)
                feats[idx] = float(val)
                max_idx = max(max_idx, idx)
            rows.append(feats)
    d = n_features if n_features is not None else max_idx
    if n_features is not None and max_idx > n_features:
        raise ValueError(f"libsvm feature index {max_idx} exceeds n_features={n_features}")
    x = np.zeros((len(rows), d), dtype=np.float64)
    for i, feats in enumerate(rows):
        for idx, val in feats.items():
            x[i, idx - 1] = val
    return np.asarray(labels), x


def read_csv(path: str, delimiter: str = ",") -> np.ndarray:
    """A dense numeric CSV without header as an (n, d) f64 array."""
    return np.loadtxt(path, delimiter=delimiter, dtype=np.float64, ndmin=2)


def read_ratings(path: str, sep: str = "::") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``user<sep>item<sep>rating`` lines as (users int64, items int64,
    ratings f32)."""
    users, items, ratings = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            u, i, r = line.split(sep)[:3]
            users.append(int(u))
            items.append(int(i))
            ratings.append(float(r))
    return (np.asarray(users, dtype=np.int64), np.asarray(items, dtype=np.int64),
            np.asarray(ratings, dtype=np.float32))
