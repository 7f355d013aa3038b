"""File I/O of the port (the JAX package's ``data/io.py``).

- Durable writes for model persistence and the checkpoint shards
  (utils/checkpoint.py): tmp file + ``os.replace``, so a reader never
  sees a torn file; :func:`load_npz` reads a shard whole.
- The out-of-core readers behind the file-backed ``ChunkSource``
  constructors (data/stream.py): memory-mapped ``.npy`` row slices and
  parquet batches (pyarrow, imported when called).  Every piece read is
  a fault site (utils/faults.py): ``disk.read``, or ``spill.read`` for
  a spill's reads.
- :class:`SpillWriter`, the resilience ladder's host-OOM rung: a table
  written piece by piece to one ``.npy`` file, committed atomically
  (every piece the ``spill.write`` site).
- The eager readers of the example formats: libsvm (``label idx:val``,
  1-based), dense CSV and ``user::item::rating`` lines, parsed by the
  native host library's C++ parsers (native/, csrc/host/io_parse.cpp).
  Their plain versions, ``read_libsvm_plain``, ``read_csv_plain`` and
  ``read_ratings_plain``, are the JAX package's Python parsers and the
  contract the C++ holds to; the tests and chip_smoke call them by
  name, and no reader falls back to them.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from oap_mllib_tpu_torch.utils.faults import maybe_fault


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


def read_json(path: str) -> dict:
    """Read a JSON file written by :func:`atomic_write_json`."""
    with open(path) as f:
        return json.load(f)


def atomic_save_npy(path: str, array: np.ndarray) -> int:
    """Durably write one ``.npy`` array.  Returns bytes written."""
    return _atomic_write(path, "wb", lambda f: np.save(f, array))


def atomic_save_npz(path: str, arrays: Dict[str, np.ndarray]) -> int:
    """Durably write an uncompressed ``.npz`` of ``arrays``.  Returns
    bytes written."""
    return _atomic_write(path, "wb", lambda f: np.savez(f, **arrays))


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of an ``.npz`` in host memory; the file is closed
    before this returns (checkpoint GC unlinks old generations while
    restored state is still in use)."""
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


# -- out-of-core readers ----------------------------------------------------------


def open_npy_mmap(path: str) -> np.ndarray:
    """A 2-D ``.npy`` file as a read-only memory map."""
    arr = np.load(path, mmap_mode="r")
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected a 2-D array, got shape {arr.shape}")
    return arr


def iter_npy_rows(path: str, chunk_rows: int,
                  fault_site: str = "disk.read") -> Iterator[np.ndarray]:
    """Row slices of a ``.npy`` file, ``chunk_rows`` at a time, each read
    from disk here (``np.asarray`` detaches it from the map) and each a
    ``fault_site`` call.  The map lives for one walk; every walk reopens
    the file."""
    arr = open_npy_mmap(path)
    for lo in range(0, arr.shape[0], chunk_rows):
        maybe_fault(fault_site)
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
        maybe_fault("disk.read")
        arrays = [np.asarray(batch.column(i), dtype=np.float64)
                  for i in range(batch.num_columns)]
        yield np.stack(arrays, axis=1)


def parquet_schema(path: str) -> Tuple[int, int]:
    """(rows, columns) of a parquet file, from its footer."""
    meta = _pyarrow_parquet().ParquetFile(path).metadata
    return int(meta.num_rows), int(meta.num_columns)


class SpillWriter:
    """One 2-D ``.npy`` spill file written piece by piece.

    The host-OOM rung walks a source once into :meth:`write`, then
    :meth:`commit` writes the header for the rows seen and replaces
    ``path`` atomically (tmp file + ``os.replace``): a reader never sees
    a torn spill, and a kill mid-spill leaves only a ``*.tmp``.  Every
    piece written is the ``spill.write`` fault site.  As a context
    manager it commits on success and aborts on an error."""

    def __init__(self, path: str, n_features: int, dtype=np.float32):
        self.path = path
        self.n_features = int(n_features)
        self.dtype = np.dtype(dtype)
        self.rows = 0
        self.bytes_written = 0
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                                         suffix=".tmp")
        self._f = os.fdopen(fd, "wb")
        self._committed = False

    def write(self, piece: np.ndarray) -> None:
        """Append one row block at the spill's dtype."""
        maybe_fault("spill.write")
        piece = np.ascontiguousarray(piece, dtype=self.dtype)
        if piece.ndim != 2 or piece.shape[1] != self.n_features:
            raise ValueError(f"spill piece shape {piece.shape} does not match "
                             f"n_features={self.n_features}")
        self._f.write(piece.tobytes())
        self.rows += int(piece.shape[0])
        self.bytes_written += piece.nbytes

    def commit(self) -> str:
        """The header for the rows written, then the data, fsynced and
        moved onto ``path``.  Returns ``path``."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        final_tmp = self._tmp + ".hdr"
        try:
            with open(final_tmp, "wb") as out:
                np.lib.format.write_array_header_2_0(
                    out, {"descr": np.lib.format.dtype_to_descr(self.dtype),
                          "fortran_order": False, "shape": (self.rows, self.n_features)})
                with open(self._tmp, "rb") as raw:
                    shutil.copyfileobj(raw, out, 1 << 22)
                out.flush()
                os.fsync(out.fileno())
            os.replace(final_tmp, self.path)
        except BaseException:
            try:
                os.unlink(final_tmp)
            except OSError:
                pass
            raise
        finally:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
        self._committed = True
        return self.path

    def abort(self) -> None:
        """Drop what was written; ``path`` is untouched."""
        self._f.close()
        try:
            os.unlink(self._tmp)
        except OSError:
            pass

    def __enter__(self) -> "SpillWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        elif not self._committed:
            self.commit()


# -- eager readers of the example formats --------------------------------------------


def read_libsvm(path: str, n_features: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """A libsvm file as dense ``(labels, X)`` (f64; 1-based indices)."""
    from oap_mllib_tpu_torch import native

    return native.parse_libsvm(path, n_features)


def read_csv(path: str, delimiter: str = ",") -> np.ndarray:
    """A dense numeric CSV without header as an (n, d) f64 array."""
    from oap_mllib_tpu_torch import native

    return native.parse_csv(path, delimiter)


def read_ratings(path: str, sep: str = "::") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``user<sep>item<sep>rating`` lines (further fields, such as
    MovieLens's timestamp, ignored) as (users int64, items int64,
    ratings f32)."""
    from oap_mllib_tpu_torch import native

    return native.parse_ratings(path, sep)


def read_libsvm_plain(path: str, n_features: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`read_libsvm`'s plain version (the JAX package's Python
    reader)."""
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


def read_csv_plain(path: str, delimiter: str = ",") -> np.ndarray:
    """:func:`read_csv`'s plain version: ``numpy.loadtxt``."""
    return np.loadtxt(path, delimiter=delimiter, dtype=np.float64, ndmin=2)


def read_ratings_plain(path: str, sep: str = "::"
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`read_ratings`'s plain version (the JAX package's Python
    reader)."""
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
