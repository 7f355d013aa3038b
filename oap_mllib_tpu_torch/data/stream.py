"""Out-of-core row streaming: fit tables larger than the card's memory
(the JAX package's ``data/stream.py``).

A :class:`ChunkSource` is a re-iterable sequence of equal-width row
chunks: ``(chunk (chunk_rows, d), n_valid)`` pairs, the last chunk
zero-padded with ``n_valid < chunk_rows``.  Padded rows carry weight 0
through every kernel, so a streamed pass computes what the in-memory
one does.  A source must yield the same rows on every pass (the Lloyd
loop walks it once per iteration, k-means|| keeps per-chunk state
across passes): a pass that yields a different row count raises.

The streamed passes pull through the prefetch pipeline
(data/prefetch.py), which advances the source from a background thread
at ``Config.prefetch_depth`` >= 2: a source must tolerate that, as
generators and file reads do.

Constructors: :meth:`from_array` (ndarray, memmap or SciPy sparse, the
latter densified per chunk), :meth:`from_npy` (a memory-mapped ``.npy``
file), :meth:`from_csv`, :meth:`from_libsvm` and :meth:`from_parquet`
(pyarrow, imported when called); any generator factory goes straight
to the constructor.  :meth:`ChunkSource.spill_to_disk` stages a source
to one atomic ``.npy`` spill (data/io.SpillWriter) and returns the
"spill"-backed source over it: the resilience ladder's host-OOM rung.

Every piece a source pulls from its reader is the ``stream.read`` fault
site (utils/faults.py).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from oap_mllib_tpu_torch.data.bucketing import bucket_rows
from oap_mllib_tpu_torch.utils.faults import maybe_fault

# rows per chunk by default: 64k rows x 256 features x f32 = 64 MB
DEFAULT_CHUNK_ROWS = 1 << 16


class ChunkSource:
    """Re-iterable source of ``(chunk, n_valid)`` row blocks.

    Every chunk is ``(chunk_rows, n_features)`` at ``dtype``; the last
    one is zero-padded and its ``n_valid`` says how many rows are real.
    ``chunk_rows`` is the requested width rounded up to its shape bucket
    (data/bucketing.py), as the JAX package rounds it.  ``backing`` says
    what holds the rows between passes, for the route planner's host
    estimate: "memory" (an in-RAM array), "disk" (a file reader, O(chunk)
    host memory), "spill" (a spill the host-OOM rung wrote) or "stream"
    (an opaque generator).
    """

    def __init__(
        self,
        make_iter: Callable[[], Iterator[np.ndarray]],
        n_features: int,
        chunk_rows: int = DEFAULT_CHUNK_ROWS,
        n_rows: Optional[int] = None,
        dtype=np.float32,
        backing: str = "stream",
    ):
        if chunk_rows < 1:
            raise ValueError("chunk_rows must be >= 1")
        if n_features < 1:
            raise ValueError("n_features must be >= 1")
        self._make_iter = make_iter
        self.n_features = int(n_features)
        self.backing = backing
        self.chunk_rows = bucket_rows(int(chunk_rows))
        self._n_rows = None if n_rows is None else int(n_rows)
        self.dtype = np.dtype(dtype)

    @property
    def n_rows(self) -> Optional[int]:
        """Valid rows: known up front for arrays, after the first full
        pass for file sources."""
        return self._n_rows

    def to_array(self) -> np.ndarray:
        """The whole source as one host array."""
        return np.concatenate([c[:v] for c, v in self], axis=0)

    def with_chunk_rows(self, chunk_rows: int) -> "ChunkSource":
        """The same rows in the same order, chunked at another width."""
        return ChunkSource(
            self._make_iter, self.n_features, chunk_rows,
            n_rows=self._n_rows, dtype=self.dtype, backing=self.backing,
        )

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield ``(chunk (chunk_rows, d), n_valid)``; re-iterable.  Each
        chunk is a fresh buffer: a consumer may keep it."""
        buf = np.zeros((self.chunk_rows, self.n_features), self.dtype)
        fill = 0
        total = 0
        for piece in self._make_iter():
            maybe_fault("stream.read")
            piece = np.atleast_2d(np.asarray(piece, self.dtype))
            if piece.shape[1] != self.n_features:
                raise ValueError(
                    f"chunk width {piece.shape[1]} != n_features {self.n_features}"
                )
            off = 0
            while off < piece.shape[0]:
                take = min(self.chunk_rows - fill, piece.shape[0] - off)
                buf[fill:fill + take] = piece[off:off + take]
                fill += take
                off += take
                if fill == self.chunk_rows:
                    total += fill
                    yield buf, fill
                    buf = np.zeros_like(buf)
                    fill = 0
        if fill:
            total += fill
            yield buf, fill
        if self._n_rows is None:
            self._n_rows = total
        elif self._n_rows != total:
            raise ValueError(
                f"source yielded {total} rows this pass but {self._n_rows} "
                "before: streamed fits require a deterministic source"
            )

    # -- constructors ----------------------------------------------------------

    @classmethod
    def from_array(cls, x, chunk_rows: int = DEFAULT_CHUNK_ROWS) -> "ChunkSource":
        """An in-memory array, ``np.memmap`` (row slices, no copy) or SciPy
        sparse matrix (densified one chunk at a time: host memory holds
        the CSR and one dense chunk, never the dense table)."""
        from oap_mllib_tpu_torch.data.sparse import is_sparse

        if is_sparse(x):
            csr = x.tocsr()
            if csr.ndim != 2:
                raise ValueError(f"expected 2-D data, got shape {csr.shape}")
            dtype = csr.dtype if csr.dtype.kind == "f" else np.float64

            def sgen():
                for start in range(0, csr.shape[0], chunk_rows):
                    yield csr[start:start + chunk_rows].toarray()

            return cls(sgen, csr.shape[1], chunk_rows, n_rows=csr.shape[0],
                       dtype=dtype, backing="memory")
        x = np.asarray(x) if not isinstance(x, np.memmap) else x
        if x.ndim != 2:
            raise ValueError(f"expected 2-D data, got shape {x.shape}")

        def gen():
            for start in range(0, x.shape[0], chunk_rows):
                yield x[start:start + chunk_rows]

        return cls(gen, x.shape[1], chunk_rows, n_rows=x.shape[0],
                   dtype=x.dtype, backing="memory")

    @classmethod
    def from_npy(cls, path: str, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 fault_site: str = "disk.read") -> "ChunkSource":
        """A 2-D ``.npy`` file through a read-only memory map: host memory
        stays O(chunk) however large the file (data/io.iter_npy_rows).
        ``fault_site="spill.read"`` makes it a spill's source (backing
        "spill")."""
        from oap_mllib_tpu_torch.data import io as _io

        arr = _io.open_npy_mmap(path)  # checks 2-D, reads the header
        n, d = arr.shape
        dtype = arr.dtype
        del arr

        def gen():
            yield from _io.iter_npy_rows(path, chunk_rows, fault_site)

        backing = "spill" if fault_site == "spill.read" else "disk"
        return cls(gen, d, chunk_rows, n_rows=n, dtype=dtype, backing=backing)

    def spill_to_disk(self, path: Optional[str] = None) -> "ChunkSource":
        """This source's rows staged to one atomic ``.npy`` spill
        (data/io.SpillWriter) at ``path`` (None: a new file in
        ``Config.spill_dir``, else the system's temporary directory), and
        the "spill"-backed source over it: the same rows, order, chunk
        width and dtype.  A failed spill removes the file it made."""
        import os
        import tempfile

        from oap_mllib_tpu_torch.config import get_config
        from oap_mllib_tpu_torch.data import io as _io

        made = None
        if path is None:
            d = get_config().spill_dir or tempfile.gettempdir()
            os.makedirs(d, exist_ok=True)
            fd, path = tempfile.mkstemp(dir=d, prefix="oap-spill.", suffix=".npy")
            os.close(fd)
            made = path
        try:
            with _io.SpillWriter(path, self.n_features, self.dtype) as w:
                for chunk, n_valid in self:
                    w.write(chunk[:n_valid])
        except BaseException:
            if made is not None:
                os.unlink(made)
            raise
        return ChunkSource.from_npy(path, self.chunk_rows, fault_site="spill.read")

    @classmethod
    def from_parquet(cls, path: str, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                     columns=None, dtype=np.float64) -> "ChunkSource":
        """A parquet file, read batch by batch (pyarrow ``iter_batches``,
        imported here; data/io.iter_parquet_rows).  ``columns`` selects
        and orders numeric columns; the row and column counts come from
        the footer."""
        from oap_mllib_tpu_torch.data import io as _io

        n, d_all = _io.parquet_schema(path)
        d = len(columns) if columns is not None else d_all

        def gen():
            yield from _io.iter_parquet_rows(path, chunk_rows, columns)

        return cls(gen, d, chunk_rows, n_rows=n, dtype=dtype, backing="disk")

    @classmethod
    def from_csv(cls, path: str, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 delimiter: str = ",", n_features: Optional[int] = None,
                 dtype=np.float64) -> "ChunkSource":
        """A headerless numeric CSV, parsed in chunks; ``n_features`` None
        counts the first line's fields.  f64 by default, as
        data/io.read_csv reads."""
        if n_features is None:
            with open(path) as f:
                first = f.readline()
            n_features = len(first.strip().split(delimiter))

        def gen():
            rows = []
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rows.append([float(v) for v in line.split(delimiter)])
                    if len(rows) == chunk_rows:
                        yield np.asarray(rows)
                        rows = []
            if rows:
                yield np.asarray(rows)

        return cls(gen, n_features, chunk_rows, dtype=dtype, backing="disk")

    @classmethod
    def from_libsvm(cls, path: str, n_features: int, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                    dtype=np.float64) -> "ChunkSource":
        """A libsvm file (1-based indices), labels dropped.  ``n_features``
        is required: a streaming reader cannot find the largest index
        without a pass.  f64 by default, as data/io.read_libsvm reads."""

        def gen():
            rows = np.zeros((chunk_rows, n_features), dtype)
            fill = 0
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    for tok in line.split()[1:]:
                        idx, val = tok.split(":")
                        i = int(idx)
                        if i > n_features:
                            raise ValueError(
                                f"libsvm index {i} exceeds n_features={n_features}"
                            )
                        rows[fill, i - 1] = float(val)
                    fill += 1
                    if fill == chunk_rows:
                        yield rows
                        rows = np.zeros_like(rows)
                        fill = 0
            if fill:
                yield rows[:fill]

        return cls(gen, n_features, chunk_rows, dtype=dtype, backing="disk")
