"""The native host layer: the port of the JAX package's ``native/``.

One C++ library, ``libnative-<hash>.so``, built from ``csrc/host/``'s
``table_store.cpp``, ``io_parse.cpp``, ``shuffle.cpp`` and
``net_probe.cpp`` through utils/hostlib.py at its first call, and bound
with ``ctypes`` under the JAX package's names:

- the table store (~ the reference's OneDAL.cpp): :func:`table_create`,
  :func:`table_append` (grows past capacity), :func:`table_merge`
  (consumes its source), :func:`table_rows`, :func:`table_cols`,
  :func:`table_copy_out`, :func:`table_free`, :func:`table_count`, and
  :func:`table_view`, a zero-copy numpy view whose
  ``torch.from_numpy(view)`` shares the table's memory.  A bad handle
  gives -1, as in the JAX package.
- the parsers: :func:`parse_libsvm`, :func:`parse_csv` and
  :func:`parse_ratings`, behind ``data/io.read_*``.  Their contract is
  the plain Python readers (``data/io.read_*_plain``), which are the
  JAX package's Python path; where its C++ path differs the port does
  not follow it (ROADMAP queue C).  Errors raise ``ValueError`` naming
  the path and line.
- the ALS shuffle prep (~ ALSShuffle.cpp): :func:`shuffle_prep`,
  :func:`shuffle_prep_offsets`, :func:`shuffle_perm` (the permutation
  alone), :func:`gather` and :func:`distinct_count`.
- the bootstrap probes (~ OneCCL.cpp): :func:`local_ip` and
  :func:`free_port`, behind ``parallel/bootstrap``.

The ALS grouped-edge prep, the JAX module's ``als_grouped_total`` and
``als_group_edges``, is ``ops/host_prep.py``'s library.

Nothing falls back: the JAX loader gives way to NumPy when its library
does not build, and honours ``OAP_MLLIB_TPU_PURE_PYTHON``; here a
library that does not build raises, and there is no switch.  The loader
holds a lock, so the serving dispatcher's and the workers' threads may
call in at once.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from oap_mllib_tpu_torch.utils import hostlib

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCES = tuple(PKG_DIR / "csrc" / "host" / f for f in (
    "table_store.cpp", "io_parse.cpp", "shuffle.cpp", "net_probe.cpp"))
BUILD_DIR = PKG_DIR / "build"
WHAT = "the native host library (csrc/host: table store, parsers, shuffle prep, probes)"

_RATINGS, _CSV, _LIBSVM = 0, 1, 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64, _i32 = ctypes.c_int64, ctypes.c_int32
_i64p, _f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "oap_table_create": (_i64, [_i64, _i64]),
    "oap_table_append": (_i64, [_i64, _f64p, _i64]),
    "oap_table_merge": (_i64, [_i64, _i64]),
    "oap_table_rows": (_i64, [_i64]),
    "oap_table_cols": (_i64, [_i64]),
    "oap_table_data": (_f64p, [_i64]),
    "oap_table_copy_out": (_i64, [_i64, _f64p, _i64]),
    "oap_table_free": (_i64, [_i64]),
    "oap_table_count": (_i64, []),
    "oap_parse_open": (_i64, [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, _i64]),
    "oap_parse_status": (_i64, [_i64, ctypes.c_char_p, _i64, _i64p]),
    "oap_parse_rows": (_i64, [_i64]),
    "oap_parse_cols": (_i64, [_i64]),
    "oap_parse_fill_ratings": (_i64, [_i64, _i64p, _i64p, ctypes.POINTER(ctypes.c_float)]),
    "oap_parse_fill_dense": (_i64, [_i64, _f64p, _f64p]),
    "oap_parse_close": (_i64, [_i64]),
    "oap_parse_live": (_i64, []),
    "oap_shuffle_prep": (_i64, [_i64p, _i64p, _i64, _i64, _i64, _i64p, _i64p, _i64p]),
    "oap_gather": (_i64, [ctypes.c_void_p, _i64, _i64p, _i64, ctypes.c_void_p]),
    "oap_distinct_count": (_i64, [_i64p, _i64]),
    "oap_local_ip": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int]),
    "oap_free_port": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]),
}


def build_dir() -> Path:
    """``Config.compilation_cache_dir`` when set, else :data:`BUILD_DIR`."""
    from oap_mllib_tpu_torch.utils import progcache

    return progcache.build_dir(BUILD_DIR)


def library_path() -> Path:
    return hostlib.library_path("native", SOURCES, build_dir())


def build() -> Path:
    """Build the library for the current sources unless it is built;
    returns its path."""
    return hostlib.build("native", SOURCES, build_dir(), WHAT)


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = hostlib.load(build)
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype=ctypes.c_int64):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# -- the table store ----------------------------------------------------------------


def table_create(capacity_rows: int, cols: int) -> int:
    """An empty float64 table; its handle, or -1."""
    return int(library().oap_table_create(int(capacity_rows), int(cols)))


def table_append(handle: int, rows: np.ndarray) -> int:
    """Append row-major float64 rows; the new row count, or -1."""
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    n = rows.shape[0] if rows.ndim > 1 else (1 if rows.size else 0)
    cols = table_cols(handle)
    if cols < 0 or rows.size != n * cols:
        return -1
    return int(library().oap_table_append(int(handle), _ptr(rows, ctypes.c_double), n))


def table_merge(dst: int, src: int) -> int:
    """Append ``src``'s rows to ``dst`` and free ``src``; ``dst``'s row
    count, or -1."""
    return int(library().oap_table_merge(int(dst), int(src)))


def table_rows(handle: int) -> int:
    return int(library().oap_table_rows(int(handle)))


def table_cols(handle: int) -> int:
    return int(library().oap_table_cols(int(handle)))


def table_copy_out(handle: int) -> np.ndarray:
    """A copy of the table's valid rows, ``(rows, cols)`` float64."""
    lib = library()
    rows, cols = lib.oap_table_rows(int(handle)), lib.oap_table_cols(int(handle))
    if rows < 0 or cols < 0:
        raise ValueError(f"invalid native table handle {handle}")
    out = np.empty((rows, cols), np.float64)
    if lib.oap_table_copy_out(int(handle), _ptr(out, ctypes.c_double), rows) != rows:
        raise RuntimeError(f"native table {handle}: copy_out failed")
    return out


def table_free(handle: int) -> int:
    """0, or -1 for a bad handle."""
    return int(library().oap_table_free(int(handle)))


def table_count() -> int:
    """Live tables (leak checks)."""
    return int(library().oap_table_count())


def table_view(handle: int) -> np.ndarray:
    """A zero-copy numpy view of a live table (the caller keeps the table
    alive, and unchanged in size, while the view lives).  The handoff to
    torch is ``torch.from_numpy(view)``, which shares the memory."""
    lib = library()
    rows, cols = lib.oap_table_rows(int(handle)), lib.oap_table_cols(int(handle))
    ptr = lib.oap_table_data(int(handle))
    if rows < 0 or cols < 0 or not ptr:
        raise ValueError(f"invalid native table handle {handle}")
    if rows == 0:
        return np.empty((0, cols), np.float64)
    return np.ctypeslib.as_array(ptr, shape=(rows, cols))


# -- the parsers ----------------------------------------------------------------------


def _parse(path, kind: int, sep: str, n_features: int, fill):
    """Open a parse job, raise its first error, hand its shape to
    ``fill(lib, handle, rows, cols)``, close it."""
    lib = library()
    spath = os.fspath(path)
    h = lib.oap_parse_open(os.fsencode(spath), kind, sep.encode(), n_features)
    if h < 0:
        raise MemoryError(f"{spath}: the parser could not allocate its job")
    try:
        _raise_failed(lib, h, spath)
        out = fill(lib, h, lib.oap_parse_rows(h), lib.oap_parse_cols(h))
        _raise_failed(lib, h, spath)
        return out
    finally:
        lib.oap_parse_close(h)


def _raise_failed(lib, h: int, path: str) -> None:
    msg = ctypes.create_string_buffer(512)
    line = ctypes.c_int64(0)
    if lib.oap_parse_status(h, msg, len(msg), ctypes.byref(line)) != 0:
        where = f"{path}: line {line.value}" if line.value > 0 else path
        raise ValueError(f"{where}: {msg.value.decode(errors='replace')}")


def parse_libsvm(path, n_features: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """A libsvm file as dense ``(labels (n,) f64, X (n, d) f64)``; ``d``
    is ``n_features``, or the largest index when None (the Python
    reader's convention; the JAX native wrapper's 0 for "from the data"
    is not kept)."""
    if n_features is not None and n_features < 0:
        raise ValueError(f"n_features must be >= 0, got {n_features}")

    def fill(lib, h, rows, cols):
        labels = np.empty((rows,), np.float64)
        x = np.zeros((rows, cols), np.float64)
        lib.oap_parse_fill_dense(h, _ptr(labels, ctypes.c_double), _ptr(x, ctypes.c_double))
        return labels, x

    return _parse(path, _LIBSVM, "", -1 if n_features is None else int(n_features), fill)


def parse_csv(path, delimiter: str = ",") -> np.ndarray:
    """A dense numeric CSV without header as ``(n, d)`` f64; no data
    gives ``(0, 1)`` with numpy.loadtxt's warning."""
    if not isinstance(delimiter, str) or len(delimiter.encode()) != 1:
        raise ValueError(f"the delimiter must be one ASCII character, got {delimiter!r}")

    def fill(lib, h, rows, cols):
        x = np.empty((rows, cols), np.float64)
        lib.oap_parse_fill_dense(h, None, _ptr(x, ctypes.c_double))
        return x

    x = _parse(path, _CSV, delimiter, -1, fill)
    if x.shape[0] == 0:
        import warnings

        warnings.warn(f'loadtxt: input contained no data: "{os.fspath(path)}"',
                      category=UserWarning, stacklevel=3)
    return x


def parse_ratings(path, sep: str = "::") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``user<sep>item<sep>rating[<sep>...]`` lines as ``(users int64,
    items int64, ratings float32)``: the first three fields of a line,
    the ids exact in int64."""
    if not sep:
        raise ValueError("empty separator")

    def fill(lib, h, rows, cols):
        users = np.empty((rows,), np.int64)
        items = np.empty((rows,), np.int64)
        ratings = np.empty((rows,), np.float32)
        lib.oap_parse_fill_ratings(h, _ptr(users), _ptr(items), _ptr(ratings, ctypes.c_float))
        return users, items, ratings

    return _parse(path, _RATINGS, sep, -1, fill)


def parse_live() -> int:
    """Open parse jobs (leak checks)."""
    return int(library().oap_parse_live())


# -- the bootstrap probes -----------------------------------------------------------


def local_ip() -> Optional[str]:
    """The first IPv4 address of an interface that is up and not a
    loopback (``getifaddrs``), or None."""
    buf = ctypes.create_string_buffer(64)
    if library().oap_local_ip(buf, 64) != 0:
        return None
    return buf.value.decode()


def free_port(ip: str = "", start: int = 3000, max_tries: int = 1000) -> Optional[int]:
    """The first TCP port from ``start`` that binds on ``ip`` ("" any
    address), within ``max_tries`` ports; None when none binds."""
    port = library().oap_free_port(ip.encode(), int(start), int(max_tries))
    return port if port > 0 else None


# -- the shuffle prep ---------------------------------------------------------------

_PREP_ERRORS = {-1: "keys_per_block and n_blocks must be >= 1",
                -4: "user ids must be >= 0 on the uniform block layout"}


def _perm(users, items, kpb: int, n_blocks: int, offsets) -> Tuple[np.ndarray, np.ndarray]:
    users = np.ascontiguousarray(users, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    n = len(users)
    if len(items) != n:
        raise ValueError(f"users and items differ in length: {n}, {len(items)}")
    counts = np.empty((n_blocks,), np.int64)
    perm = np.empty((n,), np.int64)
    code = library().oap_shuffle_prep(_ptr(users), _ptr(items), n, int(kpb), int(n_blocks),
                                      None if offsets is None else _ptr(offsets),
                                      _ptr(counts), _ptr(perm))
    if code == -3:
        raise MemoryError("oap_shuffle_prep: out of host memory")
    if code < 0:
        raise ValueError(f"oap_shuffle_prep: {_PREP_ERRORS.get(code, code)}")
    return counts, perm


def _prep(users, items, ratings, kpb: int, n_blocks: int, offsets):
    users = np.ascontiguousarray(users, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    ratings = np.asarray(ratings)
    if len(ratings) != len(users):
        raise ValueError(f"users, items and ratings differ in length: "
                         f"{len(users)}, {len(items)}, {len(ratings)}")
    counts, perm = _perm(users, items, kpb, n_blocks, offsets)
    return gather(users, perm), gather(items, perm), gather(ratings, perm), counts, perm


def gather(a, perm) -> np.ndarray:
    """``a[perm]`` for a 1-D numeric array and an int64 permutation of
    its indices (from :func:`shuffle_perm`), on the host's cores: numpy's
    one-core gather waits on the prep order's random reads (phase 33's
    ``gather_s`` against ``numpy_gather_s`` in chip_smoke.py)."""
    a = np.ascontiguousarray(a)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if a.ndim != 1 or a.dtype.hasobject:
        raise ValueError(f"gather takes a 1-D numeric array, got {a.dtype} {a.shape}")
    out = np.empty((len(perm),), a.dtype)
    code = library().oap_gather(a.ctypes.data, a.dtype.itemsize, _ptr(perm), len(perm),
                                out.ctypes.data)
    if code == -3:
        raise MemoryError("oap_gather: out of host memory")
    return out


def _check_layout(keys_per_block: int, n_blocks: int) -> None:
    if keys_per_block <= 0:
        raise ValueError(f"keys_per_block must be > 0, got {keys_per_block}")
    if n_blocks <= 0:
        raise ValueError(f"n_blocks must be > 0, got {n_blocks}")


def shuffle_perm(users, items, keys_per_block: int, n_blocks: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`shuffle_prep`'s ``(block_counts, perm)`` without the
    reordered records, for a caller that gathers them itself (its own
    dtypes, one array at a time, so the host peak stays one array above
    the records): the one-device ALS fit (models/als.py)."""
    _check_layout(keys_per_block, n_blocks)
    return _perm(users, items, keys_per_block, n_blocks, None)


def shuffle_prep(users, items, ratings, keys_per_block: int, n_blocks: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bucket the ratings by user block ``min(user // keys_per_block,
    n_blocks - 1)`` and order them by (block, user, item), stably.

    Returns ``(users, items, ratings, block_counts, perm)``: the records
    reordered, each block's count and the permutation applied (the
    order of ``numpy.lexsort((items, users, block))``)."""
    _check_layout(keys_per_block, n_blocks)
    return _prep(users, items, ratings, keys_per_block, n_blocks, None)


def shuffle_prep_offsets(users, items, ratings, offsets
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`shuffle_prep` under explicit block boundaries (the
    capability-weighted layouts, parallel/balance.py): ``offsets`` is the
    ``(n_blocks + 1,)`` monotone array, block ``b`` the users in
    ``[offsets[b], offsets[b + 1])``, a user outside them the nearest
    end block (``clip(searchsorted(offsets, u, "right") - 1, 0,
    n_blocks - 1)``).  Numpy in the JAX package; the same library call
    here."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if offsets.ndim != 1 or len(offsets) < 2:
        raise ValueError("offsets must have >= 2 entries")
    if np.any(np.diff(offsets) < 0):
        raise ValueError("offsets must be monotone non-decreasing")
    return _prep(users, items, ratings, 1, len(offsets) - 1, offsets)


def distinct_count(sorted_keys) -> int:
    """Distinct consecutive keys of a sorted array (the CSR row count)."""
    keys = np.ascontiguousarray(sorted_keys, dtype=np.int64)
    return int(library().oap_distinct_count(_ptr(keys), len(keys)))
