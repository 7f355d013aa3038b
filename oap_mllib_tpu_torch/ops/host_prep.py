"""The port's host library: the ALS grouped-edge prep in C++.

``csrc/host/grouped_prep.cpp`` (a copy of the JAX package's
``native/src/grouped_prep.cpp``) is a stable counting sort by
destination, O(nnz + n_dst), where the numpy route sorts with a stable
argsort.  It compiles with the host compiler (``g++ -O3 -shared
-fPIC``; ``$CXX`` names another) into
``oap_mllib_tpu_torch/build/libgrouped_prep-<hash>.so``, named by a hash
of its source, at the first call: nothing builds at import.  It loads
with ``ctypes``.

Nothing falls back: a library that does not build raises with the
compiler's output, and the entry points' error codes (-1 bad input, -2
an allocation failure) raise too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "host" / "grouped_prep.cpp"
BUILD_DIR = PKG_DIR / "build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libgrouped_prep-{digest}.so"


def _compiler() -> str:
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if not found:
        raise RuntimeError(
            f"host compiler {name!r} not found on PATH: the grouped-edge prep "
            "library (csrc/host/grouped_prep.cpp) cannot be built"
        )
    return found


def build() -> Path:
    """Build the library for the current source unless it is built;
    returns its path.  The compiler writes a file of its own and renames
    it into place, so processes that build at once never load a partial
    library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"grouped-edge prep build failed ({' '.join(cmd)}), exit "
            f"{proc.returncode}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
            lib.oap_als_grouped_total.restype = i64
            lib.oap_als_grouped_total.argtypes = [i64p, i64, i64, i64]
            lib.oap_als_group_edges.restype = i64
            lib.oap_als_group_edges.argtypes = [
                i64p, i64p, f32p, i64, i64, i64, i64, i32p, f32p, f32p, i32p]
            _lib = lib
        return _lib


def _check(code: int, what: str) -> int:
    if code == -2:
        raise MemoryError(f"{what}: the host library could not allocate its counts")
    if code < 0:
        raise ValueError(f"{what}: bad input (a destination id outside [0, n_dst), "
                         "or a group size or destination count below 1)")
    return int(code)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def grouped_total(dst, n_dst: int, p: int) -> int:
    """Padded edge total of one grouped side: each destination's edges
    rounded up to a multiple of ``p``."""
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if len(dst) == 0:
        return 0
    return _check(_library().oap_als_grouped_total(
        _ptr(dst, ctypes.c_int64), len(dst), int(n_dst), int(p)), "oap_als_grouped_total")


def group_edges(dst, src, conf, n_dst: int, p: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The padded grouped layout of one side, by the stable counting sort:
    ``(src_g (G, p) int32, conf_g (G, p) f32, valid_g (G, p) f32,
    group_dst (G,) int32)``, padding slots src 0, conf 0, valid 0."""
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    src = np.ascontiguousarray(src, dtype=np.int64)
    conf = np.ascontiguousarray(conf, dtype=np.float32)
    total = grouped_total(dst, n_dst, p)
    src_g = np.zeros((total,), np.int32)
    conf_g = np.zeros((total,), np.float32)
    valid_g = np.zeros((total,), np.float32)
    group_dst = np.zeros((total // p,), np.int32)
    if total:
        got = _check(_library().oap_als_group_edges(
            _ptr(dst, ctypes.c_int64), _ptr(src, ctypes.c_int64),
            _ptr(conf, ctypes.c_float), len(dst), int(n_dst), int(p), total,
            _ptr(src_g, ctypes.c_int32), _ptr(conf_g, ctypes.c_float),
            _ptr(valid_g, ctypes.c_float), _ptr(group_dst, ctypes.c_int32),
        ), "oap_als_group_edges")
        if got != total:
            raise RuntimeError(f"oap_als_group_edges filled {got} slots, expected {total}")
    g = total // p
    return src_g.reshape(g, p), conf_g.reshape(g, p), valid_g.reshape(g, p), group_dst
