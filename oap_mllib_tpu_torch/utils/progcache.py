"""Process-wide program registry (the JAX package's ``utils/progcache.py``)
with the port's meaning of a program.

A "program" of the port is a launch site's kernels at one set of shapes,
tier and device: the Lloyd pass, the PCA moment passes, the ALS
iteration (ops/*).  Their first launch pays the kernel libraries'
build or load (the lazy builders: ops/cuda/_build.py, ops/host_prep.py)
and the kernels' first-shape set-up; later launches only dispatch.

1. **Registry**: :func:`get_or_build` caches built values by (algo,
   key) with LRU eviction, :func:`note` records launches, both counting
   hits, misses and evictions, mirrored into ``oap_progcache_*_total``
   by ``algo``.  Every fit summary carries :func:`delta` of
   :func:`stats` over the fit (``progcache``).
2. **Launch accounting**: :func:`launch` counts a launch, books its wall
   under ``<phase>/compile`` (first seen) or ``<phase>/execute`` (hits)
   of a ``Timings``, and is the ``fit.execute`` fault site.  The fits
   launch without a ``Timings``: their phase sets stay those the port's
   summaries have always had.
3. **Ground truth**: :func:`xla_compile_count` / :func:`xla_compile_secs`
   count the kernel-library builds and loads of this process (the
   counterpart of the JAX package's XLA backend compiles, booked under
   the same ``oap_xla_compile*`` families); :func:`note_build` is what
   the builders call.  :func:`ensure_persistent_cache` points the
   builders at ``Config.compilation_cache_dir``.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from oap_mllib_tpu_torch.telemetry import metrics as _tm

# -- registry ---------------------------------------------------------------


def _count(what: str, algo: str) -> None:
    """Mirror one registry increment into the process metrics registry
    (telemetry/metrics.py) — the summaries keep reading ``stats()``,
    exporters read ``oap_progcache_*_total{algo=...}``."""
    _tm.counter(
        f"oap_progcache_{what}_total", {"algo": algo},
        help=f"Program-cache {what} by algo key",
    ).inc()


class ProgramCache:
    """Keyed registry of built programs and launch counters.

    Two kinds of entries share one key space ``(algo, key)``:

    - *built* entries hold a value (a prepared callable or workspace)
      and are LRU-evicted past ``maxsize``;
    - *noted* entries hold no value: they record that a launch site has
      run this program (its kernels at these shapes) before.
    """

    def __init__(self, maxsize: int = 128, note_maxsize: int = 4096):
        self.maxsize = maxsize
        self.note_maxsize = note_maxsize
        self._lock = threading.RLock()
        self._built: "OrderedDict[tuple, Any]" = OrderedDict()
        self._noted: "OrderedDict[tuple, int]" = OrderedDict()
        self._counts: Dict[str, Dict[str, int]] = {}

    def _algo(self, algo: str) -> Dict[str, int]:
        return self._counts.setdefault(
            algo, {"hits": 0, "misses": 0, "evictions": 0}
        )

    def get_or_build(self, algo: str, key: tuple, build: Callable[[], Any]):
        """Return the cached value for ``(algo, key)``, building (and
        counting a miss) on first use.  The build runs outside the lock;
        a racing duplicate build is benign (last one wins)."""
        full = (algo, key)
        with self._lock:
            if full in self._built:
                self._built.move_to_end(full)
                self._algo(algo)["hits"] += 1
                _count("hits", algo)
                return self._built[full]
            self._algo(algo)["misses"] += 1
            _count("misses", algo)
        value = build()
        with self._lock:
            self._built[full] = value
            self._built.move_to_end(full)
            while len(self._built) > self.maxsize:
                (ev_algo, _), _ = self._built.popitem(last=False)
                self._algo(ev_algo)["evictions"] += 1
                _count("evictions", ev_algo)
        return value

    def note(self, algo: str, key: tuple) -> bool:
        """Record one launch of a program; True = first seen (the launch
        that pays the kernels' build or load and first-shape set-up)."""
        full = (algo, key)
        with self._lock:
            if full in self._noted:
                self._noted.move_to_end(full)
                self._noted[full] += 1
                self._algo(algo)["hits"] += 1
                _count("hits", algo)
                return False
            self._noted[full] = 1
            self._algo(algo)["misses"] += 1
            _count("misses", algo)
            while len(self._noted) > self.note_maxsize:
                (ev_algo, _), _ = self._noted.popitem(last=False)
                self._algo(ev_algo)["evictions"] += 1
                _count("evictions", ev_algo)
            return True

    def stats(self) -> Dict[str, Any]:
        """Aggregate + per-algo counters.  ``hit_rate`` is per-launch:
        of everything that went through the registry, the fraction that
        reused an existing program."""
        with self._lock:
            by_algo = {a: dict(c) for a, c in self._counts.items()}
        hits = sum(c["hits"] for c in by_algo.values())
        misses = sum(c["misses"] for c in by_algo.values())
        total = hits + misses
        return {
            "hits": hits,
            "misses": misses,
            "evictions": sum(c["evictions"] for c in by_algo.values()),
            "entries": len(self._built) + len(self._noted),
            "hit_rate": (hits / total) if total else None,
            "by_algo": by_algo,
        }

    def clear(self) -> None:
        """Drop every entry and counter (tests): the next launch of
        everything is a miss; the loaded kernel libraries stay."""
        with self._lock:
            self._built.clear()
            self._noted.clear()
            self._counts.clear()


_CACHE = ProgramCache()

# entry mutation is guarded inside ProgramCache._lock; the module-level
# clear takes this tracked seam so the "locks" sanitizer witnesses it
from oap_mllib_tpu_torch.utils import locktrace as _locktrace  # noqa: E402

_CLEAR_LOCK = _locktrace.TrackedLock("progcache.clear")


def get_or_build(algo: str, key: tuple, build: Callable[[], Any]):
    return _CACHE.get_or_build(algo, key, build)


def note(algo: str, key: tuple) -> bool:
    return _CACHE.note(algo, key)


def stats() -> Dict[str, Any]:
    return _CACHE.stats()


def clear() -> None:
    with _CLEAR_LOCK:
        _CACHE.clear()


def delta(before: Dict[str, Any]) -> Dict[str, Any]:
    """Per-fit registry activity: ``stats() - before`` for the scalar
    counters (models snapshot ``stats()`` at fit entry and attach the
    delta to the training summary)."""
    now = stats()
    out = {
        k: now[k] - before.get(k, 0) for k in ("hits", "misses", "evictions")
    }
    total = out["hits"] + out["misses"]
    out["hit_rate"] = (out["hits"] / total) if total else None
    return out


def count_launch(algo: str, key: tuple) -> bool:
    """The ``fit.execute`` fault site, then :func:`note`: one launch of a
    program with no wall booked (the fits' per-pass launches); True on
    its first launch."""
    from oap_mllib_tpu_torch.utils.faults import maybe_fault

    maybe_fault("fit.execute")
    return _CACHE.note(algo, key)


@contextlib.contextmanager
def launch(algo: str, key: tuple, timings=None, phase: Optional[str] = None,
           record_execute: bool = True):
    """Count one program launch and attribute its wall time.

    A first-seen key books the wall under ``<phase>/compile`` (the
    launch that builds or loads its kernels and sets up their first
    shapes); a hit books under ``<phase>/execute`` (the dispatch wall:
    kernels run asynchronously).  ``record_execute=False`` counts hits
    without booking them.  With no ``timings`` the launch only counts.
    Every launch is the ``fit.execute`` fault site (utils/faults.py),
    which fires before the launch is noted."""
    miss = count_launch(algo, key)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None and phase is not None:
            if miss:
                timings.add(phase + "/compile", time.perf_counter() - t0)
            elif record_execute:
                timings.add(phase + "/execute", time.perf_counter() - t0)


# -- key helpers ------------------------------------------------------------


def array_key(*arrays) -> tuple:
    """Hashable signature of array arguments: (shape, dtype, device); a
    ``{rank: tensor}`` mesh argument keys by its ranks' entries."""
    out = []
    for a in arrays:
        if isinstance(a, dict):
            out.append(tuple((str(r), *array_key(v)) for r, v in sorted(a.items(), key=str)))
            continue
        dtype = getattr(a, "dtype", type(a).__name__)
        out.append((tuple(getattr(a, "shape", ())), str(dtype).replace("torch.", ""),
                    str(getattr(a, "device", ""))))
    return tuple(out)


def mesh_fingerprint(mesh) -> tuple:
    """Stable identity of a mesh (parallel/mesh.Mesh): axis names, shape,
    the ranks' devices and the world of processes."""
    return (
        tuple(mesh.axis_names),
        tuple(mesh.shape[a] for a in mesh.axis_names),
        tuple(str(mesh.device(r)) for r in mesh.ranks),
        int(mesh.processes),
    )


def backend_fingerprint(device=None) -> tuple:
    """Identity of the device world a one-device launch runs in: the
    device, the card's name (or "cpu") and the number of processes."""
    import torch

    from oap_mllib_tpu_torch.parallel import bootstrap

    dev = torch.device("cpu" if device is None else device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return (str(dev), name, bootstrap.world_size())


def key_digest(key) -> str:
    """Short stable hex digest of a key built from primitives."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:16]


# -- build ground truth -------------------------------------------------------

_XLA_EVENTS = {"count": 0, "secs": 0.0}
_XLA_EVENTS_LOCK = _locktrace.TrackedLock("progcache.xla_events")


def note_build(seconds: float) -> None:
    """Book one kernel-library build or load (ops/cuda/_build.load,
    ops/host_prep._library) into the ground-truth counters."""
    with _XLA_EVENTS_LOCK:
        _XLA_EVENTS["count"] += 1
        _XLA_EVENTS["secs"] += float(seconds)
    _tm.counter(
        "oap_xla_compiles_total",
        help="Kernel-library builds and loads (the port's compiles)",
    ).inc()
    _tm.counter(
        "oap_xla_compile_seconds_total",
        help="Wall spent building and loading kernel libraries",
    ).inc(float(seconds))
    _tm.histogram(
        "oap_xla_compile_seconds",
        help="Per-library build and load wall",
    ).observe(float(seconds))


def xla_compile_count() -> int:
    """Kernel-library builds and loads so far in this process; snapshot
    and subtract around a region."""
    with _XLA_EVENTS_LOCK:
        return _XLA_EVENTS["count"]


def xla_compile_secs() -> float:
    """Seconds of kernel-library builds and loads so far."""
    with _XLA_EVENTS_LOCK:
        return _XLA_EVENTS["secs"]


# -- the persistent build directory -------------------------------------------

_persist_applied: Optional[str] = None


def ensure_persistent_cache(cache_dir: str) -> None:
    """Point the lazy builders at ``cache_dir`` (``Config.
    compilation_cache_dir``): libraries build into it and load from it,
    so a warm directory skips the build.  Empty keeps the package's
    build directory.  Idempotent."""
    global _persist_applied
    if _persist_applied == cache_dir:
        return
    if cache_dir:
        import os

        os.makedirs(cache_dir, exist_ok=True)
    _persist_applied = cache_dir


def build_dir(default):
    """The directory the builders use: ``Config.compilation_cache_dir``
    when set, else ``default``."""
    from pathlib import Path

    from oap_mllib_tpu_torch.config import get_config

    cache_dir = get_config().compilation_cache_dir
    if not cache_dir:
        return default
    ensure_persistent_cache(cache_dir)
    return Path(cache_dir)
