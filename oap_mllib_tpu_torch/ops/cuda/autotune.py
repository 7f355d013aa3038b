"""Persistent per-(backend, shape-bucket) kernel-geometry autotuner: the
port of the JAX package's ``ops/pallas/autotune.py``.

The Hopper kernels take their launch geometry as arguments of their
wrappers (ops/cuda/kmeans_kernel.py, pca_kernel.py, als_kernel.py,
ring_kernel.py).  The best values depend on the card and the problem's
shape regime, not on the exact operand sizes.  This module resolves
them:

- :func:`shape_bucket` quantises the kernel-relevant dims to the next
  power of two, so one tuned entry covers a whole shape regime and a
  second fit anywhere in the same backend and bucket launches tuned
  with zero sweeps.  The row count ``n`` never enters a bucket.
- :func:`resolve` maps ``(kernel, bucket, tier)`` to a geometry dict
  through the ``Config.tuning`` mode, the in-process cache, and the
  JSON files under ``Config.tuning_cache_dir`` (one a key, named by
  ``progcache.key_digest`` of the key, which holds
  ``progcache.backend_fingerprint``: the device, the card's name and
  the number of processes, so a directory shared with other cards or
  with the JAX package never crosses over).
- A miss in mode ``"on"`` runs :func:`_sweep`: the minimum of
  :data:`_BEST_OF` timed launches (CUDA events, after a warm-up launch
  that absorbs the library build) of every candidate in
  :data:`CANDIDATES`, on operands from a generator seeded by the key.
  The winner is what persists, and every later process resolves from
  the cache, so the determinism contract is the cache's, not the
  clock's.  Ties go to the earlier candidate.  A candidate the kernel
  refuses raises; none is skipped.  The sweep's launches are
  measurement: the wrappers' launch counts are restored after it.
- In a world of several processes plain :func:`resolve` refuses to
  sweep (decision ``"default-multiproc"``): a rank-local sweep could
  choose other geometry on each rank.  :func:`resolve_world` is the
  world's entry: process 0 resolves, sweeping if so configured, and its
  geometry reaches every process through ``stream_ops._allgather_host``.

Knobs (stated departure: the JAX package's are a TPU's VMEM tile rows,
rotation depth and solve batch; here they are the parameters the
Hopper wrappers pass at launch, and :data:`DEFAULTS` are the constants
each launched with before the autotuner existed):

- ``kmeans`` (K1): ``range_rows``, rows of a counting-sort range, and
  ``parts``, the most parts of a cluster's sums (``kmeans_kernel``);
- ``pca`` (K2): ``target_blocks``, the blocks of the SIMT Gram route
  (d < 64) and of the float64 form's Gram, and
  ``sum_rows``, the least rows of a mean-pass slice (``pca_kernel``);
- ``als_solve`` (K3): ``group``, as steps above ``solve_group(r)`` lanes
  a system in powers of two (0 = ``solve_group(r)``, 1 = the next power
  of two above it; ``als_kernel.solve_lanes``).  A step, not a lane
  count, so that one pin and one cached entry hold for every rank of a
  bucket.  Above rank 16 only step 0 exists (32 lanes at most);
- ``als_gram`` (K4): ``blocks`` and ``stage_floats`` of the factor Gram's
  one launch (``als_kernel.factor_gram_geometry``);
- ``ring`` (K5): ``segments``, row blocks each their own ring
  (``ring_kernel``).

Two more stated departures: a sweep on a CPU device records the default
as its winner (the plain versions take no geometry, so there is nothing
to rank; it still counts as a sweep, as the reference's ``ring`` branch
does), and the sweep's operands are sized to fill the card's 132 SMs
several times over instead of the reference's 2048 rows.

On the x64 parity lane (``Config.enable_x64``) the K-Means and PCA fits
launch K1's and K2's float64 forms, which the sweep does not time: their
geometry is fixed at :data:`DEFAULTS` whatever the mode, a pin or a
cached f32 winner, recorded as the decision ``"fixed-f64"`` at tier
``"f64"`` (so a pin of an f32 knob never reaches the f64 kernel, and a
summary's ``tuning`` says why the defaults ran).

Every resolution is recorded: ``oap_tuning_{hits,misses,sweeps}_total``
counters by kernel, a ``tuning`` node on the active span (its
``decisions``, and each sweep's wall, candidates and winner under
``sweeps``), and the :func:`mark` / :func:`delta` window that the models
attach to fit summaries as ``summary["tuning"]``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from oap_mllib_tpu_torch.ops.cuda import als_kernel, kmeans_kernel, pca_kernel
from oap_mllib_tpu_torch.utils import locktrace, progcache

log = logging.getLogger("oap_mllib_tpu_torch")

MODES = ("auto", "on", "off")  # plus "pin:<json>"

# knob vocabulary per kernel: pins outside it raise, like any typo
KNOBS = {
    "kmeans": ("range_rows", "parts"),
    "pca": ("target_blocks", "sum_rows"),
    "als_solve": ("group",),
    "als_gram": ("blocks", "stage_floats"),
    "ring": ("segments",),
}

# the JAX package's TPU knobs, named in the error of a pin that uses them
_JAX_KNOBS = ("tile_rows", "depth", "batch")

# each kernel's launch before the autotuner, the wrappers' own defaults:
# mode "off", and the no-cache answer of mode "auto"
DEFAULTS = {
    "kmeans": dict(kmeans_kernel.DEFAULT_GEOMETRY),
    "pca": dict(pca_kernel.DEFAULT_GEOMETRY),
    "als_solve": dict(als_kernel.SOLVE_DEFAULT),
    "als_gram": dict(als_kernel.GRAM_DEFAULT),
    "ring": {"segments": 1},
}

# sweep grids, small on purpose: half and twice the default block counts
# and range sizes.  K1's parts stop at 8 (its 32-bit bound on k), K4's
# stages at 4096 floats (the shared buffer its source sizes), K3's
# second step exists only up to rank 16 (:func:`candidates`)
CANDIDATES = {
    "kmeans": [{"range_rows": rr, "parts": p}
               for rr in (1024, 2048, 4096) for p in (4, 8)],
    "pca": [{"target_blocks": tb, "sum_rows": sr}
            for tb in (264, 528, 1056) for sr in (1024, 4096)],
    "als_solve": [{"group": 0}, {"group": 1}],
    "als_gram": [{"blocks": b, "stage_floats": s}
                 for b in (132, 264, 528) for s in (2048, 4096)],
    "ring": [{"segments": s} for s in (1, 2, 4)],
}

_BEST_OF = 3  # min of N timed launches a candidate (min rejects noise)

_LOCK = locktrace.TrackedLock("autotune.cache")
_MEM: Dict[tuple, Dict[str, int]] = {}
_DECISIONS: List[Dict[str, Any]] = []  # append-only; the mark()/delta() window


# -- mode / pins -------------------------------------------------------------


def parse_mode(spec: str) -> Tuple[str, Optional[Dict[str, Dict[str, int]]]]:
    """Validate ``Config.tuning`` into ``(mode, pins)``.

    ``pins`` is the per-kernel geometry of ``pin:<json>`` (None for the
    plain modes).  Unknown modes, malformed JSON, unknown kernels or
    knobs (the JAX package's TPU knobs among them) and non-integer
    values raise ValueError."""
    spec = str(spec)
    if spec in MODES:
        return spec, None
    if spec.startswith("pin:"):
        try:
            pins = json.loads(spec[4:])
        except json.JSONDecodeError as e:
            raise ValueError(f"Config.tuning pin payload is not JSON: {e}")
        if not isinstance(pins, dict):
            raise ValueError(
                "Config.tuning pin payload must be a JSON object of "
                f"{{kernel: {{knob: int}}}}, got {type(pins).__name__}"
            )
        for kern, geo in pins.items():
            if kern not in KNOBS:
                raise ValueError(
                    f"Config.tuning pins unknown kernel {kern!r} (known: {sorted(KNOBS)})"
                )
            if not isinstance(geo, dict):
                raise ValueError(
                    f"Config.tuning pin for {kern!r} must be an object, "
                    f"got {type(geo).__name__}"
                )
            for knob, val in geo.items():
                if knob not in KNOBS[kern]:
                    hint = (" (a knob of the JAX package's TPU kernels; the Hopper "
                            "kernels take other launch parameters)"
                            if knob in _JAX_KNOBS else "")
                    raise ValueError(
                        f"Config.tuning pins unknown knob {knob!r} for kernel "
                        f"{kern!r}{hint}; the port's knobs for {kern!r} are {KNOBS[kern]}"
                    )
                if not isinstance(val, int) or isinstance(val, bool):
                    raise ValueError(
                        f"Config.tuning pin {kern}.{knob} must be an integer, got {val!r}"
                    )
        return "pin", pins
    raise ValueError(
        f"Config.tuning must be one of {MODES} or 'pin:<json>', got {spec!r}"
    )


def _mode() -> Tuple[str, Optional[Dict[str, Dict[str, int]]]]:
    from oap_mllib_tpu_torch.config import get_config

    return parse_mode(get_config().tuning)


def check_config() -> None:
    """Fit entry: a ``Config.tuning`` typo raises before any work."""
    _mode()


# -- shape buckets -----------------------------------------------------------


def _pow2(v: int) -> int:
    v = max(1, int(v))
    return 1 << (v - 1).bit_length()


def shape_bucket(*dims: int) -> Tuple[int, ...]:
    """Quantise kernel-relevant dims (k, d, r, world, cols; never n) to
    the next power of two: the bucket under which tuned geometry is
    cached and reused."""
    return tuple(_pow2(d) for d in dims)


def _device(device):
    import torch

    return torch.device("cpu" if device is None else device)


def cache_key(kernel: str, bucket: Tuple[int, ...], tier: str, device=None) -> tuple:
    return (
        progcache.backend_fingerprint(_device(device)), kernel,
        tuple(int(b) for b in bucket), str(tier),
    )


def candidates(kernel: str, bucket) -> List[Dict[str, int]]:
    """The sweep grid of ``kernel`` at ``bucket``: :data:`CANDIDATES`,
    except that K3's step 1 exists only where every rank of the bucket
    has it (bucket rank <= 16)."""
    if kernel == "als_solve" and int(bucket[0]) > 16:
        return [{"group": 0}]
    return [dict(c) for c in CANDIDATES[kernel]]


# -- persistent cache --------------------------------------------------------


def _disk_path(cache_dir: str, key: tuple) -> str:
    return os.path.join(cache_dir, f"tune-{progcache.key_digest(key)}.json")


def _valid_geometry(kernel: str, geo: Any) -> bool:
    return (
        isinstance(geo, dict)
        and set(geo) == set(KNOBS[kernel])
        and all(isinstance(v, int) and not isinstance(v, bool) for v in geo.values())
    )


def _disk_load(cache_dir: str, kernel: str, key: tuple):
    """One persisted entry; a corrupt or mismatched file logs a warning
    and reads as a miss (a fresh sweep in mode "on"): the cache never
    crashes a fit."""
    path = _disk_path(cache_dir, key)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            entry = json.load(f)
        geo = entry["geometry"]
        if entry.get("key") != repr(key) or not _valid_geometry(kernel, geo):
            raise ValueError("stale or malformed entry")
        return {k: int(v) for k, v in geo.items()}
    except Exception as e:  # corrupt file, bad JSON, wrong schema, IO
        log.warning("tuning cache entry %s unreadable (%s); ignoring it and "
                    "re-resolving fresh", path, e)
        return None


def _disk_store(cache_dir: str, kernel: str, key: tuple, geometry: Dict[str, int]) -> None:
    """Atomic persist (a temporary file, then a rename); an unwritable
    directory leaves the geometry in the process, with a warning."""
    try:
        os.makedirs(cache_dir, exist_ok=True)
        path = _disk_path(cache_dir, key)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"key": repr(key), "kernel": kernel, "geometry": geometry},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:
        log.warning("tuning cache dir %s unwritable (%s); tuned geometry kept "
                    "in-process only", cache_dir, e)


def clear() -> None:
    """Drop the in-process tuning cache and the decision log (tests)."""
    with _LOCK:
        _MEM.clear()
        del _DECISIONS[:]


# -- telemetry ---------------------------------------------------------------

_HELPS = {
    "hits": "tuning-cache geometry hits (memory or disk) by kernel",
    "misses": "tuning-cache misses by kernel (resolved to default, pin, or a "
              "fresh sweep per Config.tuning)",
    "sweeps": "autotune candidate sweeps executed by kernel",
}


def _count(event: str, kernel: str) -> None:
    from oap_mllib_tpu_torch.telemetry import metrics

    metrics.counter(f"oap_tuning_{event}_total", {"kernel": kernel},
                    help=_HELPS[event]).inc()


def _record(kernel: str, bucket, tier: str, decision: str,
            geometry: Dict[str, int]) -> Dict[str, int]:
    with _LOCK:
        _DECISIONS.append({
            "kernel": kernel, "bucket": list(bucket), "tier": tier,
            "decision": decision, "geometry": dict(geometry),
        })
    if decision == "hit":
        _count("hits", kernel)
    elif decision in ("default", "default-multiproc", "sweep"):
        _count("misses", kernel)
    sp = _span()
    if sp is not None:
        sp.node("tuning").attrs.setdefault("decisions", []).append(f"{kernel}:{decision}")
    return geometry


def _span():
    from oap_mllib_tpu_torch.telemetry.spans import current_span

    return current_span()


def mark() -> int:
    """The decision log's length at fit entry (pairs with :func:`delta`)."""
    with _LOCK:
        return len(_DECISIONS)


def delta(since: int) -> Dict[str, Any]:
    """A fit's tuning activity since :func:`mark`: the decisions and their
    counts, what the models attach as ``summary["tuning"]``."""
    from oap_mllib_tpu_torch.config import get_config

    with _LOCK:
        window = [dict(d) for d in _DECISIONS[since:]]
    return {
        "mode": get_config().tuning,
        "decisions": window,
        "sweeps": sum(1 for d in window if d["decision"] == "sweep"),
        "hits": sum(1 for d in window if d["decision"] == "hit"),
        "misses": sum(1 for d in window
                      if d["decision"] in ("default", "default-multiproc", "sweep")),
    }


# -- resolution --------------------------------------------------------------


def _world() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.world_size()


def _lookup(kernel, bucket, tier, key):
    """A cached geometry (memory, then ``Config.tuning_cache_dir``) or
    None; a disk hit is kept in memory."""
    with _LOCK:
        cached = _MEM.get(key)
    if cached is not None:
        return dict(cached)
    from oap_mllib_tpu_torch.config import get_config

    cache_dir = get_config().tuning_cache_dir
    if cache_dir:
        loaded = _disk_load(cache_dir, kernel, key)
        if loaded is not None:
            with _LOCK:
                _MEM[key] = dict(loaded)
            return loaded
    return None


def _sweep_and_store(kernel, bucket, tier, device, key) -> Dict[str, int]:
    from oap_mllib_tpu_torch.config import get_config

    geometry = _sweep(kernel, bucket, tier, device)
    with _LOCK:
        _MEM[key] = dict(geometry)
    cache_dir = get_config().tuning_cache_dir
    if cache_dir:
        _disk_store(cache_dir, kernel, key, geometry)
    return _record(kernel, bucket, tier, "sweep", geometry)


# the kernels whose float64 forms the x64 lane launches at fixed geometry
F64_FIXED = ("kmeans", "pca")


def _fixed_f64(kernel: str, bucket) -> Optional[Dict[str, int]]:
    """The x64 lane's fixed geometry of ``kernel`` (recorded), or None
    off the lane or for a kernel that has no float64 form."""
    from oap_mllib_tpu_torch.config import get_config

    if kernel not in F64_FIXED or not get_config().enable_x64:
        return None
    return _record(kernel, bucket, "f64", "fixed-f64", dict(DEFAULTS[kernel]))


def resolve(kernel: str, bucket, tier: str = "f32", device=None) -> Dict[str, int]:
    """Tuned geometry for one kernel launch site on ``device`` (None: the
    CPU).

    The ladder, each step recorded: ``off`` gives the defaults and
    ignores the cache; ``pin`` the defaults overlaid with the pinned
    knobs; a cache ``hit`` (memory, then ``Config.tuning_cache_dir``)
    the tuned winner with zero sweeps; a miss in ``auto`` the
    ``default`` (never a sweep); a miss in ``on`` one ``sweep``,
    persisted, a hit ever after; a miss in ``on`` in a world of several
    processes ``default-multiproc`` (see :func:`resolve_world`).  On the
    x64 lane K1 and K2 take ``fixed-f64`` before all of it."""
    if kernel not in KNOBS:
        raise ValueError(f"unknown tunable kernel {kernel!r}")
    bucket = tuple(int(b) for b in bucket)
    mode, pins = _mode()
    fixed = _fixed_f64(kernel, bucket)
    if fixed is not None:
        return fixed
    if mode == "off":
        return _record(kernel, bucket, tier, "off", dict(DEFAULTS[kernel]))
    if mode == "pin" and kernel in (pins or {}):
        geo = dict(DEFAULTS[kernel])
        geo.update(pins[kernel])
        return _record(kernel, bucket, tier, "pin", geo)
    key = cache_key(kernel, bucket, tier, device)
    cached = _lookup(kernel, bucket, tier, key)
    if cached is not None:
        return _record(kernel, bucket, tier, "hit", cached)
    if mode != "on":
        return _record(kernel, bucket, tier, "default", dict(DEFAULTS[kernel]))
    if _world() > 1:
        # a rank-local sweep could pick other geometry on each rank;
        # resolve_world is the world's way
        return _record(kernel, bucket, tier, "default-multiproc", dict(DEFAULTS[kernel]))
    return _sweep_and_store(kernel, bucket, tier, device, key)


def resolve_world(kernel: str, bucket, tier: str = "f32", device=None) -> Dict[str, int]:
    """Rank-uniform resolution in a world of processes: process 0
    resolves (sweeping on a miss under ``tuning="on"``) and its geometry
    reaches every process through ``stream_ops._allgather_host``; the
    others record it as a ``hit``.  Every process must call it at the
    same point.  In one process this is :func:`resolve`; on the x64 lane
    K1 and K2 take ``fixed-f64`` on every process without a gather (a
    function of the config alone)."""
    if _world() < 2:
        return resolve(kernel, bucket, tier, device)
    fixed = _fixed_f64(kernel, tuple(int(b) for b in bucket))
    if fixed is not None:
        return fixed
    from oap_mllib_tpu_torch.ops import stream_ops
    from oap_mllib_tpu_torch.parallel import bootstrap

    if kernel not in KNOBS:
        raise ValueError(f"unknown tunable kernel {kernel!r}")
    knobs = KNOBS[kernel]
    bucket = tuple(int(b) for b in bucket)
    if bootstrap.process_index() == 0:
        mode, _ = _mode()
        geo = (_resolve_rank0(kernel, bucket, tier, device) if mode == "on"
               else resolve(kernel, bucket, tier, device))
        frame = np.asarray([float(geo[k]) for k in knobs], np.float64)
    else:
        frame = np.zeros((len(knobs),), np.float64)
    (gathered,) = stream_ops._allgather_host([frame])
    geo = {k: int(gathered[0, i]) for i, k in enumerate(knobs)}
    if bootstrap.process_index() != 0:
        _record(kernel, bucket, tier, "hit", geo)
    return geo


def _resolve_rank0(kernel, bucket, tier, device) -> Dict[str, int]:
    """Process 0's leg of :func:`resolve_world` under ``"on"``: the
    ladder of :func:`resolve`, sweeping despite the world (its winner is
    what every process receives)."""
    key = cache_key(kernel, bucket, tier, device)
    cached = _lookup(kernel, bucket, tier, key)
    if cached is not None:
        return _record(kernel, bucket, tier, "hit", cached)
    return _sweep_and_store(kernel, bucket, tier, device, key)


# -- the sweep ---------------------------------------------------------------

# sweep operands: rows enough to fill the card's 132 SMs many times over
# in every kernel (K1 2048 assign blocks of 128 rows and 128 sort ranges
# at the default; K2 at least 256 slices; K3 2048-plus warps; K4 every
# candidate's blocks full), capped widths beyond which the geometry
# response follows the same arithmetic
_SWEEP_ROWS = {"kmeans": 1 << 18, "pca": 1 << 18, "als_solve": 1 << 16, "als_gram": 1 << 20}
_SWEEP_CAPS = {"kmeans": (1024, 256), "pca": (1024,), "als_solve": (32,), "als_gram": (1024,)}


def _bench_operands(kernel: str, bucket, rng, device) -> tuple:
    """Seeded operands for the bucket on ``device``: uniform in
    [-0.5, 0.5) (drawn in f32, so the host spends little time), capped
    at :data:`_SWEEP_CAPS`, :data:`_SWEEP_ROWS` rows."""
    import torch

    def table(rows, cols):
        a = rng.random((rows, cols), dtype=np.float32) - np.float32(0.5)
        return torch.from_numpy(a).to(device)

    n = _SWEEP_ROWS.get(kernel)
    if kernel == "kmeans":
        k, d = (min(int(b), c) for b, c in zip(bucket, _SWEEP_CAPS[kernel]))
        x = table(n, d)
        c = x[torch.from_numpy(rng.choice(n, max(k, 2), replace=False)).to(device)].contiguous()
        return (x, torch.ones(n, dtype=torch.float32, device=device), c)
    if kernel == "pca":
        d = min(int(bucket[0]), _SWEEP_CAPS[kernel][0])
        return (table(n, d), torch.ones(n, dtype=torch.float32, device=device))
    if kernel == "als_solve":
        r = min(int(bucket[0]), _SWEEP_CAPS[kernel][0])
        m = table(n * r, r).reshape(n, r, r)
        a = torch.bmm(m, m.transpose(1, 2)) + 4.0 * torch.eye(r, device=device)
        return (a.contiguous(), table(n, r),
                torch.full((n,), 3.0, dtype=torch.float32, device=device))
    if kernel == "als_gram":
        return (table(n, min(int(bucket[0]), _SWEEP_CAPS[kernel][0])),)
    raise ValueError(f"no sweep bench for kernel {kernel!r}")


def _launcher(kernel: str, operands, geometry: Dict[str, int], tier: str):
    """A no-argument launch of ``kernel``'s wrapper on ``operands`` at
    ``geometry`` and ``tier`` (a non-tier such as "f32" for the ALS
    kernels means ``highest``)."""
    from oap_mllib_tpu_torch.ops.cuda import _tiers

    mode = _tiers.check_mode(tier) if tier in _tiers.MODES or tier in _tiers.MODE_ALIASES \
        else "highest"
    if kernel == "kmeans":
        x, w, c = operands
        return lambda: kmeans_kernel.lloyd_accumulate(x, w, c, mode, False, geometry)
    if kernel == "pca":
        x, mask = operands
        return lambda: pca_kernel.pca_moments(x, mask, None, mode, geometry=geometry)
    if kernel == "als_solve":
        a, b, n_reg = operands
        return lambda: als_kernel.solve_normal_eq(a, b, n_reg, 0.1, geometry=geometry)
    if kernel == "als_gram":
        (f,) = operands
        return lambda: als_kernel.factor_gram(f, mode, geometry)
    raise ValueError(kernel)


def _measure(kernel: str, operands, geometry: Dict[str, int], tier: str) -> float:
    """One candidate's cost in seconds: the least of :data:`_BEST_OF`
    launches timed with CUDA events, after a warm-up launch that absorbs
    the library's build and load."""
    import torch

    launch = _launcher(kernel, operands, geometry, tier)
    launch()
    best = float("inf")
    for _ in range(_BEST_OF):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _launch_tables():
    return (kmeans_kernel.LAUNCHES, kmeans_kernel.LAUNCHES_BY_MODE,
            kmeans_kernel.LAUNCHES_BY_DTYPE, pca_kernel.LAUNCHES, pca_kernel.LAUNCHES_BY_DTYPE,
            als_kernel.LAUNCHES)


def _sweep_results(kernel: str, bucket, tier: str, device) -> List[Tuple[Dict[str, int], float]]:
    """``(candidate, seconds)`` of every candidate of the bucket's grid on
    a CUDA ``device``, in grid order; the wrappers' launch counts are
    left as they were."""
    import torch

    device = _device(device)
    seed = int(progcache.key_digest((kernel,) + tuple(bucket))[:8], 16)
    rng = np.random.default_rng(seed)
    tables = _launch_tables()
    saved = [dict(t) for t in tables]
    try:
        with torch.cuda.device(device):
            operands = _bench_operands(kernel, bucket, rng, device)
            return [(cand, _measure(kernel, operands, cand, tier))
                    for cand in candidates(kernel, bucket)]
    finally:
        for table, before in zip(tables, saved):
            table.update(before)


def _sweep(kernel: str, bucket, tier: str, device=None) -> Dict[str, int]:
    """The measured best of the bucket's grid (ties to the earlier
    candidate), its wall booked under the active span's ``tuning`` node.
    ``ring`` has no one-device bench (its cost is the schedule between
    ranks, which a loopback cannot rank honestly) and resolves to its
    default, counted as a sweep as in the reference; so does every
    kernel on a CPU device, whose plain versions take no geometry."""
    from oap_mllib_tpu_torch.utils.timing import tick

    _count("sweeps", kernel)
    elapsed = tick()
    results: List[Tuple[Dict[str, int], float]] = []
    if kernel == "ring" or _device(device).type != "cuda":
        best = dict(DEFAULTS[kernel])
    else:
        results = _sweep_results(kernel, bucket, tier, device)
        best, best_t = None, float("inf")
        for cand, t in results:
            if t < best_t:
                best, best_t = dict(cand), t
    wall = elapsed()
    sp = _span()
    if sp is not None:
        node = sp.node("tuning")
        node.record(wall)
        node.attrs.setdefault("sweeps", []).append({
            "kernel": kernel, "bucket": list(bucket), "candidates": len(results),
            "winner": dict(best), "wall_s": wall,
        })
    log.info("autotune sweep %s bucket=%s tier=%s -> %s (%d candidates, %.3fs)",
             kernel, list(bucket), tier, best, len(results), wall)
    return best
