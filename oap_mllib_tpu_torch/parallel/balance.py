"""Capability-weighted shards and the straggler controller (the JAX
package's ``parallel/balance.py``).

An equal share per process lets the slowest process set the pace of
every pass of a world: two processes time-slicing one card, a throttled
host, a relaunched process with cold caches.  This module plans uneven
shares in three layers:

- **Capability**: each process's relative speed, probed once
  (utils/dispatch.throughput_probe) or pinned by
  ``Config.rank_capability``, gathered once per (world size,
  ``Config.probe_epoch``) with each process's memory budgets and
  hardware labels through ops/stream_ops.capability_sync
  (:func:`world_capabilities`), cached.  Processes on equal hardware
  get one capability (:func:`equal_classes`: the probe's noise between
  equal cards is wider than the deadband), so only different hardware
  or a pinned value weights a world.
- **Planner** (pure numpy, the JAX functions' answers exactly):
  :func:`plan_extents` turns weights into per-process row ranges
  quantised to whole chunks, so every process runs the same per-chunk
  program and only its chunk count changes, each share capped by its
  host budget; :func:`plan_block_offsets` / :func:`block_offsets` plan
  the user blocks of the replicated-item block ALS, inside a 5 %
  deadband that keeps near-equal worlds on the exact uniform layout
  (bit-identical to an unweighted fit), each block priced against its
  process's card budget.
- **Controller** (:func:`observe_pass`): after every streamed pass
  ops/stream_ops._fleet_pass hands it the pass's gathered fleet frames,
  the same on every process, so every process takes the same decision.
  When the skew ratio stays above ``Config.rebalance_threshold`` for
  ``Config.rebalance_patience`` passes and is not falling, the extents
  are planned again from the measured rows per second (EMA-blended with
  the current weights, at most eight re-plans a fit, only between Lloyd
  or PCA passes: the k-means|| init keeps state per chunk).  A
  :class:`BalancedView` reads its extent at the start of every pass, so
  the next pass takes the new shares.

Every decision lands in the fit summary's ``balance`` block
(:func:`finalize_fit`).  This module issues no collective itself.  A
process that stays slowest through the controller's re-plans (eight
re-plans spent, or a streak of twice the patience after one) is named in
a persistent-offender hint (``_maybe_hint``): the summary's
``supervisor_hint``, and with ``Config.crash_dir`` set process 0 writes
it to ``balance.hint.json`` there, which the supervisor
(utils/supervisor.py) reads as one more vote toward shrinking the world.
Not ported: the JAX package's ``oap_balance_*`` metrics.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.data.stream import ChunkSource

log = logging.getLogger("oap_mllib_tpu_torch")

ORIGIN_PROBE = "probe"
ORIGIN_PINNED = "pinned"
ORIGIN_EQUAL = "equal"
ORIGIN_MIXED = "mixed"

# weights within this of equal keep the exact uniform block layout
DEADBAND = 0.05
# the share of a process's host budget a memory-backed shard may take
_HOST_FRACTION = 0.5
# the least weight, against the mean: the planner never starves a process
_WEIGHT_FLOOR = 0.05
# a re-plan's blend of the current weights with the measured ones
_EMA = 0.5
_MAX_REPLANS = 8
# the phases whose passes a re-plan may follow
_REPLAN_PHASES = ("lloyd_loop", "covariance_streamed")
HINT_FILENAME = "balance.hint.json"
# the share of a process's card budget its block ALS keys may take
_HBM_BLOCK_FRACTION = 0.25


class BalanceError(RuntimeError):
    """An unplannable layout."""


def capability_sharding_cfg(cfg=None) -> str:
    """Validated ``Config.capability_sharding``: a typo raises."""
    cfg = cfg or get_config()
    mode = cfg.capability_sharding
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"capability_sharding must be auto|on|off, got {mode!r}")
    return mode


def rebalance_threshold_cfg(cfg=None) -> float:
    cfg = cfg or get_config()
    thr = float(cfg.rebalance_threshold)
    if not thr > 1.0:
        raise ValueError(f"rebalance_threshold must be > 1.0 (a skew ratio), got {thr}")
    return thr


def rebalance_patience_cfg(cfg=None) -> int:
    cfg = cfg or get_config()
    pat = int(cfg.rebalance_patience)
    if pat < 1:
        raise ValueError(f"rebalance_patience must be >= 1, got {pat}")
    return pat


def armed(world: int, cfg=None) -> bool:
    """Whether capability weighting applies in a world of ``world``
    processes: "on" always, "off" never, "auto" with several."""
    mode = capability_sharding_cfg(cfg)
    if mode == "off":
        return False
    return mode == "on" or world > 1


def _rank() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.process_index()


def _world() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.world_size()


# -- capability ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CapabilityWorld:
    """A world's gathered capabilities: weights normalised to mean 1, the
    raw values, each process's origin, and its card and host budgets in
    bytes (0 = unbounded)."""

    world: int
    weights: np.ndarray
    raw: np.ndarray
    origins: Tuple[str, ...]
    hbm: np.ndarray
    host: np.ndarray

    @property
    def origin(self) -> str:
        kinds = set(self.origins)
        if kinds == {ORIGIN_PINNED}:
            return ORIGIN_PINNED
        if kinds == {ORIGIN_PROBE}:
            return ORIGIN_PROBE
        return ORIGIN_MIXED


def local_capability_frame() -> np.ndarray:
    """This process's frame for the capability gather: ``[capability,
    origin (1 pinned, 0 probed), card budget, host budget]`` float64."""
    from oap_mllib_tpu_torch.utils import membudget
    from oap_mllib_tpu_torch.utils.dispatch import rank_capability

    cap, origin = rank_capability()
    budgets = membudget.Budgets.resolve(get_config().device.split(",")[0].strip() or None)
    return np.asarray([cap, 1.0 if origin == ORIGIN_PINNED else 0.0,
                       float(budgets.hbm), float(budgets.host)], np.float64)


def fold_world(gathered) -> CapabilityWorld:
    """The gathered ``(world, 4)`` capability frames as a
    :class:`CapabilityWorld` (pure)."""
    frames = np.asarray(gathered, np.float64)
    if frames.ndim != 2 or frames.shape[1] != 4:
        raise ValueError(f"capability frame shape {frames.shape} != (world, 4)")
    raw = np.maximum(frames[:, 0], 1e-9)
    return CapabilityWorld(
        world=frames.shape[0], weights=raw / raw.mean(), raw=raw,
        origins=tuple(ORIGIN_PINNED if c > 0.5 else ORIGIN_PROBE for c in frames[:, 1]),
        hbm=frames[:, 2].copy(), host=frames[:, 3].copy(),
    )


def equal_classes(gathered) -> np.ndarray:
    """The ``(world, 4)`` capability frames of a gathered ``(world, 6)``
    one whose rows end in each process's hardware labels ``[class,
    devices]`` (utils/dispatch.hardware_identity; a pinned process sends
    none), with equal hardware given one capability.  Probed processes
    of one class that share their devices with as many processes are
    equal hardware: all of the world's processes probed and equal read
    1.0 each, else each such group reads its median probe; pinned
    capabilities stay as they are.  The probe
    times milliseconds of work, and its spread between equal cards (13 %
    on four H100s) is wider than the planner's deadband: only the gap
    between different hardware comes from it, so a world of equal
    hardware keeps the uniform layout on every run."""
    frames = np.array(gathered, np.float64)
    if frames.ndim != 2 or frames.shape[1] != 6:
        raise ValueError(f"gathered capability frame shape {frames.shape} != (world, 6)")
    sharers = (frames[:, 5][:, None] == frames[None, :, 5]).sum(axis=1)
    groups: Dict[tuple, List[int]] = {}
    for p in np.flatnonzero(frames[:, 1] < 0.5):
        groups.setdefault((frames[p, 4], int(sharers[p])), []).append(int(p))
    if len(groups) == 1 and len(next(iter(groups.values()))) == len(frames):
        frames[:, 0] = 1.0
    else:
        for members in groups.values():
            frames[members, 0] = np.median(frames[members, 0])
    return frames[:, :4]


_sync_lock = threading.Lock()
_sync_cache: Dict[tuple, CapabilityWorld] = {}


def world_capabilities(world: Optional[int] = None) -> CapabilityWorld:
    """The world's capabilities, gathered once per (world size,
    ``Config.probe_epoch``) with each process's hardware labels, equal
    hardware made equal (:func:`equal_classes`), and cached: the first
    plan of a process pays one probe and one small gather, later plans
    read the cache.  The gather runs outside the lock (fits are serial
    within a process)."""
    from oap_mllib_tpu_torch.utils.dispatch import hardware_identity

    world = _world() if world is None else int(world)
    key = (world, int(get_config().probe_epoch))
    with _sync_lock:
        cached = _sync_cache.get(key)
    if cached is not None:
        return cached
    frame = local_capability_frame()
    # the labels of the hardware the probe ran on (none for a pinned value)
    frame = np.concatenate([frame, hardware_identity() if frame[1] < 0.5 else (0.0, 0.0)])
    if world == 1:
        gathered = frame[None]
    else:
        from oap_mllib_tpu_torch.ops.stream_ops import capability_sync

        gathered = capability_sync(frame)
    cw = fold_world(equal_classes(gathered))
    with _sync_lock:
        _sync_cache[key] = cw
    log.info("balance: world capabilities (%s) = %s", cw.origin,
             [round(float(w), 3) for w in cw.weights])
    return cw


def cached_capability() -> float:
    """This process's gathered or pinned weight, or 0.0 when nothing was
    gathered yet: reading it never probes and never gathers."""
    with _sync_lock:
        for cw in _sync_cache.values():
            r = _rank()
            if r < cw.world:
                return float(cw.weights[r])
    return 0.0


# -- the planners (pure) --------------------------------------------------------------


def _apportion(total: int, weights: np.ndarray,
               caps: Optional[np.ndarray]) -> Tuple[np.ndarray, bool]:
    """``total`` units shared in proportion to ``weights``, each process
    at most its cap (None or <= 0: no cap): a waterfill (capped processes
    saturate, their excess spreads over the rest), then the largest
    remainders, ties to the lower process.  Returns ``(units, over_cap)``;
    ``over_cap`` says the caps could not hold ``total`` and were
    overflowed in proportion instead (budgets steer, they never drop
    data)."""
    world = len(weights)
    w = np.maximum(np.asarray(weights, np.float64), 1e-12)
    cap_arr = np.full((world,), np.inf)
    if caps is not None:
        c = np.asarray(caps, np.float64)
        cap_arr = np.where(c > 0, c, np.inf)
    over = bool(np.isfinite(cap_arr).all() and cap_arr.sum() < total)
    if over:
        cap_arr = np.full((world,), np.inf)
    shares = np.zeros((world,), np.float64)
    remaining = float(total)
    free = np.ones((world,), bool)
    while remaining > 1e-9 and free.any():
        add = remaining * (w * free) / float((w * free).sum())
        trial = shares + np.where(free, add, 0.0)
        hit = free & (trial >= cap_arr)
        if not hit.any():
            shares = trial
            break
        shares[hit] = cap_arr[hit]
        free &= ~hit
        remaining = max(0.0, float(total - shares.sum()))
    units = np.floor(shares).astype(np.int64)
    order = np.argsort(-(shares - units), kind="stable")
    leftover = int(total - units.sum())
    for r in order:
        if leftover <= 0:
            break
        if units[r] + 1 <= cap_arr[r]:
            units[r] += 1
            leftover -= 1
    i = 0
    while leftover > 0 and i < world:  # every cap saturated: spill in order
        units[order[i % world]] += 1
        leftover -= 1
        i += 1
    return units, over


def plan_extents(n_rows: int, chunk_rows: int, weights: Sequence[float],
                 caps_rows: Optional[Sequence[int]] = None
                 ) -> Tuple[List[Tuple[int, int]], bool]:
    """Per-process row ranges ``(start, rows)`` in proportion to
    ``weights``, every boundary but the table's end a multiple of
    ``chunk_rows``, each process at most its ``caps_rows`` (a process
    with any cap stages at least one chunk).  Returns ``(extents,
    over_cap)``; the extents cover ``[0, n_rows)`` exactly."""
    n = int(n_rows)
    if n < 1:
        raise ValueError(f"n_rows must be >= 1, got {n}")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    world = len(weights)
    if world == 1:
        over1 = bool(caps_rows is not None and len(caps_rows) == 1
                     and caps_rows[0] and 0 < caps_rows[0] < n)
        return [(0, n)], over1
    n_chunks = -(-n // chunk_rows)
    caps_c = None
    if caps_rows is not None:
        caps_c = np.asarray([max(1, int(c) // chunk_rows) if c and c > 0 else 0
                             for c in caps_rows], np.float64)
    w = np.maximum(np.asarray(weights, np.float64),
                   _WEIGHT_FLOOR * max(float(np.mean(weights)), 1e-12))
    chunks, over = _apportion(n_chunks, w, caps_c)
    extents: List[Tuple[int, int]] = []
    start = 0
    for r in range(world):
        rows = max(min(int(chunks[r]) * chunk_rows, n - start), 0)
        extents.append((start, rows))
        start += rows
    if start < n:
        # a capped process took the last whole chunk: the sub-chunk tail
        # goes to the last process with rows
        for r in range(world - 1, -1, -1):
            s, rows = extents[r]
            if rows > 0 or r == 0:
                extents[r] = (s, rows + (n - start))
                break
    if sum(rows for _, rows in extents) != n:
        raise BalanceError(f"planner bug: extents {extents} do not cover {n} rows")
    return extents, over


def host_caps_rows(capworld: CapabilityWorld, row_bytes: int,
                   backing: str) -> Optional[List[int]]:
    """Per-process row caps from the gathered host budgets: a
    memory-backed shard fits half its process's budget; sources read
    from disk or a spill are uncapped (0 = uncapped)."""
    if backing in ("disk", "spill") or row_bytes <= 0:
        return None
    caps = [int(b * _HOST_FRACTION / row_bytes) if b > 0 else 0 for b in capworld.host]
    return None if all(c == 0 for c in caps) else caps


def plan_block_offsets(n_keys: int, weights: Sequence[float],
                       caps_keys: Optional[Sequence[int]] = None,
                       deadband: float = DEADBAND) -> Optional[np.ndarray]:
    """``(world + 1,)`` user-block boundaries in proportion to
    ``weights`` (each block non-empty when ``n_keys >= world``), or None
    when the weights lie within ``deadband`` of equal: the caller keeps
    the uniform ``ceil(n / world)`` blocks."""
    world = len(weights)
    if world <= 1:
        return None
    w = np.asarray(weights, np.float64)
    w = w / max(float(w.mean()), 1e-12)
    if float(np.max(np.abs(w - 1.0))) <= deadband:
        return None
    n = int(n_keys)
    caps = None
    if caps_keys is not None:
        caps = np.asarray([int(c) if c and c > 0 else 0 for c in caps_keys], np.float64)
    keys, _ = _apportion(n, w, caps)
    if n >= world:
        for r in range(world):
            while keys[r] < 1:
                donor = int(np.argmax(keys))
                if keys[donor] <= 1:
                    break
                keys[donor] -= 1
                keys[r] += 1
    offsets = np.zeros((world + 1,), np.int64)
    offsets[1:] = np.cumsum(keys)
    offsets[-1] = n
    return offsets


def block_offsets(n_keys: int, mesh_world: int, bytes_per_key: int = 0,
                  capworld: Optional[CapabilityWorld] = None) -> Optional[np.ndarray]:
    """The user-block offsets of the replicated-item block ALS, or None
    for the uniform split (disarmed, inside the deadband, or a mesh whose
    data ranks do not split evenly over the processes).  A process's
    weight spreads over its data ranks; ``bytes_per_key`` prices a
    block's factor and moment rows against its process's card budget.
    The 2-D item layout must not use it: its gathers need uniform
    blocks."""
    if capworld is None:
        nproc = _world()
        if not armed(nproc):
            return None
        capworld = world_capabilities(nproc)
    slots = max(1, int(mesh_world) // capworld.world)
    if capworld.world * slots != int(mesh_world):
        return None
    w = np.repeat(capworld.weights, slots)
    caps = None
    if bytes_per_key > 0:
        caps = []
        for b in capworld.hbm:
            per_slot = int(b * _HBM_BLOCK_FRACTION / (slots * bytes_per_key)) if b > 0 else 0
            caps.extend([per_slot] * slots)
    offsets = plan_block_offsets(n_keys, w, caps_keys=caps)
    if offsets is not None:
        log.info("balance: capability-weighted block offsets (%s): %s", capworld.origin,
                 [int(o) for o in offsets])
    return offsets


def block_capabilities() -> Optional[CapabilityWorld]:
    """The world's capabilities for a block ALS plan, or None when
    capability weighting is disarmed for this world."""
    nproc = _world()
    return world_capabilities(nproc) if armed(nproc) else None


def block_summary(offsets: Optional[np.ndarray], mesh_world: int,
                  capworld: Optional[CapabilityWorld], reason: str = "") -> Dict[str, Any]:
    """A block ALS fit's ``balance`` record: whether weighting was armed,
    the gathered weights and their origin, and the offsets it planned
    (None: the uniform blocks), the same on every process."""
    out: Dict[str, Any] = {
        "enabled": capworld is not None,
        "world": capworld.world if capworld is not None else _world(),
        "mesh_world": int(mesh_world),
        "origin": capworld.origin if capworld is not None else ORIGIN_EQUAL,
        "offsets": None if offsets is None else [int(o) for o in offsets],
    }
    if capworld is not None:
        out["weights"] = [round(float(w), 4) for w in capworld.weights]
    if reason:
        out["reason"] = reason
    return out


# -- the shard plan and the balanced views ------------------------------------------------


class ShardPlan:
    """A world's live extents over one table.  A pass reads its extent
    when it starts; the controller replaces the extents between passes
    (a streamed pass has closed its prefetcher before its reduction)."""

    def __init__(self, n_rows: int, chunk_rows: int, capworld: CapabilityWorld, origin: str,
                 extents: List[Tuple[int, int]], over_cap: bool,
                 caps_rows: Optional[List[int]] = None):
        self.n_rows = int(n_rows)
        self.chunk_rows = int(chunk_rows)
        self.world = capworld.world
        self.origin = origin
        self.over_cap = bool(over_cap)
        self.caps_rows = caps_rows
        self._lock = threading.Lock()
        self._extents = list(extents)
        self._weights = np.array(capworld.weights, np.float64)

    def extents(self) -> List[Tuple[int, int]]:
        with self._lock:
            return list(self._extents)

    def local_extent(self, rank: int) -> Tuple[int, int]:
        with self._lock:
            return self._extents[rank]

    def weights(self) -> np.ndarray:
        with self._lock:
            return np.array(self._weights)

    def set_extents(self, extents: List[Tuple[int, int]], weights: np.ndarray) -> None:
        with self._lock:
            self._extents = list(extents)
            self._weights = np.array(weights, np.float64)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            extents = list(self._extents)
            weights = [round(float(w), 4) for w in self._weights]
        out: Dict[str, Any] = {
            "world": self.world, "origin": self.origin, "chunk_rows": self.chunk_rows,
            "n_rows": self.n_rows, "weights": weights,
            "extents": [[int(s), int(r)] for s, r in extents],
        }
        if self.over_cap:
            out["over_cap"] = True
        if self.caps_rows is not None:
            out["caps_rows"] = [int(c) for c in self.caps_rows]
        return out


def make_plan(n_rows: int, chunk_rows: int, *, row_bytes: int = 0, backing: str = "memory",
              world: Optional[int] = None,
              capworld: Optional[CapabilityWorld] = None) -> ShardPlan:
    """The shard plan of one table over the world, made the fit's live
    plan: armed, the gathered weights with the host-budget caps;
    disarmed, equal extents (origin "equal") through the same code."""
    world = _world() if world is None else int(world)
    caps_rows = None
    if armed(world):
        if capworld is None and world != _world():
            raise BalanceError(
                f"cannot plan a {world}-process world from a {_world()}-process one "
                "without an explicit capworld (the gather covers the live processes)")
        cw = capworld or world_capabilities(world)
        origin = cw.origin
        caps_rows = host_caps_rows(cw, row_bytes, backing)
    else:
        cw = CapabilityWorld(world=world, weights=np.ones((world,)), raw=np.ones((world,)),
                             origins=tuple([ORIGIN_EQUAL] * world),
                             hbm=np.zeros((world,)), host=np.zeros((world,)))
        origin = ORIGIN_EQUAL
    extents, over = plan_extents(n_rows, chunk_rows, cw.weights, caps_rows=caps_rows)
    plan = ShardPlan(n_rows, chunk_rows, cw, origin, extents, over, caps_rows)
    if over:
        log.warning("balance: the host caps cannot hold %d rows; the extents overflow them "
                    "in proportion", n_rows)
    activate(plan)
    return plan


class BalancedView(ChunkSource):
    """One process's view of a table every process holds: a
    ``ChunkSource`` whose rows are the plan's CURRENT extent for
    ``rank``, read when each pass starts, so a re-plan between passes
    moves rows between processes without a new source.  ``data`` is
    anything 2-D that slices by rows (an ndarray, a memmap)."""

    def __init__(self, data, plan: ShardPlan, chunk_rows: int, rank: Optional[int] = None):
        if getattr(data, "ndim", len(getattr(data, "shape", ()))) != 2:
            raise ValueError("BalancedView needs 2-D row-sliceable data")
        self._data = data
        self._plan = plan
        self._rank = _rank() if rank is None else int(rank)
        if not 0 <= self._rank < plan.world:
            raise ValueError(f"rank {self._rank} outside plan world {plan.world}")
        super().__init__(self._pieces, int(data.shape[1]), chunk_rows,
                         n_rows=plan.local_extent(self._rank)[1],
                         dtype=np.dtype(getattr(data, "dtype", np.float32)), backing="memory")
        if plan.chunk_rows % self.chunk_rows and self.chunk_rows % plan.chunk_rows:
            raise ValueError(
                f"view chunk_rows {self.chunk_rows} must divide (or be a multiple of) the "
                f"plan's {plan.chunk_rows}: extents are whole plan chunks")

    @property
    def plan(self) -> ShardPlan:
        return self._plan

    def _pieces(self):
        start, rows = self._plan.local_extent(self._rank)
        cr = self.chunk_rows
        for lo in range(0, rows, cr):
            take = min(cr, rows - lo)
            yield np.asarray(self._data[start + lo: start + lo + take], self.dtype)

    def with_chunk_rows(self, chunk_rows: int) -> "BalancedView":
        """The same plan and extent in chunks of another width (one that
        divides the plan's chunk, so the extents stay aligned)."""
        return BalancedView(self._data, self._plan, chunk_rows, rank=self._rank)

    def __iter__(self):
        # the live extent's row count, or the base walk's determinism
        # check would refuse the first pass after a re-plan
        self._n_rows = self._plan.local_extent(self._rank)[1]
        return super().__iter__()


def local_sources(x, sample_weight=None, chunk_rows: Optional[int] = None,
                  plan: Optional[ShardPlan] = None, rank: Optional[int] = None):
    """This process's balanced view of a table every process holds whole:
    every process passes the same ``x`` (and optional per-row
    ``sample_weight``) and gets a view of its planned extent; the weight
    view shares the plan, so the two stay in lockstep across re-plans.
    Returns ``source`` or ``(source, weight_source)``."""
    from oap_mllib_tpu_torch.data.bucketing import bucket_rows
    from oap_mllib_tpu_torch.data.stream import DEFAULT_CHUNK_ROWS

    if getattr(x, "ndim", 0) != 2:
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"expected 2-D data, got shape {x.shape}")
    cr = bucket_rows(DEFAULT_CHUNK_ROWS if chunk_rows is None else int(chunk_rows))
    if plan is None:
        plan = make_plan(int(x.shape[0]), cr,
                         row_bytes=int(x.shape[1])
                         * np.dtype(getattr(x, "dtype", np.float32)).itemsize,
                         backing="memory")
    src = BalancedView(x, plan, cr, rank=rank)
    if sample_weight is None:
        return src
    w = np.asarray(sample_weight, np.float64).reshape(-1, 1)
    if w.shape[0] != x.shape[0]:
        raise ValueError(f"sample_weight rows {w.shape[0]} != data rows {x.shape[0]}")
    return src, BalancedView(w, plan, cr, rank=rank)


# -- the straggler controller (module state, reset per fit) --------------------------------

_state_lock = threading.Lock()
_active: Optional[ShardPlan] = None
_skews: List[float] = []
_over_count = 0
_streak_rank: Optional[int] = None
_streak = 0
_decisions: List[Dict[str, Any]] = []
_hint: Optional[Dict[str, Any]] = None


def activate(plan: ShardPlan) -> None:
    """Make ``plan`` the live plan the controller re-plans."""
    global _active
    with _state_lock:
        _active = plan


def deactivate() -> None:
    global _active
    with _state_lock:
        _active = None


def observe_pass(phase: str, frames) -> Optional[Dict[str, Any]]:
    """The controller, given one pass's gathered fleet frames (the same
    on every process, so every process decides alike).  Returns the
    decision record when it re-planned."""
    global _over_count, _streak_rank, _streak
    frames = np.asarray(frames, np.float64)
    if frames.ndim != 2 or frames.shape[0] < 1:
        return None
    world = frames.shape[0]
    if not armed(world):
        return None
    with _state_lock:
        plan = _active
    if plan is None or plan.world != world:
        return None
    thr = rebalance_threshold_cfg()
    pat = rebalance_patience_cfg()
    walls = frames[:, 0]
    mean = float(walls.mean())
    skew = float(walls.max() / mean) if mean > 0 else 1.0
    slowest = int(np.argmax(walls))
    with _state_lock:
        _skews.append(skew)
        over = skew > thr
        _over_count = _over_count + 1 if over else 0
        if over and slowest == _streak_rank:
            _streak += 1
        elif over:
            _streak_rank, _streak = slowest, 1
        else:
            _streak_rank, _streak = None, 0
        over_count = _over_count
        streak = _streak
        skews = list(_skews)
        n_replans = len(_decisions)
    if not over or over_count < pat:
        return None
    from oap_mllib_tpu_torch.telemetry.fleet import _trend

    trend = _trend(skews[-max(2 * pat, 4):])
    if trend == "falling" or phase not in _REPLAN_PHASES:
        return None
    if n_replans >= _MAX_REPLANS or streak >= 2 * pat and n_replans > 0:
        _maybe_hint(slowest, skew, streak)
        if n_replans >= _MAX_REPLANS:
            return None
    return _replan(plan, frames, skew, slowest, trend)


def _maybe_hint(rank: int, skew: float, streak: int) -> None:
    """The persistent-offender hint, once a fit: the process that stayed
    slowest through the re-plans, for the supervisor's shrink path (the
    file only with the recovery sideband armed, written by process 0)."""
    global _hint
    with _state_lock:
        if _hint is not None:
            return
        _hint = {"schema": 1, "rank": int(rank), "skew_ratio": round(float(skew), 4),
                 "streak_passes": int(streak), "replans": len(_decisions),
                 "reason": "persistent straggler despite re-planning"}
        hint = dict(_hint)
    log.warning("balance: process %d is a persistent straggler (skew %.2f for %d passes "
                "despite re-planning); handing it to the supervisor's shrink path",
                rank, skew, streak)
    crash_dir = get_config().crash_dir
    if crash_dir and _rank() == 0:
        import os

        from oap_mllib_tpu_torch.data import io as _io

        try:
            os.makedirs(crash_dir, exist_ok=True)
            _io.atomic_write_json(os.path.join(crash_dir, HINT_FILENAME), hint)
        except OSError as e:  # the hint is advice
            log.warning("balance: hint write failed: %s", e)


def _replan(plan: ShardPlan, frames: np.ndarray, skew: float, slowest: int,
            trend: str) -> Optional[Dict[str, Any]]:
    global _over_count
    walls = frames[:, 0]
    old_extents = plan.extents()
    rows = np.asarray([r for _, r in old_extents], np.float64)
    # rows per second of each process; one with no rows keeps its weight
    with np.errstate(divide="ignore", invalid="ignore"):
        meas = np.where((walls > 0) & (rows > 0), rows / np.maximum(walls, 1e-9), 0.0)
    cur = plan.weights()
    sel = meas > 0
    if not sel.any():
        return None
    meas_n = np.array(cur)
    meas_n[sel] = meas[sel] / meas[sel].mean()
    new_w = _EMA * cur + (1.0 - _EMA) * meas_n
    new_w = np.maximum(new_w / new_w.mean(), _WEIGHT_FLOOR)
    new_extents, _ = plan_extents(plan.n_rows, plan.chunk_rows, new_w,
                                  caps_rows=plan.caps_rows)
    decision = {
        "pass": len(_skews),
        "skew_ratio": round(skew, 4),
        "slowest_rank": slowest,
        "trend": trend,
        "weights": [round(float(w), 4) for w in new_w],
        "old_extents": [[int(s), int(r)] for s, r in old_extents],
        "new_extents": [[int(s), int(r)] for s, r in new_extents],
    }
    if new_extents == old_extents:
        decision["noop"] = True
    else:
        plan.set_extents(new_extents, new_w)
        log.warning("balance: re-planned extents (skew %.2f, slowest process %d, trend %s): "
                    "%s -> %s", skew, slowest, trend, [r for _, r in old_extents],
                    [r for _, r in new_extents])
    with _state_lock:
        _over_count = 0
        _decisions.append(decision)
    return decision


def decisions() -> List[Dict[str, Any]]:
    with _state_lock:
        return list(_decisions)


def summary_block(world: int) -> Optional[Dict[str, Any]]:
    """The fit's ``balance`` block, or None when no plan is live."""
    with _state_lock:
        plan = _active
        dec = list(_decisions)
        hint = dict(_hint) if _hint is not None else None
        passes = len(_skews)
    if plan is None:
        return None
    block = dict(plan.as_dict())
    block["enabled"] = armed(world)
    block["passes_observed"] = passes
    block["replans"] = dec
    if hint is not None:
        block["supervisor_hint"] = hint
    return block


def finalize_fit(summary) -> None:
    """At a fit's end: put the ``balance`` block in ``summary`` (a dict's
    key, else an attribute) when a plan is live, then reset the
    controller's per-fit state.  The plan stays live: its adapted
    extents start the next fit over the same views."""
    with _state_lock:
        plan = _active
    if plan is None:
        return
    block = summary_block(_world())
    reset_fit()
    if summary is None or block is None:
        return
    if isinstance(summary, dict):
        summary["balance"] = block
    else:
        summary.balance = block


def reset_fit() -> None:
    """Drop the controller's per-fit state (skews, decisions, streaks,
    the hint)."""
    global _over_count, _streak_rank, _streak, _hint
    with _state_lock:
        _skews.clear()
        _decisions.clear()
        _over_count = 0
        _streak_rank, _streak = None, 0
        _hint = None


def reset() -> None:
    """Forget the capability cache and the live plan, and reset the
    controller."""
    global _active
    with _sync_lock:
        _sync_cache.clear()
    with _state_lock:
        _active = None
    reset_fit()
