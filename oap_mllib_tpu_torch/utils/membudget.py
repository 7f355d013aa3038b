"""Memory-budget route planning (the JAX package's ``utils/membudget.py``):
each fit prices its candidate routes against the device and host
budgets and picks one, explicitly and on the record.

- **Budgets** (``Config.memory_budget_hbm`` / ``memory_budget_host``,
  :func:`parse_budget`'s grammar; empty detects them) bound the fit's
  working set on the card and its staged footprint on the host.  The
  card's budget is detected as its whole memory,
  ``torch.cuda.get_device_properties(device).total_memory``: a fixed
  capacity, as the JAX package prices its allocator's ``bytes_limit``,
  rather than ``torch.cuda.mem_get_info``'s free bytes, which exclude
  what torch's caching allocator holds reserved and so vary with the
  fits run before.  ``summary.route["budgets"]["hbm_detected_as"]``
  names that choice.  On the CPU the card's budget is 0 (unbounded), as
  in the JAX package.
- **Estimates**: each candidate route's device and host bytes from the
  fit's shapes, with the JAX package's constants, every candidate
  recorded with why it was rejected.  The streamed K-Means and PCA
  estimates carry a calibration factor learnt from the bytes the
  prefetch pipeline staged per row (:func:`record_plan`); ALS has none,
  its staged rows being groups of the data's own width.
- **Policy** (``Config.scale_policy``): "auto" takes the first candidate
  that fits and warns when that is not the fit's natural route,
  "strict" raises :class:`BudgetError` instead, "pin:<route>" forces a
  route.
- **Exposure**: the decision lands in ``summary.route`` (a
  ``KMeansSummary`` attribute, or the ``"route"`` key of the PCA and ALS
  summary dicts).

The port has one process and no 64-bit mode, so the JAX planner's
multi-process advisory branch and its 8-byte dtype do not arise.  The
in-memory routes' tables are priced at the rows the port's
``DenseTable`` holds (:func:`_padded_rows`: exactly ``n``, its kernels
mask ragged edges), where the JAX package prices its bucketed padding
(``bucket_rows(n, 256)``), and ALS is left out of the calibration;
every other constant is the JAX package's.

The spill primitives of the resilience ladder's host-OOM rung:
:func:`spill_source` stages a fit's source (and its lockstep weights)
to disk spills and swaps the fit onto them, :func:`spill_array` does
so for an in-memory route's array; ``record_plan(..., spilled=True)``
marks the route.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

import torch

from oap_mllib_tpu_torch.config import get_config

log = logging.getLogger("oap_mllib_tpu_torch")

ROUTE_IN_MEMORY = "in-memory"
ROUTE_CHUNKED = "chunked"
ROUTE_STREAMED = "streamed"
ROUTE_STREAMED_BLOCK = "streamed-block"
ROUTES = (ROUTE_IN_MEMORY, ROUTE_CHUNKED, ROUTE_STREAMED, ROUTE_STREAMED_BLOCK)

# allowance on analytic estimates for temporaries and allocator slack
_OVERHEAD = 1.25
# flat allowance for programs and runtime structures per fit
_PROGRAM_BYTES = 64 << 20
# the narrowest chunk the planner suggests (the JAX package's
# resilience.OOM_CHUNK_FLOOR_ROWS)
OOM_CHUNK_FLOOR_ROWS = 64
# f32 everywhere: the port has no 64-bit mode
_DTYPE_BYTES = 4
# what the detected card budget is
HBM_DETECTED_AS = "torch.cuda.get_device_properties().total_memory"


class BudgetError(RuntimeError):
    """``scale_policy="strict"`` and the budget forced a route off the
    fit's natural one (or priced even the natural one out).
    ``estimates`` carries every candidate's footprint."""

    def __init__(self, algo: str, msg: str,
                 estimates: Optional[List["RouteEstimate"]] = None):
        self.algo = algo
        self.estimates = list(estimates or [])
        detail = "; ".join(
            f"{e.route}: hbm~{_fmt_bytes(e.hbm_bytes)} host~{_fmt_bytes(e.host_bytes)}"
            + (f" ({e.reject})" if e.reject else "")
            for e in self.estimates
        )
        super().__init__(f"{algo}: {msg}" + (f"; candidates: {detail}" if detail else ""))


def _fmt_bytes(n: int) -> str:
    if n <= 0:
        return "?"
    for unit in ("B", "K", "M", "G", "T"):
        if n < 1024 or unit == "T":
            return f"{n:.4g}{unit}" if unit != "B" else f"{n}B"
        n /= 1024.0
    return f"{n:.4g}T"


_UNITS = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_budget(spec: str) -> Optional[int]:
    """A budget knob: ``""`` -> None (detect), ``"0"`` / ``"unlimited"``
    / ``"none"`` / ``"inf"`` -> 0 (unbounded), else bytes with an
    optional K/M/G/T suffix (``"4G"``, ``"512M"``).  Anything else
    raises."""
    s = spec.strip().lower()
    if not s:
        return None
    if s in ("unlimited", "none", "inf"):
        return 0
    mult = 1
    if s[-1] in _UNITS:
        mult = _UNITS[s[-1]]
        s = s[:-1]
    try:
        v = float(s)
    except ValueError:
        raise ValueError(
            "memory budget must be bytes with an optional K/M/G/T suffix, "
            f"'0'/'unlimited', or empty (auto-detect); got {spec!r}"
        ) from None
    if v < 0:
        raise ValueError(f"memory budget must be >= 0, got {spec!r}")
    return int(v * mult)


def detect_hbm_bytes(device=None) -> int:
    """The card's memory in bytes (module docstring); 0 (unbounded) on
    the CPU or where there is no card."""
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type != "cuda":
        return 0
    if not torch.cuda.is_available():
        return 0
    index = dev.index if dev is not None and dev.index is not None else torch.cuda.current_device()
    return int(torch.cuda.get_device_properties(index).total_memory)


def detect_host_bytes() -> int:
    """Physical host RAM; 0 (unbounded) when it cannot be read."""
    try:
        return int(os.sysconf("SC_PHYS_PAGES")) * int(os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):
        return 0


@dataclasses.dataclass(frozen=True)
class Budgets:
    """The budgets of one plan, 0 = unbounded; ``*_source`` says whether
    each came from the config or was detected."""

    hbm: int
    host: int
    hbm_source: str
    host_source: str

    @classmethod
    def resolve(cls, device=None) -> "Budgets":
        cfg = get_config()
        hbm = parse_budget(cfg.memory_budget_hbm)
        host = parse_budget(cfg.memory_budget_host)
        return cls(
            hbm=detect_hbm_bytes(device) if hbm is None else hbm,
            host=detect_host_bytes() if host is None else host,
            hbm_source="detected" if hbm is None else "config",
            host_source="detected" if host is None else "config",
        )

    def as_dict(self) -> dict:
        out = {"hbm": self.hbm, "host": self.host, "hbm_source": self.hbm_source,
               "host_source": self.host_source}
        if self.hbm_source == "detected":
            out["hbm_detected_as"] = HBM_DETECTED_AS
        return out


def scale_policy_cfg() -> Tuple[str, Optional[str]]:
    """Validated ``Config.scale_policy`` as (mode, pinned route)."""
    policy = get_config().scale_policy.strip()
    if policy in ("auto", "strict"):
        return policy, None
    if policy.startswith("pin:"):
        route = policy[4:]
        if route in ROUTES:
            return "pin", route
        raise ValueError(
            f"scale_policy pin route must be one of {', '.join(ROUTES)}; got {policy!r}"
        )
    raise ValueError(f"scale_policy must be auto|strict|pin:<route>, got {policy!r}")


@dataclasses.dataclass
class RouteEstimate:
    """One candidate's priced footprint; bytes <= 0 are unknown (an
    unsized source), which fits any budget."""

    route: str
    hbm_bytes: int
    host_bytes: int
    reject: str = ""

    def fits(self, budgets: Budgets) -> bool:
        if budgets.hbm > 0 and self.hbm_bytes > budgets.hbm:
            return False
        if budgets.host > 0 and self.host_bytes > budgets.host:
            return False
        return True

    def why_rejected(self, budgets: Budgets) -> str:
        parts = []
        if budgets.hbm > 0 and self.hbm_bytes > budgets.hbm:
            parts.append(f"hbm estimate {_fmt_bytes(self.hbm_bytes)} > budget "
                         f"{_fmt_bytes(budgets.hbm)}")
        if budgets.host > 0 and self.host_bytes > budgets.host:
            parts.append(f"host estimate {_fmt_bytes(self.host_bytes)} > budget "
                         f"{_fmt_bytes(budgets.host)}")
        return "; ".join(parts)

    def as_dict(self) -> dict:
        out = {"route": self.route, "hbm_bytes": self.hbm_bytes, "host_bytes": self.host_bytes}
        if self.reject:
            out["reject"] = self.reject
        return out


class RoutePlan:
    """The decision for one fit: the chosen and the natural route, every
    candidate's estimate, the budgets and policy, the suggested chunk
    width, and the staged-bytes markers :func:`record_plan` reads."""

    def __init__(self, algo: str, route: str, natural: str, estimates: List[RouteEstimate],
                 budgets: Budgets, policy: str, *, chunk_rows: int = 0,
                 over_budget: bool = False, forced: bool = False):
        from oap_mllib_tpu_torch.data.prefetch import staged_totals

        self.algo = algo
        self.route = route
        self.natural = natural
        self.estimates = estimates
        self.budgets = budgets
        self.policy = policy
        self.chunk_rows = chunk_rows
        self.over_budget = over_budget
        self.forced = forced
        self.downgrades: List[str] = []
        # bytes the planner priced one staged row at; record_plan holds it
        # against the bytes per row the pipeline really staged
        self.est_row_bytes = 0.0
        self.staged_marker = staged_totals()

    @property
    def degraded_scale(self) -> bool:
        """True when the budget (not the caller) moved the fit off its
        natural route."""
        return self.route != self.natural and not self.forced

    def estimate_for(self, route: str) -> Optional[RouteEstimate]:
        return next((e for e in self.estimates if e.route == route), None)

    def downgrade(self, route: str, why: str) -> None:
        """A move to another route after the plan (the ALS grouped guard
        rejecting a source's degrees): strict raises when it lowers the
        scale, auto warns and records it."""
        mode, _ = scale_policy_cfg()
        if mode == "strict" and _scale_rank(route) < _scale_rank(self.route):
            raise BudgetError(
                self.algo,
                f"scale_policy=strict forbids downgrading the planned {self.route!r} "
                f"route to {route!r} ({why})",
                self.estimates,
            )
        log.warning("%s: route downgraded %s -> %s (%s)", self.algo, self.route, route, why)
        self.downgrades.append(f"{self.route}->{route}: {why}")
        self.route = route

    def as_dict(self) -> dict:
        out = {
            "route": self.route,
            "natural": self.natural,
            "policy": self.policy,
            "budgets": self.budgets.as_dict(),
            "estimates": [e.as_dict() for e in self.estimates],
        }
        if self.chunk_rows:
            out["chunk_rows"] = self.chunk_rows
        if self.over_budget:
            out["over_budget"] = True
        if self.forced:
            out["forced"] = True
        if self.degraded_scale:
            out["degraded_scale"] = True
        if self.downgrades:
            out["downgrades"] = list(self.downgrades)
        return out


def _scale_rank(route: str) -> int:
    """Higher handles more data per resident byte; a move to a lower rank
    is a scale downgrade."""
    return {ROUTE_IN_MEMORY: 0, ROUTE_CHUNKED: 1, ROUTE_STREAMED: 2,
            ROUTE_STREAMED_BLOCK: 3}[route]


def choose(algo: str, estimates: List[RouteEstimate], natural: Optional[str] = None,
           device=None) -> RoutePlan:
    """Pick a route from ``estimates`` (fastest first) under the budgets
    and ``Config.scale_policy``: "pin:<route>" that route (it must be a
    candidate); "strict" the natural route or :class:`BudgetError`;
    "auto" the first that fits, else the last (most scale-capable) one
    with ``over_budget`` recorded and a warning."""
    if not estimates:
        raise ValueError(f"{algo}: no candidate routes to plan over")
    budgets = Budgets.resolve(device)
    mode, pinned = scale_policy_cfg()
    natural = natural or estimates[0].route
    for e in estimates:
        if not e.fits(budgets):
            e.reject = e.why_rejected(budgets)
    if mode == "pin":
        if not any(e.route == pinned for e in estimates):
            raise ValueError(
                f"{algo}: scale_policy=pin:{pinned} does not apply to this fit "
                f"(candidates: {', '.join(e.route for e in estimates)})"
            )
        return RoutePlan(algo, pinned, natural, estimates, budgets, f"pin:{pinned}",
                         forced=True)
    chosen = next((e for e in estimates if not e.reject), None)
    if mode == "strict":
        nat = next(e for e in estimates if e.route == natural)
        if nat.reject:
            raise BudgetError(
                algo, f"scale_policy=strict and the natural {natural!r} route exceeds "
                f"the budget ({nat.reject})", estimates)
        if chosen is None or chosen.route != natural:
            raise BudgetError(
                algo, f"scale_policy=strict forbids degrading scale off the natural "
                f"{natural!r} route", estimates)
        return RoutePlan(algo, natural, natural, estimates, budgets, "strict")
    over = chosen is None
    if over:
        chosen = estimates[-1]
        log.warning("%s: no candidate route fits the memory budget (hbm=%s host=%s); "
                    "running the most scale-capable route %r over budget", algo,
                    _fmt_bytes(budgets.hbm), _fmt_bytes(budgets.host), chosen.route)
    plan = RoutePlan(algo, chosen.route, natural, estimates, budgets, "auto",
                     over_budget=over)
    if plan.degraded_scale:
        nat = plan.estimate_for(natural)
        log.warning("%s: memory budget moved the fit off its natural %r route onto %r (%s)",
                    algo, natural, chosen.route,
                    nat.reject if nat is not None else "unpriceable")
    return plan


# -- per-algorithm pricing ------------------------------------------------------------


def _padded_rows(n: int) -> int:
    """Rows of the port's ``DenseTable`` of ``n`` rows: no padding."""
    return max(int(n), 1)


def _depth() -> int:
    from oap_mllib_tpu_torch.data.prefetch import resolve_depth

    try:
        return resolve_depth()
    except ValueError:
        return 1


def suggest_chunk_rows(d: int, extra_width: int, budgets: Budgets, default_rows: int) -> int:
    """The streamed chunk width: the default unless the card's budget
    needs narrower: ``depth`` staged (rows, d) chunks and the (rows,
    extra_width) working block must fit half the budget, floored at
    :data:`OOM_CHUNK_FLOOR_ROWS`."""
    if budgets.hbm <= 0:
        return default_rows
    per_row = (d + extra_width + 1) * _DTYPE_BYTES * _depth()
    fit_rows = max(int(budgets.hbm // (2 * max(per_row, 1))), OOM_CHUNK_FLOOR_ROWS)
    return max(min(default_rows, fit_rows), 1)


def _calibrated(algo: str, estimate: int) -> int:
    return int(estimate * calibration_factor(algo))


def plan_kmeans(n: Optional[int], d: int, k: int, *, source_backing: Optional[str] = None,
                chunk_rows: int = 0, row_chunks_hint: int = 1, device=None) -> RoutePlan:
    """The route of one K-Means fit.  ``source_backing`` None prices an
    array (candidates in-memory / chunked / streamed); a source passes
    its ``backing`` (natural route streamed).  ``row_chunks_hint`` is
    ``kmeans_ops.auto_row_chunks(n, k)``: above 1 the JAX package's
    resident route chunks its scores, so the natural route is
    "chunked"."""
    from oap_mllib_tpu_torch.data.stream import DEFAULT_CHUNK_ROWS
    from oap_mllib_tpu_torch.ops.kmeans_ops import SCORE_BUDGET_ELEMS

    b = _DTYPE_BYTES
    budgets = Budgets.resolve(device)
    centroids = 3 * k * d * b + _PROGRAM_BYTES
    rows = chunk_rows or suggest_chunk_rows(d, k, budgets, DEFAULT_CHUNK_ROWS)
    streamed_hbm = _calibrated(
        "kmeans", int((_depth() * rows * (d + k + 1) * b + centroids) * _OVERHEAD))
    if source_backing is None:
        np_ = _padded_rows(n)
        table = np_ * (d + 1) * b
        host = n * d * b
        in_mem = RouteEstimate(ROUTE_IN_MEMORY,
                               int((table + np_ * k * b + centroids) * _OVERHEAD), host)
        chunked = RouteEstimate(ROUTE_CHUNKED,
                                int((table + SCORE_BUDGET_ELEMS * b + centroids) * _OVERHEAD),
                                host)
        streamed = RouteEstimate(ROUTE_STREAMED, streamed_hbm, host)
        if row_chunks_hint <= 1:
            ests, natural = [in_mem, chunked, streamed], ROUTE_IN_MEMORY
        else:
            ests, natural = [chunked, streamed], ROUTE_CHUNKED
        plan = choose("KMeans", ests, natural, device)
    else:
        host = n * d * b if (n and source_backing == "memory") else rows * d * b * 2
        plan = choose("KMeans", [RouteEstimate(ROUTE_STREAMED, streamed_hbm, host)],
                      ROUTE_STREAMED, device)
    plan.chunk_rows = rows
    plan.est_row_bytes = (d + 1) * b  # the row and its weight
    return plan


def plan_pca(n: Optional[int], d: int, *, source_backing: Optional[str] = None,
             chunk_rows: int = 0, device=None) -> RoutePlan:
    """The route of one PCA fit: the in-memory covariance or the two
    streamed moment passes."""
    from oap_mllib_tpu_torch.data.stream import DEFAULT_CHUNK_ROWS

    b = _DTYPE_BYTES
    budgets = Budgets.resolve(device)
    gram = 2 * d * d * b + _PROGRAM_BYTES
    rows = chunk_rows or suggest_chunk_rows(d, 0, budgets, DEFAULT_CHUNK_ROWS)
    streamed_hbm = _calibrated("pca", int((_depth() * rows * (d + 1) * b + 2 * gram) * _OVERHEAD))
    if source_backing is None:
        np_ = _padded_rows(n)
        host = n * d * b
        ests = [RouteEstimate(ROUTE_IN_MEMORY, int((np_ * (d + 1) * b + gram) * _OVERHEAD), host),
                RouteEstimate(ROUTE_STREAMED, streamed_hbm, host)]
        plan = choose("PCA", ests, ROUTE_IN_MEMORY, device)
    else:
        host = n * d * b if (n and source_backing == "memory") else rows * d * b * 2
        plan = choose("PCA", [RouteEstimate(ROUTE_STREAMED, streamed_hbm, host)],
                      ROUTE_STREAMED, device)
    plan.chunk_rows = rows
    plan.est_row_bytes = (d + 1) * b
    return plan


# grouped edge layouts: ~12 bytes an edge per direction, times the group
# padding the blowup guard allows
_ALS_EDGE_BYTES = 12
_ALS_BLOWUP = 2.0


def plan_als(nnz: int, n_users: int, n_items: int, rank: int, *, world: int = 1,
             source_backing: Optional[str] = None, device=None) -> RoutePlan:
    """The route of one ALS fit: the resident grouped / COO layouts
    (in-memory), host-resident edges uploaded in chunks (streamed), and
    on a mesh the streamed block layout (streamed-block).  Host memory is
    O(nnz) on every route; the streamed property is device memory."""
    b = 4
    factors = (n_users + n_items) * rank * b
    edges = int(2 * nnz * _ALS_EDGE_BYTES * _ALS_BLOWUP)
    moments = (n_users + n_items) * rank * (rank + 1) * b
    host_edges = edges + 3 * nnz * 8
    upload = 64 << 20
    in_mem = RouteEstimate(
        ROUTE_IN_MEMORY, int((edges + 3 * factors + moments + _PROGRAM_BYTES) * _OVERHEAD),
        host_edges)
    streamed = RouteEstimate(
        ROUTE_STREAMED, int((3 * factors + moments + upload + _PROGRAM_BYTES) * _OVERHEAD),
        host_edges)
    if world > 1:
        block = RouteEstimate(
            ROUTE_STREAMED_BLOCK,
            int((3 * factors // world + moments // world + upload + _PROGRAM_BYTES)
                * _OVERHEAD),
            host_edges // world + 3 * nnz * 8)
        plan = choose("ALS", [block], ROUTE_STREAMED_BLOCK, device)
    else:
        natural = ROUTE_STREAMED if source_backing is not None else ROUTE_IN_MEMORY
        ests = [streamed, in_mem] if source_backing is not None else [in_mem, streamed]
        plan = choose("ALS", ests, natural, device)
    # no calibration: the pipeline stages group rows of the data's own
    # width, which no per-row price foresees (the JAX package prices a
    # triples row, 24 B, against ~3 KB group rows and drifts 4x high)
    return plan


# -- calibration: estimates learn from the bytes the pipeline staged ----------------

_cal_lock = threading.Lock()
_cal: Dict[str, float] = {}
_CAL_ALPHA = 0.3  # weight of the newest observation
_CAL_CLAMP = (0.25, 4.0)  # a wilder ratio is a fault, not a calibration


def calibration_factor(algo: str) -> float:
    with _cal_lock:
        return _cal.get(algo, 1.0)


def reset_calibration() -> None:
    with _cal_lock:
        _cal.clear()


def _note_calibration(algo: str, estimated: float, actual: float) -> float:
    """Fold one fit's staged-bytes-per-row ratio into the algorithm's
    moving average."""
    if estimated <= 0 or actual <= 0:
        return calibration_factor(algo)
    ratio = min(max(actual / estimated, _CAL_CLAMP[0]), _CAL_CLAMP[1])
    with _cal_lock:
        prev = _cal.get(algo, 1.0)
        _cal[algo] = prev + _CAL_ALPHA * (ratio - prev)
        return _cal[algo]


def spill_source(holder: Dict[str, object], algo: str) -> bool:
    """The host-OOM rung: ``holder["source"]`` (and ``holder["weights"]``,
    a lockstep source, when present) staged to disk spills
    (``ChunkSource.spill_to_disk``), the holder swapped onto the
    spill-backed sources; the fit's next attempt reads them.  False
    (with a warning) when the spill fails: the ladder falls through,
    the holder untouched."""
    try:
        spilled = holder["source"].spill_to_disk()
        w = holder.get("weights")
        if w is not None:
            holder["weights"] = w.spill_to_disk()
        holder["source"] = spilled
        log.warning("%s: spilled %s rows to %s", algo, spilled.n_rows, spilled.backing)
        return True
    except Exception as e:  # noqa: BLE001 -- the rung falls through
        log.warning("%s: spill to disk failed: %s", algo, e)
        return False


def spill_array(holder: Dict[str, object], x, weights, chunk_rows: int, algo: str) -> bool:
    """The in-memory route's host-OOM rung: the array (and its row
    weights) as sources of ``chunk_rows``, spilled by
    :func:`spill_source` into ``holder``, from which the next attempt
    streams; a failed spill leaves ``holder`` as it was."""
    import numpy as np

    from oap_mllib_tpu_torch.data.stream import ChunkSource

    staged = {"source": ChunkSource.from_array(x, chunk_rows=chunk_rows)}
    if weights is not None:
        staged["weights"] = ChunkSource.from_array(np.asarray(weights).reshape(-1, 1),
                                                   chunk_rows=chunk_rows)
    if not spill_source(staged, algo):
        return False  # the holder stays empty: the in-memory route runs again
    holder.update(staged)
    return True


def record_plan(summary, plan: Optional[RoutePlan], *, spilled: bool = False) -> None:
    """Attach the plan to the fit's summary (``summary["route"]`` for a
    dict, ``summary.route`` otherwise), with the bytes the pipeline
    staged since the plan was made, the bytes per row against the
    planner's price, and the calibration that ratio moves; ``spilled``
    marks a fit the host-OOM rung moved to a disk spill."""
    if summary is None or plan is None:
        return
    from oap_mllib_tpu_torch.data.prefetch import staged_totals

    d = plan.as_dict()
    if spilled:
        d["spilled"] = True
    total_b, total_r = staged_totals()
    actual_b = total_b - plan.staged_marker[0]
    actual_r = total_r - plan.staged_marker[1]
    if actual_b > 0:
        d["actual_bytes_staged"] = int(actual_b)
    if actual_b > 0 and actual_r > 0 and plan.est_row_bytes > 0:
        observed = actual_b / actual_r
        d["staged_bytes_per_row"] = round(observed, 2)
        d["estimated_bytes_per_row"] = round(plan.est_row_bytes, 2)
        d["calibration"] = round(
            _note_calibration(plan.algo.lower(), plan.est_row_bytes, observed), 4)
    if isinstance(summary, dict):
        summary["route"] = d
    else:
        summary.route = d
