"""Process-wide metrics registry: counters, gauges, log-bucket
histograms (the JAX package's ``telemetry/metrics.py``, whole).

Every subsystem of the port books here: the program cache
(``oap_progcache_*``, utils/progcache.py), the kernel wrappers
(``oap_kernel_*``, ops/cuda/_tiers.kernel_launch), the host collectives
(``oap_collective_*``), the streamed passes (``oap_prefetch_*``,
``oap_stream_*``), the ladder (``oap_resilience_*``), the kernel-geometry
autotuner (``oap_tuning_{hits,misses,sweeps}_total`` by ``kernel``,
ops/cuda/autotune.py), recovery, checkpoints, balance and the fleet
rollups.  The summaries keep their
own shapes; the registry is what the exporters (telemetry/export.py),
``GET /metrics`` (telemetry/fleet.py) and a dashboard read.  Names and
labels are the JAX package's, and so is :func:`render_prometheus`'s
text, byte for byte, for the same sequence of operations.

- **Deterministic**: fixed log-scale bucket bounds; observations are
  values the caller measured on the monotonic clock.
- **Cheap**: an increment is a dict lookup and an add under one lock
  (the prefetch producer books concurrently with the consumer).
- **Prometheus-ready**: ``# HELP`` / ``# TYPE`` per family, cumulative
  ``_bucket{le=...}``, ``_sum`` and ``_count`` for histograms, and
  OpenMetrics exemplars after a bucket line.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

# Fixed log-scale bucket bounds (factor-4 geometric series).  Durations
# span 1 µs .. ~67 s; bytes span 256 B .. ~17 GB.  Everything past the
# last bound lands in the +Inf overflow bucket.
DURATION_BUCKETS: Tuple[float, ...] = tuple(1e-6 * 4.0 ** i for i in range(14))
BYTES_BUCKETS: Tuple[float, ...] = tuple(256.0 * 4.0 ** i for i in range(14))
COUNT_BUCKETS: Tuple[float, ...] = tuple(1.0 * 4.0 ** i for i in range(14))

LabelSet = Tuple[Tuple[str, str], ...]


def _labelset(labels: Optional[Dict[str, str]]) -> LabelSet:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with _LOCK:
            self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        with _LOCK:
            self.value = float(v)


class Histogram:
    """Cumulative-bucket histogram over fixed log-scale bounds.

    ``counts[i]`` is the number of observations ``<= bounds[i]`` in that
    bucket (non-cumulative storage; the Prometheus renderer emits the
    cumulative form); ``counts[-1]`` is the +Inf overflow.

    ``observe(..., exemplar={...})`` pins an OpenMetrics exemplar
    (label dict + the observed value, e.g. a sampled request trace id)
    to the bucket the observation lands in — latest observation wins
    per bucket; ``render_prometheus`` emits it after the bucket line
    (`` # {trace_id="..."} 0.0042``).  Storage stays None until the
    first exemplar, so un-traced histograms pay nothing."""

    __slots__ = ("bounds", "counts", "sum", "count", "exemplars")

    def __init__(self, bounds: Tuple[float, ...] = DURATION_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        # bucket index -> (labels dict, observed value); lazily built
        self.exemplars: Optional[Dict[int, Tuple[Dict[str, str], float]]] \
            = None

    def observe(self, v: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        v = float(v)
        with _LOCK:
            idx = bisect.bisect_left(self.bounds, v)
            self.counts[idx] += 1
            self.sum += v
            self.count += 1
            if exemplar:
                if self.exemplars is None:
                    self.exemplars = {}
                self.exemplars[idx] = (dict(exemplar), v)


_LOCK = threading.Lock()


def histogram_quantile(h: Histogram, q: float) -> float:
    """Upper-bound estimate of the ``q``-quantile from a cumulative
    bucket read: the smallest bucket bound whose cumulative count
    reaches ``q * count`` (the +Inf overflow returns the largest finite
    bound).  With the factor-4 log buckets the estimate is within one
    bucket factor of the true quantile — the resolution the serving
    p50/p99 summary block and bench tail-latency lines report at.

    Edges: an empty histogram returns 0.0 for any ``q``; ``q=0``
    returns the lowest non-empty bucket's bound (the min estimate);
    ``q=1`` the highest non-empty finite bound; mass in the +Inf
    overflow clamps to the largest finite bound (the storage has no
    upper witness).  Out-of-range ``q`` raises."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    with _LOCK:
        total = h.count
        if total == 0:
            return 0.0
        if q == 0.0:
            for bound, c in zip(h.bounds, h.counts):
                if c > 0:
                    return float(bound)
            return float(h.bounds[-1])  # all mass in the overflow
        target = q * total
        cum = 0
        for bound, c in zip(h.bounds, h.counts):
            cum += c
            if cum >= target:
                return float(bound)
        return float(h.bounds[-1])


class Registry:
    """Name+labels -> metric instance, with per-name type/help metadata."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelSet], Any] = {}
        self._meta: Dict[str, Tuple[str, str]] = {}  # name -> (type, help)

    def _get(self, name: str, labels, kind: str, help_: str, make):
        key = (name, _labelset(labels))
        with _LOCK:
            prev = self._meta.get(name)
            if prev is not None and prev[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev[0]}, "
                    f"not {kind}"
                )
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = make()
            # a family registered help-less at one call site must still
            # pick up the help a richer site supplies later — every
            # family then renders with a real # HELP line
            if prev is None or (not prev[1] and help_):
                self._meta[name] = (kind, help_)
            return m

    def family_total(self, name: str) -> float:
        """Sum of one family's values across all its label sets
        (histograms contribute their observation ``sum``); 0.0 for an
        unregistered family.  The cheap cross-label read the fleet
        rollup frames use (telemetry/fleet.local_frame)."""
        with _LOCK:
            total = 0.0
            for (n, _), m in self._metrics.items():
                if n != name:
                    continue
                total += m.sum if isinstance(m, Histogram) else m.value
            return total

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        return self._get(name, labels, "counter", help, Counter)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        return self._get(name, labels, "gauge", help, Gauge)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  bounds: Tuple[float, ...] = DURATION_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get(
            name, labels, "histogram", help, lambda: Histogram(bounds)
        )

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dump of every metric: ``{name: {labels-json:
        value-or-histogram-dict}}`` with labels rendered ``k=v,...``
        (empty string for unlabelled series).  Deterministically ordered
        (sorted names, sorted label sets)."""
        with _LOCK:
            items = sorted(
                self._metrics.items(),
                key=lambda kv: (kv[0][0], kv[0][1]),
            )
            out: Dict[str, Any] = {}
            for (name, labels), m in items:
                lab = ",".join(f"{k}={v}" for k, v in labels)
                series = out.setdefault(name, {})
                if isinstance(m, Histogram):
                    series[lab] = {
                        "buckets": dict(
                            zip([_fmt(b) for b in m.bounds] + ["+Inf"],
                                m.counts)
                        ),
                        "sum": m.sum,
                        "count": m.count,
                    }
                else:
                    series[lab] = m.value
            return out

    def render_prometheus(self) -> str:
        """Standard Prometheus text exposition of the whole registry."""
        with _LOCK:
            items = sorted(
                self._metrics.items(),
                key=lambda kv: (kv[0][0], kv[0][1]),
            )
            lines: List[str] = []
            seen_meta = set()
            for (name, labels), m in items:
                if name not in seen_meta:
                    seen_meta.add(name)
                    kind, help_ = self._meta.get(name, ("untyped", ""))
                    # the promtext spec wants one # HELP + # TYPE per
                    # family; families registered without help get a
                    # self-naming fallback so scrapers never see a bare
                    # family (tests/test_telemetry.py round-trips this)
                    lines.append(
                        f"# HELP {name} "
                        f"{_escape_help(help_ or name)}"
                    )
                    lines.append(f"# TYPE {name} {kind}")
                lab = _render_labels(labels)
                if isinstance(m, Histogram):
                    cum = 0
                    for i, (b, c) in enumerate(zip(m.bounds, m.counts)):
                        cum += c
                        lines.append(
                            f"{name}_bucket{_render_labels(labels, le=_fmt(b))}"
                            f" {cum}{_render_exemplar(m, i)}"
                        )
                    cum += m.counts[-1]
                    lines.append(
                        f'{name}_bucket{_render_labels(labels, le="+Inf")}'
                        f" {cum}{_render_exemplar(m, len(m.bounds))}"
                    )
                    lines.append(f"{name}_sum{lab} {_fmt(m.sum)}")
                    lines.append(f"{name}_count{lab} {m.count}")
                else:
                    lines.append(f"{name}{lab} {_fmt(m.value)}")
            return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every metric AND its metadata (tests; the per-fit delta
        consumers snapshot-and-subtract instead)."""
        with _LOCK:
            self._metrics.clear()
            self._meta.clear()


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_help(text: str) -> str:
    """Promtext HELP escaping: backslash and newline only."""
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    """Promtext label-value escaping: backslash, double-quote, newline."""
    return (
        value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _render_exemplar(m: Histogram, idx: int) -> str:
    """OpenMetrics exemplar suffix for one bucket line (`` # {k="v"}
    value``), or "" when the bucket holds none.  Label values get the
    standard promtext escaping."""
    if m.exemplars is None:
        return ""
    ex = m.exemplars.get(idx)
    if ex is None:
        return ""
    labels, v = ex
    body = ",".join(
        f'{k}="{_escape_label(str(val))}"' for k, val in sorted(labels.items())
    )
    return f" # {{{body}}} {_fmt(v)}"


def _render_labels(labels: LabelSet, le: Optional[str] = None) -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels]
    if le is not None:
        parts.append(f'le="{le}"')
    return "{" + ",".join(parts) + "}" if parts else ""


# -- module-level singleton (the process registry) ---------------------------

_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def counter(name: str, labels: Optional[Dict[str, str]] = None,
            help: str = "") -> Counter:
    return _REGISTRY.counter(name, labels, help)


def gauge(name: str, labels: Optional[Dict[str, str]] = None,
          help: str = "") -> Gauge:
    return _REGISTRY.gauge(name, labels, help)


def histogram(name: str, labels: Optional[Dict[str, str]] = None,
              bounds: Tuple[float, ...] = DURATION_BUCKETS,
              help: str = "") -> Histogram:
    return _REGISTRY.histogram(name, labels, bounds, help)


def family_total(name: str) -> float:
    return _REGISTRY.family_total(name)


def snapshot() -> Dict[str, Any]:
    return _REGISTRY.snapshot()


def render_prometheus() -> str:
    return _REGISTRY.render_prometheus()


def reset() -> None:
    _REGISTRY.reset()
