"""Deterministic fault injection: the port of the JAX package's
``utils/faults.py``.  Every rung of the resilience ladder
(utils/resilience.py) can be driven without a real hardware fault.

Named *sites* sit at the fragile edges of the runtime and fire when
``Config.fault_spec`` (env ``OAP_MLLIB_TPU_FAULT_SPEC``) arms them.  The
sites the port plants, and where:

=======================  ==================================================
site                     fires at
=======================  ==================================================
``stream.read``          every piece a ``ChunkSource`` pulls from its
                         reader (data/stream.ChunkSource.__iter__)
``prefetch.stage``       every stage call of the prefetch pipeline
                         (data/prefetch.Prefetcher), in the producer
                         thread at depth >= 2
``bootstrap.connect``    each attempt to join the world's store
                         (parallel/bootstrap._connect)
``fit.execute``          once per Lloyd pass (kmeans_ops._lloyd_loop on
                         every in-memory and mesh route,
                         stream_ops.streamed_accumulate), once per PCA
                         moment pass (pca_ops.covariance*,
                         stream_ops.covariance_streamed) and once per
                         ALS iteration (als_ops.run_sides,
                         als_block._run, als_stream.als_run_streamed,
                         als_block_stream.als_block_run_streamed),
                         before the pass's kernels launch: where a
                         device OOM surfaces.  The port has no program
                         cache, the JAX package's chokepoint
``collective.dispatch``  every host collective across processes
                         (parallel/collective._all_gather_host, which
                         ``process_allgather`` and the host reductions
                         of ops/stream_ops go through, and
                         ``all_to_all``)
``disk.read``            every piece of a file-backed source's reader
                         (data/io.iter_npy_rows, iter_parquet_rows)
``spill.write``          every piece written by data/io.SpillWriter
``spill.read``           every piece read back from a spill
                         (data/io.iter_npy_rows of a spill-backed source)
=======================  ==================================================

``ckpt.write``, ``ckpt.restore``, ``serve.*`` and ``delta.*`` stay in
:data:`SITES`, so a spec naming them parses as in the JAX package;
nothing plants them until their modules are ported.

The spec is a comma-separated list of ``site:kind=count`` entries::

    stream.read:fail=2,prefetch.stage:fail=1   # the first 2 reads and
                                               # the first stage raise
    fit.execute:oom=*                          # every pass raises OOM

Kinds: ``fail`` (transient, the retry rung), ``oom`` (device memory,
the halving rung), ``oomhost`` (host memory, the spill rung), ``nan``
(a non-finite iterate, the precision rung and ``nonfinite_policy``),
``err`` (permanent: no fault, propagates raw) and ``kill`` (SIGKILL on
the spot, no exception, no cleanup).  ``count`` is a positive int (the
first N calls fire) or ``*`` (every call).  Same spec and same call
sequence, same faults.

**Chaos mode** (``Config.chaos``, env ``OAP_MLLIB_TPU_CHAOS``) lays a
seeded random schedule over every site on top of the spec:
``seed:rate[:kinds[:budget]]`` fires on about ``rate`` of the site
calls, cycling through ``kinds`` (``+``-separated, default ``fail``),
at most ``budget`` fires (default unbounded).  The decision hashes
(seed, process index, site, call index) with ``zlib.crc32``: the same
on every run, different on every process of a world.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional

from oap_mllib_tpu_torch.config import get_config

SITES = (
    "stream.read", "prefetch.stage", "bootstrap.connect", "fit.execute",
    "ckpt.write", "ckpt.restore", "collective.dispatch",
    "disk.read", "spill.write", "spill.read", "serve.request",
    "serve.dispatch", "serve.batch", "serve.drain",
    "delta.ingest", "delta.solve",
)

KIND_FAIL = "fail"
KIND_OOM = "oom"
KIND_HOST_OOM = "oomhost"
KIND_NONFINITE = "nan"
KIND_ERR = "err"
KIND_KILL = "kill"
_KINDS = (KIND_FAIL, KIND_OOM, KIND_HOST_OOM, KIND_NONFINITE, KIND_ERR, KIND_KILL)


class FaultInjected(Exception):
    """Base of the injected faults: the classifier reads their kind,
    never their message."""

    kind = KIND_ERR


class InjectedTransientError(FaultInjected, OSError):
    """An injected transient fault (an ``OSError``, the host-I/O shape)."""

    kind = KIND_FAIL


class InjectedOOMError(FaultInjected, MemoryError):
    """An injected device OOM."""

    kind = KIND_OOM


class InjectedHostOOMError(FaultInjected, MemoryError):
    """An injected host-memory exhaustion (a bare ``MemoryError``): the
    spill rung."""

    kind = KIND_HOST_OOM


class InjectedPermanentError(FaultInjected, RuntimeError):
    """An injected permanent fault: not a fault to the ladder, which
    re-raises it unchanged."""

    kind = KIND_ERR


class InjectedNonFiniteError(FaultInjected, FloatingPointError):
    """An injected non-finite iterate: the precision rung and the
    ``nonfinite_policy`` tiers without data that overflows."""

    kind = KIND_NONFINITE


def _hard_kill(site: str, nth: int) -> None:
    """The ``kill`` kind: SIGKILL this process, as a preemption would."""
    import logging
    import os
    import signal

    logging.getLogger("oap_mllib_tpu_torch").warning(
        "fault injection: hard-killing process at %s (fire %d)", site, nth)
    os.kill(os.getpid(), signal.SIGKILL)


def _make_fault(kind: str, site: str, nth: int) -> FaultInjected:
    if kind == KIND_OOM:
        return InjectedOOMError(f"CUDA out of memory: injected device OOM at {site} (call {nth})")
    if kind == KIND_FAIL:
        return InjectedTransientError(f"injected transient fault at {site} (call {nth})")
    if kind == KIND_HOST_OOM:
        return InjectedHostOOMError(f"injected host memory exhaustion at {site} (call {nth})")
    if kind == KIND_NONFINITE:
        return InjectedNonFiniteError(f"injected non-finite iterate at {site} (call {nth})")
    return InjectedPermanentError(f"injected permanent fault at {site} (call {nth})")


class _SiteState:
    __slots__ = ("kind", "limit", "calls", "fired")

    def __init__(self, kind: str, limit: int):
        self.kind = kind
        self.limit = limit  # -1: every call
        self.calls = 0
        self.fired = 0


def parse_spec(spec: str) -> Dict[str, _SiteState]:
    """The spec's armed sites; a malformed entry raises ``ValueError``
    naming the valid sites or kinds."""
    out: Dict[str, _SiteState] = {}
    for entry in spec.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            site, action = entry.split(":", 1)
            kind, count = action.split("=", 1)
        except ValueError:
            raise ValueError(
                f"malformed fault_spec entry {entry!r}: expected "
                "'site:kind=count' (e.g. 'stream.read:fail=2')"
            ) from None
        site, kind, count = site.strip(), kind.strip(), count.strip()
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; valid sites: {', '.join(SITES)}")
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; valid kinds: {', '.join(_KINDS)}")
        if count == "*":
            limit = -1
        else:
            try:
                limit = int(count)
            except ValueError:
                raise ValueError(f"fault count must be an int or '*', got {count!r}") from None
            if limit < 0:
                raise ValueError(f"fault count must be >= 0, got {limit}")
        out[site] = _SiteState(kind, limit)
    return out


class ChaosState:
    """A seeded random fault schedule over every site: each call fires
    when ``crc32("seed:rank:site:call")`` maps below ``rate``; the kinds
    fired cycle through ``kinds``; at most ``budget`` fires (-1: no
    bound)."""

    __slots__ = ("seed", "rate", "kinds", "budget", "calls", "fired")

    def __init__(self, seed: int, rate: float, kinds: List[str], budget: int):
        self.seed = seed
        self.rate = rate
        self.kinds = list(kinds)
        self.budget = budget
        self.calls: Dict[str, int] = {}
        self.fired = 0

    def decide(self, site: str, call: int, rank: int) -> bool:
        """The fire decision of one call, a pure function."""
        h = zlib.crc32(f"{self.seed}:{rank}:{site}:{call}".encode())
        return (h / 0xFFFFFFFF) < self.rate

    def maybe_fire(self, site: str, rank: int) -> Optional[str]:
        """Count one call at ``site``; the kind to fire, or None."""
        call = self.calls.get(site, 0)
        self.calls[site] = call + 1
        if self.budget != -1 and self.fired >= self.budget:
            return None
        if not self.decide(site, call, rank):
            return None
        kind = self.kinds[self.fired % len(self.kinds)]
        self.fired += 1
        return kind

    def stats(self) -> Dict[str, object]:
        return {"seed": self.seed, "rate": self.rate, "kinds": list(self.kinds),
                "budget": self.budget, "fired": self.fired, "calls": dict(self.calls)}


def parse_chaos(spec: str) -> Optional[ChaosState]:
    """``Config.chaos`` (``seed:rate[:kinds[:budget]]``) parsed; None for
    the empty spec, ``ValueError`` on anything malformed."""
    spec = spec.strip()
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) < 2 or len(parts) > 4:
        raise ValueError(
            f"malformed chaos spec {spec!r}: expected 'seed:rate[:kinds[:budget]]' "
            "(e.g. '7:0.02' or '7:0.01:fail+kill:3')"
        )
    try:
        seed = int(parts[0])
        rate = float(parts[1])
    except ValueError:
        raise ValueError(
            f"chaos seed must be an int and rate a float, got {parts[0]!r}:{parts[1]!r}"
        ) from None
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"chaos rate must be in [0, 1], got {rate}")
    kinds = ["fail"]
    if len(parts) >= 3 and parts[2].strip():
        kinds = [k.strip() for k in parts[2].split("+") if k.strip()]
        bad = [k for k in kinds if k not in _KINDS]
        if bad:
            raise ValueError(f"unknown chaos kind(s) {bad}; valid kinds: {', '.join(_KINDS)}")
    budget = -1
    if len(parts) == 4 and parts[3].strip() not in ("", "*"):
        try:
            budget = int(parts[3])
        except ValueError:
            raise ValueError(f"chaos budget must be an int or '*', got {parts[3]!r}") from None
        if budget < 0:
            raise ValueError(f"chaos budget must be >= 0, got {budget}")
    return ChaosState(seed, rate, kinds, budget)


def _process_index() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.process_index()


class FaultRegistry:
    """The process's armed sites.  :meth:`maybe_fault` re-arms whenever
    ``Config.fault_spec`` or ``Config.chaos`` changed, so tests and
    services arm faults through the config alone."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spec: Optional[str] = None
        self._sites: Dict[str, _SiteState] = {}
        self._chaos_spec: Optional[str] = None
        self._chaos: Optional[ChaosState] = None

    def arm(self, spec: str) -> None:
        sites = parse_spec(spec)  # validate before swapping state
        with self._lock:
            self._spec = spec
            self._sites = sites

    def arm_chaos(self, spec: str) -> None:
        chaos = parse_chaos(spec)
        with self._lock:
            self._chaos_spec = spec
            self._chaos = chaos

    def maybe_fault(self, site: str) -> None:
        cfg = get_config()
        if cfg.fault_spec != self._spec:
            self.arm(cfg.fault_spec)
        if cfg.chaos != self._chaos_spec:
            self.arm_chaos(cfg.chaos)
        if not self._sites and self._chaos is None:
            return
        rank = _process_index() if self._chaos is not None else 0
        with self._lock:
            st = self._sites.get(site)
            if st is not None:
                st.calls += 1
                if st.limit == -1 or st.fired < st.limit:
                    st.fired += 1
                    if st.kind == KIND_KILL:
                        _hard_kill(site, st.fired)
                    raise _make_fault(st.kind, site, st.fired)
            if self._chaos is not None:
                kind = self._chaos.maybe_fire(site, rank)
                if kind is not None:
                    nth = self._chaos.fired
                    if kind == KIND_KILL:
                        _hard_kill(site, nth)
                    raise _make_fault(kind, site, nth)

    def stats(self) -> Dict[str, Dict[str, object]]:
        """Per armed site: calls seen, faults fired, limit and kind; the
        chaos schedule's counters under ``"chaos"``."""
        with self._lock:
            out: Dict[str, Dict[str, object]] = {
                s: {"calls": st.calls, "fired": st.fired, "limit": st.limit, "kind": st.kind}
                for s, st in self._sites.items()
            }
            if self._chaos is not None:
                out["chaos"] = self._chaos.stats()
            return out

    def reset(self) -> None:
        """Re-arm the current specs with fresh counters."""
        with self._lock:
            spec, chaos_spec = self._spec, self._chaos_spec
        if spec is not None:
            self.arm(spec)
        if chaos_spec is not None:
            self.arm_chaos(chaos_spec)


_REGISTRY = FaultRegistry()


def maybe_fault(site: str) -> None:
    """Raise the fault armed at ``site`` while its count lasts; nothing
    when the site is not armed."""
    _REGISTRY.maybe_fault(site)


def stats() -> Dict[str, Dict[str, object]]:
    return _REGISTRY.stats()


def reset() -> None:
    _REGISTRY.reset()
