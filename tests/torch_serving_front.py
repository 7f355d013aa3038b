"""Shared by the port's serving-front parity tests
(``test_torch_traffic.py``, ``test_torch_reqtrace.py``): each package's
modules by the paths both share, the JAX tests' fake clock and spy
handles, and the records the tests hold equal across the packages."""

from __future__ import annotations

import importlib

import numpy as np

class Pkg:
    """One package's serving front, reached by the module paths both
    packages share."""

    def __init__(self, root: str):
        self.root = root

        def m(path):
            return importlib.import_module(f"{root}.{path}")

        self.serving = m("serving")
        self.traffic = m("serving.traffic")
        self.registry = m("serving.registry")
        self.reqtrace = m("serving.reqtrace")
        self.slo = m("serving.slo")
        self.ha = m("serving.ha")
        self.batcher = m("serving.batcher")
        self.config = m("config")
        self.tm = m("telemetry.metrics")
        self.faults = m("utils.faults")
        self.locktrace = m("utils.locktrace")
        self.recovery = m("utils.recovery")
        self.resilience = m("utils.resilience")
        self.supervisor = m("utils.supervisor")

    def set_config(self, **kw):
        self.config.set_config(**kw)

    def reset(self):
        self.registry.clear()
        self.traffic._reset_for_tests()
        self.ha._reset_for_tests()
        self.reqtrace._reset_for_tests()
        self.slo._reset_for_tests()
        self.faults.reset()


JAX = Pkg("oap_mllib_tpu")
PORT = Pkg("oap_mllib_tpu_torch")
BOTH = (JAX, PORT)


class FakeClock:
    """Injected monotonic clock: no wall-clock read in the deadline
    logic."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class SpyHandle:
    """Records each flush's per-request row counts and answers each
    request with its row count."""

    kind = "spy"

    def __init__(self, fail: Exception | None = None):
        self.flushes: list[list[int]] = []
        self.fail = fail

    def predict_many(self, batches):
        self.flushes.append([b.shape[0] for b in batches])
        if self.fail is not None:
            raise self.fail
        return [np.full(b.shape[0], b.shape[0], np.int32) for b in batches]


class FlakyHandle:
    """Fails the first ``fail_times`` flushes, then answers like
    SpyHandle."""

    def __init__(self, fail_times: int,
                 exc_factory=lambda: ConnectionError("peer reset")):
        self.flushes: list[list[int]] = []
        self.fail_times = fail_times
        self.exc_factory = exc_factory
        self.calls = 0

    def predict_many(self, batches):
        self.flushes.append([b.shape[0] for b in batches])
        self.calls += 1
        if self.calls <= self.fail_times:
            raise self.exc_factory()
        return [np.full(b.shape[0], b.shape[0], np.int32) for b in batches]


class PoisonSpy:
    """A flush holding a nonfinite row raises the package's
    NonFiniteError, as registry._flush_many's guard does."""

    def __init__(self, p: Pkg):
        self.flushes: list[list[int]] = []
        self.err = p.resilience.NonFiniteError

    def predict_many(self, batches):
        self.flushes.append([b.shape[0] for b in batches])
        if any(not np.isfinite(b).all() for b in batches):
            raise self.err("poison flush")
        return [np.full(b.shape[0], b.shape[0], np.int32) for b in batches]


# -- records ----------------------------------------------------------------------


def outcome(f):
    """One future's outcome as plain data."""
    if not f.done():
        return ("pending",)
    if f.cancelled():
        return ("cancelled",)
    exc = f.exception()
    if exc is None:
        return ("ok", np.asarray(f.result()).tolist())
    name = type(exc).__name__
    if name == "ShedError":
        return ("shed", exc.reason, exc.queue_depth, exc.deadline_ms, exc.priced_bytes,
                exc.budget_bytes)
    if name == "ServeError":
        return ("serve", exc.reason, exc.fault_class, exc.retries)
    return (name, str(exc))


def counters(p: Pkg) -> dict:
    """Every ``oap_serve_*`` / ``oap_slo_*`` counter's value and every
    histogram's count, by (name, labels)."""
    reg = p.tm.registry()
    out = {}
    with p.tm._LOCK:
        for (name, labels), m in reg._metrics.items():
            if not name.startswith(("oap_serve_", "oap_slo_")):
                continue
            if isinstance(m, p.tm.Counter):
                out[(name, labels)] = m.value
            elif isinstance(m, p.tm.Histogram):
                out[(name + "#count", labels)] = m.count
    return out


def gauge(p: Pkg, name: str, labels=()):
    reg = p.tm.registry()
    with p.tm._LOCK:
        m = reg._metrics.get((name, tuple(labels)))
        return None if m is None else m.value


class Delta:
    """The change of the counters across a block."""

    def __init__(self, p: Pkg):
        self.p = p
        self.before = counters(p)

    def __call__(self) -> dict:
        after = counters(self.p)
        return {k: v - self.before.get(k, 0) for k, v in after.items()
                if v != self.before.get(k, 0)}


def run_both(script):
    """``script(p)`` in each package, the counter deltas added under
    ``"counters"``; the two records must be equal.  Returns the port's."""
    recs = []
    for p in BOTH:
        delta = Delta(p)
        rec = script(p)
        rec["counters"] = delta()
        recs.append(rec)
    jrec, prec = recs
    assert prec == jrec, f"port {prec!r}\n  jax {jrec!r}"
    return prec


def pump_until_done(q, futs, clock, rounds=60):
    """Drive a start=False queue until every future resolves, the clock
    past each retry backoff."""
    for _ in range(rounds):
        if all(f.done() for f in futs):
            return
        clock.advance(1.0)
        try:
            q.pump()
        except Exception:  # noqa: BLE001 -- a crashed cycle landed its futures
            pass
    raise AssertionError(
        f"unresolved futures after {rounds} pump rounds: "
        f"{sum(not f.done() for f in futs)}"
    )


# -- the served K-Means ------------------------------------------------------------


def kmeans_blobs(n=600, d=16, k=8, seed=5):
    rng = np.random.default_rng(seed)
    proto = rng.normal(size=(k, d)).astype(np.float32) * 4.0
    return (proto[rng.integers(k, size=n)]
            + rng.normal(size=(n, d)).astype(np.float32) * 0.3).astype(np.float32)


def served(p: Pkg, centers):
    """The K-Means of ``centers`` served in ``p``."""
    if p is JAX:
        from oap_mllib_tpu.models.kmeans import KMeansModel

        return p.serving.serve(KMeansModel(centers))
    from oap_mllib_tpu_torch.convert import kmeans_model_from_arrays

    return p.serving.serve(kmeans_model_from_arrays(centers, device="cpu"))
