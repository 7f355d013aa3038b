"""The port's traffic plane and replica heartbeats against the JAX
package's, on the CPU.

Mirrors the JAX package's ``tests/test_traffic.py`` class by class
(``TestAdmission`` ... ``TestServingChaos``) and ``TestHA`` of its
``tests/test_serving.py``.  Every scenario runs once in each package,
through the same module paths, with the same fake clock script and the
same spy handles (``FakeClock``, ``SpyHandle``, ``FlakyHandle``,
``PoisonSpy`` as in the JAX tests), and the two records must be equal,
exactly: each future's outcome (labels, or the error's class and
``reason``), the flush groups, the ``oap_serve_*`` / ``oap_slo_*``
counter deltas, the brownout rungs, the scale decisions and the hint's
JSON, the drain report.  The JAX test's own assertions then hold on the
port's record.  Where a live dispatcher thread makes the flush groups a
matter of timing, only the outcomes are compared.

The served model is a K-Means of k = 8 on 16-wide seeded blobs, fitted
in JAX and carried over with ``convert.kmeans_model_from_arrays``.

``TestHAWorld`` runs one gloo world of two processes (a subprocess each,
a 20 s collective timeout): both replicas heartbeat, process 1 is
SIGKILLed, the survivor's ``ReplicaGuard`` evicts it and the survivor
keeps answering bit-equal to its answers from before the kill.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest

from oap_mllib_tpu_torch import config as port_config
from torch_serving_front import (BOTH, PORT, Delta, FakeClock, FlakyHandle, PoisonSpy,
                                 SpyHandle, gauge, kmeans_blobs, outcome, pump_until_done,
                                 run_both, served)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    port_config.set_config(device="cpu")
    for p in BOTH:
        p.reset()
    yield
    for p in BOTH:
        p.reset()
    port_config.reset_config()


@pytest.fixture(scope="module")
def km_centers():
    """A JAX K-Means (k = 8, d = 16) fitted on the seeded blobs."""
    from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans

    return np.asarray(JaxKMeans(k=8, seed=3, max_iter=10).fit(kmeans_blobs()).cluster_centers_)


# -- the classes of tests/test_traffic.py ---------------------------------------------


class TestAdmission:
    def test_needs_predict_many(self):
        for p in BOTH:
            with pytest.raises(TypeError, match="predict_many"):
                p.serving.TrafficQueue(object(), start=False)
            with pytest.raises(ValueError, match="max_batch_rows"):
                p.serving.TrafficQueue(SpyHandle(), start=False, max_batch_rows=0)

    @pytest.mark.parametrize("knobs,deadline,match", [
        ({"serve_queue_depth": 0}, None, "serve_queue_depth"),
        ({"serve_shed_headroom": 1.5}, None, "serve_shed_headroom"),
        ({"serve_shed_headroom": 0.0}, None, "serve_shed_headroom"),
        ({"serve_deadline_ms": -1.0}, None, "serve_deadline_ms"),
        ({"serve_retry_limit": -1}, None, "serve_retry_limit"),
        ({"serve_retry_backoff": -0.5}, None, "serve_retry_backoff"),
        ({"serve_trace_sample": 1.5}, None, "serve_trace_sample"),
        ({}, -5, "deadline_ms"),
    ])
    def test_knob_typos_raise_at_submit(self, knobs, deadline, match):
        msgs = []
        for p in BOTH:
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            p.set_config(**knobs)
            with pytest.raises(ValueError, match=match) as ei:
                q.submit(np.zeros((1, 2)), deadline_ms=deadline)
            msgs.append(str(ei.value))
            p.set_config(**{k: getattr(p.config.Config(), k) for k in knobs})
            q.close()
        assert msgs[0] == msgs[1]

    def test_queue_full_sheds_loudly_at_submit(self):
        def script(p):
            p.set_config(serve_queue_depth=2)
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            q.submit(np.zeros((1, 2)))
            q.submit(np.zeros((1, 2)))
            with pytest.raises(p.serving.ShedError) as ei:
                q.submit(np.zeros((1, 2)), deadline_ms=25.0)
            q.pump()
            q.close()
            return {"error": str(ei.value), "reason": ei.value.reason,
                    "depth": ei.value.queue_depth}

        rec = run_both(script)
        assert rec["reason"] == "queue_full" and rec["depth"] == 2
        assert "serve_queue_depth=2" in rec["error"]
        assert "queue depth 2" in rec["error"] and "25.0 ms" in rec["error"]
        assert rec["counters"][("oap_serve_shed_total", (("reason", "queue_full"),))] == 1

    def test_budget_shed_prices_against_membudget(self):
        def script(p):
            # 4 KiB x 0.5 = 2048 B; a 100 x 8 f32 request prices over it
            p.set_config(memory_budget_hbm="4K", serve_shed_headroom=0.5)
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            with pytest.raises(p.serving.ShedError) as ei:
                q.submit(np.zeros((100, 8), np.float32))
            f = q.submit(np.zeros((10, 8), np.float32))
            with pytest.raises(p.serving.ShedError) as ei2:
                # (320 + 1600) x 1.25 = 2400 B > 2048 B
                q.submit(np.zeros((50, 8), np.float32))
            q.pump()
            q.close()
            return {"errors": [str(ei.value), str(ei2.value)],
                    "sheds": [outcome_of(ei.value), outcome_of(ei2.value)],
                    "admitted": outcome(f)}

        rec = run_both(script)
        _, reason, _, _, priced, budget = rec["sheds"][0]
        assert reason == "budget" and budget == 2048 and priced > budget
        assert "budget" in rec["errors"][0] and "OOM" in rec["errors"][0]
        assert rec["admitted"][0] == "ok"
        assert rec["counters"][("oap_serve_shed_total", (("reason", "budget"),))] == 2

    def test_unbounded_budget_prices_nothing(self):
        def script(p):
            p.set_config(memory_budget_hbm="0")
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            f = q.submit(np.zeros((5000, 8), np.float32))
            q.pump()
            q.close()
            return {"f": outcome(f)[0]}

        assert run_both(script)["f"] == "ok"

    def test_submit_after_close_raises(self):
        for p in BOTH:
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            q.close()
            with pytest.raises(RuntimeError, match="closed"):
                q.submit(np.zeros((1, 2)))

    def test_budget_resolves_once_per_knob_value(self, monkeypatch):
        from oap_mllib_tpu_torch.utils import membudget

        calls = []
        real = membudget.Budgets.resolve

        def counted(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(membudget.Budgets, "resolve", counted)
        PORT.set_config(memory_budget_hbm="1G")
        q = PORT.serving.TrafficQueue(SpyHandle(), start=False)
        for _ in range(20):
            q.submit(np.zeros((3, 2), np.float32))
        assert len(calls) == 1
        PORT.set_config(memory_budget_hbm="2G")
        q.submit(np.zeros((3, 2), np.float32))
        assert len(calls) == 2
        q.close()


def outcome_of(exc):
    return ("shed", exc.reason, exc.queue_depth, exc.deadline_ms, exc.priced_bytes,
            exc.budget_bytes)


class TestDeadlineBatching:
    def _storm(self, p, subs, advance=0.0, max_batch_rows=1024, handle=None):
        clock = FakeClock()
        spy = handle or SpyHandle()
        q = p.serving.TrafficQueue(spy, start=False, clock=clock,
                                   max_batch_rows=max_batch_rows)
        futs = [q.submit(np.zeros((rows, 2)), **({} if dl is None else {"deadline_ms": dl}))
                for rows, dl in subs]
        clock.advance(advance)
        n = q.pump()
        q.close()
        return {"flushes": spy.flushes, "out": [outcome(f) for f in futs], "resolved": n}

    def test_out_of_order_arrivals_flush_in_deadline_order(self):
        rec = run_both(lambda p: self._storm(p, [(3, 5000), (7, 100), (5, 1000)]))
        assert rec["flushes"] == [[7, 5, 3]]

    def test_no_deadline_sorts_last_by_arrival(self):
        rec = run_both(lambda p: self._storm(p, [(2, None), (9, 50), (4, None)]))
        assert rec["flushes"] == [[9, 2, 4]]

    def test_default_deadline_comes_from_config(self):
        def script(p):
            p.set_config(serve_deadline_ms=10.0)
            return self._storm(p, [(1, None)], advance=1.0)

        rec = run_both(script)
        assert rec["out"][0][:2] == ("shed", "deadline") and rec["flushes"] == []

    def test_expired_shed_before_dispatch_live_still_answered(self):
        rec = run_both(lambda p: self._storm(p, [(6, 10), (4, 60_000)], advance=0.5))
        assert rec["resolved"] == 2
        assert rec["out"][0][:2] == ("shed", "deadline")
        assert rec["out"][1] == ("ok", [4] * 4)
        assert rec["flushes"] == [[4]]
        assert rec["counters"][("oap_serve_shed_total", (("reason", "deadline"),))] == 1

    def test_max_batch_rows_splits_flushes_in_deadline_order(self):
        rec = run_both(lambda p: self._storm(p, [(6, 300), (6, 100), (6, 200)],
                                             max_batch_rows=10))
        assert rec["flushes"] == [[6], [6], [6]]

    def test_futures_resolve_exactly_once(self):
        def script(p):
            clock = FakeClock()
            q = p.serving.TrafficQueue(SpyHandle(), start=False, clock=clock)
            f = q.submit(np.zeros((2, 2)))
            first_pump = q.pump()
            first = f.result(timeout=5)
            second_pump = q.pump()
            same = f.result() is first
            q.close()
            return {"pumps": [first_pump, second_pump], "same": same}

        rec = run_both(script)
        assert rec["pumps"] == [1, 0] and rec["same"]

    def test_cancelled_future_dropped_without_dispatch(self):
        def script(p):
            clock = FakeClock()
            spy = SpyHandle()
            q = p.serving.TrafficQueue(spy, start=False, clock=clock)
            f = q.submit(np.zeros((2, 2)))
            cancelled = f.cancel()
            q.pump()
            q.close()
            return {"cancelled": cancelled, "flushes": spy.flushes, "out": outcome(f)}

        rec = run_both(script)
        assert rec["cancelled"] and rec["flushes"] == [] and rec["out"] == ("cancelled",)

    def test_handle_exception_lands_on_every_future_of_the_flush(self):
        for p in BOTH:
            boom = RuntimeError("scoring failed")
            q = p.serving.TrafficQueue(SpyHandle(fail=boom), start=False, clock=FakeClock())
            f1 = q.submit(np.zeros((2, 2)))
            f2 = q.submit(np.zeros((3, 2)))
            q.pump()
            assert f1.exception() is boom and f2.exception() is boom
            q.close()


class TestAsyncDispatch:
    def test_storm_answers_match_direct_predict(self, km_centers):
        rng = np.random.default_rng(11)
        x = kmeans_blobs(seed=9)
        sizes = rng.integers(3, 60, size=40)
        offs = rng.integers(0, len(x) - 60, size=40)
        answers = []
        for p in BOTH:
            handle = served(p, km_centers)
            handle.warmup(64)
            batches = [x[o:o + s] for s, o in zip(sizes, offs)]
            with p.serving.TrafficQueue(handle) as q:
                futs = [q.submit(b, deadline_ms=60_000) for b in batches]
                got = [f.result(timeout=60) for f in futs]
            for b, ids in zip(batches, got):
                np.testing.assert_array_equal(ids, handle.predict(b))
            answers.append([np.asarray(g).tolist() for g in got])
        assert answers[0] == answers[1]

    def test_close_drains_pending(self):
        def script(p):
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            futs = [q.submit(np.zeros((2, 2))) for _ in range(5)]
            q.close()
            return {"out": [outcome(f) for f in futs]}

        rec = run_both(script)
        assert all(o[0] == "ok" for o in rec["out"])

    def test_dispatcher_thread_is_daemon_and_joined(self):
        for p in BOTH:
            q = p.serving.TrafficQueue(SpyHandle())
            t = q._thread
            assert t is not None and t.daemon
            q.close()
            assert not t.is_alive()
            assert q._thread is None


class TestQueueDepthGauge:
    def test_gauge_tracks_pending_and_returns_to_zero(self):
        def script(p):
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            for _ in range(3):
                q.submit(np.zeros((2, 2)))
            seen = [gauge(p, "oap_serve_queue_depth"), q.depth()]
            q.pump()
            seen += [gauge(p, "oap_serve_queue_depth"), q.depth()]
            q.close()
            return {"seen": seen}

        assert run_both(script)["seen"] == [3, 3, 0, 0]

    def test_delta_folding_is_race_safe(self):
        n, per = 8, 200
        start = threading.Barrier(n)

        def hammer():
            start.wait(timeout=30)
            for _ in range(per):
                PORT.registry.note_queue_depth(1)
                PORT.registry.note_queue_depth(-1)

        threads = [threading.Thread(target=hammer, daemon=True) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert gauge(PORT, "oap_serve_queue_depth") == 0

    def test_clean_under_locks_sanitizer(self, km_centers):
        x = kmeans_blobs(seed=13)
        PORT.locktrace._reset_for_tests()
        PORT.set_config(sanitizers="locks")
        try:
            handle = served(PORT, km_centers)
            handle.warmup(64)
            # armed tracked locks raise LockOrderError on any inversion
            # across the submit, dispatcher and flush seams
            with PORT.serving.TrafficQueue(handle) as q:
                futs = [q.submit(x[5 * i:5 * i + 5], deadline_ms=60_000) for i in range(30)]
                got = [f.result(timeout=60) for f in futs]
            for i, ids in enumerate(got):
                np.testing.assert_array_equal(ids, handle.predict(x[5 * i:5 * i + 5]))
            edges = PORT.locktrace.order_edges()
            assert "serving.traffic" in PORT.locktrace.tracked_names()
            assert all((b, a) not in edges for a, b in edges)
        finally:
            PORT.set_config(sanitizers="")
            PORT.locktrace._reset_for_tests()


class TestScaleController:
    def test_validates_knobs(self):
        for p in BOTH:
            with pytest.raises(ValueError, match="replicas"):
                p.serving.ScaleController(0)
            p.set_config(serve_scale_high=0.0)
            with pytest.raises(ValueError, match="serve_scale_high"):
                p.serving.ScaleController(1)
            p.set_config(serve_scale_high=32.0, serve_scale_idle_s=-1.0)
            with pytest.raises(ValueError, match="serve_scale_idle_s"):
                p.serving.ScaleController(1)

    def test_scales_out_on_sustained_depth(self):
        def script(p):
            p.set_config(serve_scale_high=4.0)
            sc = p.serving.ScaleController(2, clock=FakeClock())
            decisions = [sc.observe(queue_depth=40, p99_s=0.2) for _ in range(4)]
            return {"decisions": decisions, "summary": p.registry.serving_summary()["scale"],
                    "replicas_gauge": gauge(p, "oap_serve_scale_replicas")}

        rec = run_both(script)
        assert [d["action"] for d in rec["decisions"]] == ["hold"] * 3 + ["out"]
        assert rec["decisions"][-1]["replicas"] == 3
        assert "serve_scale_high=4" in rec["decisions"][-1]["reason"]
        assert rec["counters"][("oap_serve_scale_out_total", ())] == 1
        assert rec["summary"]["action"] == "out" and rec["replicas_gauge"] == 3

    def test_holds_while_depth_trend_falls(self):
        def script(p):
            p.set_config(serve_scale_high=4.0)
            sc = p.serving.ScaleController(1, clock=FakeClock())
            return {"decisions": [sc.observe(queue_depth=d) for d in (100, 90, 10, 5)]}

        d = run_both(script)["decisions"][-1]
        assert d["action"] == "hold" and d["depth_trend"] == "falling"

    def test_scales_in_on_idleness(self):
        def script(p):
            p.set_config(serve_scale_idle_s=5.0)
            clock = FakeClock()
            sc = p.serving.ScaleController(3, min_replicas=1, clock=clock)
            out = [sc.observe(queue_depth=0)]
            clock.advance(6.0)
            out.append(sc.observe(queue_depth=0))
            clock.advance(6.0)
            out.append(sc.observe(queue_depth=3))
            return {"decisions": out}

        rec = run_both(script)
        assert [d["action"] for d in rec["decisions"]] == ["hold", "in", "hold"]
        assert rec["decisions"][1]["replicas"] == 2
        assert rec["counters"][("oap_serve_scale_in_total", ())] == 1

    def test_growth_caps_and_floor(self):
        def script(p):
            p.set_config(serve_scale_high=1.0, serve_scale_idle_s=1.0)
            clock = FakeClock()
            sc = p.serving.ScaleController(1, max_replicas=2, clock=clock)
            out = [sc.observe(queue_depth=50) for _ in range(8)]
            clock.advance(10.0)
            out.append(sc.observe(queue_depth=0))
            clock.advance(10.0)
            out.append(sc.observe(queue_depth=0))
            return {"decisions": out}

        ds = run_both(script)["decisions"]
        assert ds[3]["replicas"] == 2 and ds[7]["action"] == "hold" and ds[7]["replicas"] == 2
        assert ds[8]["action"] == "in" and ds[8]["replicas"] == 1
        assert ds[9]["action"] == "hold" and ds[9]["replicas"] == 1

    def test_observe_view_folds_fleet_heartbeat(self):
        def script(p):
            p.set_config(serve_scale_high=4.0)
            sc = p.serving.ScaleController(1, clock=FakeClock())
            view = {"world": 2, "queue_depth": [30.0, 20.0], "requests": [100.0, 90.0]}
            d = sc.observe_view(view, p99_s=0.1)
            return {"decision": d, "replicas": sc.replicas}

        rec = run_both(script)
        assert rec["replicas"] == 2 and rec["decision"]["queue_depth"] == 50

    def test_write_scale_hint_roundtrip(self, tmp_path):
        def script(p):
            p.set_config(serve_scale_high=1.0)
            sc = p.serving.ScaleController(1, clock=FakeClock())
            for _ in range(4):
                d = sc.observe(queue_depth=50)
            side = tmp_path / p.root
            path = p.serving.write_scale_hint(str(side), d)
            with open(path) as f:
                hint = json.load(f)
            hold = p.serving.write_scale_hint(str(side / "x"), dict(d, action="hold"))
            # the port's supervisor reads and removes the hint
            sup = PORT.supervisor.Supervisor(lambda *a: ["true"], 1, str(side))
            read = sup._read_scale_hint()
            return {"hint": hint, "hold": hold, "read": read,
                    "gone": not os.path.exists(path), "name": os.path.basename(path)}

        rec = run_both(script)
        assert rec["hint"]["action"] == "out" and rec["hold"] is None
        assert rec["read"] == rec["hint"] and rec["gone"]
        assert rec["name"] == "serve.scale.hint.json"


class TestSummary:
    def test_serving_summary_grows_traffic_blocks(self):
        def script(p):
            p.set_config(serve_queue_depth=1)
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            q.submit(np.zeros((1, 2)))
            with pytest.raises(p.serving.ShedError):
                q.submit(np.zeros((1, 2)))
            q.pump()
            q.close()
            s = p.registry.serving_summary()
            # the shed block sums the process's counters: each package's own
            return {"queue_depth": s["queue_depth"], "queue_full": s["shed"]["queue_full"] >= 1,
                    "keys": sorted(set(s) - {"latency_p50_s", "latency_p99_s"})}

        rec = run_both(script)
        assert rec["queue_depth"] == 0 and rec["queue_full"]
        assert rec["counters"][("oap_serve_shed_total", (("reason", "queue_full"),))] == 1


class TestDurableFutures:
    def test_transient_fault_retries_then_answers(self):
        def script(p):
            p.set_config(serve_retry_limit=2, serve_retry_backoff=0.01)
            clock = FakeClock()
            h = FlakyHandle(fail_times=1)
            q = p.serving.TrafficQueue(h, start=False, clock=clock)
            f = q.submit(np.zeros((3, 2)))
            q.pump()
            pending = not f.done()
            pump_until_done(q, [f], clock)
            q.close()
            return {"pending": pending, "out": outcome(f), "calls": h.calls,
                    "flushes": h.flushes}

        rec = run_both(script)
        assert rec["pending"] and rec["out"] == ("ok", [3, 3, 3]) and rec["calls"] == 2
        assert rec["counters"][("oap_serve_retries_total", ())] == 1

    def test_retries_exhausted_fails_classified(self):
        def script(p):
            p.set_config(serve_retry_limit=1, serve_retry_backoff=0.0)
            clock = FakeClock()
            q = p.serving.TrafficQueue(FlakyHandle(fail_times=99), start=False, clock=clock)
            f = q.submit(np.zeros((2, 2)))
            pump_until_done(q, [f], clock)
            q.close()
            return {"out": outcome(f), "msg": str(f.exception())}

        rec = run_both(script)
        assert rec["out"] == ("serve", "retries-exhausted", "transient", 1)
        assert "serve_retry_limit" in rec["msg"]

    def test_retry_limit_zero_fails_immediately(self):
        def script(p):
            p.set_config(serve_retry_limit=0)
            q = p.serving.TrafficQueue(FlakyHandle(fail_times=99), start=False,
                                       clock=FakeClock())
            f = q.submit(np.zeros((2, 2)))
            q.pump()
            q.close()
            return {"out": outcome(f)}

        assert run_both(script)["out"][:2] == ("serve", "retries-exhausted")

    def test_retry_preserves_deadline_priority(self):
        def script(p):
            p.set_config(serve_retry_limit=2, serve_retry_backoff=0.0)
            clock = FakeClock()
            h = FlakyHandle(fail_times=1)
            q = p.serving.TrafficQueue(h, start=False, clock=clock)
            fa = q.submit(np.zeros((3, 2)), deadline_ms=500_000)
            fb = q.submit(np.zeros((7, 2)), deadline_ms=100_000)
            pump_until_done(q, [fa, fb], clock)
            q.close()
            return {"flushes": h.flushes, "out": [outcome(fa), outcome(fb)]}

        rec = run_both(script)
        assert rec["flushes"][0] == [7, 3] and rec["flushes"][-1] == [7, 3]

    def test_dispatcher_crash_fails_futures_and_restarts(self):
        def script(p):
            p.set_config(fault_spec="serve.dispatch:err=1")
            q = p.serving.TrafficQueue(SpyHandle(), start=False, clock=FakeClock())
            f = q.submit(np.zeros((2, 2)))
            with pytest.raises(Exception, match="serve.dispatch"):
                q.pump()
            f2 = q.submit(np.zeros((4, 2)))
            q.pump()
            q.close()
            return {"out": [outcome(f), outcome(f2)]}

        rec = run_both(script)
        assert rec["out"][0][:2] == ("serve", "dispatcher-crash")
        assert rec["out"][1] == ("ok", [4] * 4)
        assert rec["counters"][("oap_serve_dispatch_crashes_total", ())] == 1

    def test_dispatcher_thread_survives_crash(self):
        for p in BOTH:
            p.set_config(fault_spec="serve.dispatch:err=1")
            q = p.serving.TrafficQueue(SpyHandle(), poll_s=0.005)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                f1 = q.submit(np.zeros((2, 2)))
                with pytest.raises(Exception):
                    f1.result(timeout=10)
                f2 = q.submit(np.zeros((4, 2)))
                assert f2.result(timeout=10)[0] == 4
            assert q._thread.is_alive()
            q.close()

    def test_transient_dispatcher_crash_requeues(self):
        def script(p):
            p.set_config(fault_spec="serve.dispatch:fail=1", serve_retry_limit=2,
                         serve_retry_backoff=0.0)
            clock = FakeClock()
            q = p.serving.TrafficQueue(SpyHandle(), start=False, clock=clock)
            f = q.submit(np.zeros((3, 2)))
            with pytest.raises(Exception):
                q.pump()
            pending = not f.done()
            pump_until_done(q, [f], clock)
            q.close()
            return {"pending": pending, "out": outcome(f)}

        rec = run_both(script)
        assert rec["pending"] and rec["out"] == ("ok", [3, 3, 3])


class TestPoisonBisection:
    def test_poison_isolated_innocents_answered(self):
        def script(p):
            spy = PoisonSpy(p)
            q = p.serving.TrafficQueue(spy, start=False, clock=FakeClock())
            futs = [q.submit(np.full((3, 2), float(i))) for i in range(3)]
            fp = q.submit(np.full((5, 2), np.nan))
            futs.append(q.submit(np.full((4, 2), 9.0)))
            q.pump()
            q.close()
            return {"out": [outcome(f) for f in futs], "poison": outcome(fp),
                    "msg": str(fp.exception()), "flushes": spy.flushes}

        rec = run_both(script)
        assert all(o[0] == "ok" for o in rec["out"])
        assert rec["poison"][:3] == ("serve", "poison", "nonfinite") and "digest" in rec["msg"]
        assert rec["counters"][("oap_serve_poison_total", ())] == 1
        assert rec["counters"][("oap_serve_bisect_total", ())] >= 1

    def test_two_poisons_both_isolated(self):
        def script(p):
            q = p.serving.TrafficQueue(PoisonSpy(p), start=False, clock=FakeClock())
            good = [q.submit(np.full((2, 2), float(i))) for i in range(4)]
            bad = [q.submit(np.full((2, 2), np.nan)) for _ in range(2)]
            q.pump()
            q.close()
            return {"good": [outcome(f) for f in good], "bad": [outcome(f) for f in bad]}

        rec = run_both(script)
        assert all(o[0] == "ok" for o in rec["good"])
        assert all(o[:2] == ("serve", "poison") for o in rec["bad"])
        assert rec["counters"][("oap_serve_poison_total", ())] == 2

    def test_end_to_end_kmeans_flush_guard_zero_compiles(self, km_centers):
        x = kmeans_blobs(seed=17)

        def script(p):
            handle = served(p, km_centers)
            handle.warmup(64)
            q = p.serving.TrafficQueue(handle, start=False, clock=FakeClock())
            innocents = [x[:5], x[5:17], x[17:47]]
            snap = p.batcher.xla_snapshot()
            futs = [q.submit(b) for b in innocents]
            fp = q.submit(np.full((7, 16), np.nan, np.float32))
            q.pump()
            built = p.batcher.xla_snapshot() - snap
            q.close()
            direct = [np.asarray(handle.predict(b)).tolist() for b in innocents]
            return {"built": built, "poison": outcome(fp)[:2],
                    "out": [outcome(f) for f in futs], "direct": direct}

        rec = run_both(script)
        assert rec["built"] == 0 and rec["poison"] == ("serve", "poison")
        assert [o[1] for o in rec["out"]] == rec["direct"]

    def test_injected_batch_fault_triggers_bisection(self, km_centers):
        x = kmeans_blobs(seed=19)

        def script(p):
            handle = served(p, km_centers)
            handle.warmup(64)
            p.set_config(fault_spec="serve.batch:nan=1")
            q = p.serving.TrafficQueue(handle, start=False, clock=FakeClock())
            futs = [q.submit(x[4 * i:4 * i + 4]) for i in range(4)]
            q.pump()
            q.close()
            return {"out": [outcome(f) for f in futs]}

        rec = run_both(script)
        assert rec["counters"][("oap_serve_bisect_total", ())] >= 1
        assert all(o[0] == "ok" for o in rec["out"])


class TestDrain:
    def test_drain_flushes_then_sheds_draining(self):
        def script(p):
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            futs = [q.submit(np.zeros((2, 2))) for _ in range(4)]
            stats = q.drain(timeout_s=2.0)
            with pytest.raises(p.serving.ShedError) as ei:
                q.submit(np.zeros((1, 2)))
            q.close()
            return {"stats": stats, "out": [outcome(f) for f in futs],
                    "reason": ei.value.reason}

        rec = run_both(script)
        assert rec["stats"]["drained"] and rec["stats"]["failed"] == 0
        assert rec["stats"]["answered"] == 4 and rec["reason"] == "draining"
        assert rec["counters"][("oap_serve_drains_total", ())] == 1
        assert rec["counters"][("oap_serve_shed_total", (("reason", "draining"),))] == 1

    def test_drain_deadline_fails_leftovers_loudly(self):
        def script(p):
            p.set_config(serve_retry_limit=5, serve_retry_backoff=0.05)
            q = p.serving.TrafficQueue(FlakyHandle(fail_times=99), start=False,
                                       clock=FakeClock())
            futs = [q.submit(np.zeros((2, 2))) for _ in range(3)]
            stats = q.drain(timeout_s=0.2)
            depth = q.depth()
            q.close()
            return {"stats": stats, "out": [outcome(f)[:2] for f in futs], "depth": depth}

        rec = run_both(script)
        assert not rec["stats"]["drained"] and rec["stats"]["failed"] == 3
        assert rec["out"] == [("serve", "drain-deadline")] * 3 and rec["depth"] == 0

    def test_drain_posts_sideband_report_and_supervisor_reads_it(self, tmp_path):
        def script(p):
            side = tmp_path / p.root
            p.set_config(crash_dir=str(side))
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            q.submit(np.zeros((2, 2)))
            q.drain(timeout_s=1.0)
            q.close()
            names = sorted(os.listdir(side))
            with open(side / "serve.drain.done.rank0.json") as f:
                report = json.load(f)
            report.pop("timeout_s")
            sup = p.supervisor.Supervisor(lambda rank, world, coord, local: ["true"], 1,
                                          str(side))
            read = sup._read_drain_reports()
            return {"names": names, "report": report, "read": len(read),
                    "again": sup._read_drain_reports()}

        rec = run_both(script)
        assert rec["names"] == ["serve.drain.done.rank0.json"]
        assert rec["report"]["rank"] == 0 and rec["report"]["answered"] == 1
        assert rec["read"] == 1 and rec["again"] == []

    def test_scale_in_drains_attached_queue(self):
        def script(p):
            p.set_config(serve_scale_idle_s=5.0)
            clock = FakeClock()
            q = p.serving.TrafficQueue(SpyHandle(), start=False, clock=clock)
            f = q.submit(np.zeros((2, 2)))
            sc = p.serving.ScaleController(2, min_replicas=1, clock=clock, queue=q)
            sc.observe(queue_depth=0)
            clock.advance(6.0)
            d = sc.observe(queue_depth=0)
            with pytest.raises(p.serving.ShedError, match="draining"):
                q.submit(np.zeros((1, 2)))
            q.close()
            d["drained"].pop("timeout_s")
            return {"decision": d, "out": outcome(f)}

        rec = run_both(script)
        assert rec["decision"]["action"] == "in"
        assert rec["decision"]["drained"]["drained"] is True and rec["out"][0] == "ok"

    def test_drain_fault_site_armed(self):
        for p in BOTH:
            p.set_config(fault_spec="serve.drain:err=1")
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            with pytest.raises(Exception, match="serve.drain"):
                q.drain(timeout_s=0.1)
            q.close()


class TestCloseFailOrFlush:
    def test_wedged_scoring_callable_fails_futures_not_hangs(self):
        for p in BOTH:
            gate = threading.Event()
            release = threading.Event()

            class WedgedHandle:
                def predict_many(self, batches):
                    gate.set()
                    release.wait(30)
                    return [np.zeros(b.shape[0], np.int32) for b in batches]

            delta = Delta(p)
            q = p.serving.TrafficQueue(WedgedHandle(), poll_s=0.005)
            f_wedged = q.submit(np.zeros((2, 2)))
            assert gate.wait(10)
            f_pending = q.submit(np.zeros((3, 2)))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                q.close(timeout_s=0.2)
            for f in (f_wedged, f_pending):
                assert outcome(f)[:2] == ("serve", "shutdown")
            assert delta()[("oap_serve_close_wedged_total", ())] == 1
            release.set()
            t = q._thread
            if t is not None:
                t.join(5)
                assert not t.is_alive()
            assert outcome(f_wedged)[:2] == ("serve", "shutdown")

    def test_close_fails_unresolvable_retries(self):
        def script(p):
            p.set_config(serve_retry_limit=10, serve_retry_backoff=0.05)
            q = p.serving.TrafficQueue(FlakyHandle(fail_times=99), start=False,
                                       clock=FakeClock())
            f = q.submit(np.zeros((2, 2)))
            q.pump()
            pending = not f.done()
            q.close()
            return {"pending": pending, "out": outcome(f)[:2]}

        rec = run_both(script)
        assert rec["pending"] and rec["out"] == ("serve", "shutdown")

    def test_queue_depth_zero_after_failed_close(self):
        def script(p):
            p.set_config(serve_retry_limit=10, serve_retry_backoff=0.05)
            q = p.serving.TrafficQueue(FlakyHandle(fail_times=99), start=False,
                                       clock=FakeClock())
            for _ in range(3):
                q.submit(np.zeros((2, 2)))
            q.pump()
            q.close()
            return {"depth": p.registry.serving_summary()["queue_depth"]}

        assert run_both(script)["depth"] == 0


class TestEvictionFutureAccounting:
    def test_no_future_leaks_across_eviction_and_release(self):
        def script(p):
            p.set_config(serve_queue_depth=6, serve_retry_limit=1, serve_retry_backoff=0.0)
            rng = np.random.default_rng(42)
            clock = FakeClock()
            q = p.serving.TrafficQueue(FlakyHandle(fail_times=2), start=False, clock=clock)
            guard = p.serving.ReplicaGuard(queue=q)
            futs, sheds = [], 0
            for i in range(30):
                try:
                    futs.append(q.submit(rng.normal(size=(1 + i % 4, 2))))
                except p.serving.ShedError:
                    sheds += 1
                if i == 10:
                    with guard.leg():
                        raise p.recovery.RecoveryError("peer died mid-storm")
                if i % 5 == 4:
                    clock.advance(1.0)
                    q.pump()
            evicted = guard.local_only and p.serving.fleet_evicted()
            stats = guard.release(timeout_s=2.0)
            stats.pop("timeout_s")
            s = p.registry.serving_summary()
            return {"evicted": evicted, "sheds": sheds, "stats": stats,
                    "out": [outcome(f) for f in futs], "depth": s["queue_depth"],
                    "evictions": s["evictions"] >= 1}

        rec = run_both(script)
        assert rec["evicted"] and rec["sheds"] > 0
        assert all(o[0] != "pending" for o in rec["out"])
        assert rec["depth"] == 0 and rec["evictions"]
        assert rec["counters"][("oap_serve_evictions_total", ())] == 1


class TestBrownout:
    @pytest.mark.parametrize("bad", ["bogus", "pin:bogus", "pin:", "on"])
    def test_grammar_validates_at_submit(self, bad):
        for p in BOTH:
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            p.set_config(serve_brownout=bad)
            with pytest.raises(ValueError, match="serve_brownout"):
                q.submit(np.zeros((1, 2)))
            p.set_config(serve_brownout="pin:topk")
            q.submit(np.zeros((1, 2)))
            q.pump()
            q.close()

    def test_ladder_steps_up_under_sustained_pressure(self):
        def script(p):
            b = p.traffic.BrownoutController("auto")
            decisions = [b.observe(200, 100) for _ in range(12)]
            tail = [b.observe(200, 100) for _ in range(4)]
            return {"decisions": decisions, "tail": tail, "steps": b.steps, "rung": b.rung,
                    "summary": b.summary()}

        rec = run_both(script)
        assert rec["rung"] == 3 and [s["to"] for s in rec["steps"]] == ["topk", "bf16", "stale"]
        assert rec["counters"][("oap_serve_brownout_steps_total", (("direction", "up"),))] == 3
        assert any(d["absorb"] for d in rec["decisions"])
        assert not any(d["absorb"] for d in rec["tail"])

    def test_falling_trend_blocks_the_step(self):
        def script(p):
            b = p.traffic.BrownoutController("auto")
            return {"d": [b.observe(int(r * 100), 100) for r in (4.0, 3.0, 1.2, 1.1)],
                    "rung": b.rung}

        rec = run_both(script)
        assert rec["rung"] == 0 and rec["d"][-1]["stepped"] == 0

    def test_ladder_steps_down_when_pressure_clears(self):
        def script(p):
            b = p.traffic.BrownoutController("auto")
            up = [b.observe(200, 100) for _ in range(4)]
            down = [b.observe(10, 100) for _ in range(4)]
            return {"up": up, "down": down, "rung": b.rung, "steps": b.steps}

        rec = run_both(script)
        assert rec["up"][-1]["rung"] == 1 and rec["rung"] == 0
        assert rec["down"][-1]["stepped"] == -1

    def test_pinned_rung_never_absorbs(self):
        def script(p):
            p.set_config(serve_brownout="pin:bf16")
            b = p.traffic.brownout()
            return {"rung": b.rung, "d": b.observe(500, 100)}

        rec = run_both(script)
        assert rec["rung"] == 2 and rec["d"]["absorb"] is False

    def test_off_never_steps(self):
        def script(p):
            p.set_config(serve_brownout="off")
            b = p.traffic.brownout()
            return {"d": [b.observe(500, 100) for _ in range(8)], "rung": b.rung}

        rec = run_both(script)
        assert rec["rung"] == 0 and rec["d"][-1]["absorb"] is False

    def test_topk_depth_halves_at_rung(self):
        def script(p):
            p.set_config(serve_brownout="pin:topk")
            p.traffic._reset_for_tests()
            got = [p.traffic.brownout_topk(8), p.traffic.brownout_topk(1)]
            p.set_config(serve_brownout="off")
            got.append(p.traffic.brownout_topk(8))
            return {"got": got}

        rec = run_both(script)
        assert rec["got"] == [4, 1, 8]
        assert rec["counters"][("oap_serve_brownout_topk_reduced_total", ())] == 1

    def test_bf16_rung_overrides_precision_with_parity_bound(self):
        def script(p):
            p.set_config(serve_brownout="pin:bf16")
            p.traffic._reset_for_tests()
            names = [p.batcher.resolve_policy(a).name for a in ("kmeans", "pca", "als")]
            p.set_config(serving_precision="f32")
            names.append(p.batcher.resolve_policy("kmeans").name)
            p.set_config(serving_precision="", serve_brownout="auto")
            names.append(p.batcher.resolve_policy("kmeans").name)
            return {"names": names}

        rec = run_both(script)
        assert rec["names"] == ["bf16", "bf16", "bf16", "f32", "f32"]

    def test_bf16_rung_scores_like_the_pinned_policy(self, km_centers):
        # at the rung a served answer is the model's own call under
        # serving_precision="bf16", bit for bit
        x = kmeans_blobs(seed=23)[:200]
        handle = served(PORT, km_centers)
        PORT.set_config(serve_brownout="pin:bf16")
        browned = handle.predict(x)
        PORT.set_config(serve_brownout="off", serving_precision="bf16")
        np.testing.assert_array_equal(browned, handle.model.predict(x))

    def test_stale_rung_answers_from_previous_pin(self):
        def script(p):
            p.set_config(serve_brownout="pin:stale")
            p.traffic._reset_for_tests()
            cache: dict = {}
            a1 = np.ones((4, 2), np.float32)
            a2 = 2 * np.ones((4, 2), np.float32)
            d1 = p.registry.pin(cache, "t", a1)
            plain = p.registry.pin(cache, "t", a1, allow_stale=True) is d1
            stale = p.registry.pin(cache, "t", a2, allow_stale=True) is d1
            p.set_config(serve_brownout="off")
            p.traffic._reset_for_tests()
            fresh = p.registry.pin(cache, "t", a2, allow_stale=True)
            return {"plain": plain, "stale": stale, "fresh": fresh is not d1,
                    "value": np.asarray(fresh).tolist()}

        rec = run_both(script)
        assert rec["plain"] and rec["stale"] and rec["fresh"]
        assert rec["counters"][("oap_serve_stale_pins_total", ())] == 1

    def test_submit_absorbs_breach_at_active_rung(self):
        def script(p):
            p.set_config(memory_budget_hbm="4K", serve_shed_headroom=0.5)
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            p.set_config(serve_brownout="auto")
            p.traffic.brownout().rung = 1
            f = q.submit(np.zeros((100, 8), np.float32))
            q.pump()
            q.close()
            return {"out": outcome(f)[0]}

        rec = run_both(script)
        assert rec["out"] == "ok"
        assert rec["counters"][("oap_serve_brownout_absorbed_total", ())] == 1

    def test_summary_and_gauge_are_loud(self):
        def script(p):
            p.set_config(serve_brownout="pin:stale")
            p.traffic._reset_for_tests()
            p.traffic.brownout()
            s = p.registry.serving_summary()
            return {"brownout": s["brownout"], "gauge": gauge(p, "oap_serve_brownout_rung")}

        rec = run_both(script)
        assert rec["brownout"]["rung"] == "stale" and rec["brownout"]["policy"] == "pin:stale"
        assert rec["gauge"] == 3.0


class TestServingChaos:
    def _storm(self, p, handle, seed):
        clock = FakeClock()
        q = p.serving.TrafficQueue(handle, start=False, clock=clock)
        r = np.random.default_rng(seed)
        futs = [q.submit(r.normal(size=(int(s), 16)).astype(np.float32))
                for s in r.integers(2, 20, size=16)]
        pump_until_done(q, futs, clock)
        q.close()
        return [outcome(f)[:2] if outcome(f)[0] == "serve" else outcome(f)[0] for f in futs]

    def test_seeded_serving_chaos_is_deterministic(self, km_centers):
        def script(p):
            handle = served(p, km_centers)
            handle.warmup(32)
            p.set_config(serve_retry_limit=1, serve_retry_backoff=0.0,
                         chaos="1234:0.35:fail+nan")
            run1 = self._storm(p, handle, 7)
            p.faults.reset()
            run2 = self._storm(p, handle, 7)
            p.set_config(chaos="")
            return {"runs": [run1, run2]}

        rec = run_both(script)
        assert rec["runs"][0] == rec["runs"][1]
        assert any(tag != "ok" for tag in rec["runs"][0])


# -- TestHA of tests/test_serving.py, and a world of two processes -------------------


class TestHA:
    def test_heartbeat_single_process_view(self):
        views = [p.serving.heartbeat(requests=7, queue_depth=2) for p in BOTH]
        assert views[0] == views[1] == {"world": 1, "rank": 0, "requests": [7],
                                        "queue_depth": [2]}

    def test_heartbeat_defaults_read_the_registry(self):
        def script(p):
            p.set_config(serve_queue_depth=8)
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            q.submit(np.zeros((1, 2)))
            view = p.serving.heartbeat()
            q.close()
            # the requests counter is process-wide: each package's own
            return {"world": view["world"], "depth": view["queue_depth"],
                    "requests": view["requests"] == [
                        int(p.tm.family_total("oap_serve_requests_total"))]}

        rec = run_both(script)
        assert rec["world"] == 1 and rec["depth"] == [1] and rec["requests"]
        assert rec["counters"][("oap_serve_heartbeats_total", ())] == 1

    def test_replica_guard_absorbs_recovery_errors(self):
        def script(p):
            guard = p.serving.ReplicaGuard()
            with guard.leg():
                raise p.recovery.CollectiveTimeoutError(
                    "peer missed deadline", op="process_allgather", axis="host",
                    elapsed_s=10.0)
            return {"local_only": guard.local_only, "evictions": guard.evictions,
                    "error": type(guard.last_error).__name__,
                    "evicted": p.serving.fleet_evicted()}

        rec = run_both(script)
        assert rec == {"local_only": True, "evictions": 1, "error": "CollectiveTimeoutError",
                       "evicted": True,
                       "counters": {("oap_serve_evictions_total", ()): 1}}

    def test_replica_guard_propagates_other_errors(self):
        for p in BOTH:
            guard = p.serving.ReplicaGuard()
            with pytest.raises(ValueError):
                with guard.leg():
                    raise ValueError("a genuine bug")
            assert not guard.local_only and not p.serving.fleet_evicted()

    def test_release_without_a_queue(self):
        for p in BOTH:
            assert p.serving.ReplicaGuard().release() is None


# two replicas, one process each, each its own K-Means queue: both
# heartbeat, process 1 is SIGKILLed, process 0's guard evicts it and
# keeps answering
_HA_WORLD = r"""
import json, os, signal, sys
import numpy as np
from oap_mllib_tpu_torch import serving, set_config
from oap_mllib_tpu_torch.convert import kmeans_model_from_arrays
from oap_mllib_tpu_torch.parallel import bootstrap
from oap_mllib_tpu_torch.utils import recovery
rank, port, crash, centers = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
set_config(device="cpu", crash_dir=crash, collective_timeout=20.0)
bootstrap.initialize_distributed(f"127.0.0.1:{port}", 2, rank)
handle = serving.serve(kmeans_model_from_arrays(np.load(centers), device="cpu"))
x = np.load(centers.replace("centers", "requests"))
guard = serving.ReplicaGuard()
with serving.TrafficQueue(handle) as q:
    before = [q.submit(x[i * 10:(i + 1) * 10]).result(timeout=30).tolist() for i in range(6)]
with guard.leg():
    view = serving.heartbeat()
if rank == 1:
    os.kill(os.getpid(), signal.SIGKILL)
with guard.leg():
    serving.heartbeat()
q = serving.TrafficQueue(handle)
guard.queue = q
after = [q.submit(x[i * 10:(i + 1) * 10]).result(timeout=30).tolist() for i in range(6)]
stats = guard.release(timeout_s=5.0)
print("RESULT " + json.dumps({
    "rank": rank, "view": view, "before": before, "after": after,
    "local_only": guard.local_only, "evicted": serving.fleet_evicted(),
    "error": type(guard.last_error).__name__,
    "evictions": int(serving.serving_summary()["evictions"]),
    "drained": stats["drained"]}), flush=True)
recovery.exit_now(0)
"""


def _os_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestHAWorld:
    def test_survivor_evicts_the_killed_replica_and_keeps_answering(self, tmp_path, km_centers):
        x = kmeans_blobs(seed=29)[:60]
        np.save(tmp_path / "centers.npy", km_centers)
        np.save(tmp_path / "requests.npy", x)
        crash, port = str(tmp_path / "sb"), _os_port()
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="2")
        procs = [subprocess.Popen([sys.executable, "-c", _HA_WORLD, str(r), str(port), crash,
                                   str(tmp_path / "centers.npy")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=env, cwd=ROOT)
                 for r in range(2)]
        try:
            out0 = procs[0].communicate(timeout=120)[0]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.communicate()
        assert procs[0].returncode == 0, out0
        assert procs[1].returncode == -9
        line = [ln for ln in out0.splitlines() if ln.startswith("RESULT ")]
        assert line, out0
        res = json.loads(line[-1][len("RESULT "):])
        # the heartbeat gathered both replicas before the kill
        assert res["view"]["world"] == 2 and res["view"]["requests"] == [6, 6]
        assert res["local_only"] and res["evicted"] and res["evictions"] == 1
        assert res["error"] in ("PeerAbortError", "CollectiveTimeoutError")
        assert res["after"] == res["before"] and res["drained"]
        # the answers are the JAX package's for the same requests
        from oap_mllib_tpu.models.kmeans import KMeansModel

        want = KMeansModel(km_centers).predict(x)
        assert sum(res["before"], []) == np.asarray(want).tolist()
