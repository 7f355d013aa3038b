"""The port's request tracing, SLO engine and serving health surfaces
against the JAX package's, on the CPU.

Mirrors the JAX package's ``tests/test_reqtrace.py`` class by class
(``TestSampling``, ``TestLedger``, ``TestAttach``,
``TestTrafficIntegration``, ``TestExemplars``, ``TestSLOEngine``,
``TestDecisionRecords``, ``TestHealthSurfaces``).  Each scenario runs in
both packages under the same fake clock script
(tests/torch_serving_front.py) and the records must be equal, exactly:
``is_sampled`` on the same ids, each ``Ledger.as_record()``, the stage
histograms' counts, the burn rates and the SLO state of the same
observation script, the ``/healthz`` serving block, the ``/sloz``
payload, the JSON-lines ``request`` records (their process-wide ``seq``
aside).  The JAX test's assertions then hold on the port's record.
"""

from __future__ import annotations

import json
import re
import urllib.request

import numpy as np
import pytest

from oap_mllib_tpu_torch import config as port_config
from torch_serving_front import (BOTH, JAX, PORT, FakeClock, SpyHandle, kmeans_blobs, outcome,
                                 run_both, served)


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
    from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans

    return np.asarray(JaxKMeans(k=8, seed=3, max_iter=10).fit(kmeans_blobs()).cluster_centers_)


class TestSampling:
    def test_trace_id_deterministic_and_rank_tagged(self):
        for p in BOTH:
            assert p.reqtrace.make_trace_id(3, 7) == "03-00000007"
            assert p.reqtrace.make_trace_id(0, 7) != p.reqtrace.make_trace_id(1, 7)

    @pytest.mark.parametrize("sample", [0.05, 0.37, 0.5, 0.99])
    def test_sampling_is_the_same_pure_hash(self, sample):
        ids = [PORT.reqtrace.make_trace_id(r, s) for r in range(3) for s in range(300)]
        port = [PORT.reqtrace.is_sampled(i, sample) for i in ids]
        assert port == [JAX.reqtrace.is_sampled(i, sample) for i in ids]
        assert port == [PORT.reqtrace.is_sampled(i, sample) for i in ids]
        if sample == 0.37:
            assert 0.2 < sum(port) / len(port) < 0.55

    def test_sampling_edges(self):
        for p in BOTH:
            tid = p.reqtrace.make_trace_id(0, 1)
            assert p.reqtrace.is_sampled(tid, 1.0) is True
            assert p.reqtrace.is_sampled(tid, 0.0) is False

    @pytest.mark.parametrize("bad", [1.5, -0.1])
    def test_knob_validated_at_begin(self, bad):
        msgs = []
        for p in BOTH:
            p.set_config(serve_trace_sample=bad)
            with pytest.raises(ValueError, match="serve_trace_sample") as ei:
                p.reqtrace.begin(0.0, 0, 0, 0.0)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]

    def test_disarmed_begin_returns_none(self):
        for p in BOTH:
            assert p.reqtrace.begin(0.0, 0, 0, 0.0) is None
            assert not p.reqtrace.armed()


def _ledger(p, t0=100.0, seq=5):
    p.set_config(serve_trace_sample=1.0)
    return p.reqtrace.begin(t0, 0, seq, 50.0)


class TestLedger:
    def test_cuts_sum_to_wall_exactly(self):
        def script(p):
            lg = _ledger(p)
            lg.cut("admission", 100.25)
            lg.cut("queue_wait", 101.0)
            lg.cut("batch_form", 101.125)
            lg.cut_flush(102.0, pad_s=0.25, compile_s=0.5)
            p.reqtrace.finalize(lg, "answered", 102.5, model="kmeans")
            return {"record": lg.as_record(), "sum": lg.stage_sum()}

        rec = run_both(script)
        assert rec["record"]["wall_s"] == pytest.approx(2.5) == rec["sum"]
        assert rec["record"]["stages"] == {
            "admission": 0.25, "queue_wait": 0.75, "batch_form": 0.125, "bucket_pad": 0.25,
            "compile": 0.5, "execute": 0.125, "dispatch": 0.5}

    def test_cut_flush_clamps_parts_to_the_interval(self):
        def script(p):
            lg = _ledger(p, 0.0)
            lg.cut("queue_wait", 1.0)
            lg.cut_flush(2.0, pad_s=5.0, compile_s=5.0)
            p.reqtrace.finalize(lg, "answered", 2.0)
            return {"record": lg.as_record()}

        st = run_both(script)["record"]["stages"]
        assert st["bucket_pad"] == 1.0 and st["compile"] == 0.0 and st["execute"] == 0.0

    def test_finalize_is_idempotent(self):
        def script(p):
            lg = _ledger(p, 0.0)
            p.reqtrace.finalize(lg, "answered", 1.0)
            p.reqtrace.finalize(lg, "failed", 9.0)
            return {"record": lg.as_record()}

        rec = run_both(script)["record"]
        assert rec["outcome"] == "answered" and rec["wall_s"] == 1.0

    def test_unknown_outcome_classifies_as_failed(self):
        def script(p):
            lg = _ledger(p, 0.0)
            p.reqtrace.finalize(lg, "exploded", 1.0)
            return {"outcome": lg.outcome}

        assert run_both(script)["outcome"] == "failed"

    def test_record_schema_is_fixed(self):
        assert PORT.reqtrace.STAGES == JAX.reqtrace.STAGES
        assert PORT.reqtrace.OUTCOMES == JAX.reqtrace.OUTCOMES

        def script(p):
            lg = _ledger(p, 10.0)
            lg.event("retry", "n=1", 10.5)
            p.reqtrace.finalize(lg, "answered", 11.0)
            return {"record": lg.as_record()}

        rec = run_both(script)["record"]
        assert set(rec["stages"]) == set(PORT.reqtrace.STAGES)
        assert rec["events"][0]["kind"] == "retry"

    def test_finalize_books_histograms_and_outcome_counter(self):
        def script(p):
            lg = _ledger(p, 0.0)
            lg.cut("queue_wait", 0.5)
            p.reqtrace.finalize(lg, "answered", 1.0)
            q = p.reqtrace.stage_quantiles()
            return {"stages": sorted(q), "attr": p.reqtrace.attribution_block()["coverage"]}

        rec = run_both(script)
        assert rec["counters"][("oap_serve_traced_total", (("outcome", "answered"),))] == 1
        assert rec["counters"][("oap_serve_stage_seconds#count", (("stage", "queue_wait"),))] == 1
        assert {"queue_wait", "dispatch", "execute"} <= set(rec["stages"])
        assert rec["attr"] == 1.0


class TestAttach:
    def test_notes_fold_into_attached_flush(self):
        def script(p):
            lg = _ledger(p, 0.0, seq=1)
            with p.reqtrace.attach([lg, None]) as att:
                p.reqtrace.note_flush("bucket_pad", 0.25)
                p.reqtrace.note_flush("bucket_pad", 0.25)
                p.reqtrace.note_event("ring_hop", "hop=0 block=1", 0.5)
                ex = p.reqtrace.exemplar_trace_id()
                notes = att.flush_notes()
                inside = len(p.reqtrace.current_ledgers())
            return {"ex": ex, "notes": notes, "events": lg.events, "inside": inside,
                    "after": p.reqtrace.current_ledgers()}

        rec = run_both(script)
        assert rec["ex"] == "00-00000001" and rec["notes"] == {"bucket_pad": 0.5}
        assert rec["events"][0]["kind"] == "ring_hop" and rec["inside"] == 1
        assert rec["after"] == []

    def test_misses_outside_attach_are_noops(self):
        for p in BOTH:
            p.reqtrace.note_flush("bucket_pad", 1.0)
            p.reqtrace.note_event("ring_hop", "", 0.0)
            assert p.reqtrace.exemplar_trace_id() is None
            assert p.reqtrace.current_ledgers() == []

    def test_the_batcher_pads_into_an_attached_flush(self, km_centers):
        # the notes outlive the block, where the traffic plane reads
        # them (the JAX package's are gone by then: its bucket_pad is 0)
        lg = _ledger(PORT, 0.0)
        with PORT.reqtrace.attach([lg]) as att:
            PORT.batcher.bucket_batch(np.zeros((5, 3), np.float32))
        assert att.flush_notes()["bucket_pad"] > 0.0
        handle = served(PORT, km_centers)
        PORT.set_config(serve_trace_sample=1.0)
        with PORT.serving.TrafficQueue(handle) as q:
            futs = [q.submit(kmeans_blobs(seed=41)[:37], deadline_ms=60_000) for _ in range(8)]
            for f in futs:
                f.result(timeout=60)
        pads = [PORT.reqtrace.ledger_of(f).stages["bucket_pad"] for f in futs]
        assert all(v > 0.0 for v in pads)


class TestTrafficIntegration:
    def test_answered_future_carries_finalized_ledger(self):
        def script(p):
            clock = FakeClock(100.0)
            q = p.serving.TrafficQueue(SpyHandle(), start=False, clock=clock)
            p.set_config(serve_trace_sample=1.0)
            f = q.submit(np.zeros((4, 3), np.float32), deadline_ms=60_000)
            clock.advance(0.5)
            q.pump()
            q.close()
            lg = p.reqtrace.ledger_of(f)
            return {"record": lg.as_record(), "sum": lg.stage_sum()}

        rec = run_both(script)
        r = rec["record"]
        assert r["outcome"] == "answered" and r["model"] == "spy"
        assert rec["sum"] == pytest.approx(r["wall_s"])
        assert r["stages"]["queue_wait"] == pytest.approx(0.5)

    def test_fake_clock_storm_records_equal(self):
        # retries, sheds, answers and a sampled share, under one clock
        # script: every ledger equal across the packages
        def script(p):
            from torch_serving_front import FlakyHandle

            clock = FakeClock(10.0)
            p.set_config(serve_trace_sample=0.37, serve_retry_limit=2, serve_retry_backoff=0.0)
            q = p.serving.TrafficQueue(FlakyHandle(fail_times=1), start=False, clock=clock)
            futs = []
            for i in range(24):
                futs.append(q.submit(np.zeros((1 + i % 5, 3), np.float32),
                                     deadline_ms=[0, 50, 5000][i % 3]))
                clock.advance(0.01)
                if i % 6 == 5:
                    q.pump()
            clock.advance(1.0)
            for _ in range(4):
                q.pump()
                clock.advance(0.25)
            q.close()
            return {"out": [outcome(f)[:2] for f in futs],
                    "records": [p.reqtrace.ledger_of(f).as_record() for f in futs],
                    "attr": {k: v for k, v in p.reqtrace.attribution_block().items()
                             if k != "stages"}}

        rec = run_both(script)
        recs = rec["records"]
        assert {o[0] for o in rec["out"]} >= {"ok", "shed"}
        assert any(r["retries"] for r in recs) and any(r["sampled"] for r in recs)
        assert not all(r["sampled"] for r in recs)
        for r in recs:
            assert sum(r["stages"].values()) == pytest.approx(r["wall_s"], abs=1e-12)

    def test_live_storm_ledgers_cover_wall_within_5pct(self, km_centers):
        x = kmeans_blobs(seed=31)
        sizes = np.random.default_rng(3).integers(5, 128, size=20)
        answers = []
        for p in BOTH:
            handle = served(p, km_centers)
            p.set_config(serve_trace_sample=1.0)
            with p.serving.TrafficQueue(handle) as q:
                futs = [q.submit(x[:int(s)], deadline_ms=60_000) for s in sizes]
                got = [f.result(timeout=60).tolist() for f in futs]
            for f in futs:
                lg = p.reqtrace.ledger_of(f)
                assert lg is not None and lg.outcome == "answered"
                assert abs(lg.stage_sum() - lg.wall_s) <= max(0.05 * lg.wall_s, 1e-6)
            attr = p.reqtrace.attribution_block()
            assert attr["traced"] >= 20 and 0.95 <= attr["coverage"] <= 1.05
            assert p.serving.serving_summary()["attribution"]["traced"] >= 20
            answers.append(got)
        assert answers[0] == answers[1]

    def test_deadline_shed_finalizes_ledger_as_shed(self):
        def script(p):
            clock = FakeClock(0.0)
            q = p.serving.TrafficQueue(SpyHandle(), start=False, clock=clock)
            p.set_config(serve_trace_sample=1.0)
            f = q.submit(np.zeros((4, 3), np.float32), deadline_ms=1.0)
            clock.advance(10.0)
            q.pump()
            q.close()
            return {"out": outcome(f)[:2], "record": p.reqtrace.ledger_of(f).as_record()}

        rec = run_both(script)
        assert rec["out"] == ("shed", "deadline") and rec["record"]["outcome"] == "shed"
        assert sum(rec["record"]["stages"].values()) == pytest.approx(rec["record"]["wall_s"])

    def test_disarmed_future_has_no_ledger(self):
        for p in BOTH:
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            f = q.submit(np.zeros((4, 3), np.float32))
            q.pump()
            q.close()
            assert p.reqtrace.ledger_of(f) is None
            assert p.reqtrace.attribution_block() == {}

    def test_emit_requests_lines_equal(self, tmp_path):
        def script(p):
            sink = tmp_path / f"{p.root}.jsonl"
            p.set_config(telemetry_log=str(sink), serve_trace_sample=0.5)
            clock = FakeClock(5.0)
            q = p.serving.TrafficQueue(SpyHandle(), start=False, clock=clock)
            futs = [q.submit(np.zeros((1 + i % 3, 2), np.float32)) for i in range(12)]
            clock.advance(0.125)
            q.pump()
            q.close()
            lines = [json.loads(ln) for ln in sink.read_text().splitlines()]
            requests = [ln for ln in lines if ln["type"] == "request"]
            for ln in requests:
                ln.pop("seq")
            sampled = sum(p.reqtrace.ledger_of(f).ctx.sampled for f in futs)
            p.set_config(telemetry_log="")
            return {"requests": requests, "sampled": sampled}

        rec = run_both(script)
        assert 0 < rec["sampled"] < 12 and len(rec["requests"]) == rec["sampled"]
        assert all(r["rank"] == 0 and r["outcome"] == "answered" for r in rec["requests"])

    def test_emit_requests_off_and_empty(self):
        for p in BOTH:
            assert p.reqtrace is not None
        from oap_mllib_tpu.telemetry import export as jexport
        from oap_mllib_tpu_torch.telemetry import export

        assert export.emit_requests([{"trace_id": "x"}]) == jexport.emit_requests(
            [{"trace_id": "x"}]) == 0
        PORT.set_config(telemetry_log="/nonexistent-dir/sink.jsonl")
        assert export.emit_requests([{"trace_id": "x"}]) == 0  # OSError swallowed
        assert export.emit_requests([]) == 0


class TestExemplars:
    _EX = re.compile(
        r'^(?P<name>\w+_bucket)\{(?P<labels>[^}]*)\} (?P<count>\d+)'
        r'(?: # \{(?P<exlabels>[^}]*)\} (?P<exvalue>\S+))?$'
    )

    def _lines(self, p, name):
        return [ln for ln in p.tm.render_prometheus().splitlines() if ln.startswith(name)]

    def test_exemplar_lines_equal(self):
        raw = 'id "quoted" back\\slash\nnewline'
        got = []
        for p in BOTH:
            h = p.tm.histogram("test_torch_ex_seconds", {"stage": "execute"})
            h.observe(0.003, exemplar={"trace_id": "00-0000002a"})
            h.observe(0.003, exemplar={"trace_id": "00-0000002b"})
            h.observe(1e9, exemplar={"trace_id": raw})
            got.append(self._lines(p, "test_torch_ex_seconds_bucket"))
        assert got[0] == got[1]
        ex = [ln for ln in got[1] if "#" in ln]
        assert len(ex) == 2 and all(self._EX.match(ln) for ln in ex)
        assert 'trace_id="00-0000002b"' in ex[0] and "0000002a" not in "".join(got[1])

    def test_request_histogram_pins_sampled_trace_ids(self, km_centers):
        x = kmeans_blobs(seed=37)
        handle = served(PORT, km_centers)
        PORT.set_config(serve_trace_sample=1.0)
        with PORT.serving.TrafficQueue(handle) as q:
            f = q.submit(x[:32], deadline_ms=60_000)
            f.result(timeout=60)
        tid = PORT.reqtrace.ledger_of(f).ctx.trace_id
        text = PORT.tm.render_prometheus()
        stage_ex = [ln for ln in text.splitlines()
                    if ln.startswith("oap_serve_stage_seconds_bucket") and "trace_id=" in ln]
        req_ex = [ln for ln in text.splitlines()
                  if ln.startswith("oap_serve_request_seconds_bucket") and tid in ln]
        assert stage_ex and req_ex


class TestSLOEngine:
    def _engine(self, p, clock, p99_ms=100.0, availability=0.99, window_s=600.0):
        return p.slo.SLOEngine(p99_ms, availability, window_s, clock=clock)

    def _script(self, steps, window_s=600.0):
        """An observation script: (advance, wall_s, ok) steps, then the
        engine's state, burn rates and samples held."""
        def script(p):
            clock = FakeClock()
            eng = self._engine(p, clock, window_s=window_s)
            for adv, wall, ok in steps:
                clock.advance(adv)
                if wall is not None:
                    eng.observe(wall, ok=ok)
            return {"state": eng.state(), "fast": eng.burn_rate(eng.fast_window_s),
                    "budget": eng.budget_remaining(), "held": len(eng._samples)}

        return script

    def test_healthy_baseline_burns_nothing(self):
        rec = run_both(self._script([(0.1, 0.010, True)] * 100))
        assert rec["fast"] == 0.0 and rec["budget"] == 1.0 and rec["state"]["breach"] is False

    def test_breach_moves_both_windows_and_flag(self):
        rec = run_both(self._script([(0.1, 0.010, True)] * 100 + [(0.1, 0.500, True)] * 50))
        st = rec["state"]
        assert st["burn_rate_fast"] > 1.0 and st["burn_rate_slow"] > 1.0 and st["breach"]
        assert st["error_budget_remaining"] < 1.0

    def test_failures_are_bad_regardless_of_wall(self):
        rec = run_both(self._script([(0.0, 0.001, False)]))
        assert rec["state"]["lifetime_bad"] == 1

    def test_breach_needs_both_windows(self):
        rec = run_both(self._script([(0.1, 0.500, True)] * 20 + [(60.0, None, True)]
                                    + [(0.1, 0.010, True)] * 20))
        st = rec["state"]
        assert st["burn_rate_slow"] > 1.0 and st["burn_rate_fast"] < 1.0 and not st["breach"]

    def test_windows_prune_old_samples(self):
        rec = run_both(self._script([(0.1, 0.500, True)] * 5 + [(100.0, None, True)],
                                    window_s=10.0))
        assert rec["state"]["burn_rate_slow"] == 0.0 and rec["budget"] == 1.0
        assert rec["held"] == 0

    def test_gauges_follow_the_engine(self):
        def script(p):
            p.set_config(serve_slo_p99_ms=100.0)
            for _ in range(10):
                p.slo.observe_request(0.5, ok=True, t=1.0)
            reg = p.tm.registry()
            with p.tm._LOCK:
                g = {(n, lab): m.value for (n, lab), m in reg._metrics.items()
                     if n.startswith("oap_slo_")}
            return {"gauges": g}

        g = run_both(script)["gauges"]
        assert g[("oap_slo_burn_rate", (("window", "fast"),))] > 1.0

    def test_knob_validation(self):
        for knobs, match in (({"serve_slo_availability": 1.5}, "serve_slo_availability"),
                             ({"serve_slo_window_s": 0.0}, "serve_slo_window_s"),
                             ({"serve_slo_p99_ms": -1.0}, "serve_slo_p99_ms")):
            msgs = []
            for p in BOTH:
                p.set_config(**{"serve_slo_p99_ms": 10.0, **knobs})
                with pytest.raises(ValueError, match=match) as ei:
                    p.slo.slo_cfg()
                msgs.append(str(ei.value))
                p.set_config(serve_slo_p99_ms=0.0, serve_slo_availability=0.999,
                             serve_slo_window_s=3600.0)
            assert msgs[0] == msgs[1]

    def test_singleton_rebuilds_on_knob_change(self):
        for p in BOTH:
            p.set_config(serve_slo_p99_ms=100.0)
            e1 = p.slo.engine()
            p.set_config(serve_slo_p99_ms=200.0)
            e2 = p.slo.engine()
            assert e1 is not e2 and e2.p99_ms == 200.0 and p.slo.engine() is e2

    def test_disarmed_surface(self):
        for p in BOTH:
            assert p.slo.engine() is None and p.slo.brief() == {}
            assert p.slo.summary_block() == {}
            assert p.slo.state() == p.slo.slo_state() == {"armed": False}
            p.slo.observe_request(99.0, ok=False)


class TestDecisionRecords:
    def _arm_breach(self, p):
        p.set_config(serve_slo_p99_ms=100.0, serve_slo_availability=0.99,
                     serve_slo_window_s=600.0)
        for _ in range(10):
            p.slo.observe_request(0.5, ok=False)

    def test_brownout_steps_record_slo_state(self):
        def script(p):
            self._arm_breach(p)
            bc = p.serving.BrownoutController("auto")
            for _ in range(12):
                bc.observe(200, 100)
            return {"breach": [s["slo"]["breach"] for s in bc.steps]}

        assert run_both(script)["breach"] == [True, True, True]

    def test_scale_decisions_record_slo_state(self):
        def script(p):
            self._arm_breach(p)
            d = p.serving.ScaleController(1, clock=FakeClock()).observe(queue_depth=3)
            return {"slo": {k: d["slo"][k] for k in ("burn_rate_slow", "breach")},
                    "fast": d["slo"]["burn_rate_fast"] > 1.0}

        rec = run_both(script)
        assert rec["fast"] and rec["slo"]["breach"] is True

    def test_disarmed_decisions_stay_clean(self):
        for p in BOTH:
            assert "slo" not in p.serving.ScaleController(1).observe(queue_depth=0)

    def test_traced_requests_feed_the_engine(self):
        def script(p):
            p.set_config(serve_trace_sample=1.0, serve_slo_p99_ms=1000.0)
            clock = FakeClock(3.0)
            q = p.serving.TrafficQueue(SpyHandle(), start=False, clock=clock)
            q.submit(np.zeros((4, 3), np.float32), deadline_ms=60_000)
            q.submit(np.zeros((2, 3), np.float32), deadline_ms=1.0)
            clock.advance(2.0)
            q.pump()
            q.close()
            eng = p.slo.engine()
            return {"total": eng.total, "bad": eng.bad}

        rec = run_both(script)
        # the shed is bad, the answer took 2 s against a 1 s target
        assert rec["total"] == 2 and rec["bad"] == 2


class TestHealthSurfaces:
    def test_serving_health_block_fields(self):
        def script(p):
            p.set_config(serve_slo_p99_ms=100.0)
            return {"block": p.serving.serving_health_block()}

        block = run_both(script)["block"]
        assert block["queue_depth"] == 0 and block["in_flight"] == 0
        assert block["pinned_models"] == 0 and block["brownout_rung"] == "off"
        assert "last_shed" not in block and "burn_rate_fast" in block["slo"]

    def test_last_shed_reason_and_age_surface(self):
        def script(p):
            p.set_config(serve_queue_depth=1)
            q = p.serving.TrafficQueue(SpyHandle(), start=False)
            q.submit(np.zeros((2, 3), np.float32))
            with pytest.raises(p.serving.ShedError):
                q.submit(np.zeros((2, 3), np.float32))
            q.close()
            block = p.serving.serving_health_block()
            age = block["last_shed"].pop("age_s")
            return {"block": block, "age": age >= 0.0}

        rec = run_both(script)
        assert rec["block"]["last_shed"] == {"reason": "queue_full"} and rec["age"]

    def test_healthz_payload_carries_serving_block(self, km_centers):
        from oap_mllib_tpu.telemetry import fleet as jfleet
        from oap_mllib_tpu_torch.telemetry import fleet

        for p in BOTH:
            served(p, km_centers)
            p.set_config(serve_brownout="pin:bf16")
            p.traffic.brownout()
        port, jax = fleet._healthz_payload(), jfleet._healthz_payload()
        assert set(port) == set(jax)
        for block in (port["serving"], jax["serving"]):
            for m in block["models"]:
                m.pop("staleness_seconds")
        assert port["serving"] == jax["serving"]
        assert port["serving"]["brownout_rung"] == "bf16"

    def test_sloz_payload_tracks_engine_state(self):
        from oap_mllib_tpu.telemetry import fleet as jfleet
        from oap_mllib_tpu_torch.telemetry import fleet

        assert fleet._sloz_payload() == jfleet._sloz_payload() == {"armed": False}
        for p in BOTH:
            p.set_config(serve_slo_p99_ms=100.0)
            p.slo.observe_request(0.5, ok=False, t=1.0)
        port, jax = fleet._sloz_payload(), jfleet._sloz_payload()
        assert set(port) == set(jax) and port["armed"] and port["lifetime_requests"] >= 1

    def test_sloz_endpoint_served_next_to_metrics(self):
        from oap_mllib_tpu.telemetry import fleet as jfleet
        from oap_mllib_tpu_torch.parallel.bootstrap import free_port
        from oap_mllib_tpu_torch.telemetry import fleet

        port = free_port("127.0.0.1", 9500)
        PORT.set_config(serve_slo_p99_ms=100.0, metrics_port=port)
        JAX.set_config(serve_slo_p99_ms=100.0)
        assert fleet.maybe_serve() == port
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/sloz", timeout=10) as resp:
                payload = json.loads(resp.read())
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
                health = json.loads(resp.read())
        finally:
            fleet.stop_server()
        assert payload["armed"] is True and set(payload) == set(jfleet._sloz_payload())
        assert set(health["serving"]) == set(jfleet._healthz_payload()["serving"])
