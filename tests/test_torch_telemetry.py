"""The port's observability plane against the JAX package's, on the CPU:
the metrics registry (byte-equal Prometheus text), the span tree and the
``Timings`` views, the flight recorder, the kernel-launch booking, the
exporters (JSON-lines sink, report, the ordered exit), the fit boundary
of the three estimators, the live ``/metrics`` and ``/healthz``
endpoint, the profiler trace and the debug printers.
"""

import json
import os
import re
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch

from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.models.als import ALS as JaxALS
from oap_mllib_tpu.models.kmeans import KMeans as JaxKMeans
from oap_mllib_tpu.models.pca import PCA as JaxPCA
from oap_mllib_tpu.ops.pallas import _tiers as jax_tiers
from oap_mllib_tpu.telemetry import export as jax_export
from oap_mllib_tpu.telemetry import fleet as jax_fleet
from oap_mllib_tpu.telemetry import flightrec as jax_flightrec
from oap_mllib_tpu.telemetry import metrics as jax_tm
from oap_mllib_tpu.telemetry import spans as jax_spans
from oap_mllib_tpu.utils import debug as jax_debug
from oap_mllib_tpu.utils import timing as jax_timing
from oap_mllib_tpu_torch import ALS, PCA, KMeans, config as port_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.data.table import DenseTable
from oap_mllib_tpu_torch.ops.cuda import _tiers
from oap_mllib_tpu_torch.telemetry import export, fleet, flightrec
from oap_mllib_tpu_torch.telemetry import metrics as tm
from oap_mllib_tpu_torch.telemetry import spans
from oap_mllib_tpu_torch.utils import debug, profiling, progcache, timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    for mod in (tm, jax_tm):
        mod.reset()
    for rec in (flightrec, jax_flightrec):
        rec._reset_for_tests()
    fleet._reset_for_tests()
    progcache.clear()
    yield
    fleet._reset_for_tests()
    port_config.reset_config()
    for rec in (flightrec, jax_flightrec):
        rec._reset_for_tests()


def _blobs(n=600, d=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=5.0, size=(4, d))
    return (centers[rng.integers(4, size=n)] + rng.normal(size=(n, d))).astype(np.float32)


def _ratings(seed=1, nnz=900, n_users=60, n_items=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(n_users, size=nnz), rng.integers(n_items, size=nnz),
            (rng.random(nnz) * 4 + 1).astype(np.float32))


# -- the metrics registry ------------------------------------------------------------


def _drive_registry(mod):
    """One sequence of registry operations, run on either package's module."""
    reg = mod.Registry()
    reg.counter("c_total", {"algo": "kmeans"}, help="a counter").inc(2)
    reg.counter("c_total", {"algo": "pca"}).inc(0.5)
    reg.counter("helpless_total").inc()
    reg.counter("lazy_total").inc()
    reg.counter("lazy_total", help="the real help").inc(3)
    reg.gauge("g", help="a gauge").set(2.5)
    reg.gauge("g", {"stat": "max"}, help="a gauge").set(-1e-7)
    h = reg.histogram("lat_seconds", bounds=(0.1, 1.0, 10.0), help="hist")
    for v in (0.05, 0.1, 0.5, 2.0, 50.0):
        h.observe(v)
    h.observe(0.7, exemplar={"trace_id": 'a"b'})
    d = reg.histogram("dur_seconds", {"kernel": "kmeans.accumulate"}, help="d")
    for v in (1e-6, 3e-4, 0.02, 1.5, 100.0):
        d.observe(v)
    reg.counter("esc_total", {"path": 'a"b\\c', "msg": "two\nlines"}, help="x\\y\nz").inc()
    return reg, h


class TestMetricsParity:
    def test_prometheus_text_is_byte_equal(self):
        ours, _ = _drive_registry(tm)
        ref, _ = _drive_registry(jax_tm)
        assert ours.render_prometheus() == ref.render_prometheus()

    def test_snapshot_is_equal(self):
        ours, _ = _drive_registry(tm)
        ref, _ = _drive_registry(jax_tm)
        assert ours.snapshot() == ref.snapshot()

    @pytest.mark.parametrize("name", ["c_total", "g", "lat_seconds", "dur_seconds", "none"])
    def test_family_total(self, name):
        assert _drive_registry(tm)[0].family_total(name) == pytest.approx(
            _drive_registry(jax_tm)[0].family_total(name))

    @pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.99, 1.0])
    def test_histogram_quantile(self, q):
        assert tm.histogram_quantile(_drive_registry(tm)[1], q) == \
            jax_tm.histogram_quantile(_drive_registry(jax_tm)[1], q)

    def test_quantile_edges_and_type_conflict(self):
        assert tm.histogram_quantile(tm.Histogram(), 0.5) == 0.0
        with pytest.raises(ValueError):
            tm.histogram_quantile(tm.Histogram(), 1.5)
        tm.counter("conflicted")
        with pytest.raises(ValueError, match="already registered"):
            tm.gauge("conflicted")

    def test_buckets_are_the_jax_bounds(self):
        assert tm.DURATION_BUCKETS == jax_tm.DURATION_BUCKETS
        assert tm.BYTES_BUCKETS == jax_tm.BYTES_BUCKETS
        assert tm.COUNT_BUCKETS == jax_tm.COUNT_BUCKETS

    def test_reset_drops_families(self):
        tm.counter("x_total").inc()
        tm.reset()
        assert tm.snapshot() == {} and tm.render_prometheus() == "\n"


# -- spans and the Timings views -------------------------------------------------------

RECORDINGS = [
    [("table_convert", 0.5), ("init_centers", 1.25), ("lloyd_loop", 2.0)],
    [("lloyd_loop/stage", 0.1), ("lloyd_loop/transfer", 0.05), ("lloyd_loop/compute", 0.4),
     ("lloyd_loop/stream_wall", 0.5), ("lloyd_loop", 0.6), ("lloyd_loop/stage", 0.2),
     ("lloyd_loop/stream_wall", 0.25)],
    [("covariance/compile", 0.3), ("covariance/execute", 0.01), ("covariance/execute", 0.02),
     ("covariance", 0.4), ("eigh", 0.1)],
    [("pass/stage", 0.0), ("pass/stream_wall", 0.2)],
    [("a/b/c", 1.0), ("a", 2.0), ("a/b/c", 0.5), ("d", 0.25)],
]


def _span_tree(mod):
    root = mod.Span("fit")
    root.node("a/b").record(1.0)
    root.node("a").record(2.0)
    root.node("a/b").record(0.5)
    root.node("phase/compile").record(0.25)
    sp = root.node("a")
    sp.note_collective("all_gather", 1024, 0.01)
    sp.note_collective("all_gather", 1024, 0.02)
    sp.note_collective("barrier", 0, 0.001)
    sp.attrs["kernels"] = {"kmeans.accumulate": 3}
    return root


class TestSpansParity:
    def test_as_dict_flat_and_walk(self):
        ours, ref = _span_tree(spans), _span_tree(jax_spans)
        assert ours.as_dict() == ref.as_dict()
        assert ours.flat() == ref.flat()
        assert [p for p, _ in ours.walk()] == [p for p, _ in ref.walk()]

    @pytest.mark.parametrize("case", range(len(RECORDINGS)))
    def test_timings_views(self, case):
        ours, ref = timing.Timings("kmeans.fit"), jax_timing.Timings("kmeans.fit")
        for phase, seconds in RECORDINGS[case]:
            ours.add(phase, seconds)
            ref.add(phase, seconds)
        assert ours.as_dict() == ref.as_dict()
        assert ours.root.as_dict() == ref.root.as_dict()
        for prefix in ("lloyd_loop", "covariance", "pass", "a", "missing"):
            assert ours.subphases(prefix) == ref.subphases(prefix)
            assert ours.overlap_efficiency(prefix) == ref.overlap_efficiency(prefix)
            assert ours.compile_split(prefix) == ref.compile_split(prefix)
        assert ours.total() == ref.total()

    def test_enter_stack_records_on_exception(self):
        sp = spans.Span("outer")
        assert spans.current_span() is None
        with spans.enter(sp):
            assert spans.current_span() is sp
            with spans.enter(sp.child("inner")) as inner:
                assert spans.current_span() is inner
            assert spans.current_span() is sp
        assert spans.current_span() is None and sp.count == 1
        with pytest.raises(RuntimeError):
            with spans.enter(sp):
                raise RuntimeError("boom")
        assert sp.count == 2 and spans.current_span() is None

    def test_the_stack_is_per_thread(self):
        seen = []
        with spans.enter(spans.Span("consumer")):
            t = threading.Thread(target=lambda: seen.append(spans.current_span()))
            t.start()
            t.join()
        assert seen == [None]

    def test_phase_timer_is_the_active_span(self):
        t = timing.Timings("pca.fit")
        with timing.phase_timer(t, "covariance", device="cpu"):
            assert spans.current_span() is t.root.child("covariance")
        assert set(t.as_dict()) == {"covariance"} and t.root.name == "pca.fit"


# -- the flight recorder -----------------------------------------------------------------


def _drive_recorder(mod, cfg_set, slots=8):
    cfg_set(flight_recorder=slots)
    for i in range(11):
        mod.record("span_open" if i % 2 else "collective", f"name{i}", f"detail{i}")
    drained = mod.drain_new()
    mod.record("crash", "site", "fault")
    return mod.tail(), mod.tail(3), drained, mod.drain_new(), mod.last_seq()


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("t", "tid")} for e in events]


class TestFlightRecorderParity:
    def test_tails_drains_and_seq(self):
        ours = _drive_recorder(flightrec, port_config.set_config)
        ref = _drive_recorder(jax_flightrec, jax_set_config)
        for a, b in zip(ours[:4], ref[:4]):
            assert _strip(a) == _strip(b)
        assert ours[4] == ref[4] == 11
        assert len(ours[0]) == 8 and ours[0][-1]["kind"] == "crash"

    def test_off_records_nothing_and_negative_raises(self):
        assert flightrec.record("x", "y") is None and flightrec.tail() == []
        assert flightrec.last_seq() == -1
        port_config.set_config(flight_recorder=-1)
        with pytest.raises(ValueError, match="flight_recorder"):
            flightrec.record("x", "y")

    def test_seq_is_monotonic_under_threads(self):
        port_config.set_config(flight_recorder=4096)
        threads = [threading.Thread(target=lambda: [flightrec.record("k", "n") for _ in range(200)])
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        seqs = [e["seq"] for e in flightrec.tail()]
        assert seqs == list(range(800))

    def test_spans_record_open_and_close(self):
        port_config.set_config(flight_recorder=16)
        with spans.enter(spans.Span("lloyd_loop")):
            pass
        assert [(e["kind"], e["name"]) for e in flightrec.tail()] == [
            ("span_open", "lloyd_loop"), ("span_close", "lloyd_loop")]


# -- kernel launches ------------------------------------------------------------------------


class TestKernelLaunchBooking:
    def test_labels_are_the_jax_names(self):
        assert set(_tiers.LABELS.values()) == {
            "kmeans.accumulate", "pca.moments", "als.solve", "als.factor_gram", "ring.allreduce"}

    def test_booking_matches_the_jax_kernel_launch(self):
        sp, jsp = spans.Span("lloyd_loop"), jax_spans.Span("lloyd_loop")
        with spans.enter(sp):
            with _tiers.kernel_launch("kmeans.accumulate"):
                pass
            _tiers.book_launch("ring.allreduce", 1e-4, n=2)
        with jax_spans.enter(jsp):
            with jax_tiers.kernel_launch("kmeans.accumulate"):
                pass
            for _ in range(2):
                with jax_tiers.kernel_launch("ring.allreduce"):
                    pass
        assert sp.attrs["kernels"] == jsp.attrs["kernels"] == {
            "kmeans.accumulate": 1, "ring.allreduce": 2}
        snap, ref = tm.snapshot(), jax_tm.snapshot()
        assert snap["oap_kernel_launches_total"] == ref["oap_kernel_launches_total"]
        assert set(snap["oap_kernel_dispatch_seconds"]) == set(ref["oap_kernel_dispatch_seconds"])
        assert fleet.local_frame(_Stats(), 0.5)[fleet.FRAME_FIELDS.index("kernel_dispatch_s")] \
            == pytest.approx(tm.family_total("oap_kernel_dispatch_seconds"))

    def test_a_failed_launch_books_nothing(self):
        with pytest.raises(RuntimeError):
            with _tiers.kernel_launch("als.solve"):
                raise RuntimeError("CUDA launch failed")
        assert "oap_kernel_launches_total" not in tm.snapshot()


class _Stats:
    stage_s = transfer_s = wait_s = 0.0
    bytes_staged = rows = 0


# -- exporters and the fit boundary ------------------------------------------------------------


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


class TestExporters:
    def test_jsonl_sink_reproduces_the_summary_tree(self, tmp_path):
        sink = str(tmp_path / "fits.jsonl")
        port_config.set_config(telemetry_log=sink, flight_recorder=256)
        m = KMeans(k=3, max_iter=4, seed=0, device="cpu").fit(_blobs())
        PCA(k=2, device="cpu").fit(_blobs())
        recs = _lines(sink)
        assert [r["seq"] for r in recs] == sorted(r["seq"] for r in recs)
        metrics = [r for r in recs if r["type"] == "metrics"]
        assert [r["fit"] for r in metrics] == ["kmeans.fit", "pca.fit"]
        km = {r["path"]: r for r in recs if r["type"] == "span" and r["fit"] == "kmeans.fit"}
        tree = dict(m.summary.timings.root.walk())
        assert set(km) == set(tree)
        for path, sp in tree.items():
            assert km[path]["duration_s"] == sp.duration_s and km[path]["count"] == sp.count
        ev = [r for r in recs if r["type"] == "flightrec"]
        assert ev and {"span_open", "span_close"} <= {e["kind"] for e in ev[0]["events"]}
        assert all(r["rank"] == 0 for r in recs)

    def test_sink_off_opens_nothing_and_a_world_suffixes_the_rank(self, tmp_path, monkeypatch):
        opened = []
        real_open = open
        monkeypatch.setattr("builtins.open",
                            lambda *a, **k: opened.append(a[0]) or real_open(*a, **k))
        KMeans(k=2, max_iter=2, device="cpu").fit(_blobs(200))
        assert not [p for p in opened if str(p).endswith(".jsonl")]
        assert export.sink_path() is None
        port_config.set_config(telemetry_log=str(tmp_path / "t.jsonl"), num_processes=2,
                               process_id=1)
        jax_set_config(telemetry_log=str(tmp_path / "t.jsonl"), num_processes=2, process_id=1)
        assert export.sink_path() == jax_export.sink_path() == str(tmp_path / "t.jsonl.rank1")

    def test_shutdown_drains_then_snapshots_then_stops(self, tmp_path):
        sink = str(tmp_path / "exit.jsonl")
        port_config.set_config(telemetry_log=sink, flight_recorder=64, metrics_port=_free_port())
        assert fleet.maybe_serve() is not None
        flightrec.record("chunk", "prefetch", "#0")
        export.shutdown()
        recs = _lines(sink)
        assert [r["type"] for r in recs] == ["flightrec", "metrics"]
        assert all(r["final"] for r in recs) and fleet.server_port() is None

    def test_report_renders_fit_and_process(self):
        m = KMeans(k=3, max_iter=3, device="cpu").fit(_blobs())
        text = export.report(m.summary)
        assert text.startswith("== telemetry: kmeans.fit ==") and "lloyd_loop" in text
        assert "progcache:" in text
        proc = export.report()
        assert "fits completed       1" in proc and "kernel launches" in proc

    def test_every_family_has_help_and_type_after_fits(self):
        KMeans(k=2, max_iter=2, device="cpu").fit(_blobs(300))
        text = tm.render_prometheus()
        names = {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}
        helps = {ln.split()[2] for ln in text.splitlines() if ln.startswith("# HELP")}
        assert names == helps and "oap_fit_total" in names


def _jax_family_names():
    names = set()
    for dirpath, _, files in os.walk(os.path.join(ROOT, "oap_mllib_tpu")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                names |= set(re.findall(r'"(oap_[a-z0-9_]+)"', text))
                # a family named through an f-string of its event, with the
                # events its module counts (ops/pallas/autotune._count:
                # oap_tuning_{hits,misses,sweeps}_total)
                for head, tail in re.findall(r'f"(oap_[a-z0-9_]*)\{event\}([a-z0-9_]*)"', text):
                    names |= {head + e + tail for e in re.findall(r'_count\(\s*"(\w+)"', text)}
    return names


def _label_keys(snap):
    return {name: {tuple(sorted(k.split("=")[0] for k in lab.split(",") if k))
                   for lab in series} for name, series in snap.items()}


class TestFitBoundaryParity:
    """A small in-memory fit of each estimator in both packages.  The
    summaries carry the same ``telemetry`` keys and root; the top-level
    phases are the same, except that the port's one-device ALS has a
    ``grouped_build`` phase of its own (the host counting sort, which the
    JAX package runs inside ``table_convert``)."""

    PORT_ONLY_PHASES = {"als.fit": {"grouped_build"}}

    def _fits(self):
        x = _blobs()
        u, i, r = _ratings()
        jax_set_config(als_kernel="grouped")
        port_config.set_config(als_kernel="grouped")
        kw = dict(k=3, max_iter=4, seed=0, init_mode="random")
        port = [KMeans(device="cpu", **kw).fit(x).summary,
                PCA(k=2, device="cpu").fit(x).summary,
                ALS(rank=3, max_iter=2, implicit_prefs=True, device="cpu").fit(u, i, r, 60,
                                                                              40).summary]
        ref = [JaxKMeans(**kw).fit(x).summary, JaxPCA(k=2).fit(x).summary,
               JaxALS(rank=3, max_iter=2, implicit_prefs=True, num_user_blocks=1).fit(
                   u, i, r, 60, 40).summary]
        return port, ref

    @staticmethod
    def _get(s, key):
        return s[key] if isinstance(s, dict) else getattr(s, key)

    def test_telemetry_keys_roots_and_phases(self):
        port, ref = self._fits()
        for ours, theirs in zip(port, ref):
            a, b = self._get(ours, "telemetry"), self._get(theirs, "telemetry")
            assert set(a) == set(b) == {"fit", "rank", "spans", "metrics"}
            assert a["fit"] == b["fit"] == a["spans"]["name"]
            phases = {c["name"] for c in a["spans"]["children"]}
            want = {c["name"] for c in b["spans"]["children"]}
            assert phases - want == self.PORT_ONLY_PHASES.get(a["fit"], set())
            assert want <= phases
            assert set(self._get(ours, "progcache")) == set(self._get(theirs, "progcache"))

    def test_fit_families_are_jax_families_with_jax_labels(self):
        port, _ = self._fits()
        snap = tm.snapshot()
        assert {"oap_fit_total", "oap_fit_seconds", "oap_progcache_misses_total"} <= set(snap)
        assert set(snap) <= _jax_family_names()
        ours, theirs = _label_keys(snap), _label_keys(jax_tm.snapshot())
        for name in set(ours) & set(theirs):
            assert ours[name] == theirs[name], name

    def test_streamed_and_checkpointed_families_are_jax_families(self, tmp_path):
        port_config.set_config(checkpoint_dir=str(tmp_path), fleet_stats="on",
                               memory_budget_hbm="200K")
        KMeans(k=3, max_iter=3, seed=0, device="cpu").fit(ChunkSource.from_array(_blobs(), 128))
        snap = tm.snapshot()
        assert {"oap_prefetch_chunks_total", "oap_stream_rows_total",
                "oap_checkpoint_writes_total", "oap_fleet_passes_total"} <= set(snap)
        assert set(snap) <= _jax_family_names()

    def test_one_finalize_per_fit(self):
        KMeans(k=2, max_iter=2, device="cpu").fit(_blobs(300))
        KMeans(k=2, max_iter=2, device="cpu").fit(ChunkSource.from_array(_blobs(300), 64))
        ALS(rank=2, max_iter=1, device="cpu").fit(*_ratings(), 60, 40)
        assert tm.snapshot()["oap_fit_total"] == {"fit=kmeans.fit": 2, "fit=als.fit": 1}


# -- the live endpoint ----------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


class TestLiveEndpoint:
    def test_metrics_and_healthz_answer(self):
        port_config.set_config(metrics_port=_free_port(), flight_recorder=32)
        m = KMeans(k=3, max_iter=3, device="cpu").fit(_blobs())
        port = fleet.server_port()
        assert port == port_config.get_config().metrics_port
        status, ctype, body = _get(port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert 'oap_fit_total{fit="kmeans.fit"} 1' in body
        assert "# TYPE oap_progcache_misses_total counter" in body
        status, ctype, body = _get(port, "/healthz")
        health = json.loads(body)
        assert ctype == "application/json" and health["ok"] and health["rank"] == 0
        assert set(health) == set(jax_fleet._healthz_payload())
        assert health["flight_recorder_seq"] >= 0
        assert set(health["serving"]) == set(jax_fleet._healthz_payload()["serving"])
        status, ctype, body = _get(port, "/sloz")
        assert status == 200 and json.loads(body) == jax_fleet._sloz_payload() == {"armed": False}
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/nothing")
        assert m.summary.telemetry["fit"] == "kmeans.fit"

    def test_a_port_in_use_raises(self):
        with socket.socket() as s:
            s.bind(("", 0))
            s.listen()
            port_config.set_config(metrics_port=s.getsockname()[1])
            with pytest.raises(OSError, match="cannot bind"):
                fleet.maybe_serve()

    def test_negative_port_raises_and_off_starts_nothing(self):
        assert fleet.maybe_serve() is None and fleet.server_port() is None
        port_config.set_config(metrics_port=-1)
        jax_set_config(metrics_port=-1)
        for mod in (fleet, jax_fleet):
            with pytest.raises(ValueError, match="metrics_port"):
                mod.metrics_port_cfg()

    def test_fold_books_the_fleet_families_like_jax(self):
        frames = np.abs(np.random.default_rng(3).normal(size=(3, len(fleet.FRAME_FIELDS))))
        fleet.fold_pass("lloyd_loop", frames)
        jax_fleet.fold_pass("lloyd_loop", frames)
        jax_fleet._reset_for_tests()
        assert tm.snapshot() == jax_tm.snapshot()


# -- the profiler -----------------------------------------------------------------------------


class TestProfiler:
    def test_profile_dir_writes_a_trace_naming_the_spans(self, tmp_path):
        port_config.set_config(profile_dir=str(tmp_path))
        before = len(profiling.WRITTEN)
        assert not profiling.trace_active()
        KMeans(k=3, max_iter=3, device="cpu").fit(_blobs())
        assert not profiling.trace_active()
        written = profiling.WRITTEN[before:]
        assert len(written) == 1 and os.path.dirname(written[0]) == str(tmp_path)
        with open(written[0]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"table_convert", "init_centers", "lloyd_loop"} <= names

    def test_off_traces_nothing(self):
        before = len(profiling.WRITTEN)
        with profiling.maybe_trace():
            assert not profiling.trace_active()
        assert len(profiling.WRITTEN) == before


# -- debug printers ---------------------------------------------------------------------------


class TestDebugPrinters:
    def test_tensor_table_matches_jax(self):
        x = np.random.default_rng(0).normal(size=(9, 30))
        for kw in (dict(max_rows=3), dict(max_rows=2, max_cols=4), dict(precision=2)):
            assert debug.format_table(torch.from_numpy(x), "t", **kw) == \
                jax_debug.format_table(x, "t", **kw)
        assert debug.format_table(torch.arange(4.0), "v") == jax_debug.format_table(
            np.arange(4.0), "v")

    def test_dense_table_and_rank_tiles(self):
        x = np.random.default_rng(1).normal(size=(37, 4)).astype(np.float32)
        table = DenseTable.from_numpy(x, "cpu")
        assert debug.format_table(table, "dense", max_rows=3) == jax_debug.format_table(
            x, "dense", max_rows=3)
        tiles = {(0, 0): torch.from_numpy(x[:20, :2]), (0, 1): torch.from_numpy(x[:20, 2:]),
                 (1, 0): torch.from_numpy(x[20:, :2]), (1, 1): torch.from_numpy(x[20:, 2:])}
        assert debug.format_table(tiles, "tiles", max_rows=3) == jax_debug.format_table(
            x, "tiles", max_rows=3)

    def test_csr_matches_jax(self, capsys):
        import scipy.sparse

        from oap_mllib_tpu.data.table import CSRTable

        rows, cols = np.array([0, 0, 2]), np.array([1, 3, 0])
        vals = np.array([1.5, 2.5, 3.23456789], np.float32)
        ref = CSRTable.from_coo(rows, cols, vals, n_rows=3, n_cols=4)
        want = jax_debug.format_csr(ref, "ratings", precision=6)
        assert debug.format_csr(ref, "ratings", precision=6) == want
        sp = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(3, 4))
        assert debug.format_csr(sp, "ratings", precision=6) == want
        debug.print_csr(sp, max_rows=1)
        assert "(2 more rows)" in capsys.readouterr().out
