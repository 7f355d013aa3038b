"""The port's trace merger (``oap_mllib_tpu_torch/tools/oaptrace.py``)
against the repository's ``dev/oaptrace.py``, on the CPU.

The fixtures are the reference tests' (``tests/test_oaptrace.py``):
recorder-mode sinks of two ranks with skewed clocks, a span-only sink,
request ledgers with and without the recorder, and ring-hop flows, plus
the sink of a real port fit with the flight recorder armed.  Both
mergers read the same files; their traces and their validation lists
must be equal.  ``dev/oaptrace.py`` is imported here only, as the
reference tests import it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "dev"))

import oaptrace as ref_oaptrace  # noqa: E402

from oap_mllib_tpu_torch import KMeans, config as port_config  # noqa: E402
from oap_mllib_tpu_torch.data.stream import ChunkSource  # noqa: E402
from oap_mllib_tpu_torch.telemetry import flightrec  # noqa: E402
from oap_mllib_tpu_torch.tools import oaptrace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _event(seq, t, kind, name, detail="", tid=1):
    return {"seq": seq, "t": t, "tid": tid, "kind": kind, "name": name, "detail": detail}


def _flightrec(rank, events):
    return {"type": "flightrec", "rank": rank, "seq": 0, "events": events, "fit": "kmeans.fit"}


def _write(path, records):
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def _request(rank, seq, t0, outcome="answered", events=()):
    return {
        "type": "request", "rank": rank, "seq": seq, "trace_id": f"{rank:02x}-{seq:08x}",
        "deadline_ms": 50.0, "sampled": True, "t0": t0, "wall_s": 0.45, "outcome": outcome,
        "model": "kmeans", "retries": 0,
        "stages": {"admission": 0.05, "queue_wait": 0.1, "batch_form": 0.05,
                   "bucket_pad": 0.0, "compile": 0.0, "execute": 0.2, "dispatch": 0.05},
        "events": list(events),
    }


def _recorder(tmp_path, skew=0.0):
    base = str(tmp_path / "fits.jsonl")
    for rank, off, lag in ((0, 0.0, 0.0), (1, 100.0, skew)):
        t = off + 10.0
        events = [
            _event(0, t, "span_open", "lloyd_loop"),
            _event(1, t + 0.1, "chunk", "prefetch", "#0"),
            _event(2, t + 0.4 + lag, "collective", "process_allgather", "(2,2)"),
            _event(3, t + 0.5 + lag, "span_close", "lloyd_loop", "0.5s"),
            _event(4, t + 0.6 + lag, "collective", "process_allgather", "(2,2)"),
        ]
        _write(f"{base}.rank{rank}", [_flightrec(rank, events),
                                      {"type": "metrics", "rank": rank, "seq": 99,
                                       "metrics": {}}])
    return [base]


def _synthesized(tmp_path):
    path = str(tmp_path / "solo.jsonl")
    _write(path, [
        {"type": "span", "fit": "pca.fit", "path": "pca.fit", "name": "pca.fit",
         "duration_s": 1.0, "count": 1, "rank": 0, "seq": 0},
        {"type": "span", "fit": "pca.fit", "path": "pca.fit/covariance", "name": "covariance",
         "duration_s": 0.6, "count": 1, "rank": 0, "seq": 1},
        {"type": "span", "fit": "pca.fit", "path": "pca.fit/eigh", "name": "eigh",
         "duration_s": 0.4, "count": 1, "rank": 0, "seq": 2},
        {"type": "metrics", "rank": 0, "seq": 3, "metrics": {}},
    ])
    return [path]


def _requests_aligned(tmp_path):
    base = str(tmp_path / "serve.jsonl")
    for rank, off in ((0, 0.0), (1, 100.0)):
        t = off + 10.0
        _write(f"{base}.rank{rank}", [
            _flightrec(rank, [_event(0, t, "collective", "process_allgather", "(2,3)")]),
            _request(rank, rank, t + 0.2, events=[{"kind": "retry", "t": t + 0.3,
                                                   "detail": "n=1"}]),
        ])
    return [base]


def _requests_no_recorder(tmp_path):
    base = str(tmp_path / "noflight.jsonl")
    for r in range(2):
        _write(f"{base}.rank{r}", [
            _request(r, 0, 50.0 + r * 7.0),
            _request(r, 1, 50.4 + r * 7.0, outcome="shed",
                     events=[{"kind": "shed", "t": 50.6, "detail": "deadline"}]),
        ])
    return [base]


def _ring_hops(tmp_path):
    world = 3
    base = str(tmp_path / "ring.jsonl")
    for r in range(world):
        events = []
        for occ in range(2):
            events += [_event(len(events), 10.0 + 5.0 * occ + 0.1 * t, "ring_hop", f"hop{t}",
                              f"rank={r} hop={t} block={(r + t) % world} world={world}")
                       for t in range(world)]
        _write(f"{base}.rank{r}", [_flightrec(r, events)])
    return [base]


FIXTURES = {"recorder": _recorder, "recorder_skewed": lambda p: _recorder(p, skew=1.0),
            "synthesized": _synthesized, "requests_aligned": _requests_aligned,
            "requests_no_recorder": _requests_no_recorder, "ring_hops": _ring_hops}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_merges_as_the_reference_does(tmp_path, fixture):
    args = FIXTURES[fixture](tmp_path)
    paths = oaptrace.expand_paths(args)
    assert paths == ref_oaptrace.expand_paths(args)
    trace = oaptrace.merge_trace(paths)
    assert trace == ref_oaptrace.merge_trace(paths)
    assert oaptrace.validate_trace(trace) == ref_oaptrace.validate_trace(trace) == []


def test_validation_lists_equal_on_a_broken_trace():
    broken = {"traceEvents": [{"name": "a", "ph": "Q", "pid": 0, "tid": 0, "ts": 1},
                              {"name": "b", "ph": "X", "pid": 0, "tid": 0, "ts": "x"},
                              {"ph": "i", "pid": 0, "tid": 0, "ts": 1}]}
    got = oaptrace.validate_trace(broken)
    assert got == ref_oaptrace.validate_trace(broken) and len(got) == 4
    assert oaptrace.validate_trace({}) == ref_oaptrace.validate_trace({})


def test_missing_files_raise():
    with pytest.raises(FileNotFoundError):
        oaptrace.expand_paths(["/nonexistent/sink.jsonl"])


@pytest.fixture
def port_fit_sink(tmp_path):
    """A real port fit's sink: a streamed K-Means on the CPU with the
    flight recorder armed, then one request ledger line."""
    from oap_mllib_tpu_torch.telemetry import export

    sink = str(tmp_path / "real.jsonl")
    port_config.reset_config()
    flightrec._reset_for_tests()
    port_config.set_config(device="cpu", flight_recorder=256, telemetry_log=sink)
    try:
        x = np.random.default_rng(0).normal(size=(600, 4)).astype(np.float32)
        KMeans(k=2, seed=0, init_mode="random", max_iter=2).fit(
            ChunkSource.from_array(x, chunk_rows=200))
        assert export.emit_requests([{k: v for k, v in _request(0, 0, 0.0).items()
                                      if k not in ("type", "rank", "seq")}]) == 1
    finally:
        port_config.reset_config()
        flightrec._reset_for_tests()
    return sink


def test_a_port_fit_sink_merges_as_the_reference_does(port_fit_sink):
    paths = oaptrace.expand_paths([port_fit_sink])
    trace = oaptrace.merge_trace(paths)
    assert trace == ref_oaptrace.merge_trace(paths)
    assert trace["otherData"]["mode"] == "recorder"
    assert trace["otherData"]["requests"] == 1
    assert oaptrace.validate_trace(trace) == []
    assert any(e.get("ph") == "X" and e.get("cat") == "span" for e in trace["traceEvents"])


def test_the_cli_writes_a_validated_file(tmp_path):
    base = _recorder(tmp_path)[0]
    out = str(tmp_path / "trace.json")
    p = subprocess.run([sys.executable, "-m", "oap_mllib_tpu_torch.tools.oaptrace", base,
                        "-o", out], capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert p.returncode == 0, p.stderr
    assert "2 rank track(s), recorder mode" in p.stdout
    trace = json.load(open(out))
    assert oaptrace.validate_trace(trace) == []
    assert trace == ref_oaptrace.merge_trace(ref_oaptrace.expand_paths([base]))
    # in process too, on a span-only sink
    assert oaptrace.main([_synthesized(tmp_path)[0], "-o", out + ".2"]) == 0
    assert oaptrace.validate_trace(json.load(open(out + ".2"))) == []


def test_a_world_joined_by_arguments_writes_rank_sinks(tmp_path, monkeypatch):
    """A process that joined its world through ``initialize_distributed``'s
    arguments (the config still says one process) writes the merger's
    per-rank sink, ``<path>.rank<r>``, and tags its records with its rank,
    as the reference's writer does for a configured world."""
    from oap_mllib_tpu_torch.parallel import bootstrap
    from oap_mllib_tpu_torch.telemetry import export

    sink = str(tmp_path / "world.jsonl")
    monkeypatch.setattr(bootstrap, "is_initialized", lambda: True)
    monkeypatch.setattr(bootstrap, "world_size", lambda: 2)
    monkeypatch.setattr(bootstrap, "process_index", lambda: 1)
    port_config.reset_config()
    port_config.set_config(telemetry_log=sink)
    try:
        assert export.sink_path() == sink + ".rank1"
        assert export.emit_requests([{k: v for k, v in _request(1, 0, 5.0).items()
                                      if k not in ("type", "rank", "seq")}]) == 1
    finally:
        port_config.reset_config()
    assert not os.path.exists(sink)
    paths = oaptrace.expand_paths([sink])
    trace = oaptrace.merge_trace(paths)
    assert paths == [sink + ".rank1"] and trace["otherData"]["ranks"] == [1]
    assert trace == ref_oaptrace.merge_trace(paths)
