"""The port's live-world recovery plane (utils/recovery.py) against the
JAX package's, on the CPU: the collective watcher, the mapping of gloo's
own errors, crash records and the poison sideband, the supervised
ladder, and one gloo world of two processes in which one process dies
(or hangs) and the survivor exits as a victim with its crash record.

The classes mirror the JAX package's ``tests/test_recovery.py``.  Where
the JAX module bumps an ``oap_recovery_*`` counter, the port counts in
``recovery.stats()``.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from oap_mllib_tpu.utils import recovery as jax_recovery
from oap_mllib_tpu.utils import resilience as jax_res
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.config import set_config
from oap_mllib_tpu_torch.parallel import collective
from oap_mllib_tpu_torch.utils import checkpoint as ckpt_mod
from oap_mllib_tpu_torch.utils import recovery, resilience

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    set_config(device="cpu")
    recovery.reset_stats()
    yield
    port_config.reset_config()
    recovery.reset_stats()


def _two_process(monkeypatch, rank=0):
    monkeypatch.setattr(recovery, "_world", lambda: 2)
    monkeypatch.setattr(recovery, "_rank", lambda: rank)


class TestConfigSurface:
    def test_negative_collective_timeout_raises(self):
        set_config(collective_timeout=-1.0)
        with pytest.raises(ValueError, match="collective_timeout"):
            recovery.collective_timeout_cfg()

    def test_negative_raises_at_dispatch_even_in_one_process(self):
        set_config(collective_timeout=-1.0)
        with pytest.raises(ValueError, match="collective_timeout"):
            recovery.guarded_dispatch("psum", "data", lambda: 1)

    def test_the_port_arms_by_default_and_gloo_waits_longer(self):
        """The port's default deadline is 600 s (the JAX package's is 0,
        disarmed); gloo's own timeout lies GLOO_MARGIN_S past it, so the
        watcher fires first."""
        assert port_config.Config().collective_timeout == 600.0
        assert recovery.gloo_timeout_s() == 600.0 + recovery.GLOO_MARGIN_S
        set_config(collective_timeout=0.0)
        assert recovery.gloo_timeout_s() == 0.0

    def test_recovery_fields_have_the_jax_defaults(self):
        from oap_mllib_tpu.config import Config as JaxConfig

        port, ref = port_config.Config(), JaxConfig()
        for name in ("crash_dir", "restart_budget", "restart_backoff", "shrink_after",
                     "checkpoint_dir", "checkpoint_interval", "resume"):
            assert getattr(port, name) == getattr(ref, name), name

    @pytest.mark.parametrize("field,raw,want", [
        ("restart_budget", "7", 7), ("restart_backoff", "0.25", 0.25),
        ("shrink_after", "4", 4), ("checkpoint_interval", "3", 3),
        ("crash_dir", "/x", "/x"), ("resume", "require", "require")])
    def test_env_values_are_typed(self, monkeypatch, field, raw, want):
        monkeypatch.setenv("OAP_MLLIB_TPU_" + field.upper(), raw)
        assert getattr(port_config.Config.from_env(), field) == want


class TestWatchdog:
    def test_fast_dispatch_passes_through_and_fingerprints(self, monkeypatch):
        _two_process(monkeypatch)
        set_config(collective_timeout=5.0)
        assert recovery.guarded_dispatch("psum", "data", lambda: 7) == 7
        after = recovery.last_completed()
        assert after == {"count": 1, "last": "psum|data"}

    def test_worker_exception_propagates(self, monkeypatch):
        _two_process(monkeypatch)
        set_config(collective_timeout=5.0)

        def boom():
            raise RuntimeError("inner failure")

        with pytest.raises(RuntimeError, match="inner failure"):
            recovery.guarded_dispatch("psum", "data", boom)

    def test_timeout_raises_named_diagnosis(self, monkeypatch, tmp_path):
        _two_process(monkeypatch)
        crash = str(tmp_path / "sideband")
        set_config(collective_timeout=0.3, crash_dir=crash)
        recovery.guarded_dispatch("all_gather", "host", lambda: 1)
        t0 = time.monotonic()
        with pytest.raises(recovery.CollectiveTimeoutError) as ei:
            recovery.guarded_dispatch("allreduce_sum", "data", lambda: time.sleep(3))
        assert time.monotonic() - t0 < 2.0
        e = ei.value
        assert e.op == "allreduce_sum" and e.axis == "data" and e.elapsed_s >= 0.3
        assert e.last_completed == {"count": 1, "last": "all_gather|host"}
        msg = str(e)
        assert "allreduce_sum" in msg and "collective_timeout=0.3" in msg
        assert "#1 [all_gather|host]" in msg and "Recovery:" in msg
        rec = json.load(open(recovery.crash_record_path(crash, 0)))
        assert rec["fault_class"] == recovery.FAULT_TIMEOUT == jax_recovery.FAULT_TIMEOUT
        assert rec["op"] == "allreduce_sum"
        assert recovery.stats()["timeouts"] == {"allreduce_sum": 1}
        assert recovery.abandoned() == 1

    def test_peer_poison_aborts_promptly(self, monkeypatch, tmp_path):
        _two_process(monkeypatch)
        crash = str(tmp_path / "sideband")
        os.makedirs(crash)
        with open(recovery.crash_record_path(crash, 1), "w") as f:
            json.dump({"rank": 1, "fault_class": "oom", "site": "als.fit", "error": "boom",
                       "last_checkpoint_step": 5}, f)
        set_config(collective_timeout=30.0, crash_dir=crash)
        t0 = time.monotonic()
        with pytest.raises(recovery.PeerAbortError) as ei:
            recovery.guarded_dispatch("all_gather", "host", lambda: time.sleep(30))
        assert time.monotonic() - t0 < 5.0
        assert ei.value.record["rank"] == 1 and ei.value.op == "all_gather"
        msg = str(ei.value)
        assert "rank 1" in msg and "oom" in msg and "als.fit" in msg
        assert "checkpoint step was 5" in msg
        rec = json.load(open(recovery.crash_record_path(crash, 0)))
        assert rec["fault_class"] == recovery.FAULT_PEER_ABORT
        assert recovery.stats()["peer_aborts"] == 1

    def test_single_process_never_watches(self):
        set_config(collective_timeout=0.05)
        t0 = time.monotonic()
        assert recovery.guarded_dispatch("psum", "data",
                                         lambda: (time.sleep(0.2), 9)[1]) == 9
        assert time.monotonic() - t0 >= 0.2

    def test_nested_dispatch_runs_inline(self, monkeypatch):
        _two_process(monkeypatch)
        set_config(collective_timeout=5.0)
        import threading

        outer = []

        def inner():
            return threading.current_thread().name

        def fn():
            outer.append(threading.current_thread().name)
            return recovery.guarded_dispatch("inner", "host", inner)

        got = recovery.guarded_dispatch("outer", "host", fn)
        assert got == outer[0] == "oap-collective-outer"


class TestGlooErrorMapping:
    """gloo raises on its own when a peer closes its connection (the JAX
    package's survivor only times out): inside a guarded dispatch its
    connection errors become PeerAbortError and its timeouts
    CollectiveTimeoutError, armed or not, each writing the record."""

    CLOSED = ["[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection closed by peer "
              "[127.0.0.1]:41234", "Connection reset by peer", "Broken pipe"]

    @pytest.mark.parametrize("timeout", [0.0, 5.0])
    @pytest.mark.parametrize("text", CLOSED)
    def test_closed_connection_is_a_peer_abort(self, monkeypatch, tmp_path, timeout, text):
        _two_process(monkeypatch)
        crash = str(tmp_path / "sb")
        set_config(collective_timeout=timeout, crash_dir=crash)

        def closed():
            raise RuntimeError(text)

        with pytest.raises(recovery.PeerAbortError) as ei:
            recovery.guarded_dispatch("all_to_all", "data", closed)
        e = ei.value
        assert e.op == "all_to_all" and e.axis == "data" and e.elapsed_s >= 0.0
        assert isinstance(e.__cause__, RuntimeError) and e.record == {}
        assert "last completed dispatch" in str(e).lower()
        rec = json.load(open(recovery.crash_record_path(crash, 0)))
        assert rec["fault_class"] == "peer_abort" and rec["op"] == "all_to_all"

    @pytest.mark.parametrize("timeout", [0.0, 5.0])
    def test_gloo_timeout_is_a_collective_timeout(self, monkeypatch, tmp_path, timeout):
        _two_process(monkeypatch)
        set_config(collective_timeout=timeout, crash_dir=str(tmp_path))

        def slow():
            raise RuntimeError("[gloo] Timed out waiting 610000ms for recv operation to complete")

        with pytest.raises(recovery.CollectiveTimeoutError) as ei:
            recovery.guarded_dispatch("barrier", "host", slow)
        assert ei.value.op == "barrier"

    def test_a_peer_record_names_the_culprit_on_a_closed_connection(self, monkeypatch,
                                                                    tmp_path):
        _two_process(monkeypatch)
        crash = str(tmp_path / "sb")
        os.makedirs(crash)
        with open(recovery.crash_record_path(crash, 1), "w") as f:
            json.dump({"rank": 1, "fault_class": "oom", "site": "ALS.fit"}, f)
        set_config(crash_dir=crash)

        def closed():
            raise RuntimeError("Connection closed by peer")

        with pytest.raises(recovery.PeerAbortError) as ei:
            recovery.guarded_dispatch("agree", "host", closed)
        assert ei.value.record["rank"] == 1 and "ALS.fit" in str(ei.value)

    @pytest.mark.parametrize("exc", [RuntimeError("a kernel failed"), ValueError("shape"),
                                     KeyError("x")])
    def test_other_errors_propagate_unchanged(self, monkeypatch, exc):
        _two_process(monkeypatch)

        def boom():
            raise exc

        with pytest.raises(type(exc)) as ei:
            recovery.guarded_dispatch("all_gather", "host", boom)
        assert ei.value is exc


class TestCollectivesAreWatched:
    @pytest.mark.parametrize("call", ["all_gather", "all_to_all", "barrier", "agree"])
    def test_every_host_collective_goes_through_the_watcher(self, monkeypatch, call):
        seen = []
        monkeypatch.setattr(recovery, "guarded_dispatch",
                            lambda op, axis, fn: seen.append((op, axis)) or fn())
        monkeypatch.setattr(collective.bootstrap, "world_size", lambda: 2)
        import torch
        import torch.distributed as dist

        # a world of two without gloo: every process sent what this one did
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        monkeypatch.setattr(dist, "all_gather", lambda outs, t: [o.copy_(t) for o in outs])
        monkeypatch.setattr(dist, "all_to_all_single", lambda out, t: out.copy_(t))
        monkeypatch.setattr(dist, "barrier", lambda: None)
        if call == "all_gather":
            collective._all_gather_host(torch.zeros(3))
        elif call == "all_to_all":
            collective.all_to_all([np.zeros(2), np.zeros(2)], axis="data")
        elif call == "barrier":
            collective.barrier()
        else:
            collective.agree(None, "x")
        assert seen == [(call, "data" if call == "all_to_all" else "host")]


class TestCrashRecords:
    def test_disarmed_is_noop(self):
        assert recovery.write_crash_record("s", "oom", "x") is None

    def test_record_schema_is_the_jax_packages(self, tmp_path, monkeypatch):
        """Version 2, the JAX package's keys; the planes the port does not
        have yet write what the JAX package writes with them off."""
        crash = str(tmp_path / "sideband")
        set_config(crash_dir=crash)
        path = recovery.write_crash_record("kmeans.fit", "transient", "connection reset",
                                           op="psum", elapsed_s=1.25)
        rec = json.load(open(path))
        from oap_mllib_tpu.config import set_config as jax_set_config

        jax_set_config(crash_dir=str(tmp_path / "jax"))
        ref = json.load(open(jax_recovery.write_crash_record(
            "kmeans.fit", "transient", "connection reset", op="psum", elapsed_s=1.25)))
        assert set(rec) == set(ref)
        assert rec["version"] == ref["version"] == recovery.CRASH_RECORD_VERSION == 2
        for key in ("rank", "world", "site", "fault_class", "error", "op", "elapsed_s"):
            assert rec[key] == ref[key], key
        assert rec["flight_recorder"] == [] and rec["sanitizer_fingerprint"] == ""
        assert isinstance(rec["telemetry"], dict) and "last_completed" in rec

    def test_record_carries_last_durable_checkpoint_step(self, tmp_path):
        set_config(crash_dir=str(tmp_path))
        ckpt_mod.reset_stats()
        ckpt_mod._note_durable(7)
        try:
            path = recovery.write_crash_record("s", "oom", "x")
            assert json.load(open(path))["last_checkpoint_step"] == 7
        finally:
            ckpt_mod.reset_stats()

    def test_check_poison_ignores_self_and_parses_peers(self, tmp_path):
        d = str(tmp_path)
        with open(recovery.crash_record_path(d, 0), "w") as f:
            json.dump({"rank": 0, "fault_class": "oom"}, f)
        assert recovery.check_poison(d, 0) is None
        with open(recovery.crash_record_path(d, 2), "w") as f:
            json.dump({"rank": 2, "fault_class": "killed"}, f)
        assert recovery.check_poison(d, 0)["rank"] == 2
        assert recovery.list_crash_records(d) == [recovery.crash_record_path(d, r)
                                                  for r in (0, 2)]

    def test_torn_record_still_poisons(self, tmp_path):
        d = str(tmp_path)
        with open(recovery.crash_record_path(d, 1), "w") as f:
            f.write("{not json")
        assert recovery.check_poison(d, 0) == {"rank": 1}

    def test_clear_crash_records(self, tmp_path):
        d = str(tmp_path)
        for r in (0, 1):
            with open(recovery.crash_record_path(d, r), "w") as f:
                json.dump({"rank": r}, f)
        assert recovery.clear_crash_records(d) == 2
        assert recovery.check_poison(d, 99) is None
        assert recovery.crash_record_path(d, 3) == jax_recovery.crash_record_path(d, 3)


class TestArmedCrashRecords:
    """With the flight recorder and the collective sanitizer armed, a
    crash record carries the recorder's tail (ending in the crash event)
    and the sanitizer's digest, with the JAX package's keys."""

    def _armed(self, tmp_path, set_cfg, rec_mod, san_mod, fr_mod):
        set_cfg(crash_dir=str(tmp_path), flight_recorder=128, sanitizers="collective")
        fr_mod._reset_for_tests()
        san_mod._reset_for_tests()
        for i in range(80):
            fr_mod.record("chunk", "prefetch", f"#{i}")
        san_mod.note_collective("barrier", "host", (), "none")
        return json.load(open(rec_mod.write_crash_record(
            "collective.dispatch", "peer_abort", "peer rank 1 aborted", op="all_gather")))

    def test_tail_and_digest_with_the_jax_keys(self, tmp_path):
        from oap_mllib_tpu.config import set_config as jax_set_config
        from oap_mllib_tpu.telemetry import flightrec as jax_fr
        from oap_mllib_tpu.utils import sanitizers as jax_san
        from oap_mllib_tpu_torch.telemetry import flightrec
        from oap_mllib_tpu_torch.utils import sanitizers

        try:
            rec = self._armed(tmp_path / "port", set_config, recovery, sanitizers, flightrec)
            ref = self._armed(tmp_path / "jax", jax_set_config, jax_recovery, jax_san, jax_fr)
        finally:
            flightrec._reset_for_tests()
            sanitizers._reset_for_tests()
            jax_fr._reset_for_tests()
            jax_san._reset_for_tests()
        assert set(rec) == set(ref)
        assert len(rec["flight_recorder"]) == len(ref["flight_recorder"]) == 64
        assert rec["flight_recorder"][-1]["kind"] == "crash"
        assert [(e["seq"], e["kind"], e["name"], e["detail"]) for e in rec["flight_recorder"]] \
            == [(e["seq"], e["kind"], e["name"], e["detail"]) for e in ref["flight_recorder"]]
        assert set(rec["flight_recorder"][0]) == set(ref["flight_recorder"][0])
        assert rec["sanitizer_fingerprint"] == ref["sanitizer_fingerprint"]
        assert rec["sanitizer_fingerprint"].startswith("1:")
        assert "oap_recovery_aborts_total" in rec["telemetry"]

    @pytest.mark.parametrize("key,sub,family", [
        ("aborts", "oom", "oap_recovery_aborts_total"),
        ("timeouts", "all_gather", "oap_recovery_timeouts_total"),
        ("peer_aborts", None, "oap_recovery_peer_aborts_total"),
        ("relaunches", None, "oap_recovery_relaunches_total"),
        ("world_shrinks", None, "oap_recovery_world_shrinks_total")])
    def test_counts_book_the_jax_families(self, key, sub, family):
        from oap_mllib_tpu_torch.telemetry import metrics as tm

        before = tm.family_total(family)
        stats0 = recovery.stats()
        recovery._bump(key, sub)
        assert tm.family_total(family) == before + 1
        got = recovery.stats()[key]
        assert (got[sub] == stats0[key].get(sub, 0) + 1) if sub else got == stats0[key] + 1


class TestSupervisedLadder:
    def _fit(self, monkeypatch, world, crash_dir, fn=lambda level: "ok"):
        monkeypatch.setattr(resilience, "_world", lambda: world)
        monkeypatch.setattr(jax_res, "_world", lambda: world)
        if world > 1:
            monkeypatch.setattr(recovery, "_world", lambda: world)
        set_config(crash_dir=crash_dir)
        stats = resilience.ResilienceStats()
        return resilience.resilient_fit("kmeans", fn, stats=stats), stats

    @pytest.mark.parametrize("world,sideband,ladder", [
        (2, False, "bypassed(static-world)"), (2, True, "supervised"), (1, True, "active")])
    def test_ladder_label_like_jax(self, monkeypatch, tmp_path, world, sideband, ladder):
        from oap_mllib_tpu.config import set_config as jax_set_config

        crash = str(tmp_path / "sb") if sideband else ""
        _, stats = self._fit(monkeypatch, world, crash)
        jax_set_config(crash_dir=crash, fallback=False)
        ref = jax_res.ResilienceStats()
        jax_res.resilient_fit("kmeans", lambda d: "ok", None, stats=ref)
        assert stats.ladder == ref.ladder == ladder

    def test_fatal_fault_poisons_and_propagates_unchanged(self, monkeypatch, tmp_path):
        crash = str(tmp_path / "sb")

        def boom(level):
            raise MemoryError("CUDA out of memory: drill")

        with pytest.raises(MemoryError, match="drill"):
            self._fit(monkeypatch, 2, crash, boom)
        rec = json.load(open(recovery.crash_record_path(crash, 0)))
        assert rec["site"] == "kmeans.fit" and rec["fault_class"] == "oom"

    def test_recovery_errors_do_not_double_record(self, monkeypatch, tmp_path):
        crash = str(tmp_path / "sb")

        def boom(level):
            raise recovery.CollectiveTimeoutError("already recorded")

        with pytest.raises(recovery.CollectiveTimeoutError):
            self._fit(monkeypatch, 2, crash, boom)
        assert not os.path.exists(recovery.crash_record_path(crash, 0))


# a process of a gloo world of two: process 1 dies (SIGKILL) or hangs
# after the first collective; process 0 keeps gathering and must exit
# as a victim with its crash record
_WORLD = r"""
import os, signal, sys, time
import numpy as np
from oap_mllib_tpu_torch import set_config
from oap_mllib_tpu_torch.parallel import bootstrap, collective
from oap_mllib_tpu_torch.utils import recovery
rank, port, mode, crash = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
set_config(device="cpu", crash_dir=crash, collective_timeout=float(sys.argv[5]))
bootstrap.initialize_distributed(f"127.0.0.1:{port}", 2, rank)
collective.process_allgather([np.asarray([rank], np.int64)])
if rank == 1:
    if mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(60)
try:
    for _ in range(200):
        collective.process_allgather([np.zeros(1024, np.float32)])
        time.sleep(0.01)
except recovery.RecoveryError as e:
    print("VICTIM", type(e).__name__, e.op, e.axis, round(e.elapsed_s, 2), flush=True)
    recovery.exit_now(3)
print("NO ABORT", flush=True)
"""


def _os_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestGlooWorld:
    @pytest.mark.parametrize("mode,timeout,want", [
        ("kill", 30.0, "PeerAbortError"), ("hang", 1.0, "CollectiveTimeoutError")])
    def test_survivor_exits_as_a_victim(self, tmp_path, mode, timeout, want):
        from oap_mllib_tpu_torch.utils.supervisor import Attempt, RankExit, Supervisor

        crash, port = str(tmp_path / "sb"), _os_port()
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen([sys.executable, "-c", _WORLD, str(r), str(port), mode, crash,
                                   str(timeout)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
                 for r in range(2)]
        try:
            out0 = procs[0].communicate(timeout=90)[0]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.communicate()
        assert procs[0].returncode == 3, out0
        assert f"VICTIM {want} all_gather host" in out0
        rec = json.load(open(recovery.crash_record_path(crash, 0)))
        cls = "peer_abort" if mode == "kill" else "collective_timeout"
        assert rec["fault_class"] == cls and rec["op"] == "all_gather"
        # the supervisor's classification of this exit: a victim, and a
        # SIGKILLed peer the culprit
        sup = Supervisor(lambda *a: [], 2, crash)
        att = sup._classify(0, 2, procs, ["", ""])
        assert att.exits[0].classification == cls and att.exits[0].victim
        if mode == "kill":
            assert procs[1].returncode == -9
            assert att.exits[1].classification == "killed" and att.culprit() == 1
        assert isinstance(att, Attempt) and isinstance(att.exits[0], RankExit)
