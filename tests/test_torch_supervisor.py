"""The port's supervisor (utils/supervisor.py) on the CPU: launch,
classify, relaunch and shrink with tiny worker scripts, as the JAX
package's ``tests/test_supervisor.py`` drives its own, plus one real
supervised world: two gloo processes fit a checkpointed streamed
K-Means, a seeded ``chaos`` kill takes process 1 down mid-fit, the
survivor exits as a victim, and the relaunch resumes to the
uninterrupted fit's centers bit for bit; with ``shrink_after=1`` the
world shrinks to one process and lands within 1e-5 of it."""

import json
import os
import sys

import numpy as np
import pytest

from oap_mllib_tpu.utils import supervisor as jax_supervisor
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.config import set_config
from oap_mllib_tpu_torch.parallel import balance
from oap_mllib_tpu_torch.utils import faults, recovery
from oap_mllib_tpu_torch.utils.supervisor import Attempt, RankExit, Supervisor

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    recovery.reset_stats()
    yield
    port_config.reset_config()
    recovery.reset_stats()


def _script_argv(script: str):
    """build_argv of an inline worker: argv[1:] = rank world coord attempt."""

    def build(rank, world, coord, attempt):
        return [sys.executable, "-c", script, str(rank), str(world), coord, str(attempt)]

    return build


def _mk(tmp_path, script, world=2, **kw):
    kw.setdefault("restart_backoff", 0.01)
    kw.setdefault("grace_s", 5.0)
    kw.setdefault("attempt_timeout", 60.0)
    return Supervisor(_script_argv(script), world, str(tmp_path / "sideband"),
                      env={**os.environ, "PYTHONPATH": _REPO}, **kw)


class TestHappyPath:
    def test_clean_world_no_relaunch(self, tmp_path):
        s = _mk(tmp_path, "print('RESULT ok')", restart_budget=3).run()
        assert s["ok"] and s["relaunches"] == 0 and s["shrinks"] == 0
        assert s["final_world"] == 2 and all("RESULT ok" in o for o in s["outputs"])
        assert [e["classification"] for e in s["attempts"][0]["exits"]] == ["ok", "ok"]

    def test_invalid_world_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="world"):
            _mk(tmp_path, "pass", world=0)

    @pytest.mark.parametrize("kw,match", [({"restart_budget": -1}, "restart_budget"),
                                          ({"restart_backoff": -1.0}, "restart_backoff"),
                                          ({"shrink_after": 0}, "shrink_after")])
    def test_bad_policy_rejected(self, tmp_path, kw, match):
        with pytest.raises(ValueError, match=match):
            _mk(tmp_path, "pass", **kw)

    def test_config_defaults_flow(self, tmp_path):
        set_config(restart_budget=7, restart_backoff=0.25, shrink_after=4)
        sup = Supervisor(_script_argv("pass"), 1, str(tmp_path / "sb"))
        assert (sup.restart_budget, sup.restart_backoff, sup.shrink_after) == (7, 0.25, 4)

    def test_worker_env_is_the_jax_contract(self, tmp_path):
        """The env a worker gets, key for key as the JAX supervisor sets
        it (the chaos seed moved by the attempt)."""
        env = {"PATH": os.environ.get("PATH", "")}
        ours = Supervisor(_script_argv("pass"), 2, str(tmp_path), env=env, chaos="5:0.01:kill:1")
        ref = jax_supervisor.Supervisor(_script_argv("pass"), 2, str(tmp_path), env=env,
                                        chaos="5:0.01:kill:1")
        for attempt in (0, 3):
            assert ours._worker_env(attempt) == ref._worker_env(attempt)
        assert ours._worker_env(3)["OAP_MLLIB_TPU_CHAOS"] == "8:0.01:kill:1"
        assert ours._worker_env(3)["OAP_MLLIB_TPU_PROBE_EPOCH"] == "3"


# rank 1 fails until a marker exists: attempt 0 fails, attempt 1 passes
_FLAKY = """
import os, sys
rank, world, coord, attempt = sys.argv[1:5]
marker = os.environ["FLAKY_MARKER"]
if rank == "1" and not os.path.exists(marker):
    open(marker, "w").close()
    sys.exit(1)
print("RESULT attempt=" + attempt)
"""

# the last process dies whenever the world has several
_BAD_LAST_RANK = """
import sys
rank, world = int(sys.argv[1]), int(sys.argv[2])
if world > 1 and rank == world - 1:
    sys.exit(3)
print("RESULT world=" + str(world))
"""


class TestRelaunch:
    def test_fail_then_succeed_consumes_one_restart(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLAKY_MARKER", str(tmp_path / "marker"))
        s = _mk(tmp_path, _FLAKY, restart_budget=3).run()
        assert s["ok"] and s["relaunches"] == 1 and s["shrinks"] == 0
        assert [a["ok"] for a in s["attempts"]] == [False, True]
        assert s["attempts"][0]["culprit"] == 1
        assert any("attempt=1" in o for o in s["outputs"])
        st = recovery.stats()
        assert st["relaunches"] == st["restart_budget_spent"] == 1
        assert len(st["time_to_recovery_s"]) == 1 == len(s["recovery_s"])

    def test_budget_exhausted_reports_not_ok(self, tmp_path):
        s = _mk(tmp_path, "import sys; sys.exit(2)", world=1, restart_budget=2).run()
        assert not s["ok"] and s["relaunches"] == 2 and len(s["attempts"]) == 3
        assert all(not a["ok"] for a in s["attempts"])

    def test_stale_crash_records_cleared_between_attempts(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLAKY_MARKER", str(tmp_path / "marker"))
        record_then_ok = _FLAKY.replace(
            'open(marker, "w").close()',
            'open(marker, "w").close()\n'
            '    import json\n'
            '    json.dump({"rank": 1, "fault_class": "oom"}, '
            'open(os.environ["OAP_MLLIB_TPU_CRASH_DIR"] + "/crash.rank1.json", "w"))')
        sup = _mk(tmp_path, record_then_ok, restart_budget=2)
        s = sup.run()
        assert s["ok"] and s["attempts"][0]["exits"][1]["classification"] == "oom"
        assert recovery.check_poison(sup.crash_dir, 99) is None


class TestShrink:
    @pytest.mark.parametrize("world,shrink_after,worlds,shrinks", [
        (2, 2, [2, 2, 1], 1), (3, 1, [3, 2, 1], 2)])
    def test_repeated_culprit_shrinks_world(self, tmp_path, world, shrink_after, worlds,
                                            shrinks):
        s = _mk(tmp_path, _BAD_LAST_RANK, world=world, restart_budget=4,
                shrink_after=shrink_after).run()
        assert s["ok"] and s["final_world"] == 1 and s["shrinks"] == shrinks
        assert [a["world"] for a in s["attempts"]] == worlds
        assert any("world=1" in o for o in s["outputs"])
        assert recovery.stats()["world_shrinks"] == shrinks

    def test_world_never_shrinks_below_one(self, tmp_path):
        s = _mk(tmp_path, "import sys; sys.exit(1)", world=1, restart_budget=2,
                shrink_after=1).run()
        assert not s["ok"] and s["final_world"] == 1 and s["shrinks"] == 0

    def test_a_balance_hint_naming_the_culprit_is_one_more_vote(self, tmp_path):
        """The straggler controller's hint (parallel/balance.py, written by
        process 0 into the sideband) plus one failure reaches
        shrink_after=2 at once."""
        script = _BAD_LAST_RANK.replace(
            "    sys.exit(3)",
            "    import json, os\n"
            "    json.dump({'schema': 1, 'rank': rank}, open(os.path.join("
            "os.environ['OAP_MLLIB_TPU_CRASH_DIR'], 'balance.hint.json'), 'w'))\n"
            "    sys.exit(3)")
        s = _mk(tmp_path, script, world=2, restart_budget=3, shrink_after=2).run()
        assert s["ok"] and [a["world"] for a in s["attempts"]] == [2, 1]
        assert [h["rank"] for h in s["balance_hints"]] == [1]


class TestClassification:
    def test_signal_death_is_killed(self, tmp_path):
        script = """
import os, signal, sys
if sys.argv[1] == "0":
    os.kill(os.getpid(), signal.SIGKILL)
print("RESULT ok")
"""
        s = _mk(tmp_path, script, world=2, restart_budget=0).run()
        e = s["attempts"][0]["exits"][0]
        assert e["classification"] == "killed" and e["returncode"] == -9
        assert s["attempts"][0]["culprit"] == 0

    def test_crash_record_class_wins_over_exit_code(self, tmp_path):
        script = """
import json, os, sys
if sys.argv[1] == "1":
    json.dump({"rank": 1, "fault_class": "oom", "site": "als.fit", "last_checkpoint_step": 4},
              open(os.environ["OAP_MLLIB_TPU_CRASH_DIR"] + "/crash.rank1.json", "w"))
    sys.exit(1)
print("RESULT ok")
"""
        e = _mk(tmp_path, script, world=2, restart_budget=0).run()["attempts"][0]["exits"][1]
        assert e["classification"] == "oom" and e["record"]["site"] == "als.fit"
        assert e["record"]["last_checkpoint_step"] == 4

    @pytest.mark.parametrize("exits,culprit", [
        ([(0, 0, "collective_timeout"), (1, -9, "killed"), (2, 0, "peer_abort")], 1),
        ([(0, 0, "collective_timeout"), (1, -9, "collective_timeout")], 1),
        ([(0, 0, "ok"), (1, 1, "error")], 1),
        ([(0, 0, "peer_abort"), (1, 0, "oom")], 1),
        ([(0, 0, "ok"), (1, 0, "ok")], None)])
    def test_culprit_like_jax(self, exits, culprit):
        ours = Attempt(0, len(exits), [RankExit(r, c, k) for r, c, k in exits])
        ref = jax_supervisor.Attempt(0, len(exits),
                                     [jax_supervisor.RankExit(r, c, k) for r, c, k in exits])
        assert ours.culprit() == ref.culprit() == culprit
        assert ours.as_dict() == ref.as_dict()

    def test_chaos_reseeds_per_attempt(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FLAKY_MARKER", str(tmp_path / "marker"))
        script = _FLAKY.replace('print("RESULT attempt=" + attempt)',
                                'print("RESULT chaos=" + os.environ["OAP_MLLIB_TPU_CHAOS"])')
        s = _mk(tmp_path, script, restart_budget=2, chaos="5:0.01:kill:1").run()
        assert s["ok"] and any("chaos=6:0.01:kill:1" in o for o in s["outputs"])


class TestHints:
    def _write(self, sup, name, payload):
        os.makedirs(sup.crash_dir, exist_ok=True)
        with open(os.path.join(sup.crash_dir, name), "w") as f:
            f.write(payload if isinstance(payload, str) else json.dumps(payload))

    _FAIL_ONCE = """
import sys
rank, world, coord, attempt = sys.argv[1:5]
if attempt == "0":
    sys.exit(1)
print("RESULT world=" + world)
"""

    @pytest.mark.parametrize("action,final", [("in", 1), ("out", 2)])
    def test_scale_hint_sizes_the_next_world(self, tmp_path, action, final):
        sup = _mk(tmp_path, self._FAIL_ONCE, world=2, restart_budget=2)
        self._write(sup, "serve.scale.hint.json", {"action": action, "reason": "test"})
        s = sup.run()
        assert s["ok"] and s["final_world"] == final
        assert [h["action"] for h in s["scale_hints"]] == [action]
        assert not os.path.exists(os.path.join(sup.crash_dir, "serve.scale.hint.json"))

    def test_hold_or_torn_hints_ignored_and_consumed(self, tmp_path):
        sup = _mk(tmp_path, "pass", world=1)
        for payload in ({"action": "hold"}, "{torn"):
            self._write(sup, "serve.scale.hint.json", payload)
            assert sup._read_scale_hint() is None
            assert not os.path.exists(os.path.join(sup.crash_dir, "serve.scale.hint.json"))
        self._write(sup, "balance.hint.json", "{torn")
        assert sup._read_balance_hint() is None

    def test_drain_reports_are_read_and_removed(self, tmp_path):
        sup = _mk(tmp_path, "pass", world=1)
        self._write(sup, "serve.drain.done.rank1.json", {"rank": 1, "answered": 3})
        assert sup._read_drain_reports() == [{"rank": 1, "answered": 3}]
        assert sup._read_drain_reports() == []

    def test_the_controller_writes_the_hint_the_supervisor_reads(self, tmp_path):
        """A process that stays slowest through the re-plans is named in
        the summary's hint as the JAX controller names it, and with the
        sideband armed process 0 writes it where the supervisor reads."""
        from oap_mllib_tpu.config import set_config as jax_set_config
        from oap_mllib_tpu.parallel import balance as jax_balance
        from oap_mllib_tpu_torch.telemetry import fleet

        crash = str(tmp_path / "sb")
        set_config(crash_dir=crash, rebalance_patience=1, capability_sharding="on")
        jax_set_config(rebalance_patience=1, capability_sharding="on")
        frames_cw = np.stack([np.ones(2), np.ones(2), np.zeros(2), np.zeros(2)], 1)
        plan = balance.make_plan(4000, 100, world=2, capworld=balance.fold_world(frames_cw))
        jplan = jax_balance.make_plan(4000, 100, world=2,
                                      capworld=jax_balance.fold_world(frames_cw))
        try:
            for _ in range(6):  # process 1 four times slower, whatever its rows
                frames = np.zeros((2, len(fleet.FRAME_FIELDS)))
                frames[:, 0] = [1.0, 4.0]
                frames[:, fleet.FRAME_FIELDS.index("rows")] = [r for _, r in plan.extents()]
                balance.observe_pass("lloyd_loop", frames)
                jax_balance.observe_pass("lloyd_loop", frames)
            hint = balance.summary_block(2)["supervisor_hint"]
            assert hint == jax_balance.summary_block(2)["supervisor_hint"]
            assert jplan.extents() == plan.extents()
        finally:
            balance.reset()
            jax_balance._reset_for_tests()
        assert hint["rank"] == 1 and hint["schema"] == 1
        sup = Supervisor(_script_argv("pass"), 2, crash)
        assert sup._read_balance_hint() == hint


def _chaos_seed(counts, target_site, lo, hi, rate):
    """A chaos seed (``seed:rate:kill:1``) whose schedule fires exactly
    once over the call counts of process 1's uninterrupted run, at
    ``target_site`` call ``lo <= c < hi``, and whose next seed (the
    relaunch's) fires nowhere."""
    # every site's window is widened past the counted calls: a retried
    # join or read in a loaded run calls a site more often than the
    # uninterrupted run did, and no such call may fire
    windows = {site: 2 * counts.get(site, 0) + 8 for site in faults.SITES}

    def fires(seed):
        st = faults.ChaosState(seed, rate, ["kill"], 1)
        return [(site, c) for site, n in windows.items() for c in range(n)
                if st.decide(site, c, 1)]

    for seed in range(1, 400000):
        st = faults.ChaosState(seed, rate, ["kill"], 1)
        hit = [(target_site, c) for c in range(lo, hi) if st.decide(target_site, c, 1)]
        if len(hit) == 1 and fires(seed) == hit and not fires(seed + 1):
            return seed
    raise AssertionError("no chaos seed found")


# a process of the supervised world: a streamed K-Means over its half of
# the rows (the whole table in a world of one), checkpointed; chaos only
# in process 1 ("chaos kills process 1")
_DRILL = r"""
import json, os, sys
import numpy as np
from oap_mllib_tpu_torch import KMeans, set_config
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.parallel import bootstrap
from oap_mllib_tpu_torch.utils import faults, recovery
rank, world, coord, attempt = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
set_config(device="cpu", collective_timeout=30.0,
           chaos=os.environ.get("OAP_MLLIB_TPU_CHAOS", "") if rank == 1 else "")
if world > 1:
    bootstrap.initialize_distributed(coord, world, rank)
x = np.random.default_rng(3).normal(size=(2048, 6)).astype(np.float32)
lo, hi = rank * len(x) // world, (rank + 1) * len(x) // world
try:
    m = KMeans(k=4, seed=1, init_mode="random", max_iter=8, tol=0.0).fit(
        ChunkSource.from_array(x[lo:hi], chunk_rows=256))
except recovery.RecoveryError as e:
    print("VICTIM", type(e).__name__, flush=True)
    recovery.exit_now(3)
print("RESULT " + json.dumps({
    "centers": m.cluster_centers_.tolist(), "ck": m.summary.checkpoint,
    "ladder": m.summary.resilience["ladder"],
    "calls": faults.stats().get("chaos", {}).get("calls", {})}), flush=True)
bootstrap.shutdown()
"""


def _result(out):
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


class TestSupervisedWorld:
    def _sup(self, tmp_path, name, chaos, **kw):
        env = {**os.environ, "PYTHONPATH": _REPO,
               "OAP_MLLIB_TPU_CHECKPOINT_DIR": str(tmp_path / name / "ckpt"),
               "OAP_MLLIB_TPU_CHECKPOINT_INTERVAL": "2"}
        return Supervisor(_script_argv(_DRILL), 2, str(tmp_path / name / "sb"), env=env,
                          chaos=chaos, restart_backoff=0.01, grace_s=20.0,
                          attempt_timeout=120.0, **kw)

    def test_kill_relaunch_and_shrink(self, tmp_path):
        # the uninterrupted world, chaos armed at rate 0 to count the calls
        ref = self._sup(tmp_path, "ref", "0:0.0:kill:1").run()
        assert ref["ok"], ref["outputs"]
        full = [_result(o) for o in ref["outputs"]]
        assert full[0]["centers"] == full[1]["centers"]
        assert full[0]["ladder"] == "supervised"
        # Lloyd passes 4-8 (fit.execute calls 3-7) come after the step-2 write
        calls = full[1]["calls"]
        # about one fire expected over the widened windows
        rate = 1.0 / (2 * sum(calls.values()) + 8 * len(faults.SITES))
        seed = _chaos_seed(calls, "fit.execute", 3, 8, rate)
        run = self._sup(tmp_path, "kill", f"{seed}:{rate!r}:kill:1").run()
        assert run["ok"] and run["relaunches"] == 1 and run["shrinks"] == 0
        first = run["attempts"][0]
        assert [e["classification"] for e in first["exits"]] == ["peer_abort", "killed"]
        assert first["exits"][1]["returncode"] == -9 and first["culprit"] == 1
        assert first["exits"][0]["record"]["last_checkpoint_step"] >= 2
        got = [_result(o) for o in run["outputs"]]
        assert got[0]["ck"]["decision"] == "found" and got[0]["ck"]["restored_step"] >= 2, \
            run["outputs"]
        assert got[0]["centers"] == full[0]["centers"]  # bit for bit
        # a kill on every attempt that has a process 1, shrink_after=1
        shrunk = self._sup(tmp_path, "shrink", f"{seed}:{rate!r}:kill:1", shrink_after=1).run()
        assert shrunk["ok"] and shrunk["final_world"] == 1 and shrunk["shrinks"] == 1
        one = _result(shrunk["outputs"][0])
        assert one["ck"]["decision"] == "resharded" and one["ck"]["old_world"] == 2
        np.testing.assert_allclose(np.asarray(one["centers"]), np.asarray(full[0]["centers"]),
                                   atol=1e-5)
