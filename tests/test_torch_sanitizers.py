"""The port's sanitizers against the JAX package's, on the CPU: the
config surface, the collective fingerprint (one digest for one
(op, axis, shape, dtype) sequence in both packages), the cross-check's
diagnosis, the transfer scope's CPU caveat, the retrace watch over
kernel builds and program-cache misses, the tracked locks, and one gloo
world of two processes where one process plants an extra collective.

The world's worker is this file run with ``--worker``, through
tests/test_torch_cluster.py's launcher.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

from oap_mllib_tpu.config import set_config as jax_set_config  # noqa: E402
from oap_mllib_tpu.utils import locktrace as jax_locktrace  # noqa: E402
from oap_mllib_tpu.utils import sanitizers as jax_san  # noqa: E402
from oap_mllib_tpu_torch import KMeans, config as port_config  # noqa: E402
from oap_mllib_tpu_torch.data.prefetch import Prefetcher  # noqa: E402
from oap_mllib_tpu_torch.data.stream import ChunkSource  # noqa: E402
from oap_mllib_tpu_torch.telemetry import metrics as tm  # noqa: E402
from oap_mllib_tpu_torch.utils import locktrace, progcache  # noqa: E402
from oap_mllib_tpu_torch.utils import sanitizers as san  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    san._reset_for_tests()
    jax_san._reset_for_tests()
    yield
    port_config.reset_config()
    san._reset_for_tests()
    jax_san._reset_for_tests()


SEQUENCE = [("process_allgather", "host", ((1,), (4, 4)), "int64,float32"),
            ("all_to_all", "data", (2, 128), "uint8"),
            ("barrier", "host", (), "none"),
            ("ring_allreduce", "host", (2, 64), "float32"),
            ("agree", "host", (2,), "int64")]


def _fingerprint(mod, set_config, dtype_of):
    set_config(sanitizers="collective")
    for op, axis, shape, dtype in SEQUENCE:
        mod.note_collective(op, axis, shape, dtype_of(dtype))
    return mod.fingerprint()


class TestConfigSurface:
    def test_default_off(self):
        assert san.enabled_set() == frozenset() and not san.enabled("collective")

    def test_parse_comma_set(self):
        port_config.set_config(sanitizers=" collective, locks ,")
        assert san.enabled_set() == {"collective", "locks"}
        assert san.enabled("locks") and not san.enabled("transfer")

    def test_typo_raises_like_jax(self):
        port_config.set_config(sanitizers="collective,trnsfer")
        jax_set_config(sanitizers="collective,trnsfer")
        with pytest.raises(ValueError) as ours:
            san.enabled("collective")
        with pytest.raises(ValueError) as ref:
            jax_san.enabled("collective")
        assert str(ours.value) == str(ref.value)
        assert san.VALID == jax_san.VALID


class TestCollectiveFingerprint:
    def test_off_records_nothing(self):
        san.note_collective("barrier", "host", (), "none")
        assert san.fingerprint()[0] == 0

    @pytest.mark.parametrize("dtype_of", [lambda d: d, lambda d: np.dtype(d.split(",")[0])
                                          if d != "none" else d],
                             ids=["names", "numpy"])
    def test_one_sequence_one_digest_in_both_packages(self, dtype_of):
        ours = _fingerprint(san, port_config.set_config, dtype_of)
        ref = _fingerprint(jax_san, jax_set_config, dtype_of)
        assert ours == ref and ours[0] == len(SEQUENCE)

    def test_torch_dtypes_sign_as_numpy_names(self):
        import torch

        port_config.set_config(sanitizers="collective")
        jax_set_config(sanitizers="collective")
        san.note_collective("all_gather", "host", (3, 2), torch.float32)
        san.note_collective("all_gather", "host", (3, 2), torch.bfloat16)
        jax_san.note_collective("all_gather", "host", (3, 2), np.dtype(np.float32))
        jax_san.note_collective("all_gather", "host", (3, 2), "bfloat16")
        assert san.fingerprint() == jax_san.fingerprint()
        assert san._SEQ[-1].endswith("bfloat16:reduced")

    def test_reduced_dtype_changes_the_fingerprint(self):
        port_config.set_config(sanitizers="collective")
        san.note_collective("ring_allreduce", "host", (2, 4), "float32")
        f32 = san.fingerprint()
        san._reset_for_tests()
        san.note_collective("ring_allreduce", "host", (2, 4), "bfloat16")
        assert san.fingerprint() != f32

    @pytest.mark.parametrize("mod,set_config", [(san, port_config.set_config),
                                                (jax_san, jax_set_config)],
                             ids=["port", "jax"])
    def test_divergence_names_both_ops(self, monkeypatch, mod, set_config):
        set_config(sanitizers="collective")
        monkeypatch.setattr(mod, "_world", lambda: 2)
        peer = b"op:barrier|host|()|none:full"
        monkeypatch.setattr(mod, "_gather_frames", lambda frame: [frame, peer])
        with pytest.raises(mod.CollectiveDivergenceError) as ei:
            mod.note_collective("all_gather", "host", (4, 4), "float32")
        msg = str(ei.value)
        assert "all_gather|host|(4, 4)|float32:full" in msg and "barrier" in msg
        assert "rank 1: op:barrier" in msg

    def test_finalize_attaches_and_advances_the_window(self):
        port_config.set_config(sanitizers="collective,locks")
        san.note_collective("barrier", "host", (), "none")
        first, second = {}, {}
        san.finalize_fit_sanitizers(first)
        san.finalize_fit_sanitizers(second)
        assert first["sanitizers"]["enabled"] == ["collective", "locks"]
        assert first["sanitizers"]["collective"]["ops"] == 1
        assert not first["sanitizers"]["collective"]["world_checked"]
        assert second["sanitizers"]["collective"]["ops"] == 0
        assert set(first["sanitizers"]["locks"]) == {"tracked", "order_edges", "hold_p99_s"}

    def test_tail_divergence_raises_at_the_boundary(self, monkeypatch):
        port_config.set_config(sanitizers="collective")
        monkeypatch.setattr(san, "_world", lambda: 2)
        monkeypatch.setattr(san, "_gather_frames", lambda f: [f, b"fit:7:deadbeef"])
        san.note_collective("barrier", "host", (), "none", crosscheck=False)
        with pytest.raises(san.CollectiveDivergenceError, match="deadbeef"):
            san.finalize_fit_sanitizers({})


class TestTransferAndRetrace:
    def test_transfer_scope_on_the_cpu_only_counts(self):
        import torch

        port_config.set_config(sanitizers="transfer")
        before = tm.family_total("oap_sanitizer_transfer_scopes_total")
        with Prefetcher(range(3), stage=lambda i: (i, [np.zeros((2, 2), np.float32)]),
                        device=torch.device("cpu")) as pf:
            assert [h for h, _ in pf] == [0, 1, 2]
        assert tm.family_total("oap_sanitizer_transfer_scopes_total") == before + 3
        with san.allow_transfers():
            pass

    def test_steady_state_passes_warm_and_catches_a_build(self):
        port_config.set_config(sanitizers="retrace")
        progcache.note("t.warm", ("k",))
        with san.steady_state("warm"):
            progcache.note("t.warm", ("k",))
        with pytest.raises(san.RetraceError, match="steady-state scope 'cold'"):
            with san.steady_state("cold"):
                progcache.note_build(0.01)

    def test_prefetch_catches_a_mid_pass_miss(self):
        port_config.set_config(sanitizers="retrace")
        with pytest.raises(san.RetraceError, match="chunk 2"):
            with Prefetcher(range(4)) as pf:
                for i in pf:
                    if i == 2:
                        progcache.note("t.midpass", (time.perf_counter(),))

    def test_a_streamed_fit_armed_is_bit_equal_to_unarmed(self):
        x = np.random.default_rng(2).normal(size=(900, 5)).astype(np.float32)
        kw = dict(k=3, max_iter=4, seed=1, device="cpu")
        plain = KMeans(**kw).fit(ChunkSource.from_array(x, 128))
        port_config.set_config(sanitizers="collective,transfer,retrace,locks",
                               flight_recorder=512)
        armed = KMeans(**kw).fit(ChunkSource.from_array(x, 128))
        assert np.array_equal(armed.cluster_centers_, plain.cluster_centers_)
        assert armed.summary.num_iter == plain.summary.num_iter
        assert armed.summary.sanitizers["enabled"] == ["collective", "locks", "retrace",
                                                       "transfer"]
        assert plain.summary.sanitizers is None


def _inversion(mod, set_config, tag):
    set_config(sanitizers="locks")
    a = mod.TrackedLock(f"{tag}.a")
    b = mod.TrackedLock(f"{tag}.b")
    with a:
        with b:
            pass
    with pytest.raises(Exception) as ei:
        with b:
            with a:
                pass
    return ei.value


class TestLocks:
    def test_off_is_a_plain_lock(self):
        a, b = locktrace.TrackedLock("t.off.a"), locktrace.TrackedLock("t.off.b")
        with a, b:
            pass
        with b, a:
            pass
        assert locktrace.order_edges() == {}

    def test_the_same_inversion_raises_in_both_naming_the_same_pair(self):
        ours = _inversion(locktrace, port_config.set_config, "t.inv")
        ref = _inversion(jax_locktrace, jax_set_config, "t.inv")
        assert type(ours).__name__ == type(ref).__name__ == "LockOrderError"
        assert isinstance(ours, san.LockOrderError)

        def head(e):
            return str(e).split("Two threads")[0]

        assert head(ours) == head(ref)
        assert "acquiring 't.inv.a' while holding 't.inv.b'" in head(ours)

    def test_two_thread_inversion(self):
        port_config.set_config(sanitizers="locks")
        a, b = locktrace.TrackedLock("t.thr.a"), locktrace.TrackedLock("t.thr.b")
        box = {}

        def leg2():
            try:
                with b, a:
                    pass
            except san.LockOrderError as e:
                box["err"] = e

        t1 = threading.Thread(target=lambda: [None for _ in [a.acquire(), b.acquire(),
                                                              b.release(), a.release()]])
        t1.start()
        t1.join()
        t2 = threading.Thread(target=leg2)
        t2.start()
        t2.join()
        assert isinstance(box.get("err"), san.LockOrderError)

    def test_reentrant_holds_and_flags(self):
        port_config.set_config(sanitizers="locks", collective_timeout=0.001)
        r = locktrace.TrackedLock("t.re", threading.RLock())
        with r, r:
            pass
        assert locktrace.order_edges() == {}
        before = tm.family_total("oap_lock_hold_flags_total")
        with locktrace.TrackedLock("t.flag"):
            time.sleep(0.01)
        assert tm.family_total("oap_lock_hold_flags_total") == before + 1
        assert locktrace.hold_quantile(0.99) > 0.0

    def test_the_seams_are_tracked(self):
        import oap_mllib_tpu_torch.parallel.balance  # noqa: F401
        import oap_mllib_tpu_torch.telemetry.export  # noqa: F401
        import oap_mllib_tpu_torch.telemetry.fleet  # noqa: F401

        assert {"telemetry.sink", "fleet.state", "fleet.server", "balance.sync",
                "balance.state", "sanitizers.seq", "progcache.clear"} <= set(
            locktrace.tracked_names())


# -- one world of two processes: a planted extra collective ------------------------------


def _worker_divergence(rank, res):
    """Process 1 issues a barrier before the streamed K-Means's first
    collective; both processes must raise CollectiveDivergenceError
    there, naming each other's op."""
    from oap_mllib_tpu_torch import set_config
    from oap_mllib_tpu_torch.parallel import collective

    set_config(sanitizers="collective", flight_recorder=256)
    if rank == 1:
        real = collective.process_allgather
        planted = {"done": False}

        def extra(arrays):
            if not planted["done"]:
                planted["done"] = True
                collective.barrier()
            return real(arrays)

        collective.process_allgather = extra
    x = np.random.default_rng(rank).normal(size=(512, 4)).astype(np.float32)
    t0 = time.perf_counter()
    try:
        KMeans(k=3, max_iter=3, seed=0, init_mode="random").fit(ChunkSource.from_array(x, 128))
        res["error"] = None
    except san.CollectiveDivergenceError as e:
        res["error"] = str(e)
    res["seconds"] = time.perf_counter() - t0


class TestPlantedDivergence:
    def test_both_processes_raise_naming_both_ops(self):
        sys.path.insert(0, HERE)
        from test_torch_cluster import COLLECTIVE_TIMEOUT_S, _launch

        res, _ = _launch(2, 1, "divergence", script=os.path.join(HERE, "test_torch_sanitizers.py"))
        for r in (0, 1):
            err = res[r]["error"]
            assert err is not None, res
            assert "process_allgather" in err and "op:barrier" in err
            assert res[r]["seconds"] < COLLECTIVE_TIMEOUT_S
        assert "rank 0 is dispatching [op:process_allgather" in res[0]["error"]
        assert "rank 1 is dispatching [op:barrier" in res[1]["error"]


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "--worker":
    sys.path.insert(0, HERE)
    from test_torch_cluster import _worker

    _worker(sys.argv[2:], {"divergence": _worker_divergence})
