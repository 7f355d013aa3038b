"""In-place serving re-pins of the port's online commits, against the JAX
package's, on the CPU.

Mirrors the JAX package's ``tests/test_online_serving.py`` case by case:
a committed delta bumps every served handle's ``model_version``, resets
its staleness clock and answers through the new state bit-equal to the
model's own call, without evicting the handle; a failed delta leaves the
handle answering bit-equal through the old version; ``online_repin=
"off"`` freezes the pin until ``registry.repin_model``.  Each version,
counter and typo is held to the JAX package's on the same deltas.  The
re-pin refreshes its pins outside the registry lock, and the lock
tracer records no order inversion while commits and requests run on two
threads.
"""

import threading

import numpy as np
import pytest

from oap_mllib_tpu import serving as jserving
from oap_mllib_tpu.config import set_config as jax_set_config
from oap_mllib_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from oap_mllib_tpu.utils import faults as jfaults
from oap_mllib_tpu_torch import ALS, KMeans, serving
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.online import IncrementalPCA
from oap_mllib_tpu_torch.serving import registry
from oap_mllib_tpu_torch.telemetry import flightrec
from oap_mllib_tpu_torch.telemetry import metrics as tm
from oap_mllib_tpu_torch.utils import faults, locktrace
from oap_mllib_tpu_torch.utils.faults import FaultInjected


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    port_config.set_config(device="cpu")
    registry.clear()
    jserving.registry.clear()
    faults.reset()
    jfaults.reset()
    yield
    registry.clear()
    jserving.registry.clear()
    faults.reset()
    jfaults.reset()
    flightrec._reset_for_tests()
    locktrace._reset_for_tests()
    port_config.reset_config()


@pytest.fixture
def rng():
    return np.random.default_rng(21)


def _kmeans(rng, n=300, d=4, k=2):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return KMeans(k=k, seed=1, max_iter=4, init_mode="random").fit(x), x


def _twin(m):
    return JaxKMeansModel(m.cluster_centers_.copy(), summary=m.summary)


class TestRepinOnCommit:
    def test_kmeans_partial_fit_repins_served_handle(self, rng):
        m, x = _kmeans(rng, n=500, d=6, k=3)
        twin = _twin(m)
        h, jh = serving.serve(m), jserving.serve(twin)
        assert h.model_version == jh.model_version == 1
        q = rng.normal(size=(40, 6)).astype(np.float32)
        h.predict(q)
        delta = rng.normal(size=(200, 6)).astype(np.float32) + 2.0
        m.partial_fit(delta)
        twin.partial_fit(delta)
        assert h.model_version == jh.model_version == 2
        np.testing.assert_array_equal(h.predict(q), m.predict(q))
        np.testing.assert_array_equal(h.predict(q), jh.predict(q))
        assert serving.serve(m) is h

    def test_staleness_resets_on_commit(self, rng):
        m, x = _kmeans(rng)
        h = serving.serve(m)
        h._committed_at -= 100.0
        assert h.staleness_seconds() > 99
        m.partial_fit(x[:50])
        assert h.staleness_seconds() < 5
        assert tm.gauge("oap_serve_model_staleness_seconds", {"model": "kmeans"}).value < 5
        assert tm.gauge("oap_serve_model_version", {"model": "kmeans"}).value == 2

    def test_ipca_commit_repins_same_handle(self, rng):
        x = rng.normal(size=(400, 5)).astype(np.float32)
        ip = IncrementalPCA(2)
        ip.partial_fit(x[:200])
        m = ip.commit()
        h = serving.serve(m)
        q = rng.normal(size=(30, 5)).astype(np.float32)
        old = h.transform(q)
        ip.partial_fit(x[200:] + 1.5)
        ip.commit()
        assert h.model_version == 2
        np.testing.assert_array_equal(h.transform(q), m.transform(q))
        assert not np.array_equal(h.transform(q), old)

    def test_als_foldin_repins_and_serves_grown_table(self, rng):
        u = rng.integers(0, 30, size=1500)
        i = rng.integers(0, 25, size=1500)
        r = rng.normal(1.0, 0.5, size=1500).astype(np.float32)
        m = ALS(rank=3, max_iter=4, reg_param=0.1, seed=2).fit(u, i, r, n_users=30, n_items=25)
        h = serving.serve(m)
        ids_before = m.recommend_for_users(np.arange(5), 3)
        out = m.fold_in_users(np.full(6, 34), np.arange(6),
                              rng.normal(1.0, 0.5, size=6).astype(np.float32))
        assert out["repinned"] == 1 and h.model_version == 2
        assert m.recommend_for_users([34], 4).shape == (1, 4)
        ids, s = h.recommend_for_users([34, 1], 4, with_scores=True)
        ids_m, s_m = m.recommend_for_users([34, 1], 4, with_scores=True)
        assert np.array_equal(ids, ids_m) and np.array_equal(s, s_m)
        np.testing.assert_array_equal(m.recommend_for_users(np.arange(5), 3), ids_before)
        # the handle re-pinned the swapped item table into the model's
        # cache; the grown user table stays on the host
        assert h.item_dev is m._dev_cache["targets:item"][1]
        np.testing.assert_array_equal(h.item_dev.numpy(), m.item_factors_)

    def test_repin_off_freezes_pin_until_explicit(self, rng):
        port_config.set_config(online_repin="off")
        m, x = _kmeans(rng)
        h = serving.serve(m)
        old_centers = h.centers_dev
        m.partial_fit(x + 3.0)
        assert h.model_version == 1 and h.centers_dev is old_centers
        assert registry.repin_model(m) == 1
        assert h.model_version == 2 and h.centers_dev is not old_centers

    def test_repin_typo_raises(self, rng):
        m, x = _kmeans(rng, d=3)
        port_config.set_config(online_repin="eager")
        jax_set_config(online_repin="eager")
        with pytest.raises(ValueError, match="online_repin must be auto|off"):
            m.partial_fit(x[:50])
        with pytest.raises(ValueError, match="online_repin must be auto|off"):
            _twin(m).partial_fit(x[:50])

    def test_repin_model_unserved_is_zero(self, rng):
        m, _ = _kmeans(rng, d=3)
        assert registry.repin_model(m) == 0

    def test_books_repin_counter_and_recorder(self, rng):
        port_config.set_config(flight_recorder=64)
        before = tm.family_total("oap_serve_repins_total")
        m, x = _kmeans(rng, d=3)
        serving.serve(m)
        m.partial_fit(x[:50])
        assert tm.family_total("oap_serve_repins_total") == before + 1
        names = [e["name"] for e in flightrec.tail()]
        assert "delta_commit" in names and "repin" in names


class TestFailedCommitLeavesPinServing:
    def test_kmeans_fault_keeps_old_answers_bit_identical(self, rng):
        m, x = _kmeans(rng, n=400, d=5, k=3)
        h = serving.serve(m)
        q = rng.normal(size=(60, 5)).astype(np.float32)
        before = h.predict(q)
        port_config.set_config(fault_spec="delta.ingest:err=1")
        with pytest.raises(FaultInjected):
            m.partial_fit(x + 5.0)
        assert h.model_version == 1
        np.testing.assert_array_equal(h.predict(q), before)

    @pytest.mark.parametrize("spec", ["delta.solve:err=1", "delta.solve:err=2"])
    def test_als_solve_fault_keeps_old_pin(self, rng, spec):
        u = rng.integers(0, 25, size=1200)
        i = rng.integers(0, 20, size=1200)
        r = rng.normal(1.0, 0.5, size=1200).astype(np.float32)
        m = ALS(rank=3, max_iter=4, reg_param=0.1, seed=2).fit(u, i, r, n_users=25, n_items=20)
        h = serving.serve(m)
        before = h.recommend_for_users(np.arange(6), 3)
        port_config.set_config(fault_spec=spec, online_foldin_batch=1)
        with pytest.raises(FaultInjected):
            m.fold_in_users([30, 30, 2], [0, 1, 4], [1.0, 2.0, 1.0])
        assert h.model_version == 1 and m.user_factors_.shape == (25, 3)
        np.testing.assert_array_equal(h.recommend_for_users(np.arange(6), 3), before)


class TestObservabilitySurfaces:
    def test_serving_summary_models_block(self, rng):
        m, x = _kmeans(rng)
        serving.serve(m)
        m.partial_fit(x[:40])
        models = {b["kind"]: b for b in registry.serving_summary()["models"]}
        assert models["kmeans"]["model_version"] == 2
        assert models["kmeans"]["staleness_seconds"] < 60

    def test_handle_stats_carry_version(self, rng):
        m, _ = _kmeans(rng)
        s = serving.serve(m).stats()
        assert s["model_version"] == 1 and s["staleness_seconds"] >= 0
        assert set(s) == set(jserving.serve(_twin(m)).stats())


class TestLockOrder:
    def test_repin_refreshes_pins_outside_the_registry_lock(self, rng, monkeypatch):
        port_config.set_config(sanitizers="locks")
        m, x = _kmeans(rng)
        h = serving.serve(m)
        held = []
        real = type(h)._repin_pins

        def spy(self):
            held.append([e[0] for e in locktrace._held()])
            real(self)

        monkeypatch.setattr(type(h), "_repin_pins", spy)
        m.partial_fit(x[:50])
        assert held and all("serving.registry" not in names for names in held)

    def test_commits_and_requests_on_two_threads_invert_no_order(self, rng):
        port_config.set_config(sanitizers="locks")
        m, x = _kmeans(rng)
        h = serving.serve(m)
        errors = []

        def requests():
            try:
                for _ in range(30):
                    h.predict_many([x[:5], x[5:9]])
                    registry.serving_summary()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        t = threading.Thread(target=requests)
        t.start()
        for lo in range(0, 200, 20):
            m.partial_fit(x[lo:lo + 20])
        t.join()
        assert errors == []
        assert h.model_version == 11
        edges = locktrace.order_edges()
        assert not [(a, b) for (a, b) in edges if (b, a) in edges]
