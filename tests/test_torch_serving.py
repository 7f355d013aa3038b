"""The port's serving core against the JAX package's, on the CPU.

Mirrors the JAX package's ``tests/test_serving.py`` (``TestRegistry``,
``TestBatcher``, ``TestChunkSourceScoring``, ``TestSweep``) case by
case.  Inputs come from ``np.random.default_rng``; both packages score
the same numpy tables.  Tolerances: K-Means labels equal; PCA
projections within 1e-5; ALS top-k scores within 1e-5 and ids equal
wherever the reference's k-th and (k+1)-th scores are more than 1e-5
apart (no near-tie).  Served answers are bit-equal to the port's own
model calls (same pinned tensors, same programs).

Also the pin repair: a model whose array is replaced answers from its
newest array (the device copies were keyed by ``id()`` of an array
they did not hold, and CPython reuses a freed array's id), and a
model's device cache holds one copy per pin name.
"""

import numpy as np
import pytest
import torch

from oap_mllib_tpu import serving as jserving
from oap_mllib_tpu.models.als import ALSModel as JaxALSModel
from oap_mllib_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from oap_mllib_tpu.models.pca import PCAModel as JaxPCAModel
from oap_mllib_tpu.serving import batcher as jbatcher
from oap_mllib_tpu.serving import sweep as jsweep
from oap_mllib_tpu_torch import ALS, KMeans, KMeansModel, PCA, PCAModel, ALSModel
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch import serving
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.serving import batcher, registry, sweep
from oap_mllib_tpu_torch.telemetry import metrics as tm
from oap_mllib_tpu_torch.utils import faults, progcache

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh():
    port_config.reset_config()
    port_config.set_config(device="cpu")
    registry.clear()
    jserving.registry.clear()
    yield
    registry.clear()
    jserving.registry.clear()
    faults.reset()
    port_config.reset_config()


def _kmeans_model(rng, n=400, d=12, k=5):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return KMeans(k=k, seed=3, max_iter=4, init_mode="random").fit(x), x


def _als_model(rng, nu=60, ni=48, rank=5):
    u = rng.integers(0, nu, size=3000)
    i = rng.integers(0, ni, size=3000)
    r = rng.normal(size=3000).astype(np.float32)
    return ALS(rank=rank, max_iter=2, seed=1).fit(u, i, r, n_users=nu, n_items=ni)


def _host_als(rng, nu, ni, r=5):
    """Both packages' host-factor models over the same random tables."""
    uf = rng.normal(size=(nu, r)).astype(np.float32)
    itf = rng.normal(size=(ni, r)).astype(np.float32)
    return ALSModel(uf, itf), JaxALSModel(uf, itf)


def assert_topk_close(ids, scores, ref_ids, ref_scores, full):
    """Scores within TOL; ids equal on every row whose k-th score stands
    more than TOL clear of the (k+1)-th of the full score row."""
    np.testing.assert_allclose(scores, ref_scores, rtol=TOL, atol=TOL)
    k = ref_ids.shape[1]
    srt = -np.sort(-full, axis=1)
    clear = (srt[:, k - 1] - srt[:, k] > TOL) if full.shape[1] > k else np.ones(len(full), bool)
    gaps = np.diff(srt[:, :k], axis=1)
    clear &= np.all(np.abs(gaps) > TOL, axis=1) if k > 1 else True
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ids[clear], ref_ids[clear])


class TestRegistry:
    def test_serve_is_keyed_like_progcache(self, rng):
        m, _ = _kmeans_model(rng)
        h1 = serving.serve(m)
        assert serving.serve(m) is h1
        assert serving.unserve(m)
        assert not serving.unserve(m)
        assert serving.serve(m, key="km") is serving.serve(m, key="km")
        assert ("km",) in serving.served_models()

    def test_serve_rejects_unknown_surface(self):
        with pytest.raises(TypeError, match="cannot serve"):
            serving.serve(object())
        with pytest.raises(TypeError, match="cannot serve"):
            jserving.serve(object())

    def test_served_bit_identical_and_held_to_jax(self, rng):
        x = rng.normal(size=(300, 10)).astype(np.float32)
        km = KMeans(k=4, seed=2, max_iter=3, init_mode="random").fit(x)
        hk = serving.serve(km)
        assert np.array_equal(hk.predict(x[:97]), km.predict(x[:97]))
        assert np.array_equal(hk.transform(x[:31]), km.transform(x[:31]))
        jk = jserving.serve(JaxKMeansModel(km.cluster_centers_))
        np.testing.assert_array_equal(hk.predict(x[:97]), jk.predict(x[:97]))

        pca = PCA(k=3).fit(x)
        hp = serving.serve(pca)
        assert np.array_equal(hp.transform(x[:53]), pca.transform(x[:53]))
        jp = jserving.serve(JaxPCAModel(pca.components_, pca.explained_variance_))
        np.testing.assert_allclose(hp.transform(x[:53]), jp.transform(x[:53]),
                                   rtol=TOL, atol=TOL)

        als = _als_model(rng)
        ha = serving.serve(als)
        ids_m, s_m = als.recommend_for_users(np.arange(20), 6, with_scores=True)
        ids_h, s_h = ha.recommend_for_users(np.arange(20), 6, with_scores=True)
        assert np.array_equal(ids_m, ids_h) and np.array_equal(s_m, s_h)
        assert np.array_equal(ha.recommend_for_all_users(5), als.recommend_for_all_users(5))
        ja = jserving.serve(JaxALSModel(als.user_factors_, als.item_factors_))
        ids_j, s_j = ja.recommend_for_users(np.arange(20), 6, with_scores=True)
        full = als.user_factors_[:20].astype(np.float64) @ als.item_factors_.T.astype(np.float64)
        assert_topk_close(ids_h, s_h, np.asarray(ids_j), np.asarray(s_j), full)
        np.testing.assert_allclose(ha.predict([0, 3], [1, 2]), als.predict([0, 3], [1, 2]))

    def test_zero_reupload_and_zero_build_on_repeat(self, rng):
        m, x = _kmeans_model(rng)
        m.predict(x[:100])
        pinned = m._dev_cache["centers"][1]
        builds = progcache.xla_compile_count()
        misses = progcache.stats()["misses"]
        m.predict(x[:100])
        m.predict(x[:100])
        assert progcache.xla_compile_count() - builds == 0
        assert progcache.stats()["misses"] - misses == 0
        assert m._dev_cache["centers"][1] is pinned

    def test_refit_invalidates_pin(self, rng):
        m, x = _kmeans_model(rng)
        m.predict(x[:10])
        old = m._dev_cache["centers"][1]
        m.cluster_centers_ = m.cluster_centers_.copy()
        m.predict(x[:10])
        assert m._dev_cache["centers"][1] is not old

    def test_als_targets_pinned_across_chunks_and_calls(self, rng):
        als = _als_model(rng)
        ids1 = als.recommend_for_all_users(4)
        pinned = als._dev_cache["targets:item"][1]
        misses = progcache.stats()["misses"]
        assert np.array_equal(als.recommend_for_all_users(4), ids1)
        assert als._dev_cache["targets:item"][1] is pinned
        assert progcache.stats()["misses"] - misses == 0

    def test_predict_many_coalesces(self, rng):
        m, x = _kmeans_model(rng)
        h = serving.serve(m)
        parts = h.predict_many([x[:7], x[7:20], x[20:21]])
        assert [len(p) for p in parts] == [7, 13, 1]
        assert np.array_equal(np.concatenate(parts), m.predict(x[:21]))
        assert h.requests == 3
        assert tm.gauge("oap_serve_queue_depth").value == 0
        jh = jserving.serve(JaxKMeansModel(m.cluster_centers_))
        jparts = jh.predict_many([x[:7], x[7:20], x[20:21]])
        for p, q in zip(parts, jparts):
            np.testing.assert_array_equal(p, q)

    def test_predict_many_poison_row_raises(self, rng):
        from oap_mllib_tpu_torch.utils.resilience import NonFiniteError

        m, x = _kmeans_model(rng)
        h = serving.serve(m)
        bad = x[:3].copy()
        bad[1, 0] = np.nan
        with pytest.raises(NonFiniteError, match="nonfinite input"):
            h.predict_many([x[:2], bad])
        assert tm.gauge("oap_serve_queue_depth").value == 0

    def test_warmup_then_jittered_storm_misses_nothing(self, rng):
        m, x = _kmeans_model(rng, n=700)
        h = serving.serve(m)
        assert h.warmup(512) == len(batcher.warm_sizes(512))
        before = progcache.stats()["by_algo"]["serve.assign"]["misses"]
        builds = batcher.xla_snapshot()
        for s in rng.integers(1, 512, size=50):
            h.predict(x[: int(s)])
        assert progcache.stats()["by_algo"]["serve.assign"]["misses"] == before
        assert batcher.xla_snapshot() == builds

    def test_serving_summary_block(self, rng):
        m, x = _kmeans_model(rng)
        h = serving.serve(m)
        h.predict(x[:30])
        block = serving.serving_summary()
        assert block["models_pinned"] == 1
        assert block["requests"] >= 1 and block["rows"] >= 30
        assert block["pad_rows"] >= 2  # 30 rows pad to 32
        assert block["latency_p50_s"] > 0
        assert block["latency_p99_s"] >= block["latency_p50_s"]
        assert block["queue_depth"] == 0
        assert [b["kind"] for b in block["models"]] == ["kmeans"]
        # the keys the JAX block carries before its traffic plane's
        jm = JaxKMeansModel(m.cluster_centers_)
        jserving.serve(jm).predict(x[:30])
        jblock = jserving.serving_summary()
        assert set(block) <= set(jblock)

    def test_no_card_and_no_cpu_raises(self, rng):
        """A handle resolves its device as the model does: with no card
        and no device="cpu", serving raises; nothing falls back."""
        port_config.set_config(device="cuda")
        m = KMeansModel(rng.normal(size=(3, 4)).astype(np.float32))
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks its absence")
        with pytest.raises(RuntimeError, match="cuda"):
            serving.serve(m)
        with pytest.raises(RuntimeError, match="cuda"):
            m.predict(np.zeros((2, 4), np.float32))


def _pool(kind, rng):
    """Host arrays for ``kind`` to cycle through."""
    if kind == "kmeans":
        return [(rng.normal(size=(6, 5)) * (1 + j)).astype(np.float32) for j in range(3)]
    if kind == "pca":
        return [np.ascontiguousarray(np.linalg.qr(rng.normal(size=(5, 5)))[0][:, :3],
                                     np.float32) for _ in range(3)]
    return [rng.normal(size=(30, 4)).astype(np.float32) for _ in range(3)]


def _fresh_copy(pool, step):
    """A fresh float64 copy, ONE allocation: the device copy never
    aliases it, and a freed array's id comes back at the next copy."""
    return pool[step % len(pool)].astype(np.float64)


class TestPinRepair:
    """The models' device copies follow the newest host array, however it
    was replaced, and hold one copy per pin name."""

    @pytest.mark.parametrize("kind", ["kmeans", "pca", "als"])
    @pytest.mark.parametrize("scoring_between", [False, True])
    def test_answers_from_the_newest_array(self, kind, scoring_between):
        rng = np.random.default_rng(17)
        x = rng.normal(size=(40, 5)).astype(np.float32)
        pool = _pool(kind, rng)
        if kind == "kmeans":
            m = KMeansModel(_fresh_copy(pool, 0), device="cpu")
            attr, score = "cluster_centers_", lambda: m.predict(x)

            def expect():
                c = m.cluster_centers_.astype(np.float32)
                return np.argmin(((x[:, None, :] - c[None]) ** 2).sum(-1), 1)
        elif kind == "pca":
            m = PCAModel(_fresh_copy(pool, 0), np.ones(3) / 3, device="cpu")
            attr, score = "components_", lambda: m.transform(x)

            def expect():
                return x.astype(np.float64) @ m.components_
        else:
            m = ALSModel(rng.normal(size=(8, 4)), _fresh_copy(pool, 0), device="cpu")
            attr, score = "item_factors_", lambda: m.predict(np.arange(8), np.arange(8))

            def expect():
                return np.sum(m.user_factors_[np.arange(8)] * m.item_factors_[np.arange(8)], 1)
        score()
        for step in range(1, 13):
            setattr(m, attr, _fresh_copy(pool, step))
            if scoring_between or step % 2 == 0:
                np.testing.assert_allclose(score(), expect(), rtol=1e-5, atol=1e-5,
                                           err_msg=f"stale answer at step {step}")

    def test_one_device_copy_per_pin_name(self, rng):
        x = rng.normal(size=(20, 5)).astype(np.float32)
        pools = {kind: _pool(kind, rng) for kind in ("kmeans", "pca", "als")}
        km = KMeansModel(_fresh_copy(pools["kmeans"], 0), device="cpu")
        pca = PCAModel(_fresh_copy(pools["pca"], 0), np.ones(3) / 3, device="cpu")
        als = ALSModel(rng.normal(size=(8, 4)), _fresh_copy(pools["als"], 0), device="cpu")
        for step in range(6):
            km.cluster_centers_ = _fresh_copy(pools["kmeans"], step)
            pca.components_ = _fresh_copy(pools["pca"], step)
            als.item_factors_ = _fresh_copy(pools["als"], step)
            als.user_factors_ = rng.normal(size=(8, 4))
            km.predict(x)
            pca.transform(x)
            als.predict([0, 1], [2, 3])
            als.recommend_for_all_users(3)
            als.recommend_for_all_items(3)
        assert set(km._dev_cache) == {"centers"}
        assert set(pca._dev_cache) == {"components"}
        assert set(als._dev_cache) == {"targets:item", "targets:user"}
        assert km._dev_cache["centers"][0] is km.cluster_centers_
        assert als._dev_cache["targets:item"][0] is als.item_factors_
        assert als._dev_cache["targets:user"][0] is als.user_factors_


    @pytest.mark.parametrize("kind", ["kmeans", "pca", "als"])
    def test_a_served_model_holds_one_device_copy(self, kind, rng):
        """A handle pins into its model's cache under the model's names:
        the model's calls and the handle's requests share one copy, and
        a re-pin after a swap replaces it."""
        x = rng.normal(size=(30, 5)).astype(np.float32)
        pool = _pool(kind, rng)
        if kind == "kmeans":
            m = KMeansModel(_fresh_copy(pool, 0), device="cpu")
            attr, name, dev_attr = "cluster_centers_", "centers", "centers_dev"
            h = serving.serve(m)
            np.testing.assert_array_equal(h.predict(x), m.predict(x))
        elif kind == "pca":
            m = PCAModel(_fresh_copy(pool, 0), np.ones(3) / 3, device="cpu")
            attr, name, dev_attr = "components_", "components", "components_dev"
            h = serving.serve(m)
            np.testing.assert_array_equal(h.transform(x), m.transform(x))
        else:
            m = ALSModel(rng.normal(size=(8, 4)).astype(np.float32), _fresh_copy(pool, 0),
                         device="cpu")
            attr, name, dev_attr = "item_factors_", "targets:item", "item_dev"
            h = serving.serve(m)
            got = h.recommend_for_users(np.arange(8), 2, with_scores=True)
            want = m.recommend_for_users(np.arange(8), 2, with_scores=True)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert set(m._dev_cache) == {name}
        assert getattr(h, dev_attr) is m._dev_cache[name][1]
        setattr(m, attr, _fresh_copy(pool, 1))
        assert registry.repin_model(m) == 1 and h.model_version == 2
        assert set(m._dev_cache) == {name}
        assert getattr(h, dev_attr) is m._dev_cache[name][1]
        assert m._dev_cache[name][0] is getattr(m, attr)


class TestBatcher:
    def test_slice_rows_is_the_largest_bucket_within_the_budget(self):
        from oap_mllib_tpu_torch.data.bucketing import bucket_rows

        for budget in (1, 7, 8, 9, 15, 16, 17, 100, 26_715, 233_016):
            rows = batcher.slice_rows(budget)
            assert bucket_rows(rows, batcher.SERVE_ROW_MULTIPLE) == rows
            assert rows <= max(budget, batcher.SERVE_ROW_MULTIPLE)
            assert bucket_rows(rows + 1, batcher.SERVE_ROW_MULTIPLE) > max(
                budget, batcher.SERVE_ROW_MULTIPLE)
        assert batcher.slice_rows(26_715) == 16_384
        assert batcher.slice_rows(233_016) == 131_072

    @pytest.mark.parametrize("kind", ["kmeans", "pca"])
    def test_full_slices_pad_nothing(self, kind, rng, monkeypatch):
        """A model's scoring slices are row buckets: only the tail pads,
        and the answer equals one unsliced request's."""
        from oap_mllib_tpu_torch.ops import kmeans_ops

        monkeypatch.setattr(kmeans_ops, "rows_per_chunk", lambda *w, **kw: 100)
        x = rng.normal(size=(197, 6)).astype(np.float32)
        if kind == "kmeans":
            m = KMeansModel(rng.normal(size=(4, 6)).astype(np.float32), device="cpu")
            score = m.predict
            whole = lambda q: batcher.assign_kmeans(m._centers_dev(), q)  # noqa: E731
        else:
            m = PCAModel(rng.normal(size=(6, 3)), np.ones(3) / 3, device="cpu")
            score = m.transform
            whole = lambda q: batcher.project_pca(  # noqa: E731
                registry.pin(m._dev_cache, "components", m.components_, "cpu"), q)
        for n, pad in ((192, 0), (200, 0), (197, 3), (64, 0), (70, 2)):
            before = tm.family_total("oap_serve_pad_rows_total")
            got = score(x[:n] if n <= len(x) else np.concatenate([x, x])[:n])
            assert tm.family_total("oap_serve_pad_rows_total") - before == pad
            q = x[:n] if n <= len(x) else np.concatenate([x, x])[:n]
            np.testing.assert_allclose(got, whole(q), rtol=TOL, atol=TOL)

    def test_bucket_batch_matches_jax(self):
        for n in list(range(1, 70)) + [127, 128, 129, 1000, 4095, 4096, 4097]:
            padded, got = batcher.bucket_batch(np.ones((n, 3), np.float32))
            jpadded, jgot = jbatcher.bucket_batch(np.ones((n, 3), np.float32))
            assert got == jgot == n
            assert padded.shape == jpadded.shape
            assert (padded[n:] == 0).all()
        t, n = batcher.bucket_batch(torch.ones((9, 3)))
        assert n == 9 and tuple(t.shape) == (16, 3) and bool((t[9:] == 0).all())

    def test_warm_sizes_match_jax(self):
        for top in (1, 7, 8, 9, 100, 512, 1000, 4096, 5000):
            sizes = batcher.warm_sizes(top)
            assert sizes == jbatcher.warm_sizes(top)
            assert sizes[-1] >= top and sizes == sorted(set(sizes))

    def test_bucketed_parity_across_jittered_sizes(self, rng):
        from oap_mllib_tpu.fallback.kmeans_np import predict_np

        m, x = _kmeans_model(rng, n=600)
        pca = PCA(k=3).fit(x)
        jm = JaxKMeansModel(m.cluster_centers_)
        jp = JaxPCAModel(pca.components_, pca.explained_variance_)
        for s in rng.integers(1, 600, size=12):
            s = int(s)
            ids = m.predict(x[:s])
            np.testing.assert_array_equal(ids, jm.predict(x[:s]))
            np.testing.assert_array_equal(
                ids, predict_np(x[:s].astype(np.float64),
                                m.cluster_centers_.astype(np.float64), "euclidean"))
            proj = pca.transform(x[:s])
            np.testing.assert_allclose(proj, jp.transform(x[:s]), rtol=TOL, atol=TOL)
            np.testing.assert_allclose(proj, x[:s] @ pca.components_, rtol=TOL, atol=TOL)

    def test_tensor_requests_match_arrays(self, rng):
        m, x = _kmeans_model(rng)
        np.testing.assert_array_equal(m.predict(torch.from_numpy(x[:77])), m.predict(x[:77]))

    def test_serving_precision_typo_raises(self, rng):
        m, x = _kmeans_model(rng)
        port_config.set_config(serving_precision="fp8")
        with pytest.raises(ValueError, match="serving_precision must be one of"):
            m.predict(x[:4])
        from oap_mllib_tpu.config import set_config as jax_set_config

        jax_set_config(serving_precision="fp8")
        with pytest.raises(ValueError, match="serving_precision must be one of"):
            JaxKMeansModel(m.cluster_centers_).predict(x[:4])

    def test_serving_precision_override_resolves(self):
        port_config.set_config(serving_precision="tf32")
        pol = batcher.resolve_policy("kmeans")
        assert pol.name == "tf32" and pol.dot_tier == "high"
        port_config.set_config(serving_precision="")
        assert batcher.resolve_policy("kmeans").name == "f32"
        port_config.set_config(compute_precision="bf16")
        assert batcher.resolve_policy("als") == ("bf16", "default")
        from oap_mllib_tpu.config import set_config as jax_set_config

        jax_set_config(serving_precision="tf32")
        assert jbatcher.resolve_policy("kmeans").name == "tf32"

    def test_resolving_books_no_fit_attempt(self, rng):
        from oap_mllib_tpu_torch.utils import precision as psn

        psn.begin_attempt()
        m, x = _kmeans_model(rng)
        psn.begin_attempt()
        port_config.set_config(serving_precision="bf16")
        m.predict(x[:8])
        assert not psn.reduced_active()

    def test_serve_request_fault_site_drillable(self, rng):
        m, x = _kmeans_model(rng)
        m.predict(x[:8])
        port_config.set_config(fault_spec="serve.request:fail=1")
        faults.reset()
        with pytest.raises(faults.FaultInjected):
            m.predict(x[:8])
        assert m.predict(x[:8]).shape == (8,)

    def test_serve_batch_fault_site_drillable(self, rng):
        m, x = _kmeans_model(rng)
        h = serving.serve(m)
        port_config.set_config(fault_spec="serve.batch:fail=1")
        faults.reset()
        with pytest.raises(faults.FaultInjected):
            h.predict_many([x[:2], x[2:5]])
        assert len(h.predict_many([x[:2], x[2:5]])) == 2


class TestChunkSourceScoring:
    def test_kmeans_chunksource_bit_identical_to_ndarray(self, rng):
        m, x = _kmeans_model(rng, n=500)
        direct = m.predict(x)
        src = ChunkSource.from_array(x, chunk_rows=96)
        assert np.array_equal(m.predict(src), direct)
        misses = progcache.stats()["misses"]
        assert np.array_equal(m.predict(src), direct)
        assert progcache.stats()["misses"] - misses == 0

    def test_kmeans_disk_backed_scoring(self, rng, tmp_path):
        from oap_mllib_tpu_torch.data import io as dio

        m, x = _kmeans_model(rng, n=300)
        path = str(tmp_path / "table.npy")
        dio.atomic_save_npy(path, x)
        src = ChunkSource.from_npy(path, chunk_rows=64)
        assert np.array_equal(m.predict(src), m.predict(x))

    def test_pca_chunksource_matches_ndarray(self, rng):
        x = rng.normal(size=(400, 9)).astype(np.float32)
        pca = PCA(k=4).fit(x)
        src = ChunkSource.from_array(x, chunk_rows=128)
        np.testing.assert_allclose(pca.transform(src), pca.transform(x), atol=1e-6)


class TestSweep:
    def test_sweep_matches_model_exactly_and_jax(self, rng):
        als, jals = _host_als(rng, nu=150, ni=64)
        ids_m, s_m = als.recommend_for_all_users(9, with_scores=True)
        ids_s, s_s = sweep.recommend_for_all_users(als, 9, with_scores=True)
        assert np.array_equal(ids_m, ids_s)
        np.testing.assert_array_equal(s_m, s_s)
        ids_j, s_j = jsweep.recommend_for_all_users(jals, 9, with_scores=True)
        full = als.user_factors_.astype(np.float64) @ als.item_factors_.T.astype(np.float64)
        assert_topk_close(ids_s, s_s, np.asarray(ids_j), np.asarray(s_j), full)

    def test_sweep_of_fitted_model_matches_model(self, rng):
        als = _als_model(rng, nu=100, ni=48)
        assert np.array_equal(sweep.recommend_for_all_users(als, 6),
                              als.recommend_for_all_users(6))

    def test_sweep_through_a_handle(self, rng):
        als, _ = _host_als(rng, nu=70, ni=33)
        h = serving.serve(als)
        ids, s = h.recommend_for_all_users(4, with_scores=True)
        ids_m, s_m = als.recommend_for_all_users(4, with_scores=True)
        assert np.array_equal(ids, ids_m) and np.array_equal(s, s_m)
        assert tm.family_total("oap_serve_sweep_rows_total") >= 70

    def test_sweep_chunk_override_and_tail_bucket(self, rng):
        als, _ = _host_als(rng, nu=101, ni=32)
        ref = als.recommend_for_all_users(5)
        assert np.array_equal(sweep.recommend_for_all_users(als, 5, chunk_rows=17), ref)
        port_config.set_config(sweep_chunk_rows=13)
        assert np.array_equal(sweep.recommend_for_all_users(als, 5), ref)

    def test_sweep_clamps_num_items(self, rng):
        als, jals = _host_als(rng, nu=20, ni=8)
        ids = sweep.recommend_for_all_users(als, 99)
        assert ids.shape == (20, 8) == np.asarray(jsweep.recommend_for_all_users(jals, 99)).shape

    def test_sweep_zero_k_and_negative(self, rng):
        als, _ = _host_als(rng, nu=12, ni=8)
        assert sweep.recommend_for_all_users(als, 0).shape == (12, 0)
        with pytest.raises(ValueError, match=">= 0"):
            sweep.recommend_for_all_users(als, -1)

    def test_sweep_chunk_rows_config_negative_raises(self, rng):
        als, jals = _host_als(rng, nu=12, ni=8)
        port_config.set_config(sweep_chunk_rows=-1)
        with pytest.raises(ValueError, match="sweep_chunk_rows must be >= 0"):
            sweep.recommend_for_all_users(als, 2)
        from oap_mllib_tpu.config import set_config as jax_set_config

        jax_set_config(sweep_chunk_rows=-1)
        with pytest.raises(ValueError, match="sweep_chunk_rows must be >= 0"):
            jsweep.recommend_for_all_users(jals, 2)

    def test_sweep_streamed_is_chunk_invariant(self, rng):
        als, _ = _host_als(rng, nu=90, ni=40)
        ref = sweep.recommend_for_all_users(als, 6, chunk_rows=90)
        for rows in (7, 13, 64):
            assert np.array_equal(sweep.recommend_for_all_users(als, 6, chunk_rows=rows), ref)

    def test_sweep_large_table_bounded_memory(self, rng):
        """A 200k-user table sweeps in chunks (the score matrix would be
        200k x 256); sampled rows against a stable argsort."""
        nu, ni, r, k = 200_000, 256, 8, 4
        uf = rng.normal(size=(nu, r)).astype(np.float32)
        itf = rng.normal(size=(ni, r)).astype(np.float32)
        m = ALSModel(uf, itf)
        ids = sweep.recommend_for_all_users(m, k, chunk_rows=8192)
        assert ids.shape == (nu, k)
        sample = rng.integers(0, nu, size=64)
        scores = uf[sample] @ itf.T
        expect = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        assert np.array_equal(ids[sample], expect)

    def test_sweep_ties_go_to_the_lowest_id(self):
        """Duplicate item rows tie exactly; the lower id ranks first, as
        lax.top_k's does."""
        itf = np.tile(np.eye(3, dtype=np.float32), (3, 1))
        uf = np.eye(3, dtype=np.float32)
        ids = sweep.recommend_for_all_users(ALSModel(uf, itf), 3)
        np.testing.assert_array_equal(ids, [[0, 3, 6], [1, 4, 7], [2, 5, 8]])
        np.testing.assert_array_equal(
            ids, np.asarray(jsweep.recommend_for_all_users(JaxALSModel(uf, itf), 3)))
