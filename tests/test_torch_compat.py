"""The port's Spark-ML compat layer (``compat.spark`` and
``compat.pipeline``) against the JAX package's, on the CPU.

Mirrors the JAX package's ``tests/test_compat.py`` and
``tests/test_pipeline.py`` case by case, and holds the port's fits to
the JAX compat classes' on the same numpy inputs (``default_rng``).
Tolerances: K-Means with ``initMode="random"`` starts from the same rows
in both packages, centers within 1e-5 and equal labels; k-means|| draws
differ between the packages, so only the cost is compared (1e-4
relative); PCA components within 1e-5 up to sign, explained variance
within 1e-6; ALS in prediction space within 1e-5 relative (one device
on both sides, ``setNumUserBlocks(1)``), transform predictions within
1e-4 and NaN / dropped rows identical; evaluator metrics within 1e-12
(the same numpy on both sides); tuner metrics within 1e-3 relative and
the same winner.  A JAX-saved model loads through the port's compat
``load``; a manifest naming the JAX package's classes is refused.

The port runs on the CPU because every test sets ``Config.device`` to
``"cpu"`` (or a list of ``"cpu"`` ranks); without that the compat fits
take the card and raise here, as the last case checks.
"""

import json
import os

import numpy as np
import pytest

from oap_mllib_tpu import compat as jcompat
from oap_mllib_tpu.compat import pipeline as jpipeline
from oap_mllib_tpu.compat import spark as jspark
from oap_mllib_tpu_torch import compat as pcompat
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.compat import (
    ALS,
    ClusteringEvaluator,
    CrossValidator,
    KMeans,
    PCA,
    ParamGridBuilder,
    Pipeline,
    PipelineModel,
    RegressionEvaluator,
    TrainValidationSplit,
)
from oap_mllib_tpu_torch.compat import pipeline, spark
from oap_mllib_tpu_torch.serving import registry
from oap_mllib_tpu_torch.telemetry import metrics as tm

CPU4 = ",".join(["cpu"] * 4)


@pytest.fixture(autouse=True)
def _cpu():
    port_config.reset_config()
    port_config.set_config(device="cpu")
    registry.clear()
    yield
    registry.clear()
    port_config.reset_config()


def _df(rng, n=300, d=6, k=3, noise=0.05):
    centers = rng.normal(size=(k, d)) * 5
    x = centers[rng.integers(k, size=n)] + rng.normal(size=(n, d)) * noise
    return {"features": x}


def _ratings_df(rng, nu=30, ni=20):
    mask = rng.random((nu, ni)) < 0.3
    u, i = np.nonzero(mask)
    return {"user": u, "item": i, "rating": rng.integers(1, 6, len(u)).astype(np.float32)}


def _factor_ratings(rng, n=1500, nu=40, ni=30, rank=3):
    u = rng.integers(0, nu, n)
    i = rng.integers(0, ni, n)
    xt = rng.normal(size=(nu, rank))
    yt = rng.normal(size=(ni, rank))
    r = (xt[u] * yt[i]).sum(1) + 0.05 * rng.normal(size=n)
    return {"user": u, "item": i, "rating": r.astype(np.float32)}


def _pred_rel(a, b):
    pa = a.userFactors @ a.itemFactors.T
    pb = b.userFactors @ b.itemFactors.T
    return float(np.linalg.norm(pa - pb) / np.linalg.norm(pb))


def _components_close(port, ref, atol):
    for j in range(port.shape[1]):
        err = min(np.max(np.abs(port[:, j] - ref[:, j])), np.max(np.abs(port[:, j] + ref[:, j])))
        assert err <= atol, (j, err)


class TestKMeansCompat:
    def test_default_params_match_jax(self):
        km, jk = KMeans(), jspark.KMeans()
        for getter in ("getK", "getMaxIter", "getTol", "getInitMode", "getInitSteps",
                       "getDistanceMeasure", "getFeaturesCol", "getPredictionCol", "getSeed"):
            assert getattr(km, getter)() == getattr(jk, getter)(), getter

    def test_random_init_fit_matches_jax(self, rng):
        # unit-noise blobs: a cost well above the f32 cancellation of
        # ||x||^2 - 2 x.c + ||c||^2 at these magnitudes
        df = _df(rng, noise=1.0)
        def build(mod):
            return (mod.KMeans().setK(3).setMaxIter(30).setTol(1e-6).setSeed(7)
                    .setInitMode("random"))

        port, ref = build(spark).fit(df), build(jspark).fit(df)
        np.testing.assert_allclose(port.clusterCenters(), ref.clusterCenters(), atol=1e-5)
        out, jout = port.transform(df), ref.transform(df)
        np.testing.assert_array_equal(out["prediction"], jout["prediction"])
        assert "features" in out and "prediction" not in df
        assert port.summary.num_iter == ref.summary.num_iter
        np.testing.assert_allclose(port.computeCost(df), ref.computeCost(df), rtol=1e-5)

    def test_kmeans_parallel_reaches_the_jax_cost(self, rng):
        df = _df(rng)
        port = KMeans().setK(3).setSeed(1).fit(df)
        ref = jspark.KMeans().setK(3).setSeed(1).fit(df)
        np.testing.assert_allclose(port.summary.training_cost, ref.summary.training_cost,
                                   rtol=1e-4)

    def test_custom_columns_and_weights(self):
        x = np.array([[0.0, 0.0], [10.0, 10.0]])
        df = {"f": x, "w": np.array([3.0, 1.0])}
        model = (KMeans().setK(1).setMaxIter(5).setFeaturesCol("f")
                 .setWeightCol("w").setPredictionCol("cluster").fit(df))
        ref = (jspark.KMeans().setK(1).setMaxIter(5).setFeaturesCol("f")
               .setWeightCol("w").setPredictionCol("cluster").fit(df))
        np.testing.assert_allclose(model.clusterCenters()[0], [2.5, 2.5], atol=1e-4)
        np.testing.assert_allclose(model.clusterCenters(), ref.clusterCenters(), atol=1e-5)
        assert "cluster" in model.transform(df)

    def test_single_vector_predict_and_batch_refusal(self, rng):
        df = _df(rng)
        model = KMeans().setK(3).setSeed(1).fit(df)
        p = model.predict(df["features"][0])
        assert isinstance(p, int) and 0 <= p < 3
        with pytest.raises(TypeError):
            model.predict(df["features"][:5])
        with pytest.raises(TypeError):
            jspark.KMeans().setK(3).setSeed(1).fit(df).predict(df["features"][:5])

    @pytest.mark.parametrize("case", ["missing_column", "weight_without_columns"])
    def test_input_errors_match_jax(self, rng, case):
        for mod in (spark, jspark):
            if case == "missing_column":
                with pytest.raises(KeyError):
                    mod.KMeans().setFeaturesCol("nope").fit(_df(rng))
            else:
                with pytest.raises(ValueError, match="weightCol"):
                    mod.KMeans().setK(2).setWeightCol("w").fit(np.zeros((10, 2)))

    def test_save_load_keeps_columns(self, tmp_path, rng):
        x = rng.normal(size=(60, 5))
        km = (KMeans().setK(2).setSeed(1).setFeaturesCol("f").setPredictionCol("lbl")
              .fit({"f": x}))
        km.save(str(tmp_path / "km"))
        lk = spark.KMeansModel.load(str(tmp_path / "km"))
        np.testing.assert_array_equal(lk.clusterCenters(), km.clusterCenters())
        np.testing.assert_array_equal(lk.transform({"f": x})["lbl"],
                                      km.transform({"f": x})["lbl"])


class TestPCACompat:
    def test_fit_transform_matches_jax(self, rng):
        # a spectrum with separated eigenvalues: each component is defined
        # up to its sign alone
        df = {"features": rng.normal(size=(300, 8)) * np.linspace(4.0, 0.5, 8)}
        port = PCA().setK(3).setOutputCol("pca").fit(df)
        ref = jspark.PCA().setK(3).setOutputCol("pca").fit(df)
        assert port.pc.shape == (8, 3) and port.explainedVariance.shape == (3,)
        _components_close(port.pc, ref.pc, 1e-5)
        np.testing.assert_allclose(port.explainedVariance, ref.explainedVariance, atol=1e-6)
        out = port.transform(df)
        assert out["pca"].shape == (300, 3)
        # the projections agree up to each component's sign
        signs = np.sign(np.sum(port.pc * ref.pc, axis=0))
        np.testing.assert_allclose(out["pca"] * signs, ref.transform(df)["pca"], atol=1e-4)

    def test_unset_k_raises(self, rng):
        for mod in (spark, jspark):
            with pytest.raises(ValueError, match="setK"):
                mod.PCA().fit(_df(rng))

    def test_save_load_keeps_columns(self, tmp_path, rng):
        x = rng.normal(size=(60, 5))
        pm = PCA().setK(2).setInputCol("f").setOutputCol("proj").fit({"f": x})
        pm.save(str(tmp_path / "pca"))
        lp = spark.PCAModel.load(str(tmp_path / "pca"))
        np.testing.assert_array_equal(lp.transform({"f": x})["proj"],
                                      pm.transform({"f": x})["proj"])


class TestALSCompat:
    def _both(self, df, build):
        return build(spark).fit(df), build(jspark).fit(df)

    def test_implicit_fit_transform_matches_jax(self, rng):
        df = _ratings_df(rng)
        port, ref = self._both(df, lambda m: (m.ALS().setRank(6).setMaxIter(4).setRegParam(0.1)
                                              .setAlpha(2.0).setImplicitPrefs(True)
                                              .setNumUserBlocks(1)))
        assert port.rank == ref.rank == 6
        assert _pred_rel(port, ref) <= 1e-5
        out, jout = port.transform(df), ref.transform(df)
        np.testing.assert_allclose(out["prediction"], jout["prediction"], rtol=1e-4, atol=1e-4)

    def test_explicit_fit_matches_jax(self, rng):
        df = _ratings_df(rng)
        port, ref = self._both(df, lambda m: (m.ALS().setRank(4).setMaxIter(5)
                                              .setNumUserBlocks(1)))
        assert _pred_rel(port, ref) <= 1e-5

    def test_recommend_both_directions(self, rng):
        df = _ratings_df(rng)
        port, ref = self._both(df, lambda m: (m.ALS().setRank(4).setMaxIter(2)
                                              .setImplicitPrefs(True).setNumUserBlocks(1)))
        ru, su = port.recommendForAllUsers(5, withScores=True)
        ri = port.recommendForAllItems(5)
        assert ru.shape[1] == 5 and ri.shape[1] == 5
        assert ru.max() < port.itemFactors.shape[0] and ri.max() < port.userFactors.shape[0]
        # the sweep equals the model's own top-k bit for bit
        ids, scores = port._inner.recommend_for_all_users(5, with_scores=True)
        np.testing.assert_array_equal(ru, ids)
        np.testing.assert_array_equal(su, scores)
        _, jsu = ref.recommendForAllUsers(5, withScores=True)
        np.testing.assert_allclose(su, jsu, rtol=1e-4, atol=1e-4)

    def test_recommend_subsets_distinct_and_join(self, rng):
        df = _ratings_df(rng)
        model = ALS().setRank(4).setMaxIter(2).setImplicitPrefs(True).fit(df)
        nu = model.userFactors.shape[0]
        all_recs = model.recommendForAllUsers(5)
        subset = {"user": np.array([7, 2, 7, 999, 2])}  # dupes + unseen
        ids, recs = model.recommendForUserSubset(subset, 5)
        np.testing.assert_array_equal(ids, [2, 7])
        np.testing.assert_array_equal(recs, all_recs[[2, 7]])
        ids2, recs2, scores = model.recommendForItemSubset(np.array([1, 3]), 4, withScores=True)
        np.testing.assert_array_equal(ids2, [1, 3])
        assert recs2.shape == scores.shape == (2, 4) and recs2.max() < nu
        ids3, recs3 = model.recommendForUserSubset({"user": np.array([990, 991])}, 5)
        assert len(ids3) == 0 and recs3.shape == (0, 5)

    def test_model_setters_post_fit(self, rng):
        df = _ratings_df(rng)
        model = ALS().setRank(3).setMaxIter(2).fit(df)
        probe = {"user": np.array([0, 999]), "item": np.array([0, 1]),
                 "rating": np.array([1.0, 2.0], np.float32)}
        out = model.transform(probe)
        assert len(out["prediction"]) == 2 and np.isnan(out["prediction"][1])
        model.setColdStartStrategy("drop").setPredictionCol("score")
        out2 = model.transform(probe)
        assert "score" in out2 and len(out2["score"]) == 1 and np.isfinite(out2["score"]).all()
        with pytest.raises(ValueError, match="coldStartStrategy"):
            model.setColdStartStrategy("explode")
        model.setUserCol("u2").setItemCol("i2")
        out3 = model.transform({"u2": probe["user"], "i2": probe["item"]})
        np.testing.assert_allclose(out3["score"], out2["score"])

    def test_default_params_match_jax(self):
        als, jals = ALS(), jspark.ALS()
        for getter in ("getRank", "getMaxIter", "getRegParam", "getNumUserBlocks",
                       "getNumItemBlocks", "getImplicitPrefs", "getAlpha", "getNonnegative",
                       "getCheckpointInterval", "getColdStartStrategy", "getPredictionCol",
                       "getUserCol", "getItemCol", "getRatingCol", "getSeed"):
            assert getattr(als, getter)() == getattr(jals, getter)(), getter

    def test_param_errors_match_jax(self):
        for mod in (spark, jspark):
            with pytest.raises(ValueError):
                mod.ALS().setNumUserBlocks(0)
            with pytest.raises(ValueError):
                mod.ALS().setNumItemBlocks(-1)
            with pytest.raises(ValueError):
                mod.ALS().setColdStartStrategy("bogus")
            with pytest.raises(ValueError):
                mod.ALS().setCheckpointInterval(0)
            with pytest.raises(TypeError):
                mod.ALS().fit(np.zeros((3, 3)))
            assert mod.ALS().setColdStartStrategy("DROP").getColdStartStrategy() == "drop"
            assert mod.ALS().setCheckpointInterval(-1).getCheckpointInterval() == -1

    def test_num_blocks_forwarded_only_when_set(self, rng):
        df = _ratings_df(rng)
        port_config.set_config(device=CPU4)
        als = ALS().setNumBlocks(2)
        assert als.getNumUserBlocks() == 2 and als.getNumItemBlocks() == 2
        s = als.setRank(3).setMaxIter(2).setImplicitPrefs(True).fit(df)._inner.summary
        assert s["num_user_blocks_requested"] == 2 and s["num_item_blocks_requested"] == 2
        assert s["num_user_blocks"] == 2 and s["sharded_factors"]
        s = ALS().setRank(3).setMaxIter(2).setImplicitPrefs(True).fit(df)._inner.summary
        assert "num_user_blocks_requested" not in s and s["num_user_blocks"] == 4

    @pytest.mark.parametrize("layout", ["replicated", "sharded"])
    def test_block_fit_serves_its_live_layout(self, rng, layout):
        """setNumUserBlocks(4) on four ranks: a block fit whose model keeps
        its factors sharded, and recommendForAllUsers runs the ring sweep
        (hops booked on the 2-D layout) without gathering them; the
        answers equal the one-device top-k of the gathered tables and
        the JAX compat block fit's within the near-tie bound."""
        df = _factor_ratings(rng)
        port_config.set_config(device=CPU4, als_item_layout=layout)
        model = (ALS().setRank(4).setMaxIter(3).setImplicitPrefs(True).setAlpha(2.0)
                 .setNumUserBlocks(4).fit(df))
        inner = model._inner
        assert inner.summary["sharded_factors"] and inner._user_factors is None
        assert (inner._sharded_item is not None) == (layout == "sharded")
        hops = tm.family_total("oap_serve_ring_hops_total")
        ids, scores = model.recommendForAllUsers(6, withScores=True)
        assert inner._user_factors is None
        assert tm.family_total("oap_serve_ring_hops_total") - hops == (
            4 if layout == "sharded" else 0)
        ref_ids, ref_s = inner._top_k_scores(inner.user_factors_, inner.item_factors_, 6)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(scores, ref_s)
        jmodel = (jspark.ALS().setRank(4).setMaxIter(3).setImplicitPrefs(True).setAlpha(2.0)
                  .setNumUserBlocks(4).fit(df))
        assert _pred_rel(model, jmodel) <= 1e-5
        _, jscores = jmodel.recommendForAllUsers(6, withScores=True)
        np.testing.assert_allclose(scores, jscores, rtol=1e-4, atol=1e-4)

    def test_cold_start_sets_and_modes_match_jax(self, rng):
        df = _ratings_df(rng)
        keep = df["user"] != 3  # user 3: in range, unseen in training
        train = {k: v[keep] for k, v in df.items()}
        n_items = int(df["item"].max()) + 1
        test = {"user": np.array([0, 3, 1, 40]), "item": np.array([0, 0, n_items + 3, 1]),
                "rating": np.array([1.0, 1.0, 2.0, 3.0], np.float32)}
        for strategy in ("nan", "drop"):
            port, ref = self._both(train, lambda m: (m.ALS().setRank(3).setMaxIter(2)
                                                     .setImplicitPrefs(True).setNumUserBlocks(1)
                                                     .setColdStartStrategy(strategy)))
            np.testing.assert_array_equal(port._seenUsers, ref._seenUsers)
            np.testing.assert_array_equal(port._seenItems, ref._seenItems)
            out, jout = port.transform(test), ref.transform(test)
            np.testing.assert_array_equal(out["user"], jout["user"])
            np.testing.assert_array_equal(np.isnan(out["prediction"]),
                                          np.isnan(jout["prediction"]))
            np.testing.assert_allclose(out["prediction"], jout["prediction"], rtol=1e-4,
                                       atol=1e-4)
        np.testing.assert_array_equal(out["user"], [0])

    def test_cold_start_survives_save_load(self, tmp_path, rng):
        df = _ratings_df(rng)
        keep = df["user"] != 3
        train = {k: v[keep] for k, v in df.items()}
        model = (ALS().setRank(3).setMaxIter(2).setImplicitPrefs(True)
                 .setColdStartStrategy("drop").setPredictionCol("p").fit(train))
        model.save(str(tmp_path / "als"))
        loaded = spark.ALSModel.load(str(tmp_path / "als"))
        test = {"user": np.array([0, 3]), "item": np.array([0, 0]),
                "rating": np.array([1.0, 1.0], np.float32)}
        out = loaded.transform(test)
        np.testing.assert_array_equal(out["user"], [0])
        assert "p" in out
        np.testing.assert_array_equal(out["p"], model.transform(test)["p"])

    def test_checkpoint_interval_and_prediction_col(self, rng):
        df = _ratings_df(rng)
        model = (ALS().setCheckpointInterval(5).setRank(3).setMaxIter(2).setImplicitPrefs(True)
                 .setPredictionCol("score").fit(df))
        out = model.transform(df)
        assert "score" in out and "prediction" not in out
        assert model.userFactors.shape[1] == 3

    def test_nonnegative_builder(self, rng):
        df = _ratings_df(rng, nu=20, ni=15)
        port = ALS().setRank(3).setMaxIter(3).setNonnegative(True).fit(df)
        ref = jspark.ALS().setRank(3).setMaxIter(3).setNonnegative(True).fit(df)
        assert (port.userFactors >= 0).all() and (port.itemFactors >= 0).all()
        np.testing.assert_allclose(port.userFactors, ref.userFactors, rtol=1e-5, atol=1e-6)


class TestJaxSavedModels:
    """The three models' files share the JAX package's on-disk format: a
    model the JAX compat layer saved loads through the port's compat
    ``load`` and answers as the JAX model does."""

    def test_kmeans_and_pca(self, tmp_path, rng):
        df = _df(rng, d=5)
        jk = jspark.KMeans().setK(3).setSeed(1).setPredictionCol("lbl").fit(df)
        jk.save(str(tmp_path / "km"))
        pk = spark.KMeansModel.load(str(tmp_path / "km"))
        np.testing.assert_array_equal(pk.clusterCenters(), jk.clusterCenters())
        np.testing.assert_array_equal(pk.transform(df)["lbl"], jk.transform(df)["lbl"])
        jp = jspark.PCA().setK(2).setOutputCol("proj").fit(df)
        jp.save(str(tmp_path / "pca"))
        pp = spark.PCAModel.load(str(tmp_path / "pca"))
        np.testing.assert_array_equal(pp.pc, jp.pc)
        np.testing.assert_allclose(pp.transform(df)["proj"], jp.transform(df)["proj"],
                                   rtol=1e-5, atol=1e-5)

    def test_als_keeps_cold_start(self, tmp_path, rng):
        df = _ratings_df(rng)
        keep = df["user"] != 3
        train = {k: v[keep] for k, v in df.items()}
        ja = (jspark.ALS().setRank(3).setMaxIter(2).setImplicitPrefs(True)
              .setColdStartStrategy("drop").fit(train))
        ja.save(str(tmp_path / "als"))
        pa = spark.ALSModel.load(str(tmp_path / "als"))
        assert pa.getColdStartStrategy() == "drop"
        test = {"user": np.array([0, 3, 1]), "item": np.array([0, 0, 2]),
                "rating": np.array([1.0, 1.0, 1.0], np.float32)}
        out, jout = pa.transform(test), ja.transform(test)
        np.testing.assert_array_equal(out["user"], jout["user"])
        np.testing.assert_allclose(out["prediction"], jout["prediction"], rtol=1e-5, atol=1e-6)


class TestEvaluators:
    @pytest.mark.parametrize("dist", ["squaredEuclidean", "cosine"])
    def test_clustering_evaluator_matches_jax(self, rng, dist):
        x = rng.normal(size=(80, 5)) + 2.0
        labels = rng.integers(0, 3, 80)
        df = {"features": x, "prediction": labels}
        got = ClusteringEvaluator().setDistanceMeasure(dist).evaluate(df)
        want = jcompat.ClusteringEvaluator().setDistanceMeasure(dist).evaluate(df)
        np.testing.assert_allclose(got, want, atol=1e-12)
        assert ClusteringEvaluator().isLargerBetter()

    def test_clustering_evaluator_on_a_fit(self, rng):
        proto = rng.normal(size=(3, 4)) * 6
        x = proto[rng.integers(3, size=300)] + 0.05 * rng.normal(size=(300, 4))
        model = KMeans().setK(3).setSeed(1).fit({"features": x})
        sil = ClusteringEvaluator().evaluate(model.transform({"features": x}))
        assert sil > 0.95

    def test_clustering_evaluator_edge_cases(self):
        got = ClusteringEvaluator().evaluate(
            {"features": np.zeros((4, 3)), "prediction": np.array([0, 0, 1, 1])})
        assert got == 0.0
        df = {"features": np.zeros((4, 2)), "prediction": np.zeros(4, int)}
        with pytest.raises(ValueError, match="2 clusters"):
            ClusteringEvaluator().evaluate(df)
        with pytest.raises(ValueError, match="distanceMeasure"):
            ClusteringEvaluator().setDistanceMeasure("manhattan").evaluate(df)

    @pytest.mark.parametrize("metric", ["rmse", "mse", "mae", "r2", "var"])
    def test_regression_evaluator_matches_jax(self, rng, metric):
        label = rng.normal(size=50)
        df = {"rating": label, "prediction": label + rng.normal(size=50) * 0.1}
        ev = RegressionEvaluator(metricName=metric, labelCol="rating")
        jev = jcompat.RegressionEvaluator(metricName=metric, labelCol="rating")
        np.testing.assert_allclose(ev.evaluate(df), jev.evaluate(df), atol=1e-12)
        assert ev.isLargerBetter() == jev.isLargerBetter()

    def test_regression_evaluator_errors(self, rng):
        df = {"rating": np.ones(3), "prediction": np.ones(3)}
        with pytest.raises(ValueError):
            RegressionEvaluator(metricName="rmsle", labelCol="rating").evaluate(df)
        assert np.isnan(RegressionEvaluator(labelCol="rating").evaluate(
            {"rating": np.zeros(0), "prediction": np.zeros(0)}))


class TestPipeline:
    def _stages(self, mod):
        return [mod.PCA().setK(3).setInputCol("features").setOutputCol("pca"),
                mod.KMeans().setK(3).setSeed(1).setInitMode("random").setFeaturesCol("pca")]

    def test_pca_then_kmeans_matches_jax(self, rng):
        df = _df(rng, d=8)
        out = Pipeline(stages=self._stages(spark)).fit(df).transform(df)
        jout = jpipeline.Pipeline(stages=self._stages(jspark)).fit(df).transform(df)
        assert out["pca"].shape == (300, 3) and len(np.unique(out["prediction"])) == 3
        # the same partition (labels up to renaming)
        pairs = set(zip(out["prediction"].tolist(), jout["prediction"].tolist()))
        assert len(pairs) == 3

    def test_transformer_stage_and_bad_stage(self, rng):
        df = _df(rng)
        km = KMeans().setK(3).setSeed(1).fit(df)
        assert "prediction" in Pipeline(stages=[km]).fit(df).transform(df)
        with pytest.raises(TypeError, match="neither fit nor transform"):
            Pipeline(stages=[object()]).fit(df)
        p = Pipeline().setStages([km])
        assert p.getStages() == [km]

    def test_param_grid_matches_jax(self):
        grid = (ParamGridBuilder().addGrid("regParam", [0.1, 1.0]).addGrid("rank", [2, 3])
                .baseOn({"maxIter": 4}).build())
        jgrid = (jpipeline.ParamGridBuilder().addGrid("regParam", [0.1, 1.0])
                 .addGrid("rank", [2, 3]).baseOn({"maxIter": 4}).build())
        assert grid == jgrid and len(grid) == 4
        assert ParamGridBuilder().build() == [{}]

    def test_pipeline_model_roundtrip_bit_equal(self, rng, tmp_path):
        df = _df(rng, d=8)
        model = Pipeline(stages=self._stages(spark)).fit(df)
        model.save(str(tmp_path / "pm"))
        loaded = PipelineModel.load(str(tmp_path / "pm"))
        a, b = model.transform(df), loaded.transform(df)
        np.testing.assert_array_equal(a["pca"], b["pca"])
        np.testing.assert_array_equal(a["prediction"], b["prediction"])

    def test_unfitted_pipeline_roundtrip(self, rng, tmp_path):
        Pipeline(stages=self._stages(spark)).save(str(tmp_path / "p"))
        with open(tmp_path / "p" / "pipeline_metadata.json") as f:
            assert {s["module"] for s in json.load(f)["stages"]} == {
                "oap_mllib_tpu_torch.compat.spark"}
        stages = Pipeline.load(str(tmp_path / "p")).getStages()
        assert stages[0].getK() == 3 and stages[1].getSeed() == 1
        df = _df(rng)
        assert Pipeline(stages=stages).fit(df).transform(df)["pca"].shape[1] == 3

    def test_jax_manifest_is_refused_not_imported(self, rng, tmp_path):
        """A manifest the JAX package wrote names its own classes: the port
        refuses it with the JAX package's error type and message shape,
        as the JAX package refuses a foreign module, and loads nothing."""
        df = _df(rng)
        jpipeline.Pipeline(stages=[jspark.KMeans().setK(2).setSeed(1)]).fit(df).save(
            str(tmp_path / "jax_pm"))
        with pytest.raises(ValueError) as port_err:
            PipelineModel.load(str(tmp_path / "jax_pm"))
        assert str(port_err.value) == (
            "refusing to load stage class from 'oap_mllib_tpu.compat.spark'")
        d = tmp_path / "evil"
        os.makedirs(d / "stage_00_X")
        with open(d / "pipeline_metadata.json", "w") as f:
            json.dump({"type": "PipelineModel", "version": 1,
                       "stages": [{"dir": "stage_00_X", "module": "os", "cls": "system"}]}, f)
        with pytest.raises(ValueError) as jax_err:
            jpipeline.PipelineModel.load(str(d))
        with pytest.raises(ValueError, match="refusing"):
            PipelineModel.load(str(d))
        assert type(port_err.value) is type(jax_err.value)
        assert str(jax_err.value) == "refusing to load stage class from 'os'"

    def test_manifest_type_mismatch_raises(self, rng, tmp_path):
        df = _df(rng)
        Pipeline(stages=[KMeans().setK(2).setSeed(1)]).fit(df).save(str(tmp_path / "pm"))
        with pytest.raises(ValueError, match="not a CrossValidatorModel"):
            pipeline.CrossValidatorModel.load(str(tmp_path / "pm"))


class TestTuners:
    def _cv(self, mod, metric="rmse", folds=3):
        return mod.CrossValidator(
            estimator=mod.ALS().setRank(4).setMaxIter(4).setColdStartStrategy("drop")
            .setNumUserBlocks(1),
            estimatorParamMaps=mod.ParamGridBuilder().addGrid("regParam", [0.05, 50.0]).build(),
            evaluator=mod.RegressionEvaluator(metricName=metric, labelCol="rating"),
            numFolds=folds, seed=1)

    @pytest.mark.parametrize("metric", ["rmse", "r2"])
    def test_cross_validator_matches_jax(self, rng, metric):
        df = _factor_ratings(rng)
        model = self._cv(pcompat, metric).fit(df)
        jmodel = self._cv(jcompat, metric).fit(df)
        assert model.bestParams == jmodel.bestParams == {"regParam": 0.05}
        np.testing.assert_allclose(model.avgMetrics, jmodel.avgMetrics, rtol=1e-3)
        assert np.isfinite(model.transform(df)["prediction"]).all()

    def test_train_validation_split_matches_jax(self, rng):
        df = _factor_ratings(rng)

        def tvs(mod):
            return mod.TrainValidationSplit(
                estimator=mod.ALS().setRank(4).setMaxIter(4).setColdStartStrategy("drop")
                .setNumUserBlocks(1),
                estimatorParamMaps=mod.ParamGridBuilder().addGrid("regParam", [0.05, 50.0])
                .build(),
                evaluator=mod.RegressionEvaluator(metricName="rmse", labelCol="rating"),
                trainRatio=0.8, seed=1)

        model, jmodel = tvs(pcompat).fit(df), tvs(jcompat).fit(df)
        assert model.bestParams == jmodel.bestParams == {"regParam": 0.05}
        np.testing.assert_allclose(model.validationMetrics, jmodel.validationMetrics, rtol=1e-3)

    def test_tuner_errors_match_jax(self, rng):
        df = _factor_ratings(rng)
        for mod in (pcompat, jcompat):
            with pytest.raises(ValueError, match="regParm"):
                mod.CrossValidator(estimator=mod.ALS(), estimatorParamMaps=[{"regParm": 0.1}],
                                   evaluator=mod.RegressionEvaluator(labelCol="rating")).fit(df)
            with pytest.raises(ValueError, match="empty"):
                mod.CrossValidator(
                    estimator=mod.ALS(),
                    estimatorParamMaps=mod.ParamGridBuilder().addGrid("regParam", []).build(),
                    evaluator=mod.RegressionEvaluator(labelCol="rating")).fit(df)
            with pytest.raises(ValueError, match="estimator and evaluator"):
                mod.CrossValidator().fit(df)
            with pytest.raises(ValueError, match="numFolds"):
                mod.CrossValidator(estimator=mod.ALS(), numFolds=1,
                                   evaluator=mod.RegressionEvaluator(labelCol="rating")).fit(df)
            with pytest.raises(TypeError, match="dict DataFrame"):
                mod.CrossValidator(estimator=mod.ALS(),
                                   evaluator=mod.RegressionEvaluator(labelCol="rating")
                                   ).fit(np.zeros((10, 3)))
            with pytest.raises(ValueError, match="trainRatio"):
                mod.TrainValidationSplit(estimator=mod.ALS(), trainRatio=1.0,
                                         evaluator=mod.RegressionEvaluator(labelCol="rating")
                                         ).fit(df)

    def test_nan_metric_raises_not_wins(self, rng):
        df = {k: np.asarray(v).copy() for k, v in _factor_ratings(rng, nu=15, ni=12).items()}
        df["user"][0] = 999
        cv = CrossValidator(
            estimator=ALS().setRank(3).setMaxIter(2),
            estimatorParamMaps=ParamGridBuilder().addGrid("regParam", [0.05, 0.5]).build(),
            evaluator=RegressionEvaluator(labelCol="rating"), numFolds=5, seed=0)
        with pytest.raises(ValueError, match="NaN"):
            cv.fit(df)

    def test_cv_and_tvs_model_roundtrip(self, rng, tmp_path):
        df = _factor_ratings(rng)
        model = self._cv(pcompat, folds=2).fit(df)
        model.save(str(tmp_path / "cv"))
        loaded = pipeline.CrossValidatorModel.load(str(tmp_path / "cv"))
        assert loaded.bestParams == model.bestParams
        np.testing.assert_allclose(loaded.avgMetrics, model.avgMetrics)
        probe = {"user": np.array([0, 999]), "item": np.array([0, 1]),
                 "rating": np.array([1.0, 2.0], np.float32)}
        assert len(loaded.transform(probe)["prediction"]) == 1
        tvs = TrainValidationSplit(
            estimator=ALS().setRank(3).setMaxIter(3).setColdStartStrategy("drop"),
            estimatorParamMaps=ParamGridBuilder().addGrid("regParam", [0.05, 50.0]).build(),
            evaluator=RegressionEvaluator(metricName="rmse", labelCol="rating"),
            trainRatio=0.8, seed=1).fit(df)
        tvs.save(str(tmp_path / "tvs"))
        back = pipeline.TrainValidationSplitModel.load(str(tmp_path / "tvs"))
        np.testing.assert_array_equal(back.transform(df)["prediction"],
                                      tvs.transform(df)["prediction"])


class TestNoFallback:
    def test_compat_fits_need_the_card_by_default(self, rng):
        """With ``Config.device`` at its default (the card), a compat fit
        and the sweep of a sharded model raise here: nothing falls back
        to the CPU."""
        port_config.reset_config()
        df = _ratings_df(rng)
        for est in (KMeans().setK(2), PCA().setK(2)):
            with pytest.raises(RuntimeError, match="cuda"):
                est.fit(_df(rng))
        with pytest.raises(RuntimeError, match="cuda"):
            ALS().setRank(3).fit(df)
        from oap_mllib_tpu_torch.serving import sweep

        with pytest.raises(RuntimeError, match="cuda"):
            sweep.shard_factors_local(np.zeros((8, 3), np.float32))
