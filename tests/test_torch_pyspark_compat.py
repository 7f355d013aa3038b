"""The port's PySpark adapter (``compat/pyspark.py``) against the JAX
package's, on the CPU: the mock-DataFrame half of the JAX package's
``tests/test_pyspark_compat.py``, case by case.

Every test runs on a mock implementing exactly the duck-typed DataFrame
surface the adapter is written to (select / collect / columns /
sparkSession.createDataFrame, and rdd.mapPartitionsWithIndex for the
partition-wise ingestion) and, through the ``session`` fixture, on a
real local SparkSession when pyspark is importable; without pyspark the
real plane skips.  The flows mirror the reference's PySpark examples
verbatim-minus-import.  Where a case fits, the JAX package's adapter
runs the same flow on the same mock frame (inputs from
``np.random.default_rng``): K-Means labels equal (the same partition,
so the silhouette within 1e-12), PCA projections within 1e-4 up to
each component's sign, ALS predictions within 1e-4 (one device on both
sides, ``numUserBlocks=1``), dropped rows identical.  The port runs on
the CPU because ``Config.device`` is set to ``"cpu"``.
"""

import numpy as np
import pytest

from oap_mllib_tpu.compat import pyspark as jpyspark
from oap_mllib_tpu_torch import config as port_config
from oap_mllib_tpu_torch.compat.pyspark import (
    ALS,
    ClusteringEvaluator,
    KMeans,
    PCA,
    RegressionEvaluator,
)


@pytest.fixture(autouse=True)
def _cpu():
    port_config.reset_config()
    port_config.set_config(device="cpu")
    yield
    port_config.reset_config()


class FakeSession:
    def createDataFrame(self, data, schema):
        cols = {name: [row[j] for row in data] for j, name in enumerate(schema)}
        return FakeDataFrame(cols, self)


class FakeDataFrame:
    """The duck-typed surface the adapter touches — nothing more."""

    def __init__(self, columns: dict, session: FakeSession):
        self._cols = columns
        self._session = session

    @property
    def columns(self):
        return list(self._cols)

    @property
    def sparkSession(self):
        return self._session

    def select(self, *names):
        return FakeDataFrame({n: self._cols[n] for n in names}, self._session)

    def collect(self):
        names = list(self._cols)
        n = len(self._cols[names[0]]) if names else 0
        return [tuple(self._cols[c][i] for c in names) for i in range(n)]


class FakeVector:
    """Stands in for pyspark.ml.linalg.DenseVector (toArray duck-type)."""

    def __init__(self, values):
        self._v = np.asarray(values, np.float64)

    def toArray(self):
        return self._v


_REAL = {"sess": None, "tried": False}


def _real_spark():
    """Cached local SparkSession, or None when pyspark is absent (one
    JVM for the whole test module; never torn down mid-run)."""
    if not _REAL["tried"]:
        _REAL["tried"] = True
        try:
            from pyspark.sql import SparkSession
        except ImportError:
            return None
        _REAL["sess"] = (
            SparkSession.builder.master("local[2]")
            .appName("oap-mllib-tpu-torch-adapter-tests")
            .config("spark.ui.enabled", "false")
            .config("spark.ui.showConsoleProgress", "false")
            .getOrCreate()
        )
    return _REAL["sess"]


@pytest.fixture(params=["mock", "spark"])
def session(request):
    if request.param == "mock":
        return FakeSession()
    spark = _real_spark()
    if spark is None:
        pytest.skip("pyspark not installed: the real-Spark plane runs where it is")
    return spark


def _dense(session, values):
    """A dense vector cell: ml.linalg on the real plane, the toArray
    duck-type on the mock."""
    if isinstance(session, FakeSession):
        return FakeVector(values)
    from pyspark.ml.linalg import Vectors

    return Vectors.dense([float(v) for v in values])


def _df(session, types=None, **cols):
    """Build a DataFrame on either plane.  ``types`` maps column name ->
    {"double", "bigint", "array<double>"} and is REQUIRED on the real
    plane when a column is empty (Spark cannot infer a schema from an
    empty dataset; the mock never infers)."""
    n = len(next(iter(cols.values())))
    assert all(len(v) == n for v in cols.values())
    if isinstance(session, FakeSession):
        return FakeDataFrame({k: list(v) for k, v in cols.items()}, session)
    names = list(cols)
    rows = [tuple(cols[c][i] for c in names) for i in range(n)]
    if n == 0 or types:
        from pyspark.sql.types import (
            ArrayType,
            DoubleType,
            LongType,
            StructField,
            StructType,
        )

        tmap = {
            "double": DoubleType(),
            "bigint": LongType(),
            "array<double>": ArrayType(DoubleType()),
        }
        fields = [
            StructField(c, tmap[(types or {})[c]], True) for c in names
        ]
        return session.createDataFrame(rows, StructType(fields))
    return session.createDataFrame(rows, names)


class TestKMeansAdapter:
    def test_kmeans_example_flow(self, rng, session):
        """kmeans-pyspark.py verbatim-minus-import: fit -> transform ->
        ClusteringEvaluator.evaluate."""
        proto = rng.normal(size=(2, 5)) * 8
        x = proto[rng.integers(2, size=200)] + 0.1 * rng.normal(size=(200, 5))
        dataset = _df(session, features=[list(row) for row in x])

        kmeans = KMeans().setK(2).setSeed(1)
        model = kmeans.fit(dataset)
        predictions = model.transform(dataset)
        assert predictions.columns == ["features", "prediction"]

        evaluator = ClusteringEvaluator()
        silhouette = evaluator.evaluate(predictions)
        assert silhouette > 0.95  # tight separated blobs

        centers = model.clusterCenters()
        assert np.asarray(centers).shape == (2, 5)

    def test_vector_column_duck_typing(self, rng, session):
        """Features as toArray() vectors (the real ml.linalg case)."""
        x = rng.normal(size=(50, 3))
        dataset = _df(session, features=[_dense(session, r) for r in x])
        model = KMeans(k=3, seed=2).fit(dataset)
        out = model.transform(dataset)
        assert len(out.collect()) == 50
        assert model.predict(FakeVector(x[0])) in (0, 1, 2)

    def test_empty_input_transform(self, rng, session):
        """An empty split (randomSplit can produce one) transforms to an
        empty DataFrame with the prediction column — pyspark.ml
        semantics, not a shape crash."""
        x = rng.normal(size=(40, 3))
        dataset = _df(session, features=[list(r) for r in x])
        model = KMeans(k=2, seed=1).fit(dataset)
        empty = _df(session, types={"features": "array<double>"}, features=[])
        out = model.transform(empty)
        assert out.collect() == []
        assert out.columns == ["features", "prediction"]
        pca = PCA(k=2, inputCol="features", outputCol="pc").fit(dataset)
        assert pca.transform(empty).collect() == []

    def test_retransform_replaces_prediction_column(self, rng, session):
        """Transforming an already-scored DataFrame must REPLACE the
        prediction column (withColumn semantics), not append a
        duplicate name."""
        x = rng.normal(size=(40, 3))
        dataset = _df(session, features=[list(r) for r in x])
        model = KMeans(k=2, seed=1).fit(dataset)
        once = model.transform(dataset)
        twice = model.transform(once)
        assert twice.columns == ["features", "prediction"]
        assert [r[-1] for r in twice.collect()] == [
            r[-1] for r in once.collect()
        ]
        # withColumn replaces IN PLACE: a reordered frame keeps the
        # prediction column at its original position
        reordered = _df(
            session,
            prediction=[0] * 40,
            features=[list(r) for r in x],
        )
        out = model.transform(reordered)
        assert out.columns == ["prediction", "features"]
        assert [r[0] for r in out.collect()] == [
            r[-1] for r in once.collect()
        ]

    def test_weight_col(self, rng, session):
        x = rng.normal(size=(60, 4))
        w = np.ones(60)
        dataset = _df(
            session, features=[list(r) for r in x], w=list(w)
        )
        model = KMeans(k=2, seed=1, weightCol="w").fit(dataset)
        assert model.summary.accelerated


class FakePartitionedDataFrame(FakeDataFrame):
    """FakeDataFrame + the rdd.mapPartitionsWithIndex surface the
    multi-process ingestion uses; records which partitions the filter
    KEPT (returned rows from)."""

    def __init__(self, columns, session, n_parts, kept=None):
        super().__init__(columns, session)
        self._nparts = n_parts
        self.kept = kept if kept is not None else []

    def select(self, *names):
        return FakePartitionedDataFrame(
            {n: self._cols[n] for n in names}, self._session,
            self._nparts, self.kept,
        )

    @property
    def rdd(self):
        rows = self.collect()
        parts = np.array_split(np.arange(len(rows)), self._nparts)
        kept = self.kept

        class _Res:
            def __init__(self, out):
                self._out = out

            def collect(self):
                return self._out

        class _RDD:
            def mapPartitionsWithIndex(self, f):
                out = []
                for pid, idx in enumerate(parts):
                    got = list(f(pid, iter([rows[j] for j in idx])))
                    if got:
                        kept.append(pid)
                    out.extend(got)
                return _Res(out)

        return _RDD()


class TestPartitionedIngestion:
    """The multi-process ingestion helper in isolation: process r must
    keep exactly partitions p % world == r, in partition order."""

    def test_keeps_only_local_partitions(self, session):
        if not isinstance(session, FakeSession):
            pytest.skip("partition-filter accounting is mock-only")
        from oap_mllib_tpu_torch.compat.pyspark import _collect_local_partitions

        df = FakePartitionedDataFrame(
            {"v": list(range(100)), "w": list(range(100, 200))},
            session, n_parts=5,
        )
        rows, cols = _collect_local_partitions(df.select("v"), rank=1,
                                               world=2)
        assert df.kept == [1, 3]  # pid % 2 == 1 only
        assert cols == ["v"]
        assert [r[0] for r in rows] == list(range(20, 40)) + list(range(60, 80))

    def test_union_over_ranks_covers_all_rows_once(self, session):
        if not isinstance(session, FakeSession):
            pytest.skip("partition-filter accounting is mock-only")
        from oap_mllib_tpu_torch.compat.pyspark import _collect_local_partitions

        got = []
        for rank in range(3):
            df = FakePartitionedDataFrame(
                {"v": list(range(50))}, session, n_parts=7
            )
            rows, _ = _collect_local_partitions(df, rank=rank, world=3)
            got.extend(r[0] for r in rows)
        assert sorted(got) == list(range(50))

    def test_zero_partition_rank_raises(self, session):
        """Fewer partitions than world: the starved rank must get a
        clear repartition error, not a shape crash (in a real world the
        check is an allgather so every rank raises together)."""
        if not isinstance(session, FakeSession):
            pytest.skip("partition-filter accounting is mock-only")
        from oap_mllib_tpu_torch.compat.pyspark import _collect_local_partitions

        df = FakePartitionedDataFrame(
            {"v": list(range(10))}, session, n_parts=2
        )
        with pytest.raises(ValueError, match="zero partitions"):
            _collect_local_partitions(df, rank=2, world=3)

    def test_no_rdd_surface_raises(self, session):
        if not isinstance(session, FakeSession):
            pytest.skip("surface-check is mock-only")
        from oap_mllib_tpu_torch.compat.pyspark import _collect_local_partitions

        df = _df(session, v=[1, 2, 3])
        with pytest.raises(TypeError, match="mapPartitionsWithIndex"):
            _collect_local_partitions(df, rank=0, world=2)


class TestAdapterFuzz:
    """Randomized-schema fuzz: for every draw the DataFrame plane must
    produce exactly the dict plane's numbers on the same data — shuffled
    column orders, bystander columns, nan/drop cold-start, and a
    re-transform cycle.  Runs against the mock always and against a real
    SparkSession in CI (the dual-plane ``session`` fixture)."""

    def test_als_matches_dict_plane_fuzz(self, rng, session):
        from oap_mllib_tpu_torch.compat import spark as dictplane

        for trial in range(4):
            nu = int(rng.integers(8, 30))
            ni = int(rng.integers(6, 24))
            nnz = int(rng.integers(60, 300))
            u = rng.integers(0, nu, nnz)
            i = rng.integers(0, ni, nnz)
            r = (rng.random(nnz) * 4 + 1).astype(np.float32)
            strategy = ["nan", "drop"][trial % 2]

            cols = {
                "userId": [int(v) for v in u],
                "movieId": [int(v) for v in i],
                "rating": [float(v) for v in r],
                "bystander": [float(v) for v in rng.random(nnz)],
            }
            names = list(cols)
            rng.shuffle(names)  # random column order
            df = _df(session, **{n: cols[n] for n in names})

            kw = dict(rank=3, maxIter=2, regParam=0.1, seed=trial,
                      userCol="userId", itemCol="movieId",
                      ratingCol="rating", coldStartStrategy=strategy)
            model = ALS(**kw).fit(df)
            oracle = (
                dictplane.ALS().setRank(3).setMaxIter(2).setRegParam(0.1)
                .setSeed(trial).setUserCol("userId").setItemCol("movieId")
                .setRatingCol("rating").setColdStartStrategy(strategy)
                .fit({k: np.asarray(v) for k, v in cols.items()})
            )

            # probe includes unseen ids so both strategies do real work
            pu = np.concatenate([u[:10], [nu + 5]])
            pi = np.concatenate([i[:10], [0]])
            probe_cols = {
                "userId": [int(v) for v in pu],
                "movieId": [int(v) for v in pi],
                "rating": [1.0] * len(pu),
            }
            probe = _df(session, **probe_cols)
            out_rows = model.transform(probe).collect()
            want = oracle.transform(
                {k: np.asarray(v) for k, v in probe_cols.items()}
            )
            got = np.asarray([row[-1] for row in out_rows], np.float64)
            np.testing.assert_allclose(
                got, np.asarray(want["prediction"], np.float64),
                atol=1e-5, rtol=1e-5,
                err_msg=f"trial {trial} strategy={strategy} order={names}",
            )
            if strategy == "drop":
                # the unseen probe user must actually be dropped
                assert len(out_rows) == len(pu) - 1

    def test_kmeans_matches_dict_plane_fuzz(self, rng, session):
        from oap_mllib_tpu_torch.compat import spark as dictplane

        for trial in range(3):
            n = int(rng.integers(40, 120))
            d = int(rng.integers(3, 8))
            k = int(rng.integers(2, 5))
            x = rng.normal(size=(n, d))
            cols = {
                "noise": [float(v) for v in rng.random(n)],
                "features": [list(row) for row in x],
            }
            df = _df(session, **cols)
            model = KMeans(k=k, seed=trial, maxIter=5).fit(df)
            oracle = (
                dictplane.KMeans().setK(k).setSeed(trial).setMaxIter(5)
                .fit({"features": x})
            )
            got = [row[-1] for row in model.transform(df).collect()]
            want = oracle.transform({"features": x})["prediction"]
            np.testing.assert_array_equal(
                got, want, err_msg=f"trial {trial} n={n} d={d} k={k}"
            )
            # a second transform over the scored frame must be stable
            again = [
                row[-1] for row in model.transform(model.transform(df))
                .collect()
            ]
            np.testing.assert_array_equal(again, want)


class TestPipelineAdapter:
    def test_pca_kmeans_pipeline_over_dataframes(self, rng, session):
        """Pipeline is data-plane agnostic: the same class chains the
        DataFrame adapters (PCA features feed K-Means through the
        adapter's transform DataFrames)."""
        from oap_mllib_tpu_torch.compat.pyspark import Pipeline

        proto = rng.normal(size=(3, 6)) * 8
        x = proto[rng.integers(3, size=150)] + 0.1 * rng.normal(size=(150, 6))
        dataset = _df(session, features=[list(r) for r in x])
        pipe = Pipeline(stages=[
            PCA(k=3, inputCol="features", outputCol="pca"),
            KMeans(k=3, seed=1, featuresCol="pca"),
        ])
        model = pipe.fit(dataset)
        out = model.transform(dataset)
        assert out.columns == ["features", "pca", "prediction"]
        assert len(np.unique([r[2] for r in out.collect()])) == 3


class TestPCAAdapter:
    def test_pca_example_flow(self, rng, session):
        """pca-pyspark.py verbatim-minus-import: keyword constructor,
        fit, pc / explainedVariance, transform appends outputCol."""
        x = rng.normal(size=(300, 6)) @ rng.normal(size=(6, 6))
        dataset = _df(session, features=[list(r) for r in x])
        pca = PCA(k=3, inputCol="features", outputCol="pcaFeatures")
        model = pca.fit(dataset)
        assert np.asarray(model.pc).shape == (6, 3)
        assert len(np.asarray(model.explainedVariance)) == 3
        out = model.transform(dataset)
        assert out.columns == ["features", "pcaFeatures"]
        first = out.collect()[0]
        assert len(first[1]) == 3  # projected vector
        # projection parity vs direct NumPy (no centering — Spark parity,
        # models/pca.py transform contract)
        ref = x[0] @ np.asarray(model.pc)
        np.testing.assert_allclose(np.asarray(first[1]), ref, atol=1e-3)


class TestALSAdapter:
    def _ratings_df(self, rng, session, n=1500, nu=40, ni=30):
        u = rng.integers(0, nu, n)
        i = rng.integers(0, ni, n)
        xt = rng.normal(size=(nu, 3))
        yt = rng.normal(size=(ni, 3))
        r = (xt[u] * yt[i]).sum(1) + 0.05 * rng.normal(size=n)
        return (
            _df(
                session,
                userId=[int(v) for v in u],
                movieId=[int(v) for v in i],
                rating=[float(v) for v in r],
            ),
            u, i, r,
        )

    def test_als_example_flow(self, rng, session):
        """als-pyspark.py verbatim-minus-import: keyword constructor
        (userCol/itemCol/ratingCol/coldStartStrategy), getters used by
        the example's print, fit, transform, RegressionEvaluator."""
        training, u, i, r = self._ratings_df(rng, session)
        als = ALS(rank=5, maxIter=5, regParam=0.01,
                  userCol="userId", itemCol="movieId", ratingCol="rating",
                  coldStartStrategy="drop")
        # the example prints every one of these (als-pyspark.py:55-57)
        assert als.getImplicitPrefs() is False
        assert als.getRank() == 5 and als.getMaxIter() == 5
        assert als.getRegParam() == 0.01 and als.getAlpha() == 1.0
        assert als.getSeed() == 0
        model = als.fit(training)

        predictions = model.transform(training)
        assert predictions.columns == [
            "userId", "movieId", "rating", "prediction"
        ]
        evaluator = RegressionEvaluator(metricName="rmse", labelCol="rating",
                                        predictionCol="prediction")
        rmse = evaluator.evaluate(predictions)
        assert rmse < 0.5  # low-rank synthetic data fits well

        assert model.rank == 5
        assert model.userFactors.shape[1] == 5

    def test_cold_start_drop_removes_unseen_rows(self, rng, session):
        training, u, i, r = self._ratings_df(rng, session, nu=20, ni=15)
        als = ALS(rank=3, maxIter=2, userCol="userId", itemCol="movieId",
                  ratingCol="rating", coldStartStrategy="drop")
        model = als.fit(training)
        test = _df(
            session,
            userId=[0, 1, 999],  # 999 unseen
            movieId=[0, 1, 0],
            rating=[1.0, 2.0, 3.0],
        )
        out = model.transform(test)
        rows = out.collect()
        assert len(rows) == 2  # unseen user dropped
        assert all(np.isfinite(row[3]) for row in rows)

    def test_cold_start_nan_keeps_rows(self, rng, session):
        training, *_ = self._ratings_df(rng, session, nu=20, ni=15)
        model = ALS(rank=3, maxIter=2, userCol="userId", itemCol="movieId",
                    ratingCol="rating").fit(training)
        test = _df(session, userId=[0, 999], movieId=[0, 0],
                   rating=[1.0, 2.0])
        rows = model.transform(test).collect()
        assert len(rows) == 2
        assert np.isfinite(rows[0][3]) and np.isnan(rows[1][3])

    def test_cold_start_drop_all_rows(self, rng, session):
        """Every pair cold: transform must return an EMPTY DataFrame, not
        raise (on real Spark the explicitly-typed output schema is what
        makes the empty createDataFrame legal)."""
        training, *_ = self._ratings_df(rng, session, nu=20, ni=15)
        model = ALS(rank=3, maxIter=2, userCol="userId", itemCol="movieId",
                    ratingCol="rating", coldStartStrategy="drop").fit(training)
        test = _df(session, userId=[900, 901], movieId=[0, 1],
                   rating=[1.0, 2.0])
        out = model.transform(test)
        assert out.collect() == []
        assert out.columns == ["userId", "movieId", "rating", "prediction"]

    def test_cross_validator_over_dataframes(self, rng, session):
        """The common pyspark tuning flow is drop-in too: CrossValidator
        accepts a Spark DataFrame (one collect, splits on the dict
        plane) and refits the winner on the ORIGINAL frame so bestModel
        transforms DataFrames."""
        from oap_mllib_tpu_torch.compat.pipeline import (
            CrossValidator,
            ParamGridBuilder,
        )

        training, *_ = self._ratings_df(rng, session)
        cv = CrossValidator(
            estimator=ALS(rank=3, maxIter=3, userCol="userId",
                          itemCol="movieId", ratingCol="rating",
                          coldStartStrategy="drop"),
            estimatorParamMaps=(ParamGridBuilder()
                                .addGrid("regParam", [0.05, 50.0])
                                .build()),
            evaluator=RegressionEvaluator(metricName="rmse",
                                          labelCol="rating"),
            numFolds=2, seed=1,
        )
        model = cv.fit(training)
        assert model.bestParams == {"regParam": 0.05}
        assert model.avgMetrics[0] < model.avgMetrics[1]
        out = model.transform(training)  # DataFrame in, DataFrame out
        assert "prediction" in out.columns
        preds = [r[-1] for r in out.collect()]
        assert np.isfinite(preds).all()

    def test_cv_model_roundtrip_both_planes(self, rng, session, tmp_path):
        """A CV model fit on a DataFrame saves/loads and then transforms
        BOTH planes: a DataFrame (adapter egress) and a dict (the loaded
        wrapper must pass dicts through to its dict-plane inner model) —
        cold-start drop honored on each."""
        from oap_mllib_tpu_torch.compat.pipeline import (
            CrossValidator,
            CrossValidatorModel,
            ParamGridBuilder,
        )

        training, *_ = self._ratings_df(rng, session, nu=20, ni=15)
        model = CrossValidator(
            estimator=ALS(rank=3, maxIter=2, userCol="userId",
                          itemCol="movieId", ratingCol="rating",
                          coldStartStrategy="drop"),
            estimatorParamMaps=(ParamGridBuilder()
                                .addGrid("regParam", [0.05, 5.0]).build()),
            evaluator=RegressionEvaluator(metricName="rmse",
                                          labelCol="rating"),
            numFolds=2, seed=1,
        ).fit(training)
        model.save(str(tmp_path / "cv"))
        loaded = CrossValidatorModel.load(str(tmp_path / "cv"))
        assert loaded.bestParams == model.bestParams
        probe_df = _df(session, userId=[0, 999], movieId=[0, 1],
                       rating=[1.0, 2.0])
        rows = loaded.transform(probe_df).collect()
        assert len(rows) == 1 and np.isfinite(rows[0][-1])
        probe = {"userId": np.array([0, 999]), "movieId": np.array([0, 1]),
                 "rating": np.array([1.0, 2.0], np.float32)}
        out = loaded.transform(probe)
        assert len(out["prediction"]) == 1
        assert np.isfinite(out["prediction"]).all()

    def test_train_validation_split_over_dataframes(self, rng, session):
        from oap_mllib_tpu_torch.compat.pipeline import (
            ParamGridBuilder,
            TrainValidationSplit,
        )

        training, *_ = self._ratings_df(rng, session)
        model = TrainValidationSplit(
            estimator=ALS(rank=3, maxIter=3, userCol="userId",
                          itemCol="movieId", ratingCol="rating",
                          coldStartStrategy="drop"),
            estimatorParamMaps=(ParamGridBuilder()
                                .addGrid("regParam", [0.05, 50.0])
                                .build()),
            evaluator=RegressionEvaluator(metricName="rmse",
                                          labelCol="rating"),
            trainRatio=0.8, seed=1,
        ).fit(training)
        assert model.bestParams == {"regParam": 0.05}
        assert "prediction" in model.transform(training).columns

    def test_recommend_subset_from_dataframe(self, rng, session):
        """recommendForUserSubset takes a DataFrame carrying the id
        column (the pyspark.ml signature); distinct-and-join semantics
        ride the dict plane."""
        training, *_ = self._ratings_df(rng, session, nu=20, ni=15)
        model = ALS(rank=3, maxIter=2, implicitPrefs=True,
                    userCol="userId", itemCol="movieId",
                    ratingCol="rating").fit(training)
        sub = _df(session, userId=[3, 0, 3, 999])
        ids, recs = model.recommendForUserSubset(sub, 4)
        assert list(ids) == [0, 3]
        assert recs.shape == (2, 4)
        assert recs.max() < model.itemFactors.shape[0]

    def test_implicit_mode(self, rng, session):
        training, u, i, r = self._ratings_df(rng, session)
        model = ALS(rank=4, maxIter=3, implicitPrefs=True, alpha=40.0,
                    userCol="userId", itemCol="movieId",
                    ratingCol="rating").fit(training)
        recs = model.recommendForAllUsers(5)
        assert recs.shape == (model.userFactors.shape[0], 5)


class TestJaxParity:
    """The same flows through the JAX package's adapter on the same mock
    frames."""

    def test_kmeans_flow(self, rng):
        session = FakeSession()
        proto = rng.normal(size=(3, 5)) * 8
        x = proto[rng.integers(3, size=200)] + 0.1 * rng.normal(size=(200, 5))
        dataset = _df(session, features=[list(row) for row in x])
        out = KMeans().setK(3).setSeed(1).fit(dataset).transform(dataset)
        jout = jpyspark.KMeans().setK(3).setSeed(1).fit(dataset).transform(dataset)
        assert out.columns == jout.columns == ["features", "prediction"]
        labels = [r[-1] for r in out.collect()]
        jlabels = [r[-1] for r in jout.collect()]
        assert len(set(zip(labels, jlabels))) == 3  # one partition, labels renamed
        np.testing.assert_allclose(ClusteringEvaluator().evaluate(out),
                                   jpyspark.ClusteringEvaluator().evaluate(jout), atol=1e-12)

    def test_pca_flow(self, rng):
        session = FakeSession()
        x = rng.normal(size=(300, 6)) * np.linspace(3.0, 0.5, 6)
        dataset = _df(session, features=[list(r) for r in x])
        model = PCA(k=3, inputCol="features", outputCol="pcaFeatures").fit(dataset)
        jmodel = jpyspark.PCA(k=3, inputCol="features", outputCol="pcaFeatures").fit(dataset)
        signs = np.sign(np.sum(np.asarray(model.pc) * np.asarray(jmodel.pc), axis=0))
        got = np.asarray([r[1] for r in model.transform(dataset).collect()])
        want = np.asarray([r[1] for r in jmodel.transform(dataset).collect()])
        np.testing.assert_allclose(got * signs, want, atol=1e-4)

    @pytest.mark.parametrize("strategy", ["nan", "drop"])
    def test_als_flow(self, rng, strategy):
        session = FakeSession()
        training, u, i, r = TestALSAdapter()._ratings_df(rng, session, nu=20, ni=15)
        kw = dict(rank=3, maxIter=3, regParam=0.05, userCol="userId", itemCol="movieId",
                  ratingCol="rating", coldStartStrategy=strategy, numUserBlocks=1)
        model, jmodel = ALS(**kw).fit(training), jpyspark.ALS(**kw).fit(training)
        test = _df(session, userId=[0, 1, 999, 5], movieId=[0, 1, 0, 900],
                   rating=[1.0, 2.0, 3.0, 4.0])
        rows, jrows = model.transform(test).collect(), jmodel.transform(test).collect()
        assert [r[:3] for r in rows] == [r[:3] for r in jrows]
        np.testing.assert_allclose([r[3] for r in rows], [r[3] for r in jrows],
                                   rtol=1e-4, atol=1e-4)
        assert len(rows) == (2 if strategy == "drop" else 4)
        ev = dict(metricName="rmse", labelCol="rating", predictionCol="prediction")
        if strategy == "drop":
            np.testing.assert_allclose(
                RegressionEvaluator(**ev).evaluate(model.transform(training)),
                jpyspark.RegressionEvaluator(**ev).evaluate(jmodel.transform(training)),
                rtol=1e-4)
        sub = _df(session, userId=[3, 0, 3, 999])
        ids, recs, scores = model.recommendForUserSubset(sub, 4, withScores=True)
        jids, _, jscores = jmodel.recommendForUserSubset(sub, 4, withScores=True)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(scores, jscores, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("rank,world,parts", [(0, 2, 5), (1, 2, 5), (2, 3, 7)])
    def test_partitioned_ingestion(self, rank, world, parts):
        session = FakeSession()
        cols = {"v": list(range(60)), "w": list(range(100, 160))}
        got = _collect_local_partitions_port(
            FakePartitionedDataFrame(cols, session, n_parts=parts), rank, world)
        want = jpyspark._collect_local_partitions(
            FakePartitionedDataFrame(cols, session, n_parts=parts), rank=rank, world=world)
        assert got == want


def _collect_local_partitions_port(df, rank, world):
    from oap_mllib_tpu_torch.compat.pyspark import _collect_local_partitions

    return _collect_local_partitions(df, rank=rank, world=world)
