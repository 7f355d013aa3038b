"""pyspark.ml-shaped estimators over REAL Spark DataFrames: the port of
the JAX package's ``compat/pyspark.py``.

The reference's core promise is *user code unmodified*: its Scala shims
classpath-shadow ``org.apache.spark.ml`` so the stock PySpark examples
run verbatim (reference examples/als-pyspark/als-pyspark.py:52-54,
kmeans-pyspark.py, pca-pyspark.py).  Python has no classpath shadowing,
so the drop-in point is the import line — change only

    from pyspark.ml.recommendation import ALS
    from pyspark.ml.clustering import KMeans
    from pyspark.ml.feature import PCA
    from pyspark.ml.evaluation import RegressionEvaluator, ClusteringEvaluator

to

    from oap_mllib_tpu_torch.compat.pyspark import (
        ALS, KMeans, PCA, RegressionEvaluator, ClusteringEvaluator)

and the rest of the example runs unchanged: keyword constructors,
builder setters, ``fit(dataframe)``, ``model.transform(dataframe)``
returning a DataFrame with the prediction column appended, evaluators
that consume that DataFrame.

Scope (documented, deliberate): in a single-process world the data
plane is DRIVER-COLLECT — the needed columns are collected to host
NumPy and the port's estimators take over from there (mesh sharding
happens inside them, on ``Config.device``).  That matches this framework's design
point (the device mesh replaces the executor fleet; survey §2.5):
Spark is the front-end API, not the compute fabric.

In a MULTI-PROCESS world (``bootstrap.world_size() > 1``) fits ingest
partition-wise instead (the executor-local conversion of the
reference, OneDAL.scala:92-166): each process materializes ONLY the
partitions assigned to it (``partition % world == rank``) via
``dataset.rdd.mapPartitionsWithIndex`` and feeds those rows as its
process-local shard of the multi-host fit — no process ever collects
the whole dataset (see ``_collect_local_partitions``).  Transform and
the evaluators remain driver-collect scoring paths.

Availability: importing this module does NOT require pyspark — every
DataFrame interaction goes through the duck-typed surface
(``df.select(...).collect()``, ``df.columns``, ``df.sparkSession
.createDataFrame(rows, schema)``), which is exactly what the contract
tests mock (tests/test_torch_pyspark_compat.py).  With pyspark installed, a
real DataFrame satisfies the same surface; ``HAVE_PYSPARK`` reports
which world you are in (output vectors use pyspark.ml.linalg when
available, plain lists otherwise).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from oap_mllib_tpu_torch.compat import spark as _compat

try:  # optional: only used to emit real ml.linalg vectors from transform
    from pyspark.ml.linalg import Vectors as _Vectors

    HAVE_PYSPARK = True
except ImportError:  # pragma: no cover - exercised when pyspark is absent
    _Vectors = None
    HAVE_PYSPARK = False


# ---------------------------------------------------------------------------
# DataFrame duck-typed surface
# ---------------------------------------------------------------------------


def _session_of(df):
    """The DataFrame's session (``sparkSession`` on 3.3+, ``sql_ctx
    .sparkSession`` on older lines)."""
    spark = getattr(df, "sparkSession", None)
    if spark is None:
        spark = df.sql_ctx.sparkSession
    return spark


def _collect_once(df):
    """ONE materializing action per adapter call: Spark does not
    guarantee identical row order across separate actions on an
    uncached DataFrame (randomSplit output recomputed after an executor
    loss, upstream shuffles/samples), so every extracted column AND the
    egress rows must come from the same collect() — zip-by-position
    across two actions would silently pair predictions with the wrong
    rows.  Returns (rows, column-name list)."""
    return df.collect(), list(df.columns)


def _collect_local_partitions(df, rank: Optional[int] = None,
                              world: Optional[int] = None):
    """Partition-wise ingestion for multi-process worlds: process r
    materializes ONLY partitions p with ``p % world == r`` (the
    reference's executor-local conversion, OneDAL.scala:92-166 — every
    executor converts its own partitions, never the dataset).  The
    kept rows become this process's LOCAL shard, which the estimators'
    multi-host fit contract already accepts (models treat array inputs
    as process-local when ``bootstrap.world_size() > 1``).  Returns
    (rows, cols) like _collect_once."""
    from oap_mllib_tpu_torch.parallel import bootstrap, collective

    rank = bootstrap.process_index() if rank is None else rank
    world = bootstrap.world_size() if world is None else world
    rdd = getattr(df, "rdd", None)
    if rdd is None:
        raise TypeError(
            "multi-process ingestion needs dataset.rdd"
            ".mapPartitionsWithIndex (a Spark DataFrame or equivalent); "
            "a plain collect would hand every process the FULL dataset "
            "as its shard"
        )
    keep = rdd.mapPartitionsWithIndex(
        lambda pid, it, _r=rank, _w=world: it if pid % _w == _r else iter(())
    )
    rows = keep.collect()
    # a rank with zero partitions (fewer partitions than world, e.g.
    # coalesce(1)) must fail on EVERY rank together — a one-rank raise
    # would leave the others hanging in the fit's first collective
    if bootstrap.world_size() > 1:
        (counts,) = collective.process_allgather([np.asarray([len(rows)], np.int64)])
        counts = np.asarray(counts).reshape(-1)
        if (counts == 0).any():
            empty = [int(r) for r in np.nonzero(counts == 0)[0]]
            raise ValueError(
                f"process(es) {empty} received zero partitions "
                f"(world={world}); repartition the DataFrame to at "
                "least the process count"
            )
        # the pid % world routing assumes every process computed the SAME
        # partitioning of the same data; a nondeterministically
        # partitioned/ordered source (an uncached randomSplit recomputed
        # after an executor loss, an upstream sample) can silently drop
        # or duplicate rows globally.  One cheap extra action pins it:
        # the per-rank kept-row counts must sum to the DataFrame's count.
        count_fn = getattr(df, "count", None)
        total = int(counts.sum())
        expected = int(count_fn()) if count_fn is not None else total
        if total != expected:
            raise ValueError(
                f"partition-wise ingestion kept {total} rows across "
                f"{world} process(es) but df.count() is {expected} — the "
                "DataFrame's partitioning is not deterministic across "
                "processes (e.g. an uncached randomSplit/sample); "
                ".cache() or materialize it before the fit"
            )
    elif not rows:
        raise ValueError(
            f"process {rank} received zero partitions (world={world}); "
            "repartition the DataFrame to at least the process count"
        )
    return rows, list(df.columns)


def _ingest(df):
    """The fit-side ingestion dispatch: one driver collect in a
    single-process world, partition-wise local shards otherwise."""
    from oap_mllib_tpu_torch.parallel import bootstrap

    if bootstrap.world_size() > 1:
        return _collect_local_partitions(df)
    return _collect_once(df)


def _col_from(rows, cols, name: str, dtype=None) -> np.ndarray:
    j = cols.index(name)
    return np.asarray([r[j] for r in rows], dtype=dtype)


def _column_to_array(vals) -> np.ndarray:
    """One collected column's cells -> ndarray: vector cells (toArray
    duck-type) and list/tuple cells become (n, d) float64 matrices,
    scalars pass through.  THE converter for whole-frame ingestion
    (compat.pipeline._as_dict) — keep the duck-type rules here, next to
    _mat_from/_col_from, so the planes cannot drift."""
    if vals and hasattr(vals[0], "toArray"):
        return np.asarray(
            [np.asarray(v.toArray(), np.float64) for v in vals]
        )
    if vals and isinstance(vals[0], (list, tuple)):
        return np.asarray([np.asarray(v, np.float64) for v in vals])
    return np.asarray(vals)


def _mat_from(rows, cols, name: str) -> np.ndarray:
    """(n, d) float matrix from a vector column of materialized rows
    (pyspark.ml.linalg Vector — sparse or dense — via toArray();
    lists/arrays pass through)."""
    j = cols.index(name)
    return np.asarray(
        [
            np.asarray(
                r[j].toArray() if hasattr(r[j], "toArray") else r[j],
                np.float64,
            )
            for r in rows
        ]
    )


def _vectorize(mat: np.ndarray):
    """Rows of a matrix as output-column values: ml.linalg DenseVectors
    with pyspark installed, plain float lists otherwise."""
    if _Vectors is not None:
        return [_Vectors.dense([float(v) for v in row]) for row in mat]
    return [[float(v) for v in row] for row in mat]


def _out_pos(df, name: str) -> int:
    """Where the output column lands: pyspark.ml's transform is
    withColumn, which REPLACES a same-name column IN PLACE (appending
    blindly would produce duplicate names on a re-scored DataFrame,
    and moving the column to the end would break positional access and
    union-by-position vs real pyspark output).  New names append."""
    cols = list(df.columns)
    return cols.index(name) if name in cols else len(cols)


def _out_schema(df, name: str, kind: str):
    """Output schema = df.schema with one explicitly-typed column
    (kind: "int" | "double" | "vector") placed at _out_pos.  The
    explicit schema matters on real Spark: name-only inference raises
    on an EMPTY result (every row cold-dropped, an empty randomSplit
    slice) where pyspark.ml's own transform returns an empty typed
    DataFrame, and on all-null columns.  Mocks without .schema/pyspark
    fall back to the name list (inference never runs on them)."""
    j = _out_pos(df, name)

    def _drop_first(seq, match):
        # drop only the FIRST matching column: withColumn replaces one
        # slot in place, and a duplicate-name frame (Spark permits them
        # after joins) must keep row and schema lengths consistent —
        # dropping every match would shrink the schema below the rows
        out, dropped = [], False
        for f in seq:
            if not dropped and match(f):
                dropped = True
            else:
                out.append(f)
        return out

    base = getattr(df, "schema", None)
    if base is None or not HAVE_PYSPARK:
        cols = _drop_first(list(df.columns), lambda c: c == name)
        return cols[:j] + [name] + cols[j:]
    from pyspark.sql.types import (
        DoubleType,
        IntegerType,
        StructField,
        StructType,
    )

    if kind == "vector":
        from pyspark.ml.linalg import VectorUDT

        t = VectorUDT()
    elif kind == "int":
        t = IntegerType()
    else:
        t = DoubleType()
    fields = _drop_first(list(base.fields), lambda f: f.name == name)
    return StructType(fields[:j] + [StructField(name, t, True)] + fields[j:])


def _replace_cell(row, j: int, v):
    """Row tuple with the cell at ``j`` swapped for the output value —
    the withColumn in-place replace (see _out_pos)."""
    t = tuple(row)
    return t[:j] + (v,) + t[j + 1 :]


def _append_column(df, rows, name: str, values, kind: str) -> object:
    """New DataFrame = the ALREADY-MATERIALIZED rows + the output
    column (driver-side; the egress mirror of the driver-collect
    ingestion — same collect as the ingestion, see _collect_once).
    An existing same-name column is replaced in place (withColumn
    semantics, see _out_pos)."""
    schema = _out_schema(df, name, kind)
    if name in list(df.columns):
        j = _out_pos(df, name)
        data = [_replace_cell(r, j, v) for r, v in zip(rows, values)]
    else:
        data = [tuple(r) + (v,) for r, v in zip(rows, values)]
    return _session_of(df).createDataFrame(data, schema)


def _rebuild_rows(df, rows, keep_idx, name: str, values, kind: str) -> object:
    """Like _append_column but keeping only ``keep_idx`` of the
    materialized rows — the coldStartStrategy="drop" egress."""
    schema = _out_schema(df, name, kind)
    if name in list(df.columns):
        j = _out_pos(df, name)
        data = [
            _replace_cell(rows[int(i)], j, v)
            for i, v in zip(keep_idx, values)
        ]
    else:
        data = [
            tuple(rows[int(i)]) + (v,) for i, v in zip(keep_idx, values)
        ]
    return _session_of(df).createDataFrame(data, schema)


# ---------------------------------------------------------------------------
# K-Means
# ---------------------------------------------------------------------------


class KMeans(_compat.KMeans):
    """ml.clustering.KMeans over Spark DataFrames (keyword constructor +
    builder setters, Spark defaults)."""

    def __init__(self, *, featuresCol: str = "features",
                 predictionCol: str = "prediction", k: int = 2,
                 initMode: str = "k-means||", initSteps: int = 2,
                 tol: float = 1e-4, maxIter: int = 20,
                 seed: Optional[int] = None,
                 distanceMeasure: str = "euclidean",
                 weightCol: Optional[str] = None):
        super().__init__()
        self.setFeaturesCol(featuresCol).setPredictionCol(predictionCol)
        self.setK(k).setInitMode(initMode).setInitSteps(initSteps)
        self.setTol(tol).setMaxIter(maxIter)
        if seed is not None:  # unset flows to Config.seed (compat contract)
            self.setSeed(seed)
        self.setDistanceMeasure(distanceMeasure)
        if weightCol is not None:
            self.setWeightCol(weightCol)

    def fit(self, dataset):
        if isinstance(dataset, dict):
            # tuner split plane: compat.pipeline collects a Spark frame
            # once and fits the splits as dicts (dict-plane model out)
            return super().fit(dataset)
        want = [self._featuresCol] + (
            [self._weightCol] if self._weightCol is not None else []
        )
        rows, cols = _ingest(dataset.select(*want))
        data = {self._featuresCol: _mat_from(rows, cols, self._featuresCol)}
        if self._weightCol is not None:
            data[self._weightCol] = _col_from(
                rows, cols, self._weightCol, np.float64
            )
        inner = super().fit(data)
        return KMeansModel(inner)


class KMeansModel:
    def __init__(self, inner: _compat.KMeansModel):
        self._inner = inner

    def setFeaturesCol(self, v):
        self._inner.setFeaturesCol(v)
        return self

    def setPredictionCol(self, v):
        self._inner.setPredictionCol(v)
        return self

    def getFeaturesCol(self):    return self._inner.getFeaturesCol()
    def getPredictionCol(self):  return self._inner.getPredictionCol()

    def clusterCenters(self):
        return self._inner.clusterCenters()

    @property
    def summary(self):
        return self._inner.summary

    def predict(self, features):
        return self._inner.predict(
            features.toArray() if hasattr(features, "toArray") else features
        )

    def transform(self, dataset):
        if isinstance(dataset, dict):  # dict-plane passthrough (tuners)
            return self._inner.transform(dataset)
        rows, cols = _collect_once(dataset)
        if not rows:  # empty split: empty typed output, like pyspark.ml
            return _append_column(
                dataset, rows, self._inner._predictionCol, [], "int"
            )
        x = _mat_from(rows, cols, self._inner._featuresCol)
        out = self._inner.transform({self._inner._featuresCol: x})
        pred = [int(p) for p in out[self._inner._predictionCol]]
        return _append_column(
            dataset, rows, self._inner._predictionCol, pred, "int"
        )

    def save(self, path: str) -> None:
        self._inner.save(path)

    @classmethod
    def load(cls, path: str) -> "KMeansModel":
        return cls(_compat.KMeansModel.load(path))


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------


class PCA(_compat.PCA):
    """ml.feature.PCA over Spark DataFrames."""

    def __init__(self, *, k: Optional[int] = None,
                 inputCol: Optional[str] = None,
                 outputCol: Optional[str] = None):
        super().__init__()
        if k is not None:
            self.setK(k)
        if inputCol is not None:
            self.setInputCol(inputCol)
        if outputCol is not None:
            self.setOutputCol(outputCol)

    def fit(self, dataset):
        if isinstance(dataset, dict):  # tuner split plane (see KMeans.fit)
            return super().fit(dataset)
        rows, cols = _ingest(dataset.select(self._inputCol))
        inner = super().fit(
            {self._inputCol: _mat_from(rows, cols, self._inputCol)}
        )
        return PCAModel(inner)


class PCAModel:
    def __init__(self, inner: _compat.PCAModel):
        self._inner = inner

    def setInputCol(self, v):
        self._inner.setInputCol(v)
        return self

    def setOutputCol(self, v):
        self._inner.setOutputCol(v)
        return self

    def getInputCol(self):   return self._inner.getInputCol()
    def getOutputCol(self):  return self._inner.getOutputCol()

    @property
    def pc(self) -> np.ndarray:
        return self._inner.pc

    @property
    def explainedVariance(self) -> np.ndarray:
        return self._inner.explainedVariance

    def transform(self, dataset):
        if isinstance(dataset, dict):  # dict-plane passthrough (tuners)
            return self._inner.transform(dataset)
        rows, cols = _collect_once(dataset)
        if not rows:  # empty split: empty typed output, like pyspark.ml
            return _append_column(
                dataset, rows, self._inner._outputCol, [], "vector"
            )
        x = _mat_from(rows, cols, self._inner._inputCol)
        out = self._inner.transform({self._inner._inputCol: x})
        return _append_column(
            dataset, rows, self._inner._outputCol,
            _vectorize(out[self._inner._outputCol]), "vector",
        )

    def save(self, path: str) -> None:
        self._inner.save(path)

    @classmethod
    def load(cls, path: str) -> "PCAModel":
        return cls(_compat.PCAModel.load(path))


# ---------------------------------------------------------------------------
# ALS
# ---------------------------------------------------------------------------


class ALS(_compat.ALS):
    """ml.recommendation.ALS over Spark DataFrames (full keyword
    constructor of the reference's example usage: als-pyspark.py:52-54)."""

    def __init__(self, *, rank: int = 10, maxIter: int = 10,
                 regParam: float = 0.1, numUserBlocks: Optional[int] = None,
                 numItemBlocks: Optional[int] = None,
                 implicitPrefs: bool = False, alpha: float = 1.0,
                 userCol: str = "user", itemCol: str = "item",
                 ratingCol: str = "rating", seed: Optional[int] = None,
                 nonnegative: bool = False,
                 checkpointInterval: int = 10,
                 coldStartStrategy: str = "nan",
                 predictionCol: str = "prediction"):
        super().__init__()
        self.setRank(rank).setMaxIter(maxIter).setRegParam(regParam)
        self.setImplicitPrefs(implicitPrefs).setAlpha(alpha)
        self.setUserCol(userCol).setItemCol(itemCol).setRatingCol(ratingCol)
        if seed is not None:  # unset flows to Config.seed (compat contract)
            self.setSeed(seed)
        self.setNonnegative(nonnegative)
        self.setCheckpointInterval(checkpointInterval)
        self.setColdStartStrategy(coldStartStrategy)
        self.setPredictionCol(predictionCol)
        if numUserBlocks is not None:
            self.setNumUserBlocks(numUserBlocks)
        if numItemBlocks is not None:
            self.setNumItemBlocks(numItemBlocks)

    def fit(self, dataset):
        if isinstance(dataset, dict):  # tuner split plane (see KMeans.fit)
            return super().fit(dataset)
        rows, cols = _ingest(
            dataset.select(self._userCol, self._itemCol, self._ratingCol)
        )
        inner = super().fit(
            {
                self._userCol: _col_from(rows, cols, self._userCol, np.int64),
                self._itemCol: _col_from(rows, cols, self._itemCol, np.int64),
                self._ratingCol: _col_from(
                    rows, cols, self._ratingCol, np.float32
                ),
            }
        )
        return ALSModel(inner)


class ALSModel:
    def __init__(self, inner: _compat.ALSModel):
        self._inner = inner

    def setUserCol(self, v):
        self._inner.setUserCol(v)
        return self

    def setItemCol(self, v):
        self._inner.setItemCol(v)
        return self

    def setPredictionCol(self, v):
        self._inner.setPredictionCol(v)
        return self

    def setColdStartStrategy(self, v):
        self._inner.setColdStartStrategy(v)
        return self

    def getUserCol(self):            return self._inner.getUserCol()
    def getItemCol(self):            return self._inner.getItemCol()
    def getPredictionCol(self):      return self._inner.getPredictionCol()
    def getColdStartStrategy(self):  return self._inner.getColdStartStrategy()

    @property
    def rank(self) -> int:
        return self._inner.rank

    @property
    def userFactors(self) -> np.ndarray:
        return self._inner.userFactors

    @property
    def itemFactors(self) -> np.ndarray:
        return self._inner.itemFactors

    def transform(self, dataset):
        """Prediction column for (user, item) rows; coldStartStrategy
        "nan"/"drop" rides the inner transform — a hidden row-index
        column reports which input rows survive "drop".  Dicts pass
        through to the dict-plane model (tuners, loaded containers)."""
        if isinstance(dataset, dict):
            return self._inner.transform(dataset)
        rows, cols = _collect_once(dataset)
        if not rows:  # empty split: empty typed output, like pyspark.ml
            return _append_column(
                dataset, rows, self._inner._predictionCol, [], "double"
            )
        u = _col_from(rows, cols, self._inner._userCol, np.int64)
        i = _col_from(rows, cols, self._inner._itemCol, np.int64)
        pairs = {
            self._inner._userCol: u,
            self._inner._itemCol: i,
            "__row_idx": np.arange(len(u)),
        }
        out = self._inner.transform(pairs)
        pred = [float(p) for p in out[self._inner._predictionCol]]
        idx = out["__row_idx"]
        if len(idx) == len(u) and np.array_equal(idx, np.arange(len(u))):
            return _append_column(
                dataset, rows, self._inner._predictionCol, pred, "double"
            )
        return _rebuild_rows(
            dataset, rows, idx, self._inner._predictionCol, pred, "double"
        )

    def recommendForAllUsers(self, numItems: int, withScores: bool = False):
        return self._inner.recommendForAllUsers(numItems,
                                                withScores=withScores)

    def recommendForAllItems(self, numUsers: int, withScores: bool = False):
        return self._inner.recommendForAllItems(numUsers,
                                                withScores=withScores)

    @staticmethod
    def _subset_col_dict(dataset, col: str):
        """DataFrame -> {col: int64 ids} for the subset recommenders,
        with a .distinct() pushdown when the frame supports it (Spark's
        own recommendForUserSubset distincts distributedly; collecting
        every raw row only for the dict plane to unique them away would
        bound driver IO by the ROW count instead of the distinct
        count).  Dicts pass through."""
        if isinstance(dataset, dict) or not hasattr(dataset, "select"):
            return dataset
        sel = dataset.select(col)
        distinct = getattr(sel, "distinct", None)
        if distinct is not None:
            sel = distinct()
        rows, cols = _collect_once(sel)
        return {col: _col_from(rows, cols, col, np.int64)}

    def recommendForUserSubset(self, dataset, numItems: int,
                               withScores: bool = False):
        """Subset recommendations from a DataFrame carrying the user id
        column (ml.recommendation.ALSModel.recommendForUserSubset);
        returns (user_ids, item_ids[, scores]) like the dict plane."""
        return self._inner.recommendForUserSubset(
            self._subset_col_dict(dataset, self._inner._userCol),
            numItems, withScores=withScores,
        )

    def recommendForItemSubset(self, dataset, numUsers: int,
                               withScores: bool = False):
        """Subset recommendations from a DataFrame carrying the item id
        column; shape contract as recommendForUserSubset."""
        return self._inner.recommendForItemSubset(
            self._subset_col_dict(dataset, self._inner._itemCol),
            numUsers, withScores=withScores,
        )

    def save(self, path: str) -> None:
        self._inner.save(path)

    @classmethod
    def load(cls, path: str) -> "ALSModel":
        return cls(_compat.ALSModel.load(path))


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------


class RegressionEvaluator(_compat.RegressionEvaluator):
    """ml.evaluation.RegressionEvaluator over Spark DataFrames (keyword
    constructor, als-pyspark.py:62 usage)."""

    def __init__(self, *, metricName: str = "rmse",
                 labelCol: str = "label", predictionCol: str = "prediction"):
        super().__init__(metricName=metricName, labelCol=labelCol,
                         predictionCol=predictionCol)

    def evaluate(self, dataset) -> float:
        if isinstance(dataset, dict):  # tuner split plane (see KMeans.fit)
            return super().evaluate(dataset)
        rows, cols = _collect_once(
            dataset.select(self._labelCol, self._predictionCol)
        )
        return super().evaluate(
            {
                self._labelCol: _col_from(rows, cols, self._labelCol,
                                          np.float64),
                self._predictionCol: _col_from(
                    rows, cols, self._predictionCol, np.float64
                ),
            }
        )


# Pipeline/tuning composability is data-plane agnostic — Pipeline only
# touches the stage fit/transform contract, and the tuners do their own
# one-collect on Spark frames — so the SAME classes serve real Spark
# DataFrames here (the pyspark.ml.Pipeline / ml.tuning import-line
# drop-in):
#   from oap_mllib_tpu_torch.compat.pyspark import Pipeline, CrossValidator
from oap_mllib_tpu_torch.compat.pipeline import (  # noqa: E402,F401
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    Pipeline,
    PipelineModel,
    TrainValidationSplit,
    TrainValidationSplitModel,
)


class ClusteringEvaluator(_compat.ClusteringEvaluator):
    """ml.evaluation.ClusteringEvaluator over Spark DataFrames
    (kmeans-pyspark.py:57 usage)."""

    def __init__(self, *, featuresCol: str = "features",
                 predictionCol: str = "prediction",
                 metricName: str = "silhouette",
                 distanceMeasure: str = "squaredEuclidean"):
        super().__init__()
        self.setFeaturesCol(featuresCol).setPredictionCol(predictionCol)
        self.setMetricName(metricName).setDistanceMeasure(distanceMeasure)

    def evaluate(self, dataset) -> float:
        if isinstance(dataset, dict):  # tuner split plane (see KMeans.fit)
            return super().evaluate(dataset)
        rows, cols = _collect_once(
            dataset.select(self._featuresCol, self._predictionCol)
        )
        return super().evaluate(
            {
                self._featuresCol: _mat_from(rows, cols, self._featuresCol),
                self._predictionCol: _col_from(
                    rows, cols, self._predictionCol, np.int64
                ),
            }
        )
