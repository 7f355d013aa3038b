"""Builder-style estimators mirroring Spark ML's param surface: the port
of the JAX package's ``compat/spark.py``, over the port's estimators.

Parity map (reference shims, survey §2.2):
- ``ml.clustering.KMeans``: setK/setMaxIter/setTol/setSeed/setInitMode/
  setInitSteps/setDistanceMeasure/setFeaturesCol/setPredictionCol/
  setWeightCol; model: clusterCenters(), predict(), summary.
- ``ml.feature.PCA``: setK/setInputCol/setOutputCol; model: pc,
  explainedVariance, transform.
- ``ml.recommendation.ALS``: setRank/setMaxIter/setRegParam/setAlpha/
  setImplicitPrefs/setSeed/setUserCol/setItemCol/setRatingCol/
  setPredictionCol/setNumUserBlocks/setNumItemBlocks/setNumBlocks/
  setColdStartStrategy/setCheckpointInterval (full param surface of
  reference spark-3.1.1/ml/recommendation/ALS.scala:241-245); model:
  userFactors, itemFactors, transform (appends the prediction column,
  honoring coldStartStrategy nan/drop),
  recommendForAllUsers/recommendForAllItems.

Input "DataFrames" are dicts of numpy columns; transform returns a new
dict with the output column appended (input never mutated).

The fits run the port's estimators on ``Config.device`` (the card by
default; a missing card raises, nothing falls back), a device list
giving the mesh routes.  An ALS fit with ``setNumUserBlocks(n > 1)`` on
a device list is a block fit whose model keeps its live sharded layout,
and ``recommendForAllUsers`` runs the full sweep
(serving/sweep.recommend_for_all_users): the ring sweep of that layout,
or the streamed sweep of a host-factor model, which equals the model's
own ``recommend_for_all_users`` bit for bit.  The JAX package's compat
model calls the model's method, which gathers a sharded model's
factors first.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from oap_mllib_tpu_torch.models import als as _als
from oap_mllib_tpu_torch.models import kmeans as _kmeans
from oap_mllib_tpu_torch.models import pca as _pca

DataFrame = Dict[str, np.ndarray]


def _features_from(data: Union[np.ndarray, DataFrame], col: str) -> np.ndarray:
    if isinstance(data, dict):
        if col not in data:
            raise KeyError(f"column {col!r} not in data (has {list(data)})")
        return np.asarray(data[col])
    return np.asarray(data)


def _global_unique(ids: np.ndarray) -> np.ndarray:
    """Unique ids across ALL processes: the cold-start "seen in
    training" sets must be world-consistent when each process only holds
    its shard (partition-wise ingestion, compat/pyspark module notes):
    process-local sets would make transform drop different rows on
    different processes.  Fixed-shape allgather (lengths first, then
    padded ids), as every exchange across processes here is."""
    from oap_mllib_tpu_torch.parallel import bootstrap, collective

    loc = np.unique(np.asarray(ids, np.int64))
    if bootstrap.world_size() == 1:
        return loc
    (lens,) = collective.process_allgather([np.asarray([len(loc)], np.int64)])
    n = int(np.max(lens))
    pad = np.full((n,), -1, np.int64)
    pad[: len(loc)] = loc
    (allv,) = collective.process_allgather([pad])
    allv = np.asarray(allv).reshape(-1)
    return np.unique(allv[allv >= 0])


def _save_compat_meta(path: str, meta: dict) -> None:
    """Persist the compat surface alongside the core model artifacts —
    column names (and per-model extras) must survive save/load, like
    Spark's own model metadata (DefaultParamsWriter)."""
    import json as _json
    import os as _os

    with open(_os.path.join(path, "compat_metadata.json"), "w") as f:
        _json.dump(meta, f)


def _load_compat_meta(path: str) -> dict:
    """{} for a save without compat metadata (callers fall back to
    defaults)."""
    import json as _json
    import os as _os

    p = _os.path.join(path, "compat_metadata.json")
    if not _os.path.exists(p):
        return {}
    with open(p) as f:
        return _json.load(f)


class KMeans:
    """Spark-ML-style K-Means builder (reference shim: ml.clustering.KMeans)."""

    def __init__(self):
        self._k = 2
        self._maxIter = 20
        self._tol = 1e-4
        self._seed = None  # unset -> Config.seed (OAP_MLLIB_TPU_SEED)
        self._initMode = "k-means||"
        self._initSteps = 2
        self._distanceMeasure = "euclidean"
        self._featuresCol = "features"
        self._predictionCol = "prediction"
        self._weightCol: Optional[str] = None

    # -- setters (each returns self, Spark-style) --
    def setK(self, v):                self._k = v; return self
    def setMaxIter(self, v):          self._maxIter = v; return self
    def setTol(self, v):              self._tol = v; return self
    def setSeed(self, v):             self._seed = v; return self
    def setInitMode(self, v):         self._initMode = v; return self
    def setInitSteps(self, v):        self._initSteps = v; return self
    def setDistanceMeasure(self, v):  self._distanceMeasure = v; return self
    def setFeaturesCol(self, v):      self._featuresCol = v; return self
    def setPredictionCol(self, v):    self._predictionCol = v; return self
    def setWeightCol(self, v):        self._weightCol = v; return self

    # -- getters --
    def getK(self):                return self._k
    def getMaxIter(self):          return self._maxIter
    def getTol(self):              return self._tol
    def getInitMode(self):         return self._initMode

    def getSeed(self):
        """The RESOLVED seed (Config.seed when unset) — the value the fit
        will actually use, mirroring how Spark's getSeed always returns a
        concrete value."""
        from oap_mllib_tpu_torch.config import get_config

        return get_config().seed if self._seed is None else self._seed
    def getInitSteps(self):        return self._initSteps
    def getDistanceMeasure(self):  return self._distanceMeasure
    def getFeaturesCol(self):      return self._featuresCol
    def getPredictionCol(self):    return self._predictionCol

    def fit(self, data: Union[np.ndarray, DataFrame]) -> "KMeansModel":
        x = _features_from(data, self._featuresCol)
        w = None
        if self._weightCol is not None:
            if not isinstance(data, dict):
                raise ValueError(
                    f"weightCol={self._weightCol!r} is set but data has no "
                    "columns; pass a dict with the weight column"
                )
            w = np.asarray(data[self._weightCol])
        est = _kmeans.KMeans(
            k=self._k, max_iter=self._maxIter, tol=self._tol, seed=self._seed,
            init_mode=self._initMode, init_steps=self._initSteps,
            distance_measure=self._distanceMeasure,
        )
        return KMeansModel(est.fit(x, sample_weight=w), self._featuresCol,
                           self._predictionCol)


class KMeansModel:
    def __init__(self, inner: _kmeans.KMeansModel, features_col: str, prediction_col: str):
        self._inner = inner
        self._featuresCol = features_col
        self._predictionCol = prediction_col

    # Spark models re-expose their column params as setters (a fitted
    # ml.clustering.KMeansModel can be pointed at different columns)
    def setFeaturesCol(self, v):    self._featuresCol = v; return self
    def setPredictionCol(self, v):  self._predictionCol = v; return self

    def getFeaturesCol(self):    return self._featuresCol
    def getPredictionCol(self):  return self._predictionCol

    def clusterCenters(self) -> np.ndarray:
        return self._inner.cluster_centers_

    @property
    def summary(self):
        return self._inner.summary

    def predict(self, features: np.ndarray) -> int:
        """Single-vector predict (Spark's model.predict(Vector)).
        For batches, use ``transform`` — a 2-D input here is a misuse that
        would silently drop rows, so it raises."""
        features = np.asarray(features)
        if features.ndim != 1:
            raise TypeError(
                f"predict takes a single 1-D vector, got shape {features.shape}; "
                "use transform() for batches"
            )
        return int(self._inner.predict(features[None, :])[0])

    def transform(self, data: Union[np.ndarray, DataFrame]) -> DataFrame:
        x = _features_from(data, self._featuresCol)
        out = dict(data) if isinstance(data, dict) else {self._featuresCol: x}
        out[self._predictionCol] = self._inner.predict(x)
        return out

    def computeCost(self, data: Union[np.ndarray, DataFrame]) -> float:
        return self._inner.compute_cost(_features_from(data, self._featuresCol))

    def save(self, path: str) -> None:
        self._inner.save(path)
        _save_compat_meta(path, {
            "featuresCol": self._featuresCol,
            "predictionCol": self._predictionCol,
        })

    @classmethod
    def load(cls, path: str) -> "KMeansModel":
        meta = _load_compat_meta(path)
        return cls(
            _kmeans.KMeansModel.load(path),
            meta.get("featuresCol", "features"),
            meta.get("predictionCol", "prediction"),
        )


class PCA:
    """Spark-ML-style PCA builder (reference shim: ml.feature.PCA)."""

    def __init__(self):
        self._k = None
        self._inputCol = "features"
        self._outputCol = "pcaFeatures"

    def setK(self, v):          self._k = v; return self
    def setInputCol(self, v):   self._inputCol = v; return self
    def setOutputCol(self, v):  self._outputCol = v; return self

    def getK(self):         return self._k
    def getInputCol(self):  return self._inputCol
    def getOutputCol(self): return self._outputCol

    def fit(self, data: Union[np.ndarray, DataFrame]) -> "PCAModel":
        if self._k is None:
            raise ValueError("k is not set (call setK)")
        x = _features_from(data, self._inputCol)
        return PCAModel(_pca.PCA(k=self._k).fit(x), self._inputCol, self._outputCol)


class PCAModel:
    def __init__(self, inner: _pca.PCAModel, input_col: str, output_col: str):
        self._inner = inner
        self._inputCol = input_col
        self._outputCol = output_col

    # column setters on the fitted model (ml.feature.PCAModel surface)
    def setInputCol(self, v):   self._inputCol = v; return self
    def setOutputCol(self, v):  self._outputCol = v; return self

    def getInputCol(self):   return self._inputCol
    def getOutputCol(self):  return self._outputCol

    @property
    def pc(self) -> np.ndarray:
        """(d, k) principal components matrix (Spark's `pc`)."""
        return self._inner.components_

    @property
    def explainedVariance(self) -> np.ndarray:
        return self._inner.explained_variance_

    def transform(self, data: Union[np.ndarray, DataFrame]) -> DataFrame:
        x = _features_from(data, self._inputCol)
        out = dict(data) if isinstance(data, dict) else {self._inputCol: x}
        out[self._outputCol] = self._inner.transform(x)
        return out

    def save(self, path: str) -> None:
        self._inner.save(path)
        _save_compat_meta(path, {
            "inputCol": self._inputCol,
            "outputCol": self._outputCol,
        })

    @classmethod
    def load(cls, path: str) -> "PCAModel":
        meta = _load_compat_meta(path)
        return cls(
            _pca.PCAModel.load(path),
            meta.get("inputCol", "features"),
            meta.get("outputCol", "pcaFeatures"),
        )


class ALS:
    """Spark-ML-style ALS builder (reference shim: ml.recommendation.ALS)."""

    _supportedColdStartStrategies = ("nan", "drop")

    def __init__(self):
        self._rank = 10
        self._maxIter = 10
        self._regParam = 0.1
        self._alpha = 1.0
        self._implicitPrefs = False
        self._seed = None  # unset -> Config.seed (OAP_MLLIB_TPU_SEED)
        self._nonnegative = False
        self._userCol = "user"
        self._itemCol = "item"
        self._ratingCol = "rating"
        self._predictionCol = "prediction"
        # Spark defaults (reference ALS.scala:241-245): numUserBlocks=10,
        # numItemBlocks=10, checkpointInterval=10, coldStartStrategy="nan".
        # The block counts are only FORWARDED to the estimator when the
        # user sets them — Spark's 10 is a partitioning default, not a
        # device cap, and the mesh layout is the better default here.
        self._numUserBlocks = 10
        self._numItemBlocks = 10
        self._numBlocksSet = False
        self._checkpointInterval = 10
        self._coldStartStrategy = "nan"

    def setRank(self, v):           self._rank = v; return self
    def setMaxIter(self, v):        self._maxIter = v; return self
    def setRegParam(self, v):       self._regParam = v; return self
    def setAlpha(self, v):          self._alpha = v; return self
    def setImplicitPrefs(self, v):  self._implicitPrefs = v; return self
    def setSeed(self, v):           self._seed = v; return self
    def setNonnegative(self, v):    self._nonnegative = v; return self
    def setUserCol(self, v):        self._userCol = v; return self
    def setItemCol(self, v):        self._itemCol = v; return self
    def setRatingCol(self, v):      self._ratingCol = v; return self
    def setPredictionCol(self, v):  self._predictionCol = v; return self

    def setNumUserBlocks(self, v):
        if v < 1:
            raise ValueError("numUserBlocks must be >= 1")
        self._numUserBlocks = v
        self._numBlocksSet = True
        return self

    def setNumItemBlocks(self, v):
        if v < 1:
            raise ValueError("numItemBlocks must be >= 1")
        self._numItemBlocks = v
        self._numBlocksSet = True
        return self

    def setNumBlocks(self, v):
        """Set both numUserBlocks and numItemBlocks (ALS.scala:679-683)."""
        return self.setNumUserBlocks(v).setNumItemBlocks(v)

    @staticmethod
    def _validated_cold_start(v) -> str:
        """ONE case-insensitive validator + normalizer for estimator and
        model setters (Spark lowercases on read, ALS.scala:128 — storing
        normalized makes that a no-op here)."""
        s = str(v).lower()
        if s not in ALS._supportedColdStartStrategies:
            raise ValueError(
                f"coldStartStrategy must be one of "
                f"{ALS._supportedColdStartStrategies}, got {v!r}"
            )
        return s

    def setColdStartStrategy(self, v):
        """"nan" keeps NaN predictions for ids unseen in training; "drop"
        removes those rows from transform output (ALS.scala:119-128)."""
        self._coldStartStrategy = self._validated_cold_start(v)
        return self

    def setCheckpointInterval(self, v):
        """Accepted for API parity but a no-op, exactly like the reference:
        ALSDALImpl ignores checkpointInterval (survey §5 — the accelerated
        path has no intermediate RDD lineage to truncate; here a fit's
        checkpoints are ``Config.checkpoint_dir``'s).  -1 disables, like Spark."""
        if v != -1 and v < 1:
            raise ValueError("checkpointInterval must be >= 1 or -1")
        self._checkpointInterval = v
        return self

    def getRank(self):          return self._rank
    def getMaxIter(self):       return self._maxIter
    def getRegParam(self):      return self._regParam
    def getAlpha(self):         return self._alpha
    def getImplicitPrefs(self): return self._implicitPrefs

    def getSeed(self):
        """The RESOLVED seed (Config.seed when unset) — see KMeans.getSeed."""
        from oap_mllib_tpu_torch.config import get_config

        return get_config().seed if self._seed is None else self._seed
    def getNonnegative(self):   return self._nonnegative
    def getUserCol(self):       return self._userCol
    def getItemCol(self):       return self._itemCol
    def getRatingCol(self):     return self._ratingCol
    def getPredictionCol(self): return self._predictionCol
    def getNumUserBlocks(self): return self._numUserBlocks
    def getNumItemBlocks(self): return self._numItemBlocks
    def getCheckpointInterval(self): return self._checkpointInterval

    def getColdStartStrategy(self):
        return self._coldStartStrategy  # stored normalized

    def fit(self, data: DataFrame) -> "ALSModel":
        if not isinstance(data, dict):
            raise TypeError("ALS.fit expects a dict with user/item/rating columns")
        est = _als.ALS(
            rank=self._rank, max_iter=self._maxIter, reg_param=self._regParam,
            implicit_prefs=self._implicitPrefs, alpha=self._alpha, seed=self._seed,
            nonnegative=self._nonnegative,
            num_user_blocks=self._numUserBlocks if self._numBlocksSet else None,
            num_item_blocks=self._numItemBlocks if self._numBlocksSet else None,
        )
        users = np.asarray(data[self._userCol])
        items = np.asarray(data[self._itemCol])
        inner = est.fit(users, items, np.asarray(data[self._ratingCol]))
        return ALSModel(inner, self._userCol, self._itemCol,
                        prediction_col=self._predictionCol,
                        cold_start_strategy=self.getColdStartStrategy(),
                        seen_users=_global_unique(users),
                        seen_items=_global_unique(items))


class ALSModel:
    def __init__(self, inner: _als.ALSModel, user_col: str, item_col: str,
                 prediction_col: str = "prediction",
                 cold_start_strategy: str = "nan",
                 seen_users: Optional[np.ndarray] = None,
                 seen_items: Optional[np.ndarray] = None):
        self._inner = inner
        self._userCol = user_col
        self._itemCol = item_col
        self._predictionCol = prediction_col
        self._coldStartStrategy = cold_start_strategy
        # ids that actually appeared in training — Spark's cold-start set
        # is "unseen in training", which in a dense id space also covers
        # in-range ids whose every rating landed outside the training
        # split.  Persisted by save/load (like Spark's factor id lists);
        # None (a save without them, or direct construction without the
        # sets) degrades to range checks.
        self._seenUsers = seen_users
        self._seenItems = seen_items

    # Spark's fitted ALSModel re-exposes these as model params
    # (ml.recommendation.ALSModel.setColdStartStrategy et al.) — a
    # loaded model can be re-pointed at different columns or switched
    # between nan/drop without refitting
    def setUserCol(self, v):        self._userCol = v; return self
    def setItemCol(self, v):        self._itemCol = v; return self
    def setPredictionCol(self, v):  self._predictionCol = v; return self

    def setColdStartStrategy(self, v):
        self._coldStartStrategy = ALS._validated_cold_start(v)
        return self

    def getUserCol(self):            return self._userCol
    def getItemCol(self):            return self._itemCol
    def getPredictionCol(self):      return self._predictionCol

    def getColdStartStrategy(self):
        # direct construction may carry a raw value; normalize on read
        return self._coldStartStrategy.lower()

    @property
    def rank(self) -> int:
        return self._inner.rank

    @property
    def userFactors(self) -> np.ndarray:
        return self._inner.user_factors_

    @property
    def itemFactors(self) -> np.ndarray:
        return self._inner.item_factors_

    def transform(self, data: DataFrame) -> DataFrame:
        """Append the prediction column for (user, item) pairs.

        Cold-start handling mirrors Spark (ALS.scala:119-128, ALSModel
        .transform): ids with no trained factor row get NaN predictions
        under "nan" (the default), or their rows removed from every column
        under "drop" — the mode cross-validation needs to avoid NaN
        metrics."""
        users = np.asarray(data[self._userCol])
        items = np.asarray(data[self._itemCol])
        n_u = self._inner.user_factors_.shape[0]
        n_i = self._inner.item_factors_.shape[0]
        seen = (users >= 0) & (users < n_u) & (items >= 0) & (items < n_i)
        if self._seenUsers is not None:
            seen &= np.isin(users, self._seenUsers)
        if self._seenItems is not None:
            seen &= np.isin(items, self._seenItems)
        # clip before the gather so device-side indexing never reads out of
        # range, then mask the cold rows
        pred = self._inner.predict(
            np.clip(users, 0, max(n_u - 1, 0)),
            np.clip(items, 0, max(n_i - 1, 0)),
        ).astype(np.float32)
        pred[~seen] = np.nan
        out = dict(data)
        if self._coldStartStrategy == "drop":
            out = {k: np.asarray(v)[seen] for k, v in out.items()}
            out[self._predictionCol] = pred[seen]
        else:
            out[self._predictionCol] = pred
        return out

    def recommendForAllUsers(self, numItems: int,
                             withScores: bool = False):
        """Top-N item ids per user; ``withScores=True`` also returns the
        predicted ratings (Spark's recommendForAllUsers returns
        (item, rating) structs).  The full sweep
        (serving/sweep.recommend_for_all_users): a block fit's live
        sharded layout serves without a factor gather."""
        from oap_mllib_tpu_torch.serving import sweep

        return sweep.recommend_for_all_users(self._inner, numItems,
                                             with_scores=withScores)

    def recommendForAllItems(self, numUsers: int,
                             withScores: bool = False):
        """Top-N user ids per item; ``withScores`` as above."""
        return self._inner.recommend_for_all_items(
            numUsers, with_scores=withScores
        )

    def _subset_ids(self, dataset, col, seen, n_rows: int) -> np.ndarray:
        """Spark's subset semantics (ALS.scala:379-429): take the id
        column, DISTINCT it, and keep only ids with a trained factor row
        (the join against the factor frame) — unseen ids silently drop,
        they do not error."""
        ids = np.asarray(
            dataset[col] if isinstance(dataset, dict) else dataset,
            np.int64,
        )
        ids = np.unique(ids)
        ids = ids[(ids >= 0) & (ids < n_rows)]
        if seen is not None:
            ids = ids[np.isin(ids, seen)]
        return ids

    def recommendForUserSubset(self, dataset, numItems: int,
                               withScores: bool = False):
        """Top-N items for the users in ``dataset`` (a dict with the
        userCol, or a bare id array) — ml.recommendation.ALSModel
        .recommendForUserSubset.  Returns (user_ids, item_ids[, scores]):
        row j of the matrices belongs to user_ids[j] (one row per
        distinct trained user, Spark's distinct-and-join semantics)."""
        ids = self._subset_ids(
            dataset, self._userCol, self._seenUsers,
            self._inner.user_factors_.shape[0],
        )
        out = self._inner.recommend_for_users(
            ids, numItems, with_scores=withScores
        )
        return (ids, *out) if withScores else (ids, out)

    def recommendForItemSubset(self, dataset, numUsers: int,
                               withScores: bool = False):
        """Top-N users for the items in ``dataset`` — ml.recommendation
        .ALSModel.recommendForItemSubset; shape contract as
        recommendForUserSubset."""
        ids = self._subset_ids(
            dataset, self._itemCol, self._seenItems,
            self._inner.item_factors_.shape[0],
        )
        out = self._inner.recommend_for_items(
            ids, numUsers, with_scores=withScores
        )
        return (ids, *out) if withScores else (ids, out)

    def save(self, path: str) -> None:
        """Persist factors AND the compat surface: column names,
        coldStartStrategy, and the seen-id sets — Spark's cold-start
        semantics ("unseen in training") must survive a save/load
        round-trip (its ALSModel persists the factor id lists,
        ALS.scala:119-128); without them a loaded model silently
        degrades to range checks."""
        import os as _os

        self._inner.save(path)
        if self._seenUsers is not None:
            np.save(_os.path.join(path, "seen_users.npy"), self._seenUsers)
        if self._seenItems is not None:
            np.save(_os.path.join(path, "seen_items.npy"), self._seenItems)
        _save_compat_meta(path, {
            "userCol": self._userCol,
            "itemCol": self._itemCol,
            "predictionCol": self._predictionCol,
            "coldStartStrategy": self._coldStartStrategy,
        })

    @classmethod
    def load(cls, path: str) -> "ALSModel":
        import os as _os

        meta = _load_compat_meta(path)

        def _opt(name):
            p = _os.path.join(path, name)
            return np.load(p) if _os.path.exists(p) else None

        return cls(
            _als.ALSModel.load(path),
            meta.get("userCol", "user"),
            meta.get("itemCol", "item"),
            prediction_col=meta.get("predictionCol", "prediction"),
            cold_start_strategy=meta.get("coldStartStrategy", "nan"),
            seen_users=_opt("seen_users.npy"),
            seen_items=_opt("seen_items.npy"),
        )


class ClusteringEvaluator:
    """Silhouette evaluator (Spark ml.evaluation.ClusteringEvaluator —
    used by the reference K-Means examples, examples/kmeans-pyspark/
    kmeans-pyspark.py:57).  Metrics: silhouette with squaredEuclidean
    (default) or cosine distance, computed via Spark's closed form —
    point-to-cluster distances from cluster aggregates, never an (n, n)
    pairwise matrix; rows stream in chunks so the live (chunk, k) block
    is bounded."""

    _CHUNK = 1 << 16

    def __init__(self):
        self._metricName = "silhouette"
        self._distanceMeasure = "squaredEuclidean"
        self._featuresCol = "features"
        self._predictionCol = "prediction"

    def setMetricName(self, v):       self._metricName = v; return self
    def setDistanceMeasure(self, v):  self._distanceMeasure = v; return self
    def setFeaturesCol(self, v):      self._featuresCol = v; return self
    def setPredictionCol(self, v):    self._predictionCol = v; return self

    def getMetricName(self):       return self._metricName
    def getDistanceMeasure(self):  return self._distanceMeasure
    def getFeaturesCol(self):      return self._featuresCol
    def getPredictionCol(self):    return self._predictionCol

    def isLargerBetter(self) -> bool:
        return True

    def evaluate(self, dataset: DataFrame) -> float:
        if self._metricName != "silhouette":
            raise ValueError(f"unknown metric {self._metricName!r}")
        if self._distanceMeasure not in ("squaredEuclidean", "cosine"):
            raise ValueError(
                f"distanceMeasure must be squaredEuclidean or cosine, "
                f"got {self._distanceMeasure!r}"
            )
        x = np.asarray(_features_from(dataset, self._featuresCol), np.float64)
        labels = np.asarray(dataset[self._predictionCol])
        uniq = np.unique(labels)
        if len(uniq) < 2:
            raise ValueError("silhouette needs at least 2 clusters")
        own = np.searchsorted(uniq, labels)
        counts = np.bincount(own, minlength=len(uniq)).astype(np.float64)
        if self._distanceMeasure == "cosine":
            # cosine distance = 1 - a^.b^; mean distance to a cluster is
            # 1 - a^ . mean(normalized members)  (Spark CosineSilhouette)
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-300)
        sums = np.zeros((len(uniq), x.shape[1]))
        np.add.at(sums, own, x)
        means = sums / counts[:, None]
        if self._distanceMeasure == "squaredEuclidean":
            sq = np.einsum("ij,ij->i", x, x)
            mean_sq = np.zeros(len(uniq))
            np.add.at(mean_sq, own, sq)
            mean_sq /= counts
        total = 0.0
        n = len(x)
        for lo in range(0, n, self._CHUNK):
            xi = x[lo : lo + self._CHUNK]
            oi = own[lo : lo + self._CHUNK]
            if self._distanceMeasure == "squaredEuclidean":
                # E||p - x||^2 = E||p||^2 - 2 x.mean_c + ||x||^2
                d = (
                    mean_sq[None, :]
                    - 2.0 * xi @ means.T
                    + sq[lo : lo + self._CHUNK, None]
                )
            else:
                d = 1.0 - xi @ means.T
            rows = np.arange(len(xi))
            n_own = counts[oi]
            # a(i): exclude the point itself (distance 0) from its own
            # cluster's mean
            a = d[rows, oi] * n_own / np.maximum(n_own - 1, 1)
            d[rows, oi] = np.inf
            b = d.min(axis=1)
            # s(i) = 0 when max(a, b) == 0 (coincident duplicate points):
            # Spark/sklearn define the 0/0 case as 0, and without the guard
            # the NaN would propagate into the mean.
            denom = np.maximum(a, b)
            s = np.where(
                (n_own > 1) & (denom > 0),
                (b - a) / np.where(denom > 0, denom, 1.0),
                0.0,
            )
            total += float(s.sum())
        return total / n


class RegressionEvaluator:
    """Regression metrics (Spark ml.evaluation.RegressionEvaluator —
    used by the reference ALS examples, examples/als-pyspark/
    als-pyspark.py:62).  Metrics: rmse (default), mse, mae, r2, var.
    NaN predictions (coldStartStrategy="nan") must be dropped by the
    caller or via coldStartStrategy="drop", as in Spark."""

    def __init__(self, metricName: str = "rmse", labelCol: str = "label",
                 predictionCol: str = "prediction"):
        self._metricName = metricName
        self._labelCol = labelCol
        self._predictionCol = predictionCol

    def setMetricName(self, v):     self._metricName = v; return self
    def setLabelCol(self, v):       self._labelCol = v; return self
    def setPredictionCol(self, v):  self._predictionCol = v; return self

    def getMetricName(self):     return self._metricName
    def getLabelCol(self):       return self._labelCol
    def getPredictionCol(self):  return self._predictionCol

    def isLargerBetter(self) -> bool:
        return self._metricName in ("r2", "var")

    def evaluate(self, dataset: DataFrame) -> float:
        label = np.asarray(dataset[self._labelCol], np.float64)
        pred = np.asarray(dataset[self._predictionCol], np.float64)
        if len(label) == 0:
            return float("nan")
        err = pred - label
        if self._metricName == "rmse":
            return float(np.sqrt(np.mean(err ** 2)))
        if self._metricName == "mse":
            return float(np.mean(err ** 2))
        if self._metricName == "mae":
            return float(np.mean(np.abs(err)))
        if self._metricName == "r2":
            ss_res = float(np.sum(err ** 2))
            ss_tot = float(np.sum((label - label.mean()) ** 2))
            return 1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan")
        if self._metricName == "var":
            return float(np.var(pred))
        raise ValueError(f"unknown metric {self._metricName!r}")
