"""Pipeline / model-selection composability (Spark ml.Pipeline, ml.tuning):
the port of the JAX package's ``compat/pipeline.py``.

The reference inherits Spark's composability for free (its shims slot
into `pyspark.ml.Pipeline` / `CrossValidator` because they shadow the
same classes).  This module provides the analog for this framework's
compat estimators: `Pipeline` chains any stages exposing the
fit/transform contract, and `CrossValidator` + `ParamGridBuilder` do
k-fold model selection driven by the compat evaluators, in the dict
world too.

Works over BOTH data planes, because it only touches the stage
contract:
- dict "DataFrames" (`compat.spark` estimators) — k-fold row slicing is
  column slicing;
- real Spark DataFrames (`compat.pyspark` estimators): `Pipeline` /
  `PipelineModel` never look inside the data, and the tuners
  (`CrossValidator`, `TrainValidationSplit`) do the documented ONE
  collect themselves (the adapters' driver-collect scope) — split
  fit/evaluate runs on the collected dict plane (the pyspark adapters
  delegate dict inputs to their dict-plane base), and the winning
  params are refit on the ORIGINAL DataFrame so the returned
  ``bestModel`` transforms DataFrames.

Persistence: `Pipeline`/`PipelineModel`/`CrossValidatorModel`/
`TrainValidationSplitModel` all save/load (Spark's MLWritable surface,
which the reference inherits — e.g. IntelPCASuite.scala:90-104 tests
model read/write): a JSON manifest records each stage's class, and
fitted stages delegate to the stage model's own save/load (so e.g. a
loaded ALS stage keeps its coldStartStrategy and seen-id sets).

Param grids: Spark's `ParamGridBuilder.addGrid` takes `Param` objects
(`als.regParam`); these builders carry no Param descriptors, so
`addGrid` takes the SETTER NAME string instead ("regParam" →
`setRegParam(v)` on a copy of the estimator).  Same shape, one explicit
deviation, validated eagerly (an unknown name raises at addGrid, not
mid-CV).

Manifests share the JAX package's layout, and a stage class loads only
from this package: a manifest that names the JAX package's classes
(``oap_mllib_tpu.compat.spark.KMeans``) is refused, not imported, as
any other module is.  The stage models' own files share the on-disk
format, so a model the JAX package saved loads through this package's
``KMeansModel.load`` / ``PCAModel.load`` / ``ALSModel.load``.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Persistence plumbing (Spark MLWritable analog): a JSON manifest per
# container records each stage's class; fitted stages delegate to the
# stage model's own save/load, unfitted estimators snapshot their param
# attributes (all simple scalars on the builder classes).
# ---------------------------------------------------------------------------


def _class_ref(obj) -> dict:
    return {"module": type(obj).__module__, "cls": type(obj).__qualname__}


_PACKAGE = "oap_mllib_tpu_torch"


def _resolve_class(ref: dict):
    module = ref["module"]
    # manifests name classes to import — constrain to this package so a
    # tampered manifest cannot import-and-instantiate arbitrary code (nor
    # a manifest of the JAX package import JAX)
    if module != _PACKAGE and not module.startswith(_PACKAGE + "."):
        raise ValueError(f"refusing to load stage class from {module!r}")
    return getattr(importlib.import_module(module), ref["cls"])


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(
        f"cannot persist non-scalar param value {v!r} ({type(v).__name__})"
    )


def _save_estimator(est, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    params = {k: _jsonable(v) for k, v in est.__dict__.items()}
    with open(os.path.join(path, "estimator.json"), "w") as f:
        json.dump({"ref": _class_ref(est), "params": params}, f)


def _load_estimator(path: str):
    with open(os.path.join(path, "estimator.json")) as f:
        blob = json.load(f)
    est = _resolve_class(blob["ref"])()
    est.__dict__.update(blob["params"])
    return est


def _save_stage(stage, path: str) -> None:
    """Estimators snapshot params; anything else must bring its own
    save (every model class in this package does)."""
    if hasattr(stage, "fit"):
        _save_estimator(stage, path)
    elif hasattr(stage, "save"):
        os.makedirs(path, exist_ok=True)
        stage.save(path)
    else:
        raise TypeError(
            f"stage {type(stage).__name__} has neither params to "
            "snapshot (fit) nor a save method"
        )


def _load_stage(ref: dict, path: str):
    if os.path.exists(os.path.join(path, "estimator.json")):
        return _load_estimator(path)
    cls = _resolve_class(ref)
    if not hasattr(cls, "load"):
        raise TypeError(f"stage class {cls.__name__} has no load method")
    return cls.load(path)


def _write_manifest(path: str, blob: dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "pipeline_metadata.json"), "w") as f:
        json.dump(blob, f)


def _read_manifest(path: str, expect: str) -> dict:
    with open(os.path.join(path, "pipeline_metadata.json")) as f:
        blob = json.load(f)
    if blob.get("type") != expect:
        raise ValueError(
            f"not a {expect} directory: {path} (found {blob.get('type')!r})"
        )
    return blob


class Pipeline:
    """Chain of stages; each is fit on the running DataFrame and its
    transform feeds the next stage (ml.Pipeline semantics: estimators
    become models, transformers pass through)."""

    def __init__(self, *, stages: Optional[Sequence] = None):
        self._stages = list(stages or [])

    def setStages(self, stages):
        self._stages = list(stages)
        return self

    def getStages(self):
        return list(self._stages)

    def fit(self, dataset) -> "PipelineModel":
        fitted = []
        df = dataset
        # transform only feeds DOWNSTREAM fits: stages past the last
        # estimator never need the training frame scored (Spark's
        # indexOfLastEstimator rule — a trailing pre-fitted transformer
        # must not cost a full wasted pass over the training data)
        last_fit = max(
            (i for i, s in enumerate(self._stages) if hasattr(s, "fit")),
            default=-1,
        )
        for i, stage in enumerate(self._stages):
            if hasattr(stage, "fit"):
                model = stage.fit(df)
            elif hasattr(stage, "transform"):
                model = stage  # already a transformer
            else:
                raise TypeError(
                    f"pipeline stage {i} ({type(stage).__name__}) has "
                    "neither fit nor transform"
                )
            if i < last_fit:
                df = model.transform(df)
            fitted.append(model)
        return PipelineModel(fitted)

    def save(self, path: str) -> None:
        """Persist the (unfitted) stage list — param snapshots for
        estimators, model save for pre-fitted transformer stages."""
        stages = []
        for i, stage in enumerate(self._stages):
            d = f"stage_{i:02d}_{type(stage).__name__}"
            _save_stage(stage, os.path.join(path, d))
            stages.append({"dir": d, **_class_ref(stage)})
        _write_manifest(path, {"type": "Pipeline", "version": 1,
                               "stages": stages})

    @classmethod
    def load(cls, path: str) -> "Pipeline":
        blob = _read_manifest(path, "Pipeline")
        return cls(stages=[
            _load_stage(s, os.path.join(path, s["dir"]))
            for s in blob["stages"]
        ])


class PipelineModel:
    def __init__(self, stages: List):
        self.stages = list(stages)

    def transform(self, dataset):
        df = dataset
        for stage in self.stages:
            df = stage.transform(df)
        return df

    def save(self, path: str) -> None:
        """Persist every fitted stage via its own save (column names,
        coldStartStrategy, seen-id sets all ride the stage models'
        metadata)."""
        stages = []
        for i, stage in enumerate(self.stages):
            d = f"stage_{i:02d}_{type(stage).__name__}"
            _save_stage(stage, os.path.join(path, d))
            stages.append({"dir": d, **_class_ref(stage)})
        _write_manifest(path, {"type": "PipelineModel", "version": 1,
                               "stages": stages})

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        blob = _read_manifest(path, "PipelineModel")
        return cls([
            _load_stage(s, os.path.join(path, s["dir"]))
            for s in blob["stages"]
        ])


class ParamGridBuilder:
    """Cartesian grid over setter-name -> values (see module notes for
    the string-name deviation from Spark's Param objects)."""

    def __init__(self):
        self._grid: Dict[str, list] = {}

    def addGrid(self, param: str, values) -> "ParamGridBuilder":
        if not str(param):
            raise ValueError("param name must be non-empty")
        self._grid[str(param)] = list(values)
        return self

    def baseOn(self, params: Dict[str, object]) -> "ParamGridBuilder":
        """Fixed params applied to every map (Spark's baseOn)."""
        for k, v in params.items():
            self._grid[str(k)] = [v]
        return self

    def build(self) -> List[Dict[str, object]]:
        maps = [{}]
        for name, values in self._grid.items():
            maps = [{**m, name: v} for m in maps for v in values]
        return maps


def _setter(est, name: str):
    setter = getattr(est, "set" + name[0].upper() + name[1:], None)
    if setter is None:
        raise ValueError(
            f"{type(est).__name__} has no setter for param {name!r}"
        )
    return setter


def _apply_params(estimator, param_map: Dict[str, object]):
    est = copy.deepcopy(estimator)
    for name, value in param_map.items():
        _setter(est, name)(value)
    return est


def _as_dict(dataset) -> dict:
    """Dict-plane copy of a DataFrame via the adapters' documented ONE
    collect (see compat/pyspark._collect_once: every column must come
    from the same materializing action).  Cell conversion (vectors,
    lists, scalars) is compat/pyspark._column_to_array — one set of
    duck-type rules for every ingestion path.  Dicts return
    unchanged."""
    if isinstance(dataset, dict):
        return dataset
    if not (hasattr(dataset, "collect") and hasattr(dataset, "columns")):
        raise TypeError(
            "dataset must be a dict DataFrame or a Spark DataFrame "
            f"(got {type(dataset).__name__})"
        )
    from oap_mllib_tpu_torch.compat.pyspark import _column_to_array

    rows, cols = dataset.collect(), list(dataset.columns)
    return {
        c: _column_to_array([r[j] for r in rows])
        for j, c in enumerate(cols)
    }


def _tuner_prepare(estimator, evaluator, maps, dataset, kind: str):
    """Shared guard rails for both tuners: presence checks, the
    empty-grid error, EAGER setter validation (an unknown param must
    fail before any split is fit — and before the dataset is even
    collected), then the one-collect to the dict plane for Spark
    DataFrames.  Returns (param-map list, dict data for the split
    loop)."""
    if estimator is None or evaluator is None:
        raise ValueError("estimator and evaluator must be set")
    maps = [{}] if maps is None else list(maps)
    if not maps:
        # an EXPLICIT empty grid (e.g. addGrid with an empty values
        # list collapses the Cartesian product to zero maps) must not
        # silently become a defaults-only run
        raise ValueError(
            "estimatorParamMaps is empty — the param grid collapsed "
            "to zero maps (addGrid with an empty values list?)"
        )
    for m in maps:
        for name in m:
            _setter(estimator, name)
    from oap_mllib_tpu_torch.parallel import bootstrap

    if bootstrap.world_size() > 1:
        # splitting/refitting on collected copies would feed every rank
        # the FULL data as its "local shard" (world-duplicated rows);
        # tuning is a driver-side, single-process flow
        raise NotImplementedError(
            f"{kind} runs single-process; in a multi-process world run "
            "the tuner on one process (or fit the chosen params "
            "directly with the multi-host estimators)"
        )
    return maps, _as_dict(dataset)


def _select_and_refit(estimator, evaluator, maps, metrics, dataset,
                      label: str):
    """Shared selection tail: NaN guard (np.argmin/argmax return a
    NaN's index, so a single NaN split — e.g. coldStartStrategy="nan"
    leaking NaN predictions into RMSE — would silently win), argbest by
    the evaluator's direction, refit the winner on the full data.
    Returns (best_model, best_index)."""
    if any(np.isnan(a) for a in metrics):
        bad = [m for m, a in zip(maps, metrics) if np.isnan(a)]
        raise ValueError(
            f"{label} metric is NaN for param map(s) {bad} — with ALS "
            'use coldStartStrategy="drop" and ensure every split keeps '
            "evaluable rows"
        )
    larger = bool(evaluator.isLargerBetter())
    best = int(np.argmax(metrics) if larger else np.argmin(metrics))
    return _apply_params(estimator, maps[best]).fit(dataset), best


def _n_rows(df: dict) -> int:
    arrays = list(df.values())
    if not arrays:
        raise ValueError("empty DataFrame")
    n = len(np.asarray(arrays[0]))
    for a in arrays[1:]:
        if len(np.asarray(a)) != n:
            raise ValueError("ragged DataFrame columns")
    return n


def _take(df: dict, idx: np.ndarray) -> dict:
    return {k: np.asarray(v)[idx] for k, v in df.items()}


class CrossValidator:
    """k-fold model selection (ml.tuning.CrossValidator): for every
    param map, average the evaluator metric over numFolds held-out
    folds, pick the best by the evaluator's isLargerBetter, refit on
    the full data.  Dict-plane DataFrames only (see module notes)."""

    def __init__(self, *, estimator=None, estimatorParamMaps=None,
                 evaluator=None, numFolds: int = 3, seed: int = 0):
        self._estimator = estimator
        self._maps = estimatorParamMaps
        self._evaluator = evaluator
        self._numFolds = numFolds
        self._seed = seed

    def setEstimator(self, v):          self._estimator = v; return self
    def setEstimatorParamMaps(self, v): self._maps = v; return self
    def setEvaluator(self, v):          self._evaluator = v; return self
    def setNumFolds(self, v):           self._numFolds = v; return self
    def setSeed(self, v):               self._seed = v; return self

    def getEstimator(self):          return self._estimator
    def getEstimatorParamMaps(self): return self._maps
    def getEvaluator(self):          return self._evaluator
    def getNumFolds(self):           return self._numFolds

    def fit(self, dataset) -> "CrossValidatorModel":
        if self._numFolds < 2:  # before _tuner_prepare's collect
            raise ValueError("numFolds must be >= 2")
        maps, data = _tuner_prepare(
            self._estimator, self._evaluator, self._maps, dataset,
            "CrossValidator",
        )
        n = _n_rows(data)
        if n < self._numFolds:
            raise ValueError(
                f"{n} rows cannot split into {self._numFolds} folds"
            )
        perm = np.random.default_rng(self._seed).permutation(n)
        folds = np.array_split(perm, self._numFolds)

        avg = []
        for m in maps:
            scores = []
            for f in range(self._numFolds):
                test_idx = folds[f]
                train_idx = np.concatenate(
                    [folds[g] for g in range(self._numFolds) if g != f]
                )
                est = _apply_params(self._estimator, m)
                model = est.fit(_take(data, train_idx))
                pred = model.transform(_take(data, test_idx))
                scores.append(float(self._evaluator.evaluate(pred)))
            avg.append(float(np.mean(scores)))

        # refit on the ORIGINAL dataset: a Spark-plane tuner must hand
        # back a bestModel that transforms DataFrames
        best_model, best = _select_and_refit(
            self._estimator, self._evaluator, maps, avg, dataset, "CV"
        )
        return CrossValidatorModel(best_model, avg, maps[best])


class CrossValidatorModel:
    def __init__(self, bestModel, avgMetrics: List[float],
                 bestParams: Dict[str, object]):
        self.bestModel = bestModel
        self.avgMetrics = list(avgMetrics)
        self.bestParams = dict(bestParams)

    def transform(self, dataset):
        return self.bestModel.transform(dataset)

    def save(self, path: str) -> None:
        _save_stage(self.bestModel, os.path.join(path, "bestModel"))
        _write_manifest(path, {
            "type": "CrossValidatorModel", "version": 1,
            "bestModel": {"dir": "bestModel", **_class_ref(self.bestModel)},
            "avgMetrics": [float(a) for a in self.avgMetrics],
            "bestParams": {k: _jsonable(v)
                           for k, v in self.bestParams.items()},
        })

    @classmethod
    def load(cls, path: str) -> "CrossValidatorModel":
        blob = _read_manifest(path, "CrossValidatorModel")
        best = _load_stage(blob["bestModel"],
                           os.path.join(path, blob["bestModel"]["dir"]))
        return cls(best, blob["avgMetrics"], blob["bestParams"])


class TrainValidationSplit:
    """Single-split model selection (ml.tuning.TrainValidationSplit):
    CrossValidator's cheaper sibling — one random train/validation
    split per param map instead of k folds.  Same dict-plane scope,
    setter-name grids, and NaN/empty-grid guard rails."""

    def __init__(self, *, estimator=None, estimatorParamMaps=None,
                 evaluator=None, trainRatio: float = 0.75, seed: int = 0):
        self._estimator = estimator
        self._maps = estimatorParamMaps
        self._evaluator = evaluator
        self._trainRatio = trainRatio
        self._seed = seed

    def setEstimator(self, v):          self._estimator = v; return self
    def setEstimatorParamMaps(self, v): self._maps = v; return self
    def setEvaluator(self, v):          self._evaluator = v; return self
    def setTrainRatio(self, v):         self._trainRatio = v; return self
    def setSeed(self, v):               self._seed = v; return self

    def getEstimator(self):          return self._estimator
    def getEstimatorParamMaps(self): return self._maps
    def getEvaluator(self):          return self._evaluator
    def getTrainRatio(self):         return self._trainRatio

    def fit(self, dataset) -> "TrainValidationSplitModel":
        if not 0.0 < self._trainRatio < 1.0:  # before the collect
            raise ValueError("trainRatio must be in (0, 1)")
        maps, data = _tuner_prepare(
            self._estimator, self._evaluator, self._maps, dataset,
            "TrainValidationSplit",
        )
        n = _n_rows(data)
        n_train = int(n * self._trainRatio)
        if n_train < 1 or n_train >= n:
            raise ValueError(
                f"trainRatio={self._trainRatio} leaves an empty split "
                f"({n} rows)"
            )
        perm = np.random.default_rng(self._seed).permutation(n)
        train = _take(data, perm[:n_train])
        val = _take(data, perm[n_train:])

        metrics = []
        for m in maps:
            model = _apply_params(self._estimator, m).fit(train)
            metrics.append(
                float(self._evaluator.evaluate(model.transform(val)))
            )
        best_model, best = _select_and_refit(
            self._estimator, self._evaluator, maps, metrics, dataset,
            "validation",
        )
        return TrainValidationSplitModel(best_model, metrics, maps[best])


class TrainValidationSplitModel:
    def __init__(self, bestModel, validationMetrics: List[float],
                 bestParams: Dict[str, object]):
        self.bestModel = bestModel
        self.validationMetrics = list(validationMetrics)
        self.bestParams = dict(bestParams)

    def transform(self, dataset):
        return self.bestModel.transform(dataset)

    def save(self, path: str) -> None:
        _save_stage(self.bestModel, os.path.join(path, "bestModel"))
        _write_manifest(path, {
            "type": "TrainValidationSplitModel", "version": 1,
            "bestModel": {"dir": "bestModel", **_class_ref(self.bestModel)},
            "validationMetrics": [float(a) for a in self.validationMetrics],
            "bestParams": {k: _jsonable(v)
                           for k, v in self.bestParams.items()},
        })

    @classmethod
    def load(cls, path: str) -> "TrainValidationSplitModel":
        blob = _read_manifest(path, "TrainValidationSplitModel")
        best = _load_stage(blob["bestModel"],
                           os.path.join(path, blob["bestModel"]["dir"]))
        return cls(best, blob["validationMetrics"], blob["bestParams"])
