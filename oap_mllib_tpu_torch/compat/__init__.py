"""Spark-ML-style compatibility API: the port of the JAX package's
``compat``, over the port's estimators (on ``Config.device``).

The reference's public surface IS Spark ML: builder-style estimators
(``new KMeans().setK(2).setMaxIter(5).fit(df)``) over DataFrames with
named columns, shadowed by classpath substitution (survey §2.2).  This
package provides that calling convention for users migrating Spark ML /
PySpark code: the same param names in the same camelCase, column-oriented
input, ``transform`` that appends an output column.

A "DataFrame" here is a plain ``dict[str, np.ndarray]`` (column name ->
column values) — the dependency-free stand-in; ``fit`` also accepts a bare
ndarray for the features-only case.
"""

from oap_mllib_tpu_torch.compat.pipeline import (
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    Pipeline,
    PipelineModel,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from oap_mllib_tpu_torch.compat.spark import (
    ALS,
    ClusteringEvaluator,
    KMeans,
    PCA,
    RegressionEvaluator,
)

__all__ = [
    "KMeans", "PCA", "ALS", "ClusteringEvaluator", "RegressionEvaluator",
    "Pipeline", "PipelineModel", "ParamGridBuilder", "CrossValidator",
    "CrossValidatorModel", "TrainValidationSplit",
    "TrainValidationSplitModel",
]
