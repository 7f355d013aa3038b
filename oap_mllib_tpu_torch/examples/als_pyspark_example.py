"""The reference's PySpark ALS example, verbatim-minus-import.

This is the reference's examples/als-pyspark/als-pyspark.py with exactly
ONE functional change: the estimator/evaluator imports come from
``oap_mllib_tpu_torch.compat.pyspark`` instead of ``pyspark.ml.*``
(Python has no classpath shadowing, so the import line IS the drop-in
point — see compat/pyspark.py module notes). Everything else — the
SparkSession, the RDD parse of ``::``-separated ratings, the
keyword-constructed ALS, the transform + RegressionEvaluator flow — is
the reference example's own code and requires a pyspark installation;
without one this script reports the skip and exits 0 (so ``run_all.sh``
stays green where pyspark is not installed). The same adapter flow runs
against a mocked DataFrame in tests/test_torch_pyspark_compat.py."""

from __future__ import print_function

import os
import sys

from oap_mllib_tpu_torch.examples import DATA

try:
    from pyspark.sql import Row, SparkSession
except ImportError:
    print("pyspark is not installed - skipping the drop-in PySpark example "
          "(the adapter's contract is covered by tests/test_torch_pyspark_compat.py)")
    sys.exit(0)

# THE drop-in change: these two lines read
#   from pyspark.ml.evaluation import RegressionEvaluator
#   from pyspark.ml.recommendation import ALS
# in the reference example (als-pyspark.py:27-28)
from oap_mllib_tpu_torch.compat.pyspark import ALS, RegressionEvaluator  # noqa: E402

if __name__ == "__main__":
    spark = SparkSession.builder.appName("ALSExample").getOrCreate()

    path = (
        sys.argv[1]
        if len(sys.argv) == 2
        else os.path.join(DATA, "sample_als_ratings.txt")
    )

    lines = spark.read.text(path).rdd
    parts = lines.map(lambda row: row.value.split("::"))
    ratingsRDD = parts.map(lambda p: Row(userId=int(p[0]), movieId=int(p[1]),
                                         rating=float(p[2])))
    ratings = spark.createDataFrame(ratingsRDD)
    (training, test) = ratings.randomSplit([0.8, 0.2])

    # Build the recommendation model using ALS on the training data
    # Note we set cold start strategy to 'drop' to ensure we don't get
    # NaN evaluation metrics
    als = ALS(rank=10, maxIter=5, regParam=0.01, implicitPrefs=True, alpha=40.0,
              userCol="userId", itemCol="movieId", ratingCol="rating",
              coldStartStrategy="drop")
    print("\nALS training with implicitPrefs={}, rank={}, maxIter={}, "
          "regParam={}, alpha={}, seed={}\n".format(
              als.getImplicitPrefs(), als.getRank(), als.getMaxIter(),
              als.getRegParam(), als.getAlpha(), als.getSeed()))
    model = als.fit(training)

    # Evaluate the model by computing the RMSE on the test data
    predictions = model.transform(test)
    evaluator = RegressionEvaluator(metricName="rmse", labelCol="rating",
                                    predictionCol="prediction")
    rmse = evaluator.evaluate(predictions)
    print("Root-mean-square error = " + str(rmse))

    spark.stop()
