"""The reference's PySpark K-Means example, verbatim-minus-import.

This is the reference's examples/kmeans-pyspark/kmeans-pyspark.py
(itself Apache-2.0 Spark sample code) with exactly ONE functional
change: the estimator/evaluator imports come from
``oap_mllib_tpu_torch.compat.pyspark`` instead of ``pyspark.ml.*``
(Python has no classpath shadowing, so the import line IS the drop-in
point — see compat/pyspark.py module notes). Everything else — the
SparkSession, the libsvm load, the builder-style KMeans, the transform +
ClusteringEvaluator flow — is the reference example's own code and
requires a pyspark installation; without one this script reports the
skip and exits 0 (so ``run_all.sh`` stays green where pyspark is not
installed). The same adapter flow runs against a mocked DataFrame in
tests/test_torch_pyspark_compat.py."""

from __future__ import print_function

import os
import sys

from oap_mllib_tpu_torch.examples import DATA

try:
    from pyspark.sql import SparkSession
except ImportError:
    print("pyspark is not installed - skipping the drop-in PySpark example "
          "(the adapter's contract is covered by tests/test_torch_pyspark_compat.py)")
    sys.exit(0)

# THE drop-in change: these two lines read
#   from pyspark.ml.clustering import KMeans
#   from pyspark.ml.evaluation import ClusteringEvaluator
# in the reference example (kmeans-pyspark.py:29-30)
from oap_mllib_tpu_torch.compat.pyspark import ClusteringEvaluator, KMeans  # noqa: E402

if __name__ == "__main__":
    spark = SparkSession\
        .builder\
        .appName("KMeansExample")\
        .getOrCreate()

    # positional arg like the reference (kmeans-pyspark.py <libsvm path>);
    # run_all.sh's --device flags are for the non-pyspark examples and
    # fall through to the bundled default data here
    path = (
        sys.argv[1]
        if len(sys.argv) == 2 and not sys.argv[1].startswith("--")
        else os.path.join(DATA, "sample_kmeans_data.txt")
    )

    # Loads data.
    dataset = spark.read.format("libsvm").load(path)

    # Trains a k-means model.
    kmeans = KMeans().setK(2).setSeed(1)
    model = kmeans.fit(dataset)

    # Make predictions
    predictions = model.transform(dataset)

    # Evaluate clustering by computing Silhouette score
    evaluator = ClusteringEvaluator()

    silhouette = evaluator.evaluate(predictions)
    print("Silhouette with squared euclidean distance = " + str(silhouette))

    # Shows the result.
    centers = model.clusterCenters()
    print("Cluster Centers: ")
    for center in centers:
        print(center)

    spark.stop()
