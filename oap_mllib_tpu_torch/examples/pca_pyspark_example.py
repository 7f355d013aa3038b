"""The reference's PySpark PCA example, verbatim-minus-import.

This is the reference's examples/pca-pyspark/pca-pyspark.py (itself
Apache-2.0 Spark sample code) with exactly ONE functional change: the
PCA import comes from ``oap_mllib_tpu_torch.compat.pyspark`` instead of
``pyspark.ml.feature`` (Python has no classpath shadowing, so the import
line IS the drop-in point — see compat/pyspark.py module notes).
VectorAssembler stays a stock pyspark transformer, exactly as in the
reference, whose classpath shadowing also replaces only PCA. Without a
pyspark installation this script reports the skip and exits 0 (so
``run_all.sh`` stays green where pyspark is not installed). The same
adapter flow runs against a mocked DataFrame in
tests/test_torch_pyspark_compat.py."""

from __future__ import print_function

import os
import sys

from oap_mllib_tpu_torch.examples import DATA

try:
    from pyspark.ml.feature import VectorAssembler
    from pyspark.sql import SparkSession
except ImportError:
    print("pyspark is not installed - skipping the drop-in PySpark example "
          "(the adapter's contract is covered by tests/test_torch_pyspark_compat.py)")
    sys.exit(0)

# THE drop-in change: this line reads
#   from pyspark.ml.feature import PCA
# in the reference example (pca-pyspark.py:21)
from oap_mllib_tpu_torch.compat.pyspark import PCA  # noqa: E402

if __name__ == "__main__":
    spark = SparkSession\
        .builder\
        .appName("PCAExample")\
        .getOrCreate()

    # positional args like the reference (pca-pyspark.py <csv> <K>);
    # run_all.sh's --device flags are for the non-pyspark examples and
    # fall through to the bundled default data here
    if len(sys.argv) == 3 and not sys.argv[1].startswith("--"):
        path, K = sys.argv[1], int(sys.argv[2])
    else:
        path = os.path.join(DATA, "pca_data.csv")
        K = 3

    input = spark.read.load(path, format="csv", inferSchema="true", header="false")

    assembler = VectorAssembler(
        inputCols=input.columns,
        outputCol="features")

    dataset = assembler.transform(input)
    dataset.show()

    pca = PCA(k=K, inputCol="features", outputCol="pcaFeatures")
    model = pca.fit(dataset)

    print("Principal Components: ", model.pc, sep='\n')
    print("Explained Variance: ", model.explainedVariance, sep='\n')

    spark.stop()
