"""PCA through the Spark-ML compat surface, the reference's PySpark twin
(examples/pca-pyspark/pca-pyspark.py:30-46): read a headerless CSV,
assemble all columns into a features vector, fit PCA(k=K), print the
principal components and the explained-variance ratios.

Where the reference uses VectorAssembler on a SparkSession DataFrame,
the compat surface takes a dict of numpy columns.
"""

import argparse
import os

from oap_mllib_tpu_torch.examples import DATA, add_device_arg


def main():
    p = argparse.ArgumentParser(description="oap-mllib-tpu-torch PCA compat example")
    p.add_argument("--data", default=os.path.join(DATA, "pca_data.csv"))
    p.add_argument("--k", type=int, default=3)
    add_device_arg(p)
    args = p.parse_args()

    from oap_mllib_tpu_torch.compat.spark import PCA
    from oap_mllib_tpu_torch.config import set_config
    from oap_mllib_tpu_torch.data.io import read_csv

    set_config(device=args.device)

    # spark.read.load(csv) + VectorAssembler(inputCols=..., outputCol="features")
    x = read_csv(args.data)
    dataset = {"features": x}
    print(f"dataset: {x.shape[0]} rows x {x.shape[1]} cols")

    # PCA(k=K, inputCol="features", outputCol="pcaFeatures")
    pca = PCA().setK(args.k).setInputCol("features").setOutputCol("pcaFeatures")
    model = pca.fit(dataset)

    print("Principal Components: ", model.pc, sep="\n")
    print("Explained Variance: ", model.explainedVariance, sep="\n")

    projected = model.transform(dataset)
    print("pcaFeatures (first 3 rows): ", projected["pcaFeatures"][:3], sep="\n")


if __name__ == "__main__":
    main()
