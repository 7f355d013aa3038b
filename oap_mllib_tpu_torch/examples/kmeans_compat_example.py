"""K-Means through the Spark-ML compat surface, the reference's PySpark
twin (examples/kmeans-pyspark/kmeans-pyspark.py:47-67): load libsvm data,
fit KMeans().setK(2).setSeed(1), transform, score the clustering with
ClusteringEvaluator (squared-euclidean silhouette), and print the
cluster centers.

Where the reference builds a SparkSession DataFrame from libsvm, the
compat surface takes a dict of numpy columns.
"""

import argparse
import os

from oap_mllib_tpu_torch.examples import DATA, add_device_arg


def main():
    p = argparse.ArgumentParser(description="oap-mllib-tpu-torch K-Means compat example")
    p.add_argument("--data", default=os.path.join(DATA, "sample_kmeans_data.txt"))
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--seed", type=int, default=1)
    add_device_arg(p)
    args = p.parse_args()

    from oap_mllib_tpu_torch.compat.spark import ClusteringEvaluator, KMeans
    from oap_mllib_tpu_torch.config import set_config
    from oap_mllib_tpu_torch.data.io import read_libsvm

    set_config(device=args.device)

    # spark.read.format("libsvm").load(path)
    _, x = read_libsvm(args.data)
    dataset = {"features": x}

    # KMeans().setK(2).setSeed(1); model = kmeans.fit(dataset)
    kmeans = KMeans().setK(args.k).setSeed(args.seed)
    model = kmeans.fit(dataset)

    # predictions = model.transform(dataset)
    predictions = model.transform(dataset)

    # evaluator = ClusteringEvaluator(); silhouette = evaluator.evaluate(...)
    evaluator = ClusteringEvaluator()
    silhouette = evaluator.evaluate(predictions)
    print("Silhouette with squared euclidean distance = " + str(silhouette))

    print("Cluster Centers: ")
    for center in model.clusterCenters():
        print(center)


if __name__ == "__main__":
    main()
