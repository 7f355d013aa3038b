"""ALS through the Spark-ML compat surface, a line-for-line port of the
reference's PySpark example (examples/als-pyspark/als-pyspark.py:40-67):
parse user::item::rating lines, random 80/20 split, fit implicit ALS with
coldStartStrategy="drop" so the held-out RMSE never sees NaN, evaluate.

Where the reference builds a SparkSession DataFrame, the compat surface
takes a dict of numpy columns; everything from the ALS() builder call on
is the same API.
"""

import argparse
import os

import numpy as np

from oap_mllib_tpu_torch.examples import DATA, add_device_arg


def main():
    p = argparse.ArgumentParser(description="oap-mllib-tpu-torch ALS compat example")
    p.add_argument("--data", default=os.path.join(DATA, "sample_als_ratings.txt"))
    p.add_argument("--seed", type=int, default=42)
    add_device_arg(p)
    args = p.parse_args()

    from oap_mllib_tpu_torch.compat.spark import ALS, RegressionEvaluator
    from oap_mllib_tpu_torch.config import set_config

    set_config(device=args.device)

    # lines.map(lambda row: row.value.split("::")) -> Row(userId, movieId, rating)
    with open(args.data) as f:
        parts = [ln.split("::") for ln in f if ln.strip()]
    ratings = {
        "userId": np.asarray([int(r[0]) for r in parts], np.int64),
        "movieId": np.asarray([int(r[1]) for r in parts], np.int64),
        "rating": np.asarray([float(r[2]) for r in parts], np.float32),
    }

    # ratings.randomSplit([0.8, 0.2])
    rng = np.random.default_rng(args.seed)
    in_train = rng.random(len(ratings["rating"])) < 0.8
    training = {k: v[in_train] for k, v in ratings.items()}
    test = {k: v[~in_train] for k, v in ratings.items()}

    # reference hyperparameters (als-pyspark.py:52-54)
    als = (
        ALS()
        .setRank(10).setMaxIter(5).setRegParam(0.01)
        .setImplicitPrefs(True).setAlpha(40.0)
        .setUserCol("userId").setItemCol("movieId").setRatingCol("rating")
        .setColdStartStrategy("drop")
    )
    print(
        "\nALS training with implicitPrefs={}, rank={}, maxIter={}, "
        "regParam={}, alpha={}, seed={}\n".format(
            als.getImplicitPrefs(), als.getRank(), als.getMaxIter(),
            als.getRegParam(), als.getAlpha(), args.seed,
        )
    )
    model = als.fit(training)

    # RegressionEvaluator(metricName="rmse", labelCol="rating",
    # predictionCol="prediction"), reference als-pyspark.py:62; implicit
    # ALS predicts a preference score, so like the reference example this
    # is a smoke metric, not a ratings-scale fit
    predictions = model.transform(test)
    dropped = len(test["rating"]) - len(predictions["rating"])
    if dropped:
        print(f"coldStartStrategy=drop removed {dropped} cold test rows")
    evaluator = RegressionEvaluator(
        metricName="rmse", labelCol="rating", predictionCol="prediction"
    )
    rmse = evaluator.evaluate(predictions)
    print("Root-mean-square error = " + str(rmse))


if __name__ == "__main__":
    main()
