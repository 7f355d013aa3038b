"""K-Means example, the mirror of the reference's examples/kmeans
(KMeansExample.scala / kmeans-pyspark.py): load libsvm data, fit with the
port's estimator, print centers and cost.

Usage:
  python -m oap_mllib_tpu_torch.examples.kmeans_example [--data PATH] [--k 3] \
      [--max-iter 20] [--tol 1e-4] [--seed 0] [--init k-means||] [--device cuda|cpu] \
      [--timing]
"""

import argparse
import os

from oap_mllib_tpu_torch.examples import DATA, add_device_arg, print_timings


def main():
    p = argparse.ArgumentParser(description="oap-mllib-tpu-torch K-Means example")
    p.add_argument("--data", default=os.path.join(DATA, "sample_kmeans_data.txt"))
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--max-iter", type=int, default=20)
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", default="k-means||", choices=["random", "k-means||"])
    add_device_arg(p)
    p.add_argument("--timing", action="store_true", help="per-phase wall times")
    args = p.parse_args()

    from oap_mllib_tpu_torch import KMeans
    from oap_mllib_tpu_torch.config import set_config
    from oap_mllib_tpu_torch.data.io import read_libsvm

    set_config(device=args.device)
    _, x = read_libsvm(args.data)
    print(f"Loaded {x.shape[0]} rows x {x.shape[1]} features from {args.data}")

    model = KMeans(
        k=args.k, max_iter=args.max_iter, tol=args.tol, seed=args.seed,
        init_mode=args.init,
    ).fit(x)

    s = model.summary
    print(f"Accelerated path: {s.accelerated}")
    print(f"Converged in {s.num_iter} iterations, total cost {s.training_cost:.6f}")
    print("Cluster centers:")
    for c in model.cluster_centers_:
        print("  [" + ", ".join(f"{v:.4f}" for v in c) + "]")
    pred = model.predict(x)
    print("Predictions:", pred.tolist())
    if args.timing:
        print_timings(s.timings)


if __name__ == "__main__":
    main()
