"""PCA example, the mirror of the reference's examples/pca
(PCAExample.scala / pca-pyspark.py): load dense CSV, fit, print principal
components and explained variance.

Usage:
  python -m oap_mllib_tpu_torch.examples.pca_example [--data PATH] [--k 3] \
      [--device cuda|cpu] [--model-parallel N] [--timing]
"""

import argparse
import os

from oap_mllib_tpu_torch.examples import DATA, add_device_arg, print_timings


def main():
    p = argparse.ArgumentParser(description="oap-mllib-tpu-torch PCA example")
    p.add_argument("--data", default=os.path.join(DATA, "pca_data.csv"))
    p.add_argument("--k", type=int, default=3)
    add_device_arg(p)
    p.add_argument("--timing", action="store_true")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="model-axis size of a device list's mesh: >1 shards the (d, d) "
                        "Gram rows over (data, model)")
    args = p.parse_args()

    from oap_mllib_tpu_torch import PCA
    from oap_mllib_tpu_torch.config import set_config
    from oap_mllib_tpu_torch.data.io import read_csv

    set_config(device=args.device)
    if args.model_parallel is not None:
        set_config(model_parallel=args.model_parallel)

    x = read_csv(args.data)
    print(f"Loaded {x.shape[0]} rows x {x.shape[1]} features from {args.data}")

    model = PCA(k=args.k).fit(x)
    print(f"Accelerated path: {model.summary['accelerated']}")
    print("Principal components (columns):")
    for row in model.components_:
        print("  [" + ", ".join(f"{v: .4f}" for v in row) + "]")
    print("Explained variance ratios:",
          "[" + ", ".join(f"{v:.6f}" for v in model.explained_variance_) + "]")
    proj = model.transform(x[:3])
    print("First 3 projected rows:")
    for row in proj:
        print("  [" + ", ".join(f"{v: .4f}" for v in row) + "]")
    if args.timing:
        print_timings(model.summary["timings"])


if __name__ == "__main__":
    main()
