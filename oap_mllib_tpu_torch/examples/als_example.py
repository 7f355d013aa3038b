"""ALS example, the mirror of the reference's examples/als
(ALSExample.scala / als-pyspark.py): load user::item::rating data, fit
implicit-feedback ALS with the reference example's hyperparameters
(implicitPrefs=true, alpha=40, rank=10, maxIter=5: reference
examples/als-pyspark/als-pyspark.py:52-54), print factors and training
RMSE.

Usage:
  python -m oap_mllib_tpu_torch.examples.als_example [--data PATH] [--rank 10] \
      [--max-iter 5] [--reg 0.1] [--alpha 40] [--explicit] [--device cuda|cpu] \
      [--als-kernel auto|grouped|coo] [--timing]
"""

import argparse
import os

import numpy as np

from oap_mllib_tpu_torch.examples import DATA, add_device_arg, print_timings


def main():
    p = argparse.ArgumentParser(description="oap-mllib-tpu-torch ALS example")
    p.add_argument("--data", default=os.path.join(DATA, "sample_als_ratings.txt"))
    p.add_argument("--rank", type=int, default=10)
    p.add_argument("--max-iter", type=int, default=5)
    p.add_argument("--reg", type=float, default=0.1)
    p.add_argument("--alpha", type=float, default=40.0)
    p.add_argument("--explicit", action="store_true",
                   help="explicit feedback (default implicit, like the reference example)")
    add_device_arg(p)
    p.add_argument("--timing", action="store_true")
    p.add_argument("--als-kernel", default=None, choices=["auto", "grouped", "coo"],
                   help="normal-equation layout (default auto: grouped unless the degree "
                        "distribution's padding blowup trips the guard; the fit summary "
                        "records the choice)")
    args = p.parse_args()

    from oap_mllib_tpu_torch import ALS
    from oap_mllib_tpu_torch.config import set_config
    from oap_mllib_tpu_torch.data.io import read_ratings

    set_config(device=args.device)
    if args.als_kernel:
        set_config(als_kernel=args.als_kernel)

    users, items, ratings = read_ratings(args.data)
    print(f"Loaded {len(ratings)} ratings, {users.max()+1} users, {items.max()+1} items")

    model = ALS(
        rank=args.rank, max_iter=args.max_iter, reg_param=args.reg,
        alpha=args.alpha, implicit_prefs=not args.explicit,
    ).fit(users, items, ratings)

    print(f"Accelerated path: {model.summary['accelerated']}")
    print(f"User factors: {model.user_factors_.shape}, item factors: {model.item_factors_.shape}")
    pred = model.predict(users, items)
    if args.explicit:
        rmse = float(np.sqrt(np.mean((pred - ratings) ** 2)))
        print(f"Training RMSE: {rmse:.4f}")
    else:
        # implicit: the preference reconstruction (target 1 for observed)
        rmse = float(np.sqrt(np.mean((pred - 1.0) ** 2)))
        print(f"Training preference RMSE (vs 1.0): {rmse:.4f}")
    recs = model.recommend_for_all_users(3)
    print("Top-3 recommendations for first 5 users:")
    for u in range(min(5, recs.shape[0])):
        print(f"  user {u}: items {recs[u].tolist()}")
    if args.timing:
        print_timings(model.summary["timings"])


if __name__ == "__main__":
    main()
