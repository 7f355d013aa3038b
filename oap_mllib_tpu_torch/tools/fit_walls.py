"""Walls of the four headline fits with every observability plane off,
for comparing two checkouts on one card in one run.

    python oap_mllib_tpu_torch/tools/fit_walls.py --root DIR [--reps 3] [--device cuda]

imports ``oap_mllib_tpu_torch`` from the checkout at ``DIR`` (this file
uses nothing but the estimators and ``set_config``, which every checkout
of the port has), fits each of them once to warm up, then ``--reps``
times: the K-Means headline (k = 1000, d = 256, n = 2^20, k-means||, 20
iterations), PCA k = 16 on 2^20 x 128, the implicit ML-25M-scale ALS
(rank 10, 10 iterations) and the sharded K-Means on a (2, 2) mesh of
ranks on the one card.  Prints ``FIT_WALLS <json>``: each fit's walls
and median, with the card's name.  Run two checkouts as parent, change,
change, parent in one command to compare them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _blobs(n, d, k, dev, seed, spread=2.0):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    true = torch.randn((k, d), generator=g, device=dev) * spread
    lab = torch.randint(0, k, (n,), generator=g, device=dev)
    return (true[lab] + torch.randn((n, d), generator=g, device=dev)).contiguous()


def _pca_data(n, d, dev, seed):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev))
    scale = 10.0 * 0.85 ** torch.arange(d, device=dev, dtype=torch.float32)
    z = torch.randn((n, d), generator=g, device=dev) * scale
    return (z @ q.T + 3.0).contiguous()


def _als_data(n_users, n_items, nnz):
    import numpy as np

    users = np.random.default_rng(3).integers(n_users, size=nnz).astype(np.int32)
    items = (np.random.default_rng(4).zipf(1.3, size=nnz) % n_items).astype(np.int32)
    ratings = (np.random.default_rng(5).random(nnz) * 4 + 1).astype(np.float32)
    return users, items, ratings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the checkout to import the port from")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from oap_mllib_tpu_torch import ALS, PCA, KMeans, set_config

    dev = torch.device(args.device)
    x = _blobs(1 << 20, 256, 1000, dev, seed=0)
    xp = _pca_data(1 << 20, 128, dev, seed=128)
    users, items, ratings = _als_data(162_541, 59_047, 25_000_000)
    mesh = ",".join([str(dev)] * 4)

    def kmeans():
        KMeans(k=1000, max_iter=20, tol=1e-4, init_mode="k-means||", seed=0,
               device=str(dev)).fit(x)

    def pca():
        PCA(k=16, device=str(dev)).fit(xp)

    def als():
        ALS(rank=10, max_iter=10, reg_param=0.1, implicit_prefs=True, alpha=40.0, seed=0,
            device=str(dev)).fit(users, items, ratings, 162_541, 59_047)

    def sharded():
        set_config(model_parallel=2)
        try:
            KMeans(k=1000, max_iter=20, tol=1e-4, seed=0, device=mesh).fit(x)
        finally:
            set_config(model_parallel=1)

    out = {"root": root, "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for name, fit in (("kmeans", kmeans), ("pca", pca), ("als", als), ("sharded", sharded)):
        fit()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fit()
            walls.append(time.perf_counter() - t0)
        out[name] = {"walls_s": walls, "median_s": float(np.median(walls))}
    print("FIT_WALLS " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
