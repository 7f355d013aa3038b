"""Walls and answers of the models' batch scoring (K-Means ``predict``,
PCA ``transform``) at the headline shapes, for comparing two checkouts
on one card in one run.

    python oap_mllib_tpu_torch/tools/score_walls.py --root DIR --out OUT [--reps 5] [--rows N]
    python oap_mllib_tpu_torch/tools/score_walls.py --compare OUT_A OUT_B

The first form imports ``oap_mllib_tpu_torch`` from the checkout at
``DIR`` (it uses nothing but the estimators, which every checkout of the
port has), fits the K-Means headline (k = 1000, d = 256, n = 2^20,
k-means||, 20 iterations) and PCA k = 16 on 2^20 x 128 (``--rows`` cuts
n for a check on the CPU), then scores each fit's own table from host
memory once to warm up and ``--reps`` times more: ``model.predict`` and
``model.transform``.  It prints
``SCORE_WALLS <json>`` (each wall, their median, sha256 digests of the
centers, components, labels and projections, the card's name) and
writes the four arrays to ``OUT`` as ``.npy``.  The second form loads
two such directories and prints ``SCORE_PARITY <json>``: whether the
fits and the answers are bit-equal, how many labels differ, the largest
projection difference.  Run two checkouts as parent, change, change,
parent in one command, then compare.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

NAMES = ("centers", "components", "labels", "projections")


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


def _digest(a) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def measure(root: str, out: str, reps: int, device: str, rows: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from oap_mllib_tpu_torch import PCA, KMeans

    dev = torch.device(device)
    x = _blobs(rows, 256, 1000, dev, seed=0)
    km = KMeans(k=1000, max_iter=20, tol=1e-4, init_mode="k-means||", seed=0,
                device=str(dev)).fit(x)
    xh = x.cpu().numpy()
    del x
    xp = _pca_data(rows, 128, dev, seed=128)
    pca = PCA(k=16, device=str(dev)).fit(xp)
    xph = xp.cpu().numpy()
    del xp

    def timed(fn):
        fn()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            walls.append(time.perf_counter() - t0)
        return res, walls

    labels, km_walls = timed(lambda: km.predict(xh))
    proj, pca_walls = timed(lambda: pca.transform(xph))
    arrays = dict(zip(NAMES, (km.cluster_centers_, pca.components_, labels, proj)))
    os.makedirs(out, exist_ok=True)
    for name, a in arrays.items():
        np.save(os.path.join(out, f"{name}.npy"), a)
    return {
        "root": root, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "predict_s": km_walls, "predict_median_s": float(np.median(km_walls)),
        "transform_s": pca_walls, "transform_median_s": float(np.median(pca_walls)),
        "sha256": {name: _digest(a) for name, a in arrays.items()},
    }


def compare(a: str, b: str) -> dict:
    import numpy as np

    got = {name: tuple(np.load(os.path.join(d, f"{name}.npy")) for d in (a, b))
           for name in NAMES}
    out = {name: bool(np.array_equal(u, v)) for name, (u, v) in got.items()}
    la, lb = got["labels"]
    pa, pb = got["projections"]
    out["labels_differing"] = int(np.sum(la != lb))
    out["projections_max_abs_diff"] = float(np.max(np.abs(pa.astype(np.float64) - pb)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="the checkout to import the port from")
    ap.add_argument("--out", help="the directory the arrays are written to")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--compare", nargs=2, metavar=("OUT_A", "OUT_B"))
    args = ap.parse_args(argv)
    if args.compare:
        print("SCORE_PARITY " + json.dumps(compare(*args.compare)), flush=True)
        return 0
    if not (args.root and args.out):
        ap.error("--root and --out are required unless --compare is given")
    print("SCORE_WALLS " + json.dumps(measure(args.root, args.out, args.reps, args.device,
                                                args.rows)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
