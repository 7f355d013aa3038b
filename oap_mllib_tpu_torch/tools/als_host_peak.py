"""Host memory of the one-device ALS fit at ML-25M scale, for comparing
checkouts on one card in one run.

    python oap_mllib_tpu_torch/tools/als_host_peak.py --root DIR [--nnz N] [--device cuda]

imports ``oap_mllib_tpu_torch`` from the checkout at ``DIR`` (this file
uses nothing but ``ALS``, which every checkout of the port has), makes
the ratings of fit_walls.py (162,541 users, 59,047 items, 25M ratings
or ``--nnz``, int32 ids), fits once on their first 2^20 ratings to
start the card and build the kernels, then fits the implicit ALS (rank
10, 10 iterations)
on all of them while a thread reads the process's resident set from
``/proc/self/statm`` every millisecond.  Prints ``ALS_HOST_PEAK <json>``:
the resident set just before the fit, its polled peak during the fit,
the process's high-water mark (``VmHWM``) before and after, the peak's
growth over the start in bytes and bytes an edge, the fit's wall and the
card.  Run each checkout in a process of its own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

N_USERS, N_ITEMS, NNZ = 162_541, 59_047, 25_000_000


def _rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _hwm() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return -1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the checkout to import the port from")
    ap.add_argument("--nnz", type=int, default=NNZ)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from oap_mllib_tpu_torch import ALS

    nnz = args.nnz
    users = np.random.default_rng(3).integers(N_USERS, size=nnz).astype(np.int32)
    items = (np.random.default_rng(4).zipf(1.3, size=nnz) % N_ITEMS).astype(np.int32)
    ratings = (np.random.default_rng(5).random(nnz) * 4 + 1).astype(np.float32)

    def fit(n):
        return ALS(rank=10, max_iter=10, reg_param=0.1, implicit_prefs=True, alpha=40.0,
                   seed=0, device=args.device).fit(users[:n], items[:n], ratings[:n],
                                                   N_USERS, N_ITEMS)

    fit(min(nnz, 1 << 20))
    sys.setswitchinterval(1e-4)
    peak, done = [0], threading.Event()

    def poll():
        while not done.is_set():
            peak[0] = max(peak[0], _rss())
            time.sleep(1e-3)

    before, hwm_before = _rss(), _hwm()
    watcher = threading.Thread(target=poll, daemon=True)
    watcher.start()
    t0 = time.perf_counter()
    model = fit(nnz)
    wall = time.perf_counter() - t0
    done.set()
    watcher.join()
    peak_rss = max(peak[0], _rss())
    assert np.isfinite(model.user_factors_).all()
    out = {"root": root,
           "card": torch.cuda.get_device_name(0) if args.device.startswith("cuda") else "cpu",
           "nnz": nnz, "rss_before": before, "rss_peak": peak_rss,
           "hwm_before": hwm_before, "hwm_after": _hwm(),
           "growth": peak_rss - before, "growth_per_edge": (peak_rss - before) / nnz,
           "fit_s": wall}
    print("ALS_HOST_PEAK " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
