"""Times of K1's and K2's kernel forms on the card, for comparing
checkouts on one card in one run.

    python oap_mllib_tpu_torch/tools/kernel_walls.py --root DIR [--reps 10]
        [--lanes x64,wide,gram]

imports ``oap_mllib_tpu_torch`` from the checkout at ``DIR`` (only the
wrappers ``kmeans_kernel.lloyd_accumulate`` and ``pca_kernel.pca_moments``,
which every checkout since the float64 lane has), builds its kernels,
and times, by lane:

- ``x64``: the float64 forms at the main paths' shapes: K1 f64 at 2^20
  x 256, k = 1000, in loop and cost mode, and K2 f64's Gram pass at 2^20
  x 128 and 2^18 x 1024;
- ``wide``: K1 on f32 rows wider than 256 features, 2^20 x 512 and 2^20
  x 960 (GIST1M's width), k = 1000, every tier, loop and cost mode;
- ``gram``: K2's f32 Gram pass at 2^20 x 128 and 2^18 x 1024, every
  tier, with its largest difference (relative to the Gram's largest
  entry) from the plain version and from the float64 Gram of the same
  formed f32 values (the plain version's own beside it), and
  ``torch.matmul(xc.T, xc)`` (f32 with TF32 off at highest, bf16 at the
  bf16 tiers).

Each time is a mean over ``--reps`` calls between CUDA events after a
warm call; beside it, the device ms of the kernels of one call from
torch.profiler (the assignment's and the Gram's own kernels).  Prints
``KERNEL_WALLS <json>`` with the card's name and power limit.  Run two
checkouts as parent, change, change, parent in one command to compare
them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


WIDE_SHAPES = ((1 << 20, 512), (1 << 20, 960))
GRAM_SHAPES = ((1 << 20, 128), (1 << 18, 1024))
LANES = ("x64", "wide", "gram")
WIDE_K = 1000


def _data(dev, seed, n, d, k=None, dtype=None):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f64 = torch.float64 if dtype is None else dtype
    if k is None:
        q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev, dtype=f64))
        scale = 10.0 * 0.85 ** torch.arange(d, device=dev, dtype=f64)
        z = torch.randn((n, d), generator=g, device=dev, dtype=f64) * scale
        return (z @ q.T + 3.0).contiguous()
    true = torch.randn((k, d), generator=g, device=dev, dtype=f64) * 2.0
    lab = torch.randint(0, k, (n,), generator=g, device=dev)
    x = (true[lab] + torch.randn((n, d), generator=g, device=dev, dtype=f64)).contiguous()
    w = 0.5 + torch.rand((n,), generator=g, device=dev, dtype=f64)
    c = (true + 0.5 * torch.randn((k, d), generator=g, device=dev, dtype=f64)).contiguous()
    return x, w, c


def _ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _split(fn):
    """Device ms by kernel name of one call (torch.profiler over three
    calls, each kernel's mean over the launches recorded: the tracer can
    drop one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        if us:
            out[ev.key[:60]] = out.get(ev.key[:60], 0.0) + us / max(1, ev.count) / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--lanes", default="x64,wide",
                    help="comma-separated: x64 (the float64 forms), wide (K1 f32 at d > 256), "
                         "gram (K2's f32 Gram pass, every tier)")
    args = ap.parse_args(argv)
    lanes = set(args.lanes.split(","))
    if not lanes <= set(LANES):
        ap.error(f"unknown lanes {sorted(lanes - set(LANES))}")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from oap_mllib_tpu_torch.ops.cuda import kmeans_kernel, pca_kernel

    assert Path(kmeans_kernel.__file__).resolve().is_relative_to(root), kmeans_kernel.__file__
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"root": str(root), "card": smi.strip().splitlines()[0] if smi.strip() else None}
    if "wide" in lanes:
        _wide(out, kmeans_kernel, dev, args.reps)
    if "x64" in lanes:
        _x64(out, kmeans_kernel, pca_kernel, dev, args.reps)
    if "gram" in lanes:
        _gram_lane(out, pca_kernel, dev, args.reps)
    print("KERNEL_WALLS " + json.dumps(out), flush=True)
    return 0


def _wide(out, kmeans_kernel, dev, reps):
    """K1 f32 at the wide shapes, every tier and mode, with the checkout's
    assignment route."""
    import torch

    for n, d in WIDE_SHAPES:
        x, w, c = _data(dev, d, n, d, WIDE_K, torch.float32)
        route = kmeans_kernel.assign_route(d)
        for mode in ("highest", "high", "default"):
            for need_cost in (False, True):
                def run():
                    return kmeans_kernel.lloyd_accumulate(x, w, c, mode, need_cost)

                split = _split(run)
                out[f"wide_{n}x{d}_{mode}_{'cost' if need_cost else 'loop'}"] = {
                    "ms": _ms(run, reps), "route": route, "split_ms": split,
                    "assign_ms": sum(t for k, t in split.items() if "assign" in k)}
        del x, w, c


def _x64(out, kmeans_kernel, pca_kernel, dev, reps):
    import torch

    x, w, c = _data(dev, 0, 1 << 20, 256, 1000)
    for need_cost in (False, True):
        def run():
            return kmeans_kernel.lloyd_accumulate(x, w, c, "highest", need_cost)

        split = _split(run)
        out[f"k1_{'cost' if need_cost else 'loop'}"] = {
            "ms": _ms(run, reps), "split_ms": split,
            "assign_ms": sum(t for k, t in split.items() if "assign" in k)}
    del x, w, c
    for n, d in ((1 << 20, 128), (1 << 18, 1024)):
        x = _data(dev, d, n, d)
        mask = torch.ones(n, dtype=torch.float64, device=dev)
        mean = x.mean(dim=0)

        def gram():
            return pca_kernel.pca_moments(x, mask, mean, "highest", need_sums=False)

        split = _split(gram)
        out[f"k2_{n}x{d}"] = {"ms": _ms(gram, reps), "split_ms": split,
                              "gram_ms": sum(t for k, t in split.items() if "gram" in k
                                             and "sum_slices" not in k)}
        del x


def _gram_lane(out, pca_kernel, dev, reps):
    """K2's f32 Gram pass at every tier, with the library call beside it."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    for n, d in GRAM_SHAPES:
        x = _data(dev, d, n, d, dtype=torch.float32)
        mask = torch.ones(n, device=dev)
        mean = x.mean(dim=0)
        xc = x - mean
        ref64 = xc.double().T @ xc.double()
        for mode in ("highest", "high", "default"):
            def gram():
                return pca_kernel.pca_moments(x, mask, mean, mode, need_sums=False)

            g = gram()[0]
            ref = pca_kernel.pca_moments_plain(x, mask, mean, mode, need_sums=False)[0]
            a = xc if mode == "highest" else xc.to(torch.bfloat16)
            split = _split(gram)
            out[f"k2_gram_{n}x{d}_{mode}"] = {
                "ms": _ms(gram, reps), "split_ms": split,
                "gram_ms": sum(t for k, t in split.items() if "gram" in k
                               and "sum_slices" not in k),
                "rel_err": float((g - ref).abs().max() / ref.abs().max()),
                "rel_err_f64": float((g - ref64).abs().max() / ref64.abs().max()),
                "plain_rel_err_f64": float((ref - ref64).abs().max() / ref64.abs().max()),
                "symmetric": bool(torch.equal(g, g.T)),
                "library_ms": _ms(lambda: torch.matmul(a.T, a), reps),
                "library_call": "torch.matmul(xc.T, xc), "
                                + ("f32, TF32 off" if mode == "highest" else "bf16")}
            del g, ref, a
        del x, xc, ref64


if __name__ == "__main__":
    sys.exit(main())
