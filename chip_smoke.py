#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py              # on a machine with the card
    python3 chip_smoke.py --rehearse   # the same phases on the CPU, tiny

Phases, each a hard check (any failure exits non-zero):

1. device: ``resolve_device("cuda")``; the card's name and power limit.
2. build: every kernel under ``oap_mllib_tpu_torch/csrc`` with nvcc.
3. small: each kernel against its plain version at small ragged shapes,
   every tier and mode, and the kernel Lloyd loop against the numpy
   reference.
4. kernels: each kernel at the main path's shapes (n = 2^20 rows,
   d = 256, k = 1000, f32 blobs): agreement with its plain version,
   determinism of two launches, times (CUDA events), the bound from the
   H100 SXM data sheet, and one PyTorch call as a yardstick.
5. fit (the main path): ``KMeans(k=1000, max_iter=20, tol=1e-4,
   init_mode="k-means||", seed=0).fit(x)``, with every launch count set
   to 0 just before and read just after; then predict and compute_cost,
   and the kernel Lloyd loop against the plain-version loop from the
   same initial centers.

The last three lines are the kernels JSON, the card from nvidia-smi and
``{"ok": true, "device": {...}}``.  ``--rehearse`` never prints the ok
line.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from oap_mllib_tpu_torch import KMeans
from oap_mllib_tpu_torch.fallback.kmeans_np import lloyd_np
from oap_mllib_tpu_torch.ops import kmeans_ops
from oap_mllib_tpu_torch.ops.cuda import _build, kmeans_kernel
from oap_mllib_tpu_torch.utils.dispatch import resolve_device

FULL = {"n": 1 << 20, "d": 256, "k": 1000}
TINY = {"n": 4133, "d": 29, "k": 11}
TIERS = ("highest", "high", "default")
# sums/counts tolerance on the same labels: highest/high sum f32 values
# (exact bf16 parts for high) in another order; default sums
# bf16-rounded values, whose order-dependent error is ~1e-3
RTOL = {"highest": 1e-4, "high": 1e-4, "default": 1e-2}
MIN_AGREEMENT = 0.9999
# H100 SXM data sheet: FP32 (no tensor cores), bf16 dense, HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
REPLACES = "oap_mllib_tpu/ops/pallas/kmeans_kernel.py:90"


class Failed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise Failed(what)


def emit(tag, payload):
    print(f"{tag} {json.dumps(payload, sort_keys=True)}", flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, reps, warm=1):
    """Mean ms per call: CUDA events around ``reps`` calls on the card,
    the host clock in a rehearsal."""
    for _ in range(warm):
        fn()
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def blobs(n, d, k, dev, seed, spread=2.0):
    """Gaussian blobs made on the device from a seed: rows, fractional
    row weights, and centers near the blob centers."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    true = torch.randn((k, d), generator=g, device=dev) * spread
    lab = torch.randint(0, k, (n,), generator=g, device=dev)
    x = true[lab] + torch.randn((n, d), generator=g, device=dev)
    w = 0.5 + torch.rand((n,), generator=g, device=dev)
    c = true + 0.5 * torch.randn((k, d), generator=g, device=dev)
    return x.contiguous(), w, c.contiguous()


def run_kernel(x, w, c, mode, need_cost):
    """(sums, counts, cost, labels) of the kernel; on the CPU (rehearsal)
    the wrapper's plain version and its labels."""
    if x.device.type == "cuda":
        return kmeans_kernel._launch(x, w, c, mode, need_cost)
    sums, counts, cost = kmeans_kernel.lloyd_accumulate(x, w, c, mode, need_cost)
    labels, _ = kmeans_kernel.assign_plain(x, c, mode, need_cost)
    return sums, counts, cost, labels


def _rel_err(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.clamp_min(torch.max(torch.abs(b)), 1e-30))


def compare(x, w, c, mode, need_cost):
    """One kernel variant against its plain version: labels, sums and
    counts on the kernel's labels, cost, and a second launch's bits."""
    k = c.shape[0]
    sums, counts, cost, labels = run_kernel(x, w, c, mode, need_cost)
    again = run_kernel(x, w, c, mode, need_cost)
    same = all(
        (a is None and b is None) or torch.equal(a, b)
        for a, b in zip((sums, counts, cost, labels), again)
    )
    check(same, f"{mode}/cost={need_cost}: two launches differ")
    ref_labels, _ = kmeans_kernel.assign_plain(x, c, mode, need_cost)
    agree = float((labels.long() == ref_labels).float().mean())
    check(agree >= MIN_AGREEMENT,
          f"{mode}/cost={need_cost}: labels agree on {agree:.6f} of rows")
    ref_sums, ref_counts = kmeans_kernel.sums_for_labels(x, w, labels, k, mode)
    err_s, err_c = _rel_err(sums, ref_sums), _rel_err(counts, ref_counts)
    check(err_s <= RTOL[mode] and err_c <= RTOL[mode],
          f"{mode}/cost={need_cost}: sums rel err {err_s:.3g}, counts {err_c:.3g}")
    out = {
        "mode": mode, "need_cost": need_cost, "label_agreement": agree,
        "sums_rel_err": err_s, "counts_rel_err": err_c,
        "max_abs_err": float(torch.max(torch.abs(sums - ref_sums))),
        "deterministic": same,
    }
    if need_cost:
        _, _, ref_cost = kmeans_kernel.lloyd_accumulate_plain(x, w, c, mode, True)
        err = abs(float(cost) - float(ref_cost)) / max(abs(float(ref_cost)), 1e-30)
        # the cost sums w * min d2: at the bf16 tiers d2 carries the
        # cancellation of a bf16 cross term, so only highest is tight
        tol = 1e-4 if mode == "highest" else 1e-2
        check(err <= tol, f"{mode}: cost rel err {err:.3g}")
        out["cost_rel_err"] = err
    return out


def bound(n, d, k, mode):
    ops = 2.0 * n * k * d + 2.0 * n * d
    nbytes = 4.0 * (n * d + n + 2 * k * d)
    t_ops = ops / (PEAK_FP32 if mode == "highest" else PEAK_BF16)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_small(dev):
    """Short first calls: ragged shapes, every tier and mode, and the
    kernel loop against the numpy reference."""
    results = []
    for n, d, k in ((5000, 16, 8), (3001, 37, 13), (777, 300, 70)):
        x, w, c = blobs(n, d, k, dev, seed=n)
        for mode in TIERS:
            for need_cost in (True, False):
                results.append(compare(x, w, c, mode, need_cost))
    x, _, c = blobs(5000, 16, 8, dev, seed=7, spread=6.0)
    ones = torch.ones(x.shape[0], device=dev)
    c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c, 30, 1e-4)
    c2, it2, cost2 = lloyd_np(x.double().cpu().numpy(), c.double().cpu().numpy(), 30, 1e-4)
    check(it1 == it2, f"small loop: {it1} iterations, numpy reference {it2}")
    check(np.allclose(c1.cpu().numpy(), c2, atol=1e-4), "small loop: centers off")
    check(abs(float(cost1) - cost2) <= 1e-4 * cost2, "small loop: cost off")
    emit("small", {"variants": len(results), "loop_iters": it1,
                   "worst_sums_rel_err": max(r["sums_rel_err"] for r in results)})


def phase_kernels(x, w, c, dev, reps):
    n, d = x.shape
    k = c.shape[0]
    variants = []
    for mode in TIERS:
        for need_cost in (False, True):
            v = compare(x, w, c, mode, need_cost)
            v["ms"] = time_ms(lambda: run_kernel(x, w, c, mode, need_cost), dev, reps)
            v["plain_ms"] = time_ms(
                lambda: kmeans_kernel.lloyd_accumulate_plain(x, w, c, mode, need_cost),
                dev, max(1, reps // 4),
            )
            v["bound_ms"], v["bound_by"] = bound(n, d, k, mode)
            if mode == "highest":
                a, b = x, c.T
            else:
                a, b = x.to(torch.bfloat16), c.T.contiguous().to(torch.bfloat16)
            v["library_ms"] = time_ms(lambda: torch.matmul(a, b), dev, reps)
            variants.append(v)
            emit("variant", v)
    return variants


def kernel_breakdown(x, w, c, dev):
    """Device time per CUDA kernel of one wrapper call (highest, loop
    mode), from torch.profiler over three calls; empty where the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    run_kernel(x, w, c, "highest", False)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run_kernel(x, w, c, "highest", False)
        sync(dev)
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        m = re.search(r"(\w+_kernel)(<[^>]*>)?|Memset", ev.key)
        if us and m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + us / 3e3
    emit("breakdown_ms", out)
    return out


def phase_fit(x, dev, cfg, max_iter):
    kmeans_kernel.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = KMeans(k=cfg["k"], max_iter=max_iter, tol=1e-4, init_mode="k-means||",
                   seed=0, device=str(dev)).fit(x)
    wall = time.perf_counter() - t0
    launches = dict(kmeans_kernel.LAUNCHES)
    s = model.summary
    expect = s.num_iter + 1 if dev.type == "cuda" else 0
    check(s.kernels == launches, f"summary kernels {s.kernels} != counters {launches}")
    check(launches[kmeans_kernel.KERNEL] == expect,
          f"kmeans_accumulate launched {launches[kmeans_kernel.KERNEL]} times, "
          f"expected num_iter + 1 = {expect}")
    check(np.isfinite(s.training_cost) and model.cluster_centers_.shape == (cfg["k"], cfg["d"]),
          "fit: non-finite cost or wrong center shape")
    check(np.all(np.isfinite(model.cluster_centers_)), "fit: non-finite centers")
    check(abs(float(np.sum(s.cluster_sizes)) - x.shape[0]) <= 1e-3 * x.shape[0],
          "fit: cluster sizes do not add up to the rows")
    phases = s.timings.as_dict()
    fit = {
        "num_iter": s.num_iter, "training_cost": s.training_cost,
        "wall_s": wall, "phases_s": phases,
        "iters_per_s": s.num_iter / phases["lloyd_loop"],
        "launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
    }
    labels = model.predict(x)
    check(labels.shape == (x.shape[0],) and labels.min() >= 0 and labels.max() < cfg["k"],
          "predict: labels out of range")
    cost = model.compute_cost(x)
    check(abs(cost - s.training_cost) <= 1e-4 * s.training_cost,
          f"compute_cost {cost} vs training cost {s.training_cost}")
    fit["compute_cost"] = cost
    emit("fit", fit)
    return fit


def phase_loop_parity(x, dev, cfg, max_iter):
    """Kernel loop and plain-version loop from the same initial centers."""
    c0 = torch.as_tensor(
        kmeans_ops.init_random(x, x.shape[0], cfg["k"], seed=1), device=dev
    ).contiguous()
    ones = torch.ones(x.shape[0], device=dev)
    _, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c0, max_iter, 1e-4)

    def plain(centers, final):
        if final:
            return kmeans_kernel.lloyd_accumulate_plain(x, ones, centers, "highest", True)
        return kmeans_kernel.lloyd_accumulate_plain(x, ones, centers, "highest", False)

    _, it2, cost2, _ = kmeans_ops._lloyd_loop(plain, c0, max_iter, 1e-4)
    err = abs(float(cost1) - float(cost2)) / float(cost2)
    check(it1 == it2, f"loop parity: kernel {it1} iterations, plain {it2}")
    check(err <= 1e-4, f"loop parity: cost rel err {err:.3g}")
    emit("loop_parity", {"n_iter": it1, "cost_rel_err": err})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on the CPU at a tiny size, plain versions only")
    args = ap.parse_args(argv)
    if not args.rehearse and not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        dev = resolve_device("cpu" if args.rehearse else "cuda")
        cfg = TINY if args.rehearse else FULL
        smi = None
        if dev.type == "cuda":
            smi = nvidia_smi()
            print(f"device {torch.cuda.get_device_name(dev)} | {smi}", flush=True)
            t0 = time.perf_counter()
            paths = _build.build_all()
            emit("build", {"seconds": time.perf_counter() - t0,
                           "libraries": {k: str(v) for k, v in paths.items()}})
            for name in paths:
                log = (_build.BUILD_DIR / f"{name}.ptxas.log")
                if log.exists():
                    for line in log.read_text().splitlines():
                        if "registers" in line or "spill" in line:
                            print(f"ptxas {name}: {line.strip()}")
        phase_small(dev)
        x, w, c = blobs(cfg["n"], cfg["d"], cfg["k"], dev, seed=0)
        reps = 10 if dev.type == "cuda" else 1
        variants = phase_kernels(x, w, c, dev, reps)
        breakdown = kernel_breakdown(x, w, c, dev) if dev.type == "cuda" else {}
        del w, c
        max_iter = 20 if dev.type == "cuda" else 5
        fit = phase_fit(x, dev, cfg, max_iter)
        phase_loop_parity(x, dev, cfg, max_iter)
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    main_v = next(v for v in variants if v["mode"] == "highest" and not v["need_cost"])
    entry = {
        "name": kmeans_kernel.KERNEL, "route": "cuda",
        "source": "oap_mllib_tpu_torch/csrc/kmeans_accumulate.cu",
        "replaces": REPLACES,
        "launches": fit["launches"][kmeans_kernel.KERNEL],
        "max_abs_err": main_v["max_abs_err"], "ms": main_v["ms"],
        "plain_ms": main_v["plain_ms"], "bound_ms": main_v["bound_ms"],
        "bound_by": main_v["bound_by"], "library_ms": main_v["library_ms"],
        "library_call": "torch.matmul(x, c.T): the cross product only",
        "shape": cfg, "variants": variants, "breakdown_ms": breakdown,
    }
    if args.rehearse:
        # host-clock numbers of the plain versions: no device metric
        print("rehearsal passed (CPU, plain versions; times are host times)")
        return 0
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
