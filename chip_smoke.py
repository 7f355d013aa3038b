#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py              # on a machine with the card
    python3 chip_smoke.py --rehearse   # the same phases on the CPU, tiny
    python3 chip_smoke.py --mesh       # only the phases whose ranks span cards
                                       # (4's last card, 10-14, 19, 21, 22)
    python3 chip_smoke.py --mp         # only the build and the worlds (21)
    python3 chip_smoke.py --block-stream  # only the build and 22 (four cards
                                          # when the machine has four)

Phases, each a hard check (any failure exits non-zero):

1. device: ``resolve_device("cuda")``; the card's name and power limit.
2. build: every kernel under ``oap_mllib_tpu_torch/csrc`` with nvcc, one
   process per source, all started together.
3. small: each kernel against its plain version at small ragged shapes,
   every tier and mode (the ALS solve bit for bit); the kernel Lloyd
   loop against the numpy reference, and small PCA and ALS fits against
   their numpy oracles; a nonnegative ALS fit (factors >= 0, within 1e-6
   of the numpy NNLS oracle); the host library's grouped edges bit-equal
   to numpy's at ragged shapes.
4. kernels: the K-Means kernel at the main path's shapes (n = 2^20 rows,
   d = 256, k = 1000, f32 blobs): agreement with its plain version,
   determinism of two launches, the assignment's route (``wgmma``, the
   tensor cores, at every tier for d <= 256), times (CUDA events), the
   bound from the H100 SXM data sheet (highest counted as the six bf16
   products of an f32-accurate split), one PyTorch call as a yardstick,
   and the device time per CUDA kernel of one pass at highest and at
   default (torch.profiler).  The build phase prints how many HGMMA
   instructions the built ``libkmeans_accumulate`` holds and fails on
   none.  With more than one card, K1, K2, K3 and K4 also run on the
   last card against their plain versions.
5. fit (the K-Means path): ``KMeans(k=1000, max_iter=20, tol=1e-4,
   init_mode="k-means||", seed=0).fit(x)``, with every launch count set
   to 0 just before and read just after; then predict and compute_cost,
   and the kernel Lloyd loop against the plain-version loop from the
   same initial centers.
6. pca_kernels: the PCA moments kernel at 2^20 x 128 and 2^18 x 1024,
   every tier, both passes, against its plain version; two launches
   bit-equal, the Gram bit-symmetric; the Gram's route (``wgmma`` for
   the bf16 tiers, ``simt`` at highest); times, bounds,
   ``torch.matmul(xc.T, xc)`` as yardstick.  The build phase prints how
   many HGMMA (tensor-core wgmma) instructions the built
   ``libpca_moments`` holds (``cuobjdump -sass``) and fails on none.
7. pca_fit (the PCA path): ``PCA(k=16).fit(x)`` at 2^20 x 128 with the
   counts zeroed just before: 2 launches (mean pass, Gram pass); the
   components and ratios against a fit through the plain version.
8. als_kernels: the ALS solve and factor-Gram kernels at the ML-25M
   user side (162,541 systems), r = 10 and r = 32, from moments built on
   the card, against their plain versions: the solve bit-equal on the
   valid rows, the Gram deterministic and bit-symmetric and one CUDA
   kernel per call (counted by torch.profiler); times, bounds,
   yardsticks ``torch.linalg.solve`` and ``torch.matmul(F.T, F)``.
9. als_fit (the ALS path): implicit ``ALS(rank=10, max_iter=10,
   alpha=40, reg_param=0.1)`` on ML-25M-scale synthetic ratings (162,541
   users x 59,047 items, 25M ratings, zipf(1.3) items, numpy seed) with
   the counts zeroed just before: 20 solve and 20 Gram launches; the fit
   against a plain-version fit from the same initial factors in
   prediction space; an explicit fit (no Gram launch); top-10
   recommendations for a slice of users; ``table_convert`` split into
   the host library's grouped build and the rest; one iteration's device
   time by CUDA kernel with the moments formed through concatenated
   operands (the JAX package's form) and with the copy-free ones
   (torch.profiler; CUDA events for the wall).
   The small phase adds an
   implicit fit at rank 1030 on a tiny table: the factor Gram above the
   kernel's rank bound takes the ``matmul`` route, named in the summary.
10. ring_kernels: the ring allreduce kernel against its plain version,
   bit for bit, for worlds 2 and 4 and segments 1 and 2, at the sharded
   fit's packed buffer (1000, 130), a ragged (13, 37) and (65536, 256)
   (64 MB a rank), and for world 17 (every rank on the one card) at
   (1000, 130); two launches bit-equal; one launch per card per
   ring; times against the bound, the plain ring and a library
   yardstick (``torch.sum(torch.stack(parts), 0)`` on one card,
   ``torch.cuda.nccl.all_reduce`` across cards).
11. sharded_fit (the model-sharded K-Means path): on a (data 2, model 2)
   mesh of four ranks, on four distinct cards when the machine has four,
   else all on the one card: ``lloyd_run_model_sharded`` against the
   one-device ``lloyd_run_kernel`` from the same initial centers near the
   blob centers (equal iterations, centers within 1e-4, cost within
   1e-5), then
   ``KMeans(k=1000, max_iter=20).fit(x)`` at 2^20 x 256 through the mesh
   route with the counts zeroed just before: ``ring_reduce`` launches
   equal to (num_iter + 1) * model * (cards in a ring): one launch per
   card per ring, one ring per model column per pass.
12. als_block_fit (the block-parallel ALS path, run right after als_fit):
   the same implicit fit on four ranks, against the one-device fit in
   prediction space (4096 users x every item, 1e-4); K3 = K4 =
   2 * 4 * max_iter launches; its phases (ratings_shuffle,
   table_convert, als_iterations) and one iteration's device time per
   card.
13. dp_fit (the data-parallel K-Means path): on a (data 4, model 1) mesh,
   its Lloyd loop against the one-device kernel loop from centers near
   the blob centers (equal iterations, centers 1e-4, cost 1e-5), then
   ``KMeans(k=1000, max_iter=20).fit(x)`` on the device list: K1
   launches (num_iter + 1) * 4, no ring; iterations/s.
14. pca_mesh_fit (the PCA path on a mesh): ``PCA(k=16)`` at 2^20 x 128
   on (4, 1) and (2, 2) against the one-device fit (components 1e-4
   sign-insensitively, ratios 1e-5): 8 and 0 K2 launches.
15. stream_kmeans (the streamed K-Means path): the headline table as a
   ``ChunkSource`` of 65,536 rows; ``lloyd_run_streamed`` against the
   one-device ``lloyd_run_kernel`` from centers near the blob centers
   (equal iterations, centers 1e-4, cost 1e-5), K1 launched chunks x
   (iterations + 1) times; the table less its last 12,345 rows (a
   padded last chunk): K1 on its first and last staged chunks against
   the plain version, the padding of no weight (counts, and the cost of
   the valid rows alone), and a streamed cost pass over it against the
   one-device pass (sums 1e-4, counts equal, cost 1e-5); one pass's
   wall, stage / transfer / compute split, the card's idle share
   (torch.profiler) and bound (the larger of its bytes over the pinned
   host-to-device rate this run measures, one 1 GB copy, and K1's
   summed bound); the bare source walk (the first host copy); then ``KMeans(k=1000, max_iter=5).fit(source)``
   with its phases and route.
16. stream_route: ``KMeans.fit(ndarray)`` with ``memory_budget_hbm`` one
   byte below the planner's estimate of the in-memory route streams and
   gives the source fit's result; ``plan_kmeans`` / ``plan_pca`` of a
   2^27 x 256 f32 table (128 GB) under the detected budget say
   "streamed" (the planner alone).
17. stream_pca: the PCA table as a source: K2 launched 2 x chunks times,
   components within 1e-5 (sign-insensitive) and ratios within 1e-5 of
   the in-memory fit; the same under the bf16 policy against the
   in-memory bf16 fit, within the JAX package's registered bf16 bounds
   (subspace 5e-2 rad, ratios 1e-2); at each policy K2 on the first and
   the padded last staged chunk of the table less its last 12,345 rows,
   both passes, against the plain version (the count equal to the valid
   rows), and that table's streamed f32 fit against its in-memory fit
   (1e-5); the two passes' split and bound.
18. stream_als: the implicit ML-25M fit routed streamed by a card budget
   one byte below the in-memory estimate: K3 = K4 = 20, within 1e-5 of
   the in-memory fit in prediction space, iterations/s beside it, one
   iteration's split and bound; a triples ``ChunkSource`` fit on a small
   table against its array fit.
19. als_block_2d (the 2-D ALS layout): rank 32 at the ML-25M shape on
   four ranks with ``als_item_layout="auto"`` (the summary says
   "sharded"), against the one-device rank-32 fit in prediction space
   (1e-4); K3 = K4 = 2 x 4 x 10; K3 and K4 at its per-rank shapes (rank
   0's user and item half-updates from the fitted factors) against their
   plain versions, the solve bit-equal; iterations/s and each card's
   peak memory beside the replicated layout's.  ``--mesh`` runs it on
   four cards.
20. sparse_input: a SciPy CSR table through ``KMeans.fit`` and
   ``PCA.fit``, bit-equal to the fits of its dense copy.
21. The worlds of processes: the script runs itself with ``--mp-worker``
   as the processes of a ``torch.distributed`` world (gloo on
   127.0.0.1), each making only its own rows from the seed; world "a"
   has one rank a process (two processes on the one card; four, a card
   each, under ``--mesh``), world "b" two ranks a process (two
   processes; two cards each under ``--mesh``).  mp_ring (world "a"):
   K5 across the processes over CUDA IPC at the ring shapes, bit-equal
   to the plain version across processes and to the one-process plain
   ring, two launches bit-equal, one launch a process a ring, timed
   against the plain version and the gloo host path; world "b" rings
   with two members a process.  mp_kmeans: the headline fit on (2, 1)
   (k-means||, K1 (iterations + 1) a local rank) and (2, 2) (random,
   K5 one launch a process a ring), iterations/s and the host
   collectives' seconds.  mp_pca: 2^20 x 128 on (2, 1) and (2, 2).
   mp_stream: each process's half as a source of 65,536 rows, the
   streamed Lloyd loop and PCA with their f32 moments through K5 (one
   launch a pass).  mp_als: implicit ML-25M rank 10 on an uneven cut of
   the ratings, two ranks a process (K3 = K4 = 2 x 2 x 10), and rank 32
   in the 2-D layout under ``--mesh``.  Afterwards this process holds
   every fit against the one-process fit of its shape (K-Means:
   iterations equal, centers and cost 1e-5; PCA against one device,
   components 1e-4, ratios 1e-5; streamed: centers 1e-4, cost 1e-5, PCA
   1e-5; ALS 1e-4 in prediction space).  ``--mp`` runs only these.
   mp_block_stream (world "b"): each process's cut of the ML-25M ratings
   as a width-3 source, the streamed block ALS at rank 10 (K3 = K4 = 2 x
   2 x 10 a process), every process's factors against the one-process
   four-rank streamed block fit (bit-equal, or 1e-5 relative).
   mp_balance (world "a"): every process holds the whole headline table
   and takes its extent through ``balance.local_sources``; with
   capabilities pinned 1.0 / 0.5 (even / odd processes) the extents of
   the 2^20 x 256 table (16 chunks of 65,536 rows: 11 / 5 on two
   processes), the streamed Lloyd loop and the streamed PCA against the
   same fits on equal shares within 1e-5, the block ALS on the weighted
   offsets against the equal-share fit within 1e-4 in prediction space
   and, afterwards in this process, each of the two against a float64
   fit of the same ratings (balance_f64: the weighted fit no farther from
   it than twice the equal-share fit), every process's ``balance`` block
   equal; the default ("auto", nothing pinned) weighs the processes 1.0
   each, whatever their probes read; then the drill: equal pinned
   capabilities, process 1's rows slowed by 0.1 s a chunk (a wrapper of
   this script's), the fleet rollups on, threshold 1.3, patience 2: the
   controller must re-plan by the third pass; each pass's walls, skew
   ratios and re-plans printed, K1's launches equal to the chunks the
   passes' extents staged.
22. block_stream (the streamed block ALS, after als_block_2d): the
   ML-25M ratings as a width-3 source on four ranks (four cards under
   ``--mesh``), implicit rank 10 with replicated items and rank 32 in
   the 2-D layout, each against the resident block fit of its rank and
   layout: factors bit-equal (gate 1e-5 relative), K3 = K4 = 2 x 4 x 10
   and the summary's counts equal to the counters; iterations/s,
   ``table_convert``, each card's peak memory beside the resident
   route's, one streamed iteration's idle share by card and the split
   of its host wall (staging, pinned copies, waits, psums).

23. ladder (after small; 2^16 x 64, k = 16): the resilience ladder
   (utils/resilience.py) under injected faults (utils/faults.py), each
   leg's counts zeroed just before its fit and read just after: (a)
   ``stream.read:fail=2,prefetch.stage:fail=1`` on a streamed fit of
   128-row chunks, three retries, centers bit-equal to the unfaulted
   fit; (b) ``fit.execute:oom=2`` at 1024-row chunks, halvings [2, 4],
   the cost within 1e-5 of the fit at 256; a real
   ``torch.cuda.OutOfMemoryError`` (an allocation past the card)
   classified "oom", and a fit under a memory cap between the peaks of
   two chunk widths (fired or not, reported); (c) ``oomhost`` on an
   in-memory fit: the spill rung under a temporary ``spill_dir``, the
   fit bit-equal to the fit of the same source; (d) ``nan`` under the
   bf16 policy: the precision rung, K1 at the bf16 tier in the
   unfaulted fit and at highest in the retry (``LAUNCHES_BY_MODE``),
   the retry bit-equal to the f32 fit; (e) a NaN row raises
   ``NonFiniteError`` naming "centroids", a PCA overflow "Gram"; (f)
   ``fit.execute:oom=*``: ``ResilienceError`` with every halving in its
   history, the plain version never run; (g) a streamed implicit ALS
   from a triples source, ``stream.read:fail=1``, K3 = K4 = 2 x
   max_iter, factors bit-equal.
24. pca_randomized (after pca_fit): ``pca_solver="randomized"`` at 2^18
   x 1024, k = 16, against eigh on the same table (ratios 1e-4
   relative, |cosines| > 1 - 1e-4), K2 twice a fit; both fits' walls
   and both solvers' times on the covariance, with the card's name and
   power limit.

Every mesh phase puts its four ranks on four distinct cards when the
machine has four, else on the one card.

The last three lines are the kernels JSON, the card from nvidia-smi and
``{"ok": true, "device": {...}}``.  ``--rehearse`` runs every phase on
the CPU at tiny sizes and never prints the ok line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from oap_mllib_tpu_torch import ALS, PCA, KMeans, get_mesh, set_config
from oap_mllib_tpu_torch.data.prefetch import PrefetchStats
from oap_mllib_tpu_torch.data.stream import ChunkSource
from oap_mllib_tpu_torch.data.table import ShardedTable
from oap_mllib_tpu_torch.fallback import als_np
from oap_mllib_tpu_torch.fallback.kmeans_np import lloyd_np
from oap_mllib_tpu_torch.fallback.pca_np import pca_np
from oap_mllib_tpu_torch.ops import (als_block, als_block_stream, als_ops, als_stream, kmeans_ops,
                                     pca_ops, stream_ops)
from oap_mllib_tpu_torch.ops.cuda import (_build, _gram, als_kernel, kmeans_kernel, pca_kernel,
                                          ring_kernel)
from oap_mllib_tpu_torch.parallel import balance, collective
from oap_mllib_tpu_torch.telemetry import fleet
from oap_mllib_tpu_torch.utils import faults, membudget, resilience
from oap_mllib_tpu_torch.utils import precision as psn
from oap_mllib_tpu_torch.utils.dispatch import resolve_device, resolve_devices
from oap_mllib_tpu_torch.utils.timing import Timings

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
PCA_REPLACES = "oap_mllib_tpu/ops/pallas/pca_kernel.py:58"
SOLVE_REPLACES = "oap_mllib_tpu/ops/pallas/als_kernel.py:65"
GRAM_REPLACES = "oap_mllib_tpu/ops/pallas/als_kernel.py:318"
RING_REPLACES = "oap_mllib_tpu/ops/pallas/ring_reduce.py:105"
# the ring: the sharded fit's packed (k, d / model + 2) buffer, a ragged
# one and a bandwidth-sized one; the sharded fit on a (2, 2) mesh
RING_FULL = {"shapes": [(1000, 130), (13, 37), (65536, 256)], "worlds": (2, 4),
             "segments": (1, 2), "wide": (17, (1000, 130))}
RING_TINY = {"shapes": [(1000, 130), (13, 37), (512, 256)], "worlds": (2, 4),
             "segments": (1, 2), "wide": (17, (1000, 130))}
SHARDED_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20, "data": 2, "model": 2}
SHARDED_TINY = {"n": 4133, "d": 29, "k": 11, "max_iter": 5, "data": 2, "model": 2}
# the data-parallel K-Means path: the main shape on four ranks
DP_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20, "data": 4}
DP_TINY = {"n": 4133, "d": 29, "k": 11, "max_iter": 5, "data": 4}
# NVLink between two H100 SXM cards of one host: 450 GB/s each way
PEAK_NVLINK = 450e9
# PCA: the JAX bench's headline shape, and a wide one that tiles the
# output; ALS: the JAX bench's ML-25M scale (bench.py bench_als_large)
PCA_FULL = {"shapes": [(1 << 20, 128), (1 << 18, 1024)], "k": 16}
PCA_TINY = {"shapes": [(3001, 37), (777, 140)], "k": 5}
# small ragged tables over both Gram routes: SIMT below d = 64 and at
# highest, wgmma at the bf16 tiers from d = 64 (4-byte copies where d is
# not a multiple of 4), one and several output tiles
PCA_SMALL = ((1000, 5), (3001, 37), (4099, 64), (2000, 67), (777, 140), (513, 300))
ALS_FULL = {"n_users": 162_541, "n_items": 59_047, "nnz": 25_000_000,
            "rank": 10, "alpha": 40.0, "reg": 0.1, "max_iter": 10,
            "explicit_iter": 3, "ranks": (10, 32), "wide_rank": 32, "layout_2d": "auto"}
ALS_TINY = {"n_users": 700, "n_items": 300, "nnz": 20_000, "rank": 10,
            "alpha": 40.0, "reg": 0.1, "max_iter": 3, "explicit_iter": 2,
            "ranks": (10, 32), "wide_rank": 32, "layout_2d": "sharded"}
# the ratings of the streamed block ALS as a width-3 (user, item, rating)
# source: rows a chunk of it
ALS_SOURCE_ROWS = 1 << 20
# the streamed paths: the headline K-Means table in 65,536-row chunks
# (the default width), a five-iteration streamed fit (each pass walks
# the 1 GB table through the host); the PCA table; the sparse table
# the ragged checks drop the table's last ``cut`` rows, so its last chunk
# is part padding (weight 0)
STREAM_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "chunk_rows": 1 << 16, "fit_iter": 5,
               "cut": 12_345}
STREAM_TINY = {"n": 4133, "d": 29, "k": 11, "chunk_rows": 1024, "fit_iter": 3, "cut": 345}
STREAM_PCA_FULL = {"shapes": [(1 << 20, 128)], "k": 16, "chunk_rows": 1 << 16, "cut": 12_345}
STREAM_PCA_TINY = {"shapes": [(3001, 37)], "k": 5, "chunk_rows": 1024, "cut": 345}
SPARSE_FULL = {"n": 1 << 16, "d": 256, "k": 100, "pca_k": 16}
SPARSE_TINY = {"n": 2000, "d": 40, "k": 6, "pca_k": 4}
# PCA moments: colsum/count against the plain version; the Gram by tier
# against the array scale (default sums bf16-rounded products)
PCA_SUM_RTOL = 1e-6
PCA_GRAM_RTOL = {"highest": 1e-4, "high": 1e-4, "default": 1e-2}
# components (sign-insensitive, ratio > 1e-5) and ratios of the kernel
# fit against the plain-version fit
PCA_FIT_TOL = 1e-4
SOLVE_RTOL = 1e-5
ALS_FIT_RTOL = 1e-3
# the resilience ladder's legs: a small table in 128- and 1024-row
# chunks, and a small ratings table for the streamed ALS leg
LADDER_FULL = {"n": 1 << 16, "d": 64, "k": 16, "rows": (128, 1024), "max_iter": 5,
               "oom_rows": 1 << 20,
               "als": {"n_users": 20_000, "n_items": 5_000, "nnz": 400_000, "rank": 10,
                       "max_iter": 3}}
LADDER_TINY = {"n": 4133, "d": 29, "k": 11, "rows": (128, 1024), "max_iter": 3,
               "oom_rows": 4096,
               "als": {"n_users": 300, "n_items": 120, "nnz": 5_000, "rank": 10,
                       "max_iter": 2}}


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


def count_sass(lib, opcode):
    """Instructions of ``opcode`` in a built library's SASS, from the
    toolkit's ``cuobjdump`` beside nvcc."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr.strip()[:500]}")
    return sum(1 for line in out.stdout.splitlines() if re.search(rf"\b{opcode}\b", line))


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
    """Least time of one pass, whatever runs it: x, w and the centers read
    once, the sums written once; the cross term at the tensor-core peak,
    at highest as the six bf16 products of an f32-accurate split (the
    fastest f32-accurate product on this card), one product at the bf16
    tiers."""
    products = 6 if mode == "highest" else 1
    ops = products * 2.0 * n * k * d + 2.0 * n * d
    nbytes = 4.0 * (n * d + n + 2 * k * d)
    return _bound(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def phase_small(dev):
    """Short first calls: ragged shapes, every tier and mode, and the
    kernel loop against the numpy reference."""
    results = []
    # wgmma at d <= 256 (one and many center tiles, ragged rows, 4-byte
    # copies where d is no multiple of 4), SIMT at d = 300
    for n, d, k in ((5000, 16, 8), (3001, 37, 13), (4099, 256, 1000), (2000, 64, 300),
                    (777, 300, 70)):
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
            v["route"] = kmeans_kernel.assign_route(d)
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


def kernel_breakdown(x, w, c, dev, mode):
    """Device time per CUDA kernel of one wrapper call (loop mode) at a
    tier, from torch.profiler over three calls; empty where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    run_kernel(x, w, c, mode, False)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run_kernel(x, w, c, mode, False)
        sync(dev)
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        m = re.search(r"(\w+_kernel)(<[^>]*>)?|Memset", ev.key)
        if us and m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + us / 3e3
    emit("breakdown_ms", {"mode": mode, "kernels": out})
    return out


def phase_last_card(dev):
    """With more than one card: K1, K2, K3 and K4 on the last card (each
    library sets that card as its device itself: its statically linked
    runtime does not see the wrapper's current device) against their
    plain versions, at the small phase's tolerances."""
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    if count < 2:
        return None
    last = torch.device("cuda", count - 1)
    x, w, c = blobs(1 << 16, 256, 1000, last, seed=9)
    v = compare(x, w, c, "highest", True)
    v["device"] = str(last)
    g = torch.Generator(device=last)
    g.manual_seed(13)
    xp = torch.randn((1 << 16, 128), generator=g, device=last) * 2.0 + 1.5
    mask = torch.ones(xp.shape[0], device=last)
    _, cs, _ = pca_kernel.pca_moments(xp, mask, None, "highest", need_gram=False)
    _, cs_p, _ = pca_kernel.pca_moments_plain(xp, mask, None, "highest", need_gram=False)
    mean = cs / xp.shape[0]
    gk, _, _ = pca_kernel.pca_moments(xp, mask, mean, "highest", need_sums=False)
    gp, _, _ = pca_kernel.pca_moments_plain(xp, mask, mean, "highest", need_sums=False)
    v["pca_moments"] = {"colsum_rel_err": _rel_err(cs, cs_p), "gram_rel_err": _rel_err(gk, gp)}
    check(v["pca_moments"]["colsum_rel_err"] <= PCA_SUM_RTOL
          and v["pca_moments"]["gram_rel_err"] <= PCA_GRAM_RTOL["highest"],
          f"pca_moments on {last}: {v['pca_moments']}")
    r, n = 10, 20_000
    y = torch.randn((n, 3 * r, r), generator=g, device=last)
    a = y.transpose(1, 2) @ y / (3 * r)
    b = torch.randn((n, r), generator=g, device=last)
    n_reg = torch.randint(0, 3, (n,), generator=g, device=last).float()
    f = torch.randn((4099, r), generator=g, device=last)
    gram = als_kernel.factor_gram(f)
    gram_err = _rel_err(gram, als_kernel.factor_gram_plain(f))
    w_k = als_kernel.solve_normal_eq(a, b, n_reg, 0.1, gram)
    w_p = als_kernel.solve_plain(a, b, n_reg, 0.1, gram)
    v["als_solve"] = {"bit_equal": bool(torch.equal(w_k, w_p)), "rel_err": _rel_err(w_k, w_p)}
    v["als_factor_gram"] = {"rel_err": gram_err, "bit_symmetric": bool(torch.equal(gram, gram.T))}
    check(v["als_solve"]["bit_equal"], f"als_solve on {last}: {v['als_solve']}")
    check(gram_err <= 1e-5 and v["als_factor_gram"]["bit_symmetric"],
          f"als_factor_gram on {last}: {v['als_factor_gram']}")
    emit("last_card", v)
    return v


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

    _, it2, cost2, _ = kmeans_ops._lloyd_loop(plain, lambda m: m, c0, max_iter, 1e-4)
    err = abs(float(cost1) - float(cost2)) / float(cost2)
    check(it1 == it2, f"loop parity: kernel {it1} iterations, plain {it2}")
    check(err <= 1e-4, f"loop parity: cost rel err {err:.3g}")
    emit("loop_parity", {"n_iter": it1, "cost_rel_err": err})


def device_breakdown(fn, dev, top=12):
    """Device time by kernel over one call of ``fn`` (torch.profiler):
    the ``top`` kernels in ms, the device's busy total and the host wall
    of the profiled call; None on the CPU or where the profiler records
    no device time."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    by = {}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by[ev.key[:80]] = by.get(ev.key[:80], 0.0) + us / 1e3
    if not by:
        return None
    busy = sum(by.values())
    ranked = dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])
    return {"kernels_ms": ranked, "busy_ms": busy, "wall_ms": wall,
            "idle_share": max(0.0, 1.0 - busy / wall)}


def mesh_breakdown(fn, devs):
    """Device time of one call of ``fn`` per card of a mesh
    (torch.profiler's kernel events by device index, from the second of
    two profiled calls: the first starts the tracer): busy ms and
    kernels on each card, and its idle share of the call's wall without
    the profiler (``wall_ms``, the host clock between syncs of every
    card; the profiled call's own wall beside it); None on the CPU or
    where the profiler records no kernel."""
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    if not cards:
        return None
    from torch.profiler import ProfilerActivity, profile

    wall = time_ms_all(fn, devs, reps=3)
    for _ in range(2):
        sync_all(devs)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync_all(devs)
        profiled = (time.perf_counter() - t0) * 1e3
    busy, kernels = {}, {}
    for ev in prof.events():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        busy[ev.device_index] = busy.get(ev.device_index, 0.0) + ev.time_range.elapsed_us() / 1e3
        kernels[ev.device_index] = kernels.get(ev.device_index, 0) + 1
    if not busy:
        return None
    return {"wall_ms": wall, "profiled_wall_ms": profiled, "cards": {
        f"cuda:{c}": {"busy_ms": busy.get(c, 0.0), "kernels": kernels.get(c, 0),
                      "idle_share": max(0.0, 1.0 - busy.get(c, 0.0) / wall)} for c in cards}}


def profile_calls(fn, dev, reps=10, tries=6):
    """The CUDA kernels that ``reps`` calls of ``fn`` launch, by
    torch.profiler, after a warm call (which builds the kernel and fills
    the wrapper's caches): ``(names of one call's kernels, device ms per
    call)``; None on the CPU.  A profile that records no kernel is taken
    again, up to ``tries`` times (the tracer has dropped a session's
    kernels on the card, three sessions in a row once)."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(dev)
    evs = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync(dev)
        evs = [ev for ev in prof.events() if str(getattr(ev, "device_type", "")).endswith("CUDA")]
        if evs:
            break
    per_call = round(len(evs) / reps)
    names = sorted({ev.name[:80] for ev in evs})
    mean_us = sum(ev.time_range.elapsed_us() for ev in evs) / max(1, len(evs))
    return [names[i % len(names)] for i in range(per_call)], mean_us * per_call / 1e3


def _bound(t_ops, t_bytes):
    """(bound ms, what bounds it) from the two least times in seconds."""
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sign_err(c, ref):
    """Largest column difference of two component matrices, each column
    compared up to its sign."""
    return float(max((min(np.max(np.abs(c[:, j] - ref[:, j])),
                          np.max(np.abs(c[:, j] + ref[:, j])))
                      for j in range(c.shape[1])), default=0.0))


# -- PCA ----------------------------------------------------------------------

def pca_data(n, d, dev, seed):
    """Rows with a decaying spectrum (variances 100 * 0.7225^j along a
    random orthogonal basis) around a mean of 3, made on the device."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev))
    scale = 10.0 * 0.85 ** torch.arange(d, device=dev, dtype=torch.float32)
    z = torch.randn((n, d), generator=g, device=dev) * scale
    return (z @ q.T + 3.0).contiguous()


def pca_bound(n, d, mode, need_gram):
    """Least time of one moments pass: x, mask and mean read once, the
    outputs written once; the symmetric Gram's n d (d + 1) operations
    (its d (d + 1) / 2 distinct entries, 2 n each) at the tier's rate
    (high: three bf16 products), the sums' 2 n d on FP32."""
    nbytes = 4.0 * (n * d + n + d + (d * d if need_gram else d + 1))
    if not need_gram:
        return _bound(2.0 * n * d / PEAK_FP32, nbytes / PEAK_BYTES)
    ops = float(n) * d * (d + 1)
    if mode == "highest":
        return _bound(ops / PEAK_FP32, nbytes / PEAK_BYTES)
    passes = 3 if mode == "high" else 1
    return _bound(passes * ops / PEAK_BF16, nbytes / PEAK_BYTES)


def pca_variants(x, mask, mode, dev, reps):
    """Both passes of the moments kernel at one tier against the plain
    version: errors, determinism, times, bound, yardstick."""
    n, d = x.shape
    tag = f"pca {n}x{d} {mode}"
    k = pca_kernel.pca_moments
    plain = pca_kernel.pca_moments_plain
    _, cs, cnt = k(x, mask, None, mode, need_gram=False)
    _, cs2, cnt2 = k(x, mask, None, mode, need_gram=False)
    _, cs_p, cnt_p = plain(x, mask, None, mode, need_gram=False)
    same = torch.equal(cs, cs2) and torch.equal(cnt, cnt2)
    err = max(_rel_err(cs, cs_p), _rel_err(cnt.reshape(1), cnt_p.reshape(1)))
    check(same, f"{tag} mean pass: two launches differ")
    check(err <= PCA_SUM_RTOL, f"{tag} mean pass: colsum/count rel err {err:.3g}")
    mean_v = {
        "pass": "mean", "mode": mode, "shape": [n, d], "rel_err": err,
        "max_abs_err": float(torch.max(torch.abs(cs - cs_p))), "deterministic": same,
        "ms": time_ms(lambda: k(x, mask, None, mode, need_gram=False), dev, reps),
        "plain_ms": time_ms(lambda: plain(x, mask, None, mode, need_gram=False), dev, reps),
        "library_ms": time_ms(lambda: torch.sum(x, dim=0), dev, reps),
        "library_call": "torch.sum(x, dim=0)",
    }
    mean_v["bound_ms"], mean_v["bound_by"] = pca_bound(n, d, mode, False)
    emit("pca_variant", mean_v)

    mean = cs / float(n)
    g, _, _ = k(x, mask, mean, mode, need_sums=False)
    g2, _, _ = k(x, mask, mean, mode, need_sums=False)
    g_p, _, _ = plain(x, mask, mean, mode, need_sums=False)
    same = torch.equal(g, g2)
    err = _rel_err(g, g_p)
    check(same, f"{tag} Gram pass: two launches differ")
    check(dev.type != "cuda" or torch.equal(g, g.T), f"{tag} Gram pass: not bit-symmetric")
    check(err <= PCA_GRAM_RTOL[mode], f"{tag} Gram pass: rel err {err:.3g}")
    xc = x - mean
    a = xc if mode == "highest" else xc.to(torch.bfloat16)
    gram_v = {
        "pass": "gram", "mode": mode, "shape": [n, d], "rel_err": err,
        "route": _gram.pca_gram_route(mode, d),
        "max_abs_err": float(torch.max(torch.abs(g - g_p))), "deterministic": same,
        "ms": time_ms(lambda: k(x, mask, mean, mode, need_sums=False), dev, reps),
        "plain_ms": time_ms(lambda: plain(x, mask, mean, mode, need_sums=False), dev, reps),
        "library_ms": time_ms(lambda: torch.matmul(a.T, a), dev, reps),
        "library_call": "torch.matmul(xc.T, xc), " + ("f32, TF32 off" if mode == "highest" else "bf16"),
    }
    gram_v["bound_ms"], gram_v["bound_by"] = pca_bound(n, d, mode, True)
    emit("pca_variant", gram_v)
    return [mean_v, gram_v]


def phase_pca_kernels(cfg, dev, reps):
    variants = []
    for n, d in cfg["shapes"]:
        x = pca_data(n, d, dev, seed=d)
        mask = torch.ones(n, device=dev)
        for mode in TIERS:
            variants += pca_variants(x, mask, mode, dev, reps)
        del x, mask
    return variants


def phase_pca_fit(cfg, dev):
    """The PCA path, counts zeroed just before; held against a fit
    through the plain version on the same device."""
    (n, d), k = cfg["shapes"][0], cfg["k"]
    x = pca_data(n, d, dev, seed=d)
    pca_kernel.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = PCA(k=k, device=str(dev)).fit(x)
    wall = time.perf_counter() - t0
    launches = dict(pca_kernel.LAUNCHES)
    s = model.summary
    check(s["kernels"] == launches, f"summary kernels {s['kernels']} != counters {launches}")
    expect = 2 if dev.type == "cuda" else 0
    check(launches[pca_kernel.KERNEL] == expect,
          f"pca_moments launched {launches[pca_kernel.KERNEL]} times, expected {expect}")
    cov_p, _ = pca_ops.covariance(x, torch.ones(n, device=dev), n, "highest",
                                  moments=pca_kernel.pca_moments_plain)
    vals_p, vecs_p = pca_ops.eigh_descending(cov_p)
    vals_p = vals_p.cpu().numpy()
    ratio_p = vals_p[:k] / float(vals_p.sum())
    keep = ratio_p > 1e-5
    comp_err = sign_err(model.components_[:, keep], vecs_p[:, :k].cpu().numpy()[:, keep])
    ratio_err = float(np.max(np.abs(model.explained_variance_ - ratio_p)))
    check(comp_err <= PCA_FIT_TOL and ratio_err <= PCA_FIT_TOL,
          f"pca fit vs plain fit: components {comp_err:.3g}, ratios {ratio_err:.3g}")
    proj = model.transform(x[:4096])
    ref = (x[:4096] @ torch.as_tensor(model.components_, device=dev)).cpu().numpy()
    check(proj.shape == (min(4096, n), k) and np.all(np.isfinite(proj)), "transform: bad output")
    check(np.allclose(proj, ref, rtol=1e-5, atol=1e-4), "transform differs from x @ components")
    phases = s["timings"].as_dict()
    breakdown = device_breakdown(lambda: PCA(k=k, device=str(dev)).fit(x), dev)
    fit = {
        "shape": [n, d], "k": k, "wall_s": wall, "phases_s": phases,
        "breakdown": breakdown,
        "launches": launches, "components_err": comp_err, "ratio_err": ratio_err,
        "ratios": [float(v) for v in model.explained_variance_],
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
    }
    emit("pca_fit", fit)
    return fit


# -- ALS ----------------------------------------------------------------------

def als_data(cfg):
    """Ratings shaped like the JAX bench's ML-25M case, from numpy seeds:
    uniform users, zipf(1.3) items, ratings in [1, 5)."""
    rng = np.random.default_rng(3)
    users = rng.integers(cfg["n_users"], size=cfg["nnz"]).astype(np.int32)
    items = (np.random.default_rng(4).zipf(1.3, size=cfg["nnz"])
             % cfg["n_items"]).astype(np.int32)
    ratings = (rng.random(cfg["nnz"]) * 4 + 1).astype(np.float32)
    return users, items, ratings


def solve_bound(n, r, gram):
    """Least time of the solve: per system the lower triangle of A
    (r (r + 1) / 2 floats, all the solve reads), b and n_reg read once
    and the factors written once, plus the Gram's lower triangle;
    Cholesky and substitutions at the FP32 rate."""
    tri = r * (r + 1) // 2
    nbytes = 4.0 * (n * (tri + 2 * r + 1) + (tri if gram else 0))
    return _bound(n * (r ** 3 / 3.0 + 2.0 * r * r + r) / PEAK_FP32, nbytes / PEAK_BYTES)


def gram_bound(n, r):
    """F read once and the (r, r) Gram written once; the symmetric
    Gram's n r (r + 1) operations on FP32."""
    return _bound(float(n) * r * (r + 1) / PEAK_FP32, 4.0 * (n * r + r * r) / PEAK_BYTES)


def phase_als_kernels(cfg, data, dev, reps):
    """The solve and factor-Gram kernels on the user side's moments,
    built on the device from random item factors."""
    users, items, ratings = data
    n_users, n_items, reg = cfg["n_users"], cfg["n_items"], cfg["reg"]
    by_user = als_ops.build_grouped_edges(users, items, ratings, n_users)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    solves, grams = [], []
    for r in cfg["ranks"]:
        side = als_ops.prepare_grouped(*by_user, n_users, r, dev)
        y = torch.randn((n_items, r), generator=g, device=dev) / r ** 0.5
        xf = torch.randn((n_users, r), generator=g, device=dev) / r ** 0.5
        a, b, n_reg = side.partials(y, cfg["alpha"], True)
        valid = n_reg > 0
        for gm in (als_kernel.factor_gram_plain(y), None):
            tag = f"als_solve r={r} gram={gm is not None}"
            w = als_kernel.solve_normal_eq(a, b, n_reg, reg, gm)
            same = torch.equal(w, als_kernel.solve_normal_eq(a, b, n_reg, reg, gm))
            w_p = als_kernel.solve_plain(a, b, n_reg, reg, gm)
            err = _rel_err(w[valid], w_p[valid])
            bit_equal = torch.equal(w[valid], w_p[valid])
            check(same, f"{tag}: two launches differ")
            check(bool(torch.all(w[~valid] == 0)), f"{tag}: rows with n_reg = 0 are not 0")
            check(bool(torch.all(torch.isfinite(w))) and err <= SOLVE_RTOL,
                  f"{tag}: rel err {err:.3g}")
            check(bit_equal, f"{tag}: not bit-equal to the plain version (rel err {err:.3g})")
            v = {
                "r": r, "gram": gm is not None, "n": int(b.shape[0]),
                "group": als_kernel.solve_group(r),
                "empty_rows": int((~valid).sum()), "rel_err": err, "bit_equal": bit_equal,
                "max_abs_err": float(torch.max(torch.abs(w - w_p))), "deterministic": same,
                "ms": time_ms(lambda: als_kernel.solve_normal_eq(a, b, n_reg, reg, gm), dev, reps),
                "plain_ms": time_ms(lambda: als_kernel.solve_plain(a, b, n_reg, reg, gm), dev, 2),
                "library_call": "torch.linalg.solve(A, b) on the assembled A",
            }
            v["bound_ms"], v["bound_by"] = solve_bound(int(b.shape[0]), r, gm is not None)
            full = a + reg * n_reg[:, None, None] * torch.eye(r, device=dev)[None]
            if gm is not None:
                full = gm[None] + full
            v["library_ms"] = time_ms(lambda: torch.linalg.solve(full, b), dev, reps)
            v["device_ms"] = (profile_calls(
                lambda: als_kernel.solve_normal_eq(a, b, n_reg, reg, gm), dev) or (None, None))[1]
            del full
            solves.append(v)
            emit("als_solve_variant", v)
        gk = als_kernel.factor_gram(xf)
        same = torch.equal(gk, als_kernel.factor_gram(xf))
        gp = als_kernel.factor_gram_plain(xf)
        err = _rel_err(gk, gp)
        check(same and (dev.type != "cuda" or torch.equal(gk, gk.T)),
              f"als_factor_gram r={r}: not deterministic or not bit-symmetric")
        check(err <= 1e-5, f"als_factor_gram r={r}: rel err {err:.3g}")
        launched, device = profile_calls(lambda: als_kernel.factor_gram(xf), dev) or (None, None)
        check(launched is None or len(launched) == 1,
              f"als_factor_gram r={r}: one call launched {launched}, expected one kernel")
        # the same grid over 8 rows a block: the launch and the in-kernel
        # grid sum, with next to no rows to read
        blocks = als_kernel.factor_gram_geometry(n_users, r).blocks
        few = xf[:8 * blocks].contiguous()
        fixed = (profile_calls(lambda: als_kernel.factor_gram(few), dev) or (None, None))[1]
        v = {
            "r": r, "n": n_users, "rel_err": err, "deterministic": same,
            "geometry": als_kernel.factor_gram_geometry(n_users, r)._asdict(),
            "kernels_per_call": None if launched is None else len(launched),
            "kernel_names": launched, "device_ms": device,
            "fixed_device_ms": fixed, "fixed_rows": int(few.shape[0]),
            "max_abs_err": float(torch.max(torch.abs(gk - gp))),
            "ms": time_ms(lambda: als_kernel.factor_gram(xf), dev, reps),
            "plain_ms": time_ms(lambda: als_kernel.factor_gram_plain(xf), dev, reps),
            "library_ms": time_ms(lambda: torch.matmul(xf.T, xf), dev, reps),
            "library_call": "torch.matmul(F.T, F), f32, TF32 off",
        }
        v["bound_ms"], v["bound_by"] = gram_bound(n_users, r)
        grams.append(v)
        emit("als_gram_variant", v)
        del side, a, b, n_reg
    return solves, grams


def phase_als_fit(cfg, data, dev):
    """The ALS path, counts zeroed just before; held against a fit
    through the plain versions from the same initial factors."""
    users, items, ratings = data
    n_users, n_items, r, it = cfg["n_users"], cfg["n_items"], cfg["rank"], cfg["max_iter"]
    on_card = dev.type == "cuda"
    als_kernel.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = ALS(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                alpha=cfg["alpha"], seed=0, device=str(dev)).fit(
        users, items, ratings, n_users, n_items)
    wall = time.perf_counter() - t0
    launches = dict(als_kernel.LAUNCHES)
    s = model.summary
    check(s["kernels"] == launches, f"summary kernels {s['kernels']} != counters {launches}")
    expect = 2 * it if on_card else 0
    check(launches == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect},
          f"ALS launches {launches}, expected {expect} of each")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None

    user_side, item_side = als_ops.prepare_sides(
        s["als_kernel"] == "grouped", users, items, ratings, n_users, n_items, r, dev)
    x0 = torch.from_numpy(als_np.init_factors(n_users, r, 0)).to(dev)
    y0 = torch.from_numpy(als_np.init_factors(n_items, r, 1)).to(dev)
    xp, yp = als_ops.run_sides(user_side, item_side, x0, y0, it, cfg["reg"], cfg["alpha"],
                               True, solve=als_kernel.solve_plain,
                               gram=als_kernel.factor_gram_plain)
    # one iteration of the kernel loop, profiled (after the fit's counts),
    # with the moments through concatenated operands and with the
    # copy-free ones
    iteration = {}
    for name, partials in (("concat_moments", partials_with_copies),
                           ("copy_free_moments", als_ops.GroupedSide.partials)):
        saved, als_ops.GroupedSide.partials = als_ops.GroupedSide.partials, partials
        try:
            def one_iteration():
                return als_ops.run_sides(user_side, item_side, x0, y0, 1, cfg["reg"],
                                         cfg["alpha"], True)
            got = one_iteration()
            calls = profile_calls(one_iteration, dev, reps=3)
            recorded = calls is not None and len(calls[0]) > 0
            iteration[name] = {
                "device_ms": calls[1] if recorded else None,
                "kernels_per_iteration": len(calls[0]) if recorded else None,
                "ms": time_ms(one_iteration, dev, 3),
                "breakdown": device_breakdown(one_iteration, dev),
            }
        finally:
            als_ops.GroupedSide.partials = saved
        iteration.setdefault("_results", []).append(got)
    base, new = iteration.pop("_results")
    moments_err = max(_rel_err(base[0], new[0]), _rel_err(base[1], new[1]))
    check(moments_err <= 1e-4, f"one iteration, copy-free moments vs concatenated: {moments_err:.3g}")
    iteration["rel_err_between"] = moments_err
    breakdown = iteration["copy_free_moments"]["breakdown"]
    del user_side, item_side
    u = torch.as_tensor(users.astype(np.int64), device=dev)
    i = torch.as_tensor(items.astype(np.int64), device=dev)
    pred = torch.as_tensor(model.predict(users, items), device=dev)
    pred_p = als_ops.predict_pairs(xp, yp, u, i)
    err = float(torch.linalg.vector_norm(pred - pred_p) / torch.linalg.vector_norm(pred_p))
    check(bool(torch.all(torch.isfinite(pred))), "ALS fit: non-finite predictions")
    check(err <= ALS_FIT_RTOL, f"ALS fit vs plain fit: prediction rel err {err:.3g}")
    del u, i, pred, pred_p, xp, yp

    als_kernel.reset_launches()
    explicit = ALS(rank=r, max_iter=cfg["explicit_iter"], reg_param=cfg["reg"], seed=0,
                   device=str(dev)).fit(users, items, ratings, n_users, n_items)
    want = {als_kernel.SOLVE: 2 * cfg["explicit_iter"] if on_card else 0, als_kernel.GRAM: 0}
    check(dict(als_kernel.LAUNCHES) == want,
          f"explicit ALS launches {als_kernel.LAUNCHES}, expected {want}")
    check(np.all(np.isfinite(explicit.user_factors_)), "explicit ALS: non-finite factors")

    q = np.arange(min(4096, n_users))
    ids, scores = model.recommend_for_users(q, 10, with_scores=True)
    check(ids.shape == (len(q), 10) and ids.min() >= 0 and ids.max() < n_items,
          "recommend: ids out of range")
    check(bool(np.all(np.diff(scores, axis=1) <= 0)), "recommend: scores not descending")
    xq = torch.as_tensor(model.user_factors_[q[:64]], device=dev)
    full = xq @ torch.as_tensor(model.item_factors_, device=dev).T
    ref = torch.sort(full, dim=1, descending=True, stable=True).indices[:, :10]
    check(np.array_equal(ids[:64], ref.cpu().numpy()), "recommend: ids differ from a full sort")

    phases = s["timings"].as_dict()
    fit = {
        "n_users": n_users, "n_items": n_items, "nnz": len(users), "rank": r,
        "max_iter": it, "layout": s["als_kernel"], "solve_kernel": s["solve_kernel"],
        "wall_s": wall, "phases_s": phases,
        "iters_per_s": it / phases["als_iterations"], "launches": launches,
        "pred_rel_err_vs_plain": err, "peak_mem_gb": peak, "iteration_breakdown": breakdown,
        "iteration_moments": iteration,
        "table_convert_split_s": {
            "grouped_build": phases.get("grouped_build", 0.0),
            "rest": phases["table_convert"] - phases.get("grouped_build", 0.0)},
        "explicit_phases_s": explicit.summary["timings"].as_dict(),
    }
    emit("als_fit", fit)
    return fit, model


def partials_with_copies(side, src_factors, alpha, implicit, policy="f32"):
    """``GroupedSide.partials`` with the moments in the JAX package's form,
    for the before/after device times: per block ``[Ys | 1]^T [a_w Ys |
    b_w | n_w]`` through two concatenated operands (f32), one segment sum
    of the (Gb, r+1, r+2) sheet."""
    r = src_factors.shape[1]
    m = torch.zeros((side.n_dst, r + 1, r + 2), dtype=torch.float32,
                    device=src_factors.device)
    for g0, g1, first, lengths in side.blocks:
        src_b, conf_b, valid_b = side.src_g[g0:g1], side.conf_g[g0:g1], side.valid_g[g0:g1]
        gb, p = src_b.shape
        ys = src_factors.index_select(0, src_b.reshape(-1)).reshape(gb, p, r)
        a_w, b_w, n_w = als_ops._weights(conf_b, valid_b, alpha, implicit)
        lhs = torch.cat([ys, torch.ones_like(conf_b)[..., None]], dim=2)
        rhs = torch.cat([ys * a_w[..., None], b_w[..., None], n_w[..., None]], dim=2)
        als_ops._segment_add(m, torch.einsum("gpa,gpb->gab", lhs, rhs), first, lengths)
    return m[:, :r, :r], m[:, :r, r], m[:, r, r + 1]


def phase_small_slices(dev):
    """Short first calls of the PCA and ALS kernels: small ragged shapes,
    every tier, and small fits against their numpy oracles."""
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    routes = set()
    for n, d in PCA_SMALL:
        x = torch.randn((n, d), generator=g, device=dev) * 2.0 + 1.5
        mask = (torch.rand((n,), generator=g, device=dev) > 0.1).float()
        for mode in TIERS:
            _, cs, cnt = pca_kernel.pca_moments(x, mask, None, mode, need_gram=False)
            _, cs_p, cnt_p = pca_kernel.pca_moments_plain(x, mask, None, mode, need_gram=False)
            check(_rel_err(cs, cs_p) <= PCA_SUM_RTOL and float(cnt) == float(cnt_p),
                  f"small pca sums {n}x{d} {mode}")
            mean = cs / cnt
            gk, _, _ = pca_kernel.pca_moments(x, mask, mean, mode, need_sums=False)
            gk2, _, _ = pca_kernel.pca_moments(x, mask, mean, mode, need_sums=False)
            gp, _, _ = pca_kernel.pca_moments_plain(x, mask, mean, mode, need_sums=False)
            route = _gram.pca_gram_route(mode, d)
            routes.add(route)
            # the kernel's Gram is bit-symmetric (the plain one need not be)
            check(_rel_err(gk, gp) <= PCA_GRAM_RTOL[mode] and torch.equal(gk, gk2)
                  and (dev.type != "cuda" or torch.equal(gk, gk.T)),
                  f"small pca gram {n}x{d} {mode} ({route}): {_rel_err(gk, gp):.3g}, "
                  f"deterministic {torch.equal(gk, gk2)}")
    for r in (1, 7, 32, 70):
        f = torch.randn((2049, r), generator=g, device=dev)
        for mode in TIERS:
            gk = als_kernel.factor_gram(f, mode)
            err = _rel_err(gk, als_kernel.factor_gram_plain(f, mode))
            check(err <= PCA_GRAM_RTOL[mode], f"small factor gram r={r} {mode}: {err:.3g}")
            check(torch.equal(gk, als_kernel.factor_gram(f, mode))
                  and (dev.type != "cuda" or torch.equal(gk, gk.T)),
                  f"small factor gram r={r} {mode}: not deterministic or not bit-symmetric")
    for r in (1, 10, 32):
        n = 777
        y = torch.randn((n, 3 * r, r), generator=g, device=dev)
        a = y.transpose(1, 2) @ y / (3 * r)
        m = torch.zeros((n, r + 1, r + 2), device=dev)
        m[:, :r, :r] = a
        m[:, :r, r] = torch.randn((n, r), generator=g, device=dev)
        m[:, r, r + 1] = torch.randint(0, 3, (n,), generator=g, device=dev).float()
        views = (m[:, :r, :r], m[:, :r, r], m[:, r, r + 1])
        gram = a[0].contiguous()
        for gm in (gram, None):
            w = als_kernel.solve_normal_eq(*views, 0.1, gm)
            w_p = als_kernel.solve_plain(*views, 0.1, gm)
            err = _rel_err(w, w_p)
            check(err <= SOLVE_RTOL, f"small solve r={r} gram={gm is not None}: {err:.3g}")
            check(torch.equal(w, w_p), f"small solve r={r} gram={gm is not None}: "
                                       "not bit-equal to the plain version")
    rng = np.random.default_rng(12)
    xs = (rng.normal(size=(3000, 12)) * (0.8 ** np.arange(12))).astype(np.float32) + 2.0
    model = PCA(k=4, device=str(dev)).fit(xs)
    comps, ratio = pca_np(xs, 4)
    check(sign_err(model.components_, comps) <= 1e-3
          and np.allclose(model.explained_variance_, ratio, atol=1e-5),
          "small PCA fit differs from the numpy oracle")
    u, i = rng.integers(60, size=900), rng.integers(40, size=900)
    rt = (rng.random(900) * 4 + 1).astype(np.float32)
    wide = als_wide_rank(dev, rng)
    for implicit in (True, False):
        model = ALS(rank=4, max_iter=4, implicit_prefs=implicit, alpha=5.0, seed=2,
                    device=str(dev)).fit(u, i, rt, 60, 40)
        xr, yr = als_np.als_np(u, i, rt, 60, 40, 4, 4, 0.1, 5.0, implicit, seed=2)
        err = np.linalg.norm(model.user_factors_ @ model.item_factors_.T - xr @ yr.T) / (
            np.linalg.norm(xr @ yr.T))
        check(err <= 1e-3, f"small ALS fit (implicit={implicit}) vs numpy oracle: {err:.3g}")
    nonneg = ALS(rank=4, max_iter=3, implicit_prefs=True, alpha=5.0, seed=2, nonnegative=True,
                 device=str(dev)).fit(u, i, rt, 60, 40)
    xn, yn = als_np.als_np(u, i, rt, 60, 40, 4, 3, 0.1, 5.0, True, seed=2, nonnegative=True)
    nn_err = max(float(np.max(np.abs(nonneg.user_factors_ - xn))),
                 float(np.max(np.abs(nonneg.item_factors_ - yn))))
    check(bool(np.all(nonneg.user_factors_ >= 0) and np.all(nonneg.item_factors_ >= 0))
          and nn_err <= 1e-6 and nonneg.summary["accelerated"] is False
          and nonneg.summary["reason"] == "nonnegative=True",
          f"small nonnegative ALS: err {nn_err:.3g}, summary {nonneg.summary}")
    # the host library's grouped layout at a ragged shape (destinations
    # without edges, degrees off the group size) against numpy's
    ru, ri = rng.integers(997, size=12_345), rng.integers(313, size=12_345)
    rc = (rng.random(12_345) * 4 + 1).astype(np.float32)
    for dst, src, n_dst in ((ru, ri, 1000), (ri, ru, 317)):
        for p in (0, 8, 13):
            native = als_ops.build_grouped_edges(dst, src, rc, n_dst, p)
            plain = als_ops.build_grouped_edges_np(dst, src, rc, n_dst, p)
            check(all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(native, plain)),
                  f"grouped edges n_dst={n_dst} p={p}: the host library differs from numpy")
    emit("small_slices", {"pca_shapes": [list(sh) for sh in PCA_SMALL],
                          "pca_routes": sorted(routes), "gram_ranks": [1, 7, 32, 70],
                          "solve_ranks": [1, 10, 32], "fits": ["pca", "als implicit",
                                                               "als explicit"],
                          "als_wide_rank": wide, "nonnegative_err": nn_err,
                          "grouped_edges_bit_equal": True})


def als_wide_rank(dev, rng, rank=1030):
    """An implicit fit at a rank above the factor Gram kernel's bound on a
    tiny table: the Gram takes the ``matmul`` route (the summary says so,
    no Gram launch), the solve ``torch.linalg``; held against the numpy
    oracle."""
    u, i = rng.integers(30, size=200), rng.integers(20, size=200)
    rt = (rng.random(200) * 4 + 1).astype(np.float32)
    als_kernel.reset_launches()
    model = ALS(rank=rank, max_iter=2, implicit_prefs=True, alpha=5.0, seed=2,
                device=str(dev)).fit(u, i, rt, 30, 20)
    s = model.summary
    check(s["gram_route"] == "matmul" and s["solve_kernel"] == "torch.linalg",
          f"ALS rank {rank}: gram route {s['gram_route']}, solve {s['solve_kernel']}")
    check(s["kernels"] == {als_kernel.SOLVE: 0, als_kernel.GRAM: 0},
          f"ALS rank {rank}: kernel launches {s['kernels']}")
    pred = model.user_factors_ @ model.item_factors_.T
    xr, yr = als_np.als_np(u, i, rt, 30, 20, rank, 2, 0.1, 5.0, True, seed=2)
    err = float(np.linalg.norm(pred - xr @ yr.T) / np.linalg.norm(xr @ yr.T))
    check(np.all(np.isfinite(pred)) and err <= 1e-3,
          f"ALS rank {rank} vs numpy oracle: {err:.3g}")
    return {"rank": rank, "gram_route": s["gram_route"], "kernels": s["kernels"],
            "rel_err_vs_numpy": err}


# -- ring and the sharded K-Means fit ----------------------------------------

def mesh_devices(dev, world):
    """``world`` ranks: distinct cards when the machine has that many,
    else every rank on ``dev``."""
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return [torch.device("cuda", i) for i in range(world)]
    return [dev] * world


def sync_all(devs):
    for d in dict.fromkeys(devs):
        sync(d)


def time_ms_all(fn, devs, reps, warm=1):
    """Mean ms per call: CUDA events when every rank is on one card, the
    host clock between synchronisations of every card otherwise."""
    if len(set(devs)) == 1:
        return time_ms(fn, devs[0], reps, warm)
    for _ in range(warm):
        fn()
    sync_all(devs)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_all(devs)
    return (time.perf_counter() - t0) * 1e3 / reps


def ring_bound(rows, cols, world, distinct):
    """Least time of one allreduce of ``world`` f32 (rows, cols) buffers:
    on one card every input read and every result written once over HBM;
    across cards the 2 (W - 1) / W of a buffer that any allreduce brings
    into each card over NVLink, or each card's read and write over HBM,
    whichever is longer.  The (W - 1) adds per element on FP32."""
    nbytes = 4.0 * rows * cols
    t_ops = (world - 1) * rows * cols / PEAK_FP32
    if distinct:
        t_bytes = max(2.0 * (world - 1) / world * nbytes / PEAK_NVLINK,
                      2.0 * nbytes / PEAK_BYTES)
        return _bound(t_ops / world, t_bytes)
    return _bound(t_ops, 2.0 * world * nbytes / PEAK_BYTES)


def phase_ring_kernels(cfg, dev, reps):
    """The ring kernel against the plain ring, bit for bit, at every
    shape, world and segment count; times, bounds, yardsticks."""
    variants = []
    wide, wide_shape = cfg["wide"]
    cases = [(world, cfg["shapes"]) for world in cfg["worlds"]] + [(wide, [wide_shape])]
    for world, shapes in cases:
        # a world past the cards: every rank on the one card
        devs = mesh_devices(dev, world)
        distinct = len(set(devs)) > 1
        layout = "distinct cards" if distinct else f"all on {devs[0]}"
        for rows, cols in shapes:
            g = torch.Generator()
            g.manual_seed(rows * cols + world)
            parts = [(torch.randn((rows, cols), generator=g) * 10.0).to(d) for d in devs]
            for segs in cfg["segments"]:
                tag = f"ring world={world} {rows}x{cols} segments={segs}"
                out = ring_kernel.ring_allreduce(parts, segs)
                again = ring_kernel.ring_allreduce(parts, segs)
                plain = ring_kernel.ring_allreduce_plain(parts, segs)
                sync_all(devs)
                same = all(torch.equal(a, b) for a, b in zip(out, again))
                exact = all(torch.equal(a, b) for a, b in zip(out, plain))
                ranks_equal = all(torch.equal(out[0], o.to(out[0].device)) for o in out)
                check(same, f"{tag}: two launches differ")
                check(exact, f"{tag}: kernel differs from the plain ring")
                check(ranks_equal, f"{tag}: ranks hold different sums")
                ref = torch.sum(torch.stack([p.double().to(devs[0]) for p in parts]), 0)
                v = {
                    "world": world, "shape": [rows, cols], "segments": segs,
                    "layout": layout, "bit_equal_to_plain": exact, "deterministic": same,
                    "max_abs_err": max(float(torch.max(torch.abs(a - b.to(a.device))))
                                       for a, b in zip(out, plain)),
                    "err_vs_f64_sum": float(torch.max(torch.abs(out[0].double() - ref))),
                    "ms": time_ms_all(lambda: ring_kernel.ring_allreduce(parts, segs),
                                      devs, reps),
                    "plain_ms": time_ms_all(
                        lambda: ring_kernel.ring_allreduce_plain(parts, segs), devs,
                        max(1, reps // 4)),
                }
                v["bound_ms"], v["bound_by"] = ring_bound(rows, cols, world, distinct)
                ring_kernel.reset_launches()
                ring_kernel.ring_allreduce(parts, segs)
                v["launches_per_ring"] = ring_kernel.LAUNCHES[ring_kernel.KERNEL]
                want = len(set(devs)) if dev.type == "cuda" else 0
                check(v["launches_per_ring"] == want,
                      f"{tag}: {v['launches_per_ring']} launches, expected one per card ({want})")
                if not distinct:
                    v["library_call"] = "torch.sum(torch.stack(parts), 0)"
                    v["library_ms"] = time_ms_all(
                        lambda: torch.sum(torch.stack(parts), 0), devs, reps)
                elif torch.cuda.nccl.is_available(parts):
                    bufs = [torch.zeros_like(p) for p in parts]
                    v["library_call"] = "torch.cuda.nccl.all_reduce (in place)"
                    v["library_ms"] = time_ms_all(
                        lambda: torch.cuda.nccl.all_reduce(bufs), devs, reps)
                else:
                    v["library_call"], v["library_ms"] = None, None
                variants.append(v)
                emit("ring_variant", v)
            del parts
    return variants


def phase_sharded_fit(cfg, dev):
    """The model-sharded K-Means path on a (data, model) mesh: its Lloyd
    loop against the one-device kernel loop from the same centers, then
    the estimator through the mesh route with the counts zeroed just
    before."""
    n, d, k, it = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"]
    world = cfg["data"] * cfg["model"]
    devs = mesh_devices(dev, world)
    layout = ",".join(str(x) for x in devs)
    emit("sharded_layout", {"devices": layout, "distinct_cards": len(set(devs)) > 1,
                            "mesh": {"data": cfg["data"], "model": cfg["model"]}})
    set_config(model_parallel=cfg["model"])
    try:
        mesh = get_mesh(devices=resolve_devices(layout))
        # from centers near the blob centers: every row lies far from a
        # Voronoi boundary, so the two routes' products (the kernel's FP32
        # sums and cuBLAS's, in other orders) give the same labels; from
        # random rows, near-ties flip a few labels of small clusters
        x, _, c0 = blobs(n, d, k, devs[0], seed=0)
        ones = torch.ones(n, device=devs[0])
        d_pad = -(-d // cfg["model"]) * cfg["model"]
        x_pad = torch.nn.functional.pad(x, (0, d_pad - d))
        table = ShardedTable.from_numpy(x_pad, mesh)
        c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c0.contiguous(), it, 1e-4)
        c2, it2, cost2, _ = kmeans_ops.lloyd_run_model_sharded(
            table.tiles, table.mask, torch.nn.functional.pad(c0, (0, d_pad - d)), it, 1e-4,
            mesh, "data", "model")
        c_err = _rel_err(c2[:, :d].to(c1.device), c1)
        cost_err = abs(float(cost2) - float(cost1)) / float(cost1)
        check(it1 == it2, f"sharded loop: {it2} iterations, one-device kernel loop {it1}")
        check(c_err <= 1e-4, f"sharded loop: centers rel err {c_err:.3g}")
        check(cost_err <= 1e-5, f"sharded loop: cost rel err {cost_err:.3g}")
        del table, c1, c2, ones

        kmeans_kernel.reset_launches()
        ring_kernel.reset_launches()
        for x_dev in set(devs):
            if x_dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(x_dev)
        t0 = time.perf_counter()
        model = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, device=layout).fit(x)
        wall = time.perf_counter() - t0
        launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    finally:
        set_config(model_parallel=1)
    s = model.summary
    dd, mm = cfg["data"], cfg["model"]
    # one launch per card per ring, one ring per model column per pass
    ring_cards = sum(len({mesh.device(r) for r in group}) for group in mesh.groups("data"))
    expect = (s.num_iter + 1) * ring_cards if dev.type == "cuda" else 0
    check(s.kernels == launches, f"summary kernels {s.kernels} != counters {launches}")
    check(launches[ring_kernel.KERNEL] == expect,
          f"ring_reduce launched {launches[ring_kernel.KERNEL]} times, expected "
          f"(num_iter + 1) * (cards of every ring) = {expect}")
    check(launches[kmeans_kernel.KERNEL] == 0, "the mesh route launched the one-device kernel")
    check(s.mesh == {"data": dd, "model": mm} and s.ring is True,
          f"summary mesh {s.mesh}, ring {s.ring}")
    check(np.isfinite(s.training_cost) and model.cluster_centers_.shape == (k, d)
          and np.all(np.isfinite(model.cluster_centers_)),
          "sharded fit: non-finite cost or centers, or wrong center shape")
    check(abs(float(np.sum(s.cluster_sizes)) - n) <= 1e-3 * n,
          "sharded fit: cluster sizes do not add up to the rows")
    cost = model.compute_cost(x)
    check(abs(cost - s.training_cost) <= 1e-4 * s.training_cost,
          f"sharded fit: compute_cost {cost} vs training cost {s.training_cost}")
    phases = s.timings.as_dict()
    fit = {
        "devices": layout, "mesh": s.mesh, "ring": s.ring, "shape": [n, d], "k": k,
        "num_iter": s.num_iter, "training_cost": s.training_cost, "compute_cost": cost,
        "wall_s": wall, "phases_s": phases,
        "iters_per_s": s.num_iter / phases["lloyd_loop"], "launches": launches,
        "loop_parity": {"n_iter": it2, "centers_rel_err": c_err, "cost_rel_err": cost_err},
        "peak_mem_gb": ({str(x_dev): torch.cuda.max_memory_allocated(x_dev) / 1e9
                         for x_dev in set(devs)} if dev.type == "cuda" else None),
    }
    emit("sharded_fit", fit)
    return fit


def phase_dp_fit(cfg, dev):
    """The data-parallel K-Means path on a (data W, model 1) mesh: its
    Lloyd loop against the one-device kernel loop from the same centers
    near the blob centers (equal iterations, centers within 1e-4, cost
    within 1e-5), then ``KMeans(k, max_iter).fit(x)`` on the device list
    with the counts zeroed just before: K1 launches (num_iter + 1) * W,
    one a rank a pass, no ring."""
    n, d, k, it, world = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"], cfg["data"]
    devs = mesh_devices(dev, world)
    layout = ",".join(str(x) for x in devs)
    set_config(model_parallel=1)
    mesh = get_mesh(devices=resolve_devices(layout))
    x, _, c0 = blobs(n, d, k, devs[0], seed=0)
    ones = torch.ones(n, device=devs[0])
    table = ShardedTable.from_numpy(x, mesh)
    c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c0.contiguous(), it, 1e-4)
    t0 = time.perf_counter()
    c2, it2, cost2, _ = kmeans_ops.lloyd_run_data_parallel(
        table.tiles, table.mask, c0, it, 1e-4, mesh, "data")
    sync_all(devs)
    loop_s = time.perf_counter() - t0
    c_err = _rel_err(c2.to(c1.device), c1)
    cost_err = abs(float(cost2) - float(cost1)) / float(cost1)
    check(it1 == it2, f"data-parallel loop: {it2} iterations, one-device kernel loop {it1}")
    check(c_err <= 1e-4, f"data-parallel loop: centers rel err {c_err:.3g}")
    check(cost_err <= 1e-5, f"data-parallel loop: cost rel err {cost_err:.3g}")
    del table, c1, c2, ones

    kmeans_kernel.reset_launches()
    ring_kernel.reset_launches()
    t0 = time.perf_counter()
    model = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, device=layout).fit(x)
    wall = time.perf_counter() - t0
    launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    s = model.summary
    expect = (s.num_iter + 1) * world if dev.type == "cuda" else 0
    check(s.kernels == launches, f"summary kernels {s.kernels} != counters {launches}")
    check(launches[kmeans_kernel.KERNEL] == expect,
          f"kmeans_accumulate launched {launches[kmeans_kernel.KERNEL]} times on the "
          f"data-parallel route, expected (num_iter + 1) * {world} = {expect}")
    check(launches[ring_kernel.KERNEL] == 0 and s.ring is False,
          "the data-parallel route ran the ring")
    check(s.mesh == {"data": world, "model": 1}, f"summary mesh {s.mesh}")
    check(np.isfinite(s.training_cost) and model.cluster_centers_.shape == (k, d)
          and np.all(np.isfinite(model.cluster_centers_)),
          "data-parallel fit: non-finite cost or centers, or wrong center shape")
    check(abs(float(np.sum(s.cluster_sizes)) - n) <= 1e-3 * n,
          "data-parallel fit: cluster sizes do not add up to the rows")
    cost = model.compute_cost(x)
    check(abs(cost - s.training_cost) <= 1e-4 * s.training_cost,
          f"data-parallel fit: compute_cost {cost} vs training cost {s.training_cost}")
    tiles = ShardedTable.from_numpy(x, mesh)
    centers = {rk: torch.as_tensor(model.cluster_centers_, device=mesh.device(rk))
               for rk in mesh.ranks}
    iteration = mesh_breakdown(lambda: [
        kmeans_kernel.lloyd_accumulate(tiles.tiles[rk], tiles.mask[rk], centers[rk],
                                       "highest", False) for rk in mesh.ranks], devs)
    del tiles
    phases = s.timings.as_dict()
    fit = {
        "devices": layout, "mesh": s.mesh, "shape": [n, d], "k": k, "pass_by_card": iteration,
        "num_iter": s.num_iter, "training_cost": s.training_cost, "wall_s": wall,
        "phases_s": phases, "iters_per_s": s.num_iter / phases["lloyd_loop"],
        "launches": launches,
        "loop_parity": {"n_iter": it2, "centers_rel_err": c_err, "cost_rel_err": cost_err,
                        "iters_per_s": it2 / loop_s},
    }
    emit("dp_fit", fit)
    return fit


def phase_pca_mesh_fit(cfg, dev):
    """The PCA path on a device list, on a (data 4, model 1) and a
    (data 2, model 2) mesh, counts zeroed just before each fit: K2
    launches twice a rank on (4, 1) (the mean and the Gram pass) and not
    at all on (2, 2) (the model-sharded Gram is a library product, as in
    the JAX package); each fit against the one-device fit, components
    sign-insensitively within 1e-4 and ratios within 1e-5."""
    (n, d), k = cfg["shapes"][0], cfg["k"]
    x = pca_data(n, d, dev, seed=d)
    one = PCA(k=k, device=str(dev)).fit(x)
    keep = one.explained_variance_ > 1e-5
    out = []
    for data, model in ((4, 1), (2, 2)):
        devs = mesh_devices(dev, data * model)
        layout = ",".join(str(v) for v in devs)
        set_config(model_parallel=model)
        try:
            pca_kernel.reset_launches()
            t0 = time.perf_counter()
            fit = PCA(k=k, device=layout).fit(x)
            wall = time.perf_counter() - t0
            launches = dict(pca_kernel.LAUNCHES)
        finally:
            set_config(model_parallel=1)
        s = fit.summary
        expect = (2 * data if model == 1 else 0) if dev.type == "cuda" else 0
        check(s["kernels"] == launches, f"summary kernels {s['kernels']} != counters {launches}")
        check(launches[pca_kernel.KERNEL] == expect,
              f"pca_moments launched {launches[pca_kernel.KERNEL]} times on ({data}, {model}), "
              f"expected {expect}")
        check(s["mesh_shape"] == {"data": data, "model": model}, f"mesh {s['mesh_shape']}")
        comp_err = sign_err(fit.components_[:, keep], one.components_[:, keep])
        ratio_err = float(np.max(np.abs(fit.explained_variance_ - one.explained_variance_)))
        check(comp_err <= 1e-4 and ratio_err <= 1e-5,
              f"pca on ({data}, {model}) vs one device: components {comp_err:.3g}, "
              f"ratios {ratio_err:.3g}")
        v = {"mesh": s["mesh_shape"], "devices": layout, "shape": [n, d], "k": k,
             "wall_s": wall, "phases_s": s["timings"].as_dict(), "launches": launches,
             "components_err": comp_err, "ratio_err": ratio_err}
        emit("pca_mesh_fit", v)
        out.append(v)
    return out


def phase_als_block_fit(cfg, data, dev, one_device):
    """The block-parallel ALS path on four ranks (distinct cards when the
    machine has four), counts zeroed just before: implicit
    ``ALS(rank, max_iter, alpha, reg)`` at the ML-25M shape, held against
    the one-device fit of ``als_fit`` in prediction space on its user
    sample (rows 0..4095 of X Y^T) within 1e-4 relative.  Launches: every
    iteration each of the W ranks solves its users (K3) with the Gram of
    its copy of Y (K4), then every item (K3) with the psum of the W
    X-block Grams (K4), so K3 = K4 = 2 W max_iter."""
    users, items, ratings = data
    n_users, n_items, r, it = cfg["n_users"], cfg["n_items"], cfg["rank"], cfg["max_iter"]
    if one_device is None:
        one_device = ALS(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                         alpha=cfg["alpha"], seed=0, device=str(dev)).fit(
            users, items, ratings, n_users, n_items)
    world = 4
    devs = mesh_devices(dev, world)
    layout = ",".join(str(v) for v in devs)
    als_kernel.reset_launches()
    t0 = time.perf_counter()
    model = ALS(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                alpha=cfg["alpha"], seed=0, device=layout).fit(
        users, items, ratings, n_users, n_items)
    wall = time.perf_counter() - t0
    launches = dict(als_kernel.LAUNCHES)
    s = model.summary
    expect = 2 * world * it if dev.type == "cuda" else 0
    check(s["kernels"] == launches, f"summary kernels {s['kernels']} != counters {launches}")
    check(launches == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect},
          f"block ALS launches {launches}, expected 2 * {world} * {it} = {expect} of each")
    check(s["block_parallel"] and s["num_user_blocks"] == world
          and s["item_layout"] == "replicated", f"block summary {s}")
    q = np.arange(min(4096, n_users))
    on = torch.device(model.device)
    got = (torch.as_tensor(model.user_factors_[q], device=on)
           @ torch.as_tensor(model.item_factors_, device=on).T)
    want = (torch.as_tensor(one_device.user_factors_[q], device=on)
            @ torch.as_tensor(one_device.item_factors_, device=on).T)
    err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    del got, want
    check(np.all(np.isfinite(model.user_factors_)) and np.all(np.isfinite(model.item_factors_)),
          "block ALS: non-finite factors")
    check(err <= 1e-4, f"block ALS vs the one-device fit: prediction rel err {err:.3g}")
    # one iteration of the block loop, profiled card by card
    mesh = get_mesh(devices=resolve_devices(layout), model_parallel=1)
    edges = als_block.prepare_block_inputs(users, items, ratings, world, n_users)
    sides = als_block.prepare_grouped_inputs(edges, mesh, n_items, r)
    ranks = als_block.data_ranks(mesh)
    x0 = {q: torch.zeros((edges.upb, r), device=mesh.device(q)) for q in ranks}
    y0 = {q: torch.as_tensor(model.item_factors_, device=mesh.device(q)) for q in ranks}

    def one_iteration():
        return als_block.als_block_run_grouped(sides, x0, y0, 1, cfg["reg"], cfg["alpha"],
                                               mesh, implicit=True)

    one_iteration()
    iteration = mesh_breakdown(one_iteration, devs)
    del sides, edges
    phases = s["timings"].as_dict()
    fit = {"devices": layout, "world": world, "layout": s["als_kernel"], "wall_s": wall,
           "phases_s": phases, "iters_per_s": it / phases["als_iterations"],
           "launches": launches, "pred_rel_err_vs_one_device": err, "users_compared": len(q),
           "iteration_by_card": iteration}
    emit("als_block_fit", fit)
    return fit


# -- out of core: the streamed routes and the 2-D ALS layout ------------------

def pinned_h2d_rate(dev, nbytes=1 << 30):
    """Bytes per second of one ``nbytes`` copy from pinned host memory to
    the card (CUDA events, the mean of three after a warm one); None in
    a rehearsal."""
    if dev.type != "cuda":
        return None
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: dst.copy_(host, non_blocking=True), dev, reps=3)
    del host, dst
    return nbytes / (ms / 1e3)


def stream_profile(fn, dev):
    """One call of ``fn`` under torch.profiler: the card's kernel time
    (the compute stream's busy time), its copy time (the side stream's
    host-to-device copies) and the compute stream's idle share of the
    call's wall; None on the CPU or where the profiler records nothing."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        evs = [ev for ev in prof.events() if str(getattr(ev, "device_type", "")).endswith("CUDA")]
        if evs:
            break
    if not evs:
        return None
    copy = sum(ev.time_range.elapsed_us() for ev in evs if "memcpy" in ev.name.lower()) / 1e3
    compute = sum(ev.time_range.elapsed_us() for ev in evs
                  if "memcpy" not in ev.name.lower()) / 1e3
    return {"profiled_wall_ms": wall, "kernel_ms": compute, "copy_ms": copy,
            "idle_share": max(0.0, 1.0 - compute / wall)}


def stream_pass(run, phase, dev, nbytes, kernel_bound_ms, rate):
    """One streamed pass, ``run(timings)``: its wall, the prefetch split
    it recorded under ``phase``, the card's idle share while it ran
    (a second, profiled call), and its bound: the larger of its bytes
    over the measured pinned host-to-device rate and the summed bound of
    its kernel launches."""
    t = Timings()
    sync(dev)
    t0 = time.perf_counter()
    run(t)
    sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    copy_ms = nbytes / rate * 1e3 if rate else None
    return {"wall_ms": wall, "split_ms": {k: v * 1e3 for k, v in t.subphases(phase).items()},
            "overlap_efficiency": t.overlap_efficiency(phase),
            "profile": stream_profile(lambda: run(None), dev), "bytes": nbytes,
            "bound_ms": max(copy_ms or 0.0, kernel_bound_ms),
            "bound_by": ("host-to-device copy" if (copy_ms or 0.0) >= kernel_bound_ms
                         else "kernels"),
            "copy_bound_ms": copy_ms, "kernel_bound_ms": kernel_bound_ms}


def source_walk_ms(src):
    """Host ms of one bare walk of a source (its chunks copied into fresh
    buffers, nothing staged): the first of the two host copies a pass
    makes; the pinned copy is the prefetch ``transfer`` split."""
    t0 = time.perf_counter()
    for _ in src:
        pass
    return (time.perf_counter() - t0) * 1e3


def pred_rel_err(model, ref, n_users, dev):
    """Relative difference of two ALS fits in prediction space on users
    0..4095 x every item, on the card."""
    q = np.arange(min(4096, n_users))
    got = (torch.as_tensor(model.user_factors_[q], device=dev)
           @ torch.as_tensor(model.item_factors_, device=dev).T)
    want = (torch.as_tensor(ref.user_factors_[q], device=dev)
            @ torch.as_tensor(ref.item_factors_, device=dev).T)
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def staged_ends(src, dev, stage_dtype=torch.float32):
    """The first and the last chunk of ``src`` as a streamed pass stages
    them (pinned buffers, the side stream): ``[(x, w, n_valid), ...]``
    on ``dev``, x widened to f32 as the kernels take it, cloned."""
    last = -(-src.n_rows // src.chunk_rows) - 1
    ends = []
    with stream_ops._staged_chunks(src, None, dev, PrefetchStats(), stage_dtype) as pf:
        for i, ((_, n_valid, _), (x, w)) in enumerate(pf):
            if i in (0, last):
                ends.append((stream_ops._f32(x).clone(), w.clone(), n_valid))
    return ends


def stream_chunk_checks(src, c, dev):
    """K1 on a full and a ragged staged chunk against its plain version
    (:func:`compare`, loop and cost mode at highest, as the streamed loop
    and its cost pass run it); on the ragged one the padding must carry
    no weight: the counts sum to its valid rows, and its cost is the
    plain version's on the valid rows alone (1e-4, the highest tier's
    cost gate)."""
    out = []
    for x, w, n_valid in staged_ends(src, dev):
        for need_cost in (False, True):
            v = compare(x, w, c, "highest", need_cost)
            v.update(rows=int(x.shape[0]), n_valid=n_valid)
            out.append(v)
        _, counts, cost = kmeans_kernel.lloyd_accumulate(x, w, c, "highest", True)
        _, _, ref = kmeans_kernel.lloyd_accumulate_plain(x[:n_valid], w[:n_valid], c,
                                                         "highest", True)
        err = abs(float(cost) - float(ref)) / max(abs(float(ref)), 1e-30)
        check(float(counts.sum()) == n_valid and err <= 1e-4,
              f"K1 on a chunk of {n_valid} valid rows: counts sum {float(counts.sum())}, "
              f"cost {err:.3g} from the valid rows' cost")
        out[-1]["cost_vs_valid_rows_rel_err"] = err
    return out


def phase_stream_kmeans(cfg, dev):
    """The streamed K-Means path on the headline table as a
    ``ChunkSource`` of ``chunk_rows`` rows: ``lloyd_run_streamed`` and the
    one-device ``lloyd_run_kernel`` from the same centers near the blob
    centers (equal iterations, centers within 1e-4, cost within 1e-5),
    K1 launched chunks x (iterations + 1) times; one loop pass's split,
    idle share and bound; then ``KMeans(...).fit(source)`` with its
    phases and route.  Returns what the route and sparse phases reuse."""
    n, d, k, rows = cfg["n"], cfg["d"], cfg["k"], cfg["chunk_rows"]
    x, _, c0 = blobs(n, d, k, dev, seed=0)
    host = x.cpu().numpy()
    src = ChunkSource.from_array(host, chunk_rows=rows)
    chunks = -(-n // src.chunk_rows)
    ones = torch.ones(n, device=dev)
    c1, it1, cost1, _ = kmeans_kernel.lloyd_run_kernel(x, ones, c0, 20, 1e-4)
    kmeans_kernel.reset_launches()
    t0 = time.perf_counter()
    c2, it2, cost2, _ = stream_ops.lloyd_run_streamed(src, c0, 20, 1e-4)
    sync(dev)
    loop_s = time.perf_counter() - t0
    launches = dict(kmeans_kernel.LAUNCHES)
    expect = chunks * (it2 + 1) if dev.type == "cuda" else 0
    c_err = _rel_err(c2, c1)
    cost_err = abs(float(cost2) - float(cost1)) / float(cost1)
    check(it1 == it2, f"streamed loop: {it2} iterations, one-device kernel loop {it1}")
    check(c_err <= 1e-4, f"streamed loop: centers rel err {c_err:.3g}")
    check(cost_err <= 1e-5, f"streamed loop: cost rel err {cost_err:.3g}")
    check(launches[kmeans_kernel.KERNEL] == expect,
          f"streamed loop: K1 launched {launches[kmeans_kernel.KERNEL]} times, expected "
          f"chunks x (iterations + 1) = {expect}")
    # a table whose length is no multiple of the chunk width: K1 on its
    # first and its padded last chunk against the plain version, and a
    # whole streamed cost pass against the one-device pass on its rows
    nr = n - cfg["cut"]
    ragged = ChunkSource.from_array(host[:nr], chunk_rows=rows)
    chunk_checks = stream_chunk_checks(ragged, c2, dev)
    s_r, n_r, t_r = stream_ops.streamed_accumulate(ragged, c2, "highest", True)
    s_1, n_1, t_1 = kmeans_kernel.lloyd_accumulate(x[:nr], ones[:nr], c2, "highest", True)
    ragged_pass = {"rows": nr,
                   "tail_valid": nr - (nr - 1) // ragged.chunk_rows * ragged.chunk_rows,
                   "sums_rel_err": _rel_err(s_r, s_1),
                   "counts_equal": bool(torch.equal(n_r, n_1)),
                   "cost_rel_err": abs(float(t_r) - float(t_1)) / float(t_1)}
    check(ragged_pass["sums_rel_err"] <= RTOL["highest"] and ragged_pass["counts_equal"]
          and ragged_pass["cost_rel_err"] <= 1e-5,
          f"streamed pass over {nr} rows vs the one-device pass: {ragged_pass}")
    del c1, ones, x, s_r, s_1
    rate = pinned_h2d_rate(dev)
    k_bound = chunks * bound(src.chunk_rows, d, k, "highest")[0]
    lloyd_pass = stream_pass(
        lambda t: stream_ops.streamed_accumulate(src, c2, "highest", False, timings=t,
                                                 phase="pass"),
        "pass", dev, chunks * src.chunk_rows * (d + 1) * 4, k_bound, rate)
    walk = source_walk_ms(src)

    kmeans_kernel.reset_launches()
    t0 = time.perf_counter()
    model = KMeans(k=k, max_iter=cfg["fit_iter"], tol=1e-4, seed=0, device=str(dev)).fit(src)
    wall = time.perf_counter() - t0
    fit_launches = dict(kmeans_kernel.LAUNCHES)
    s = model.summary
    check(s.streamed and s.route["route"] == "streamed", f"streamed fit route {s.route}")
    check(s.kernels == fit_launches, f"summary kernels {s.kernels} != counters {fit_launches}")
    check(fit_launches[kmeans_kernel.KERNEL] == (chunks * (s.num_iter + 1)
                                                 if dev.type == "cuda" else 0),
          f"streamed fit: K1 launched {fit_launches[kmeans_kernel.KERNEL]} times")
    check(np.isfinite(s.training_cost) and np.all(np.isfinite(model.cluster_centers_))
          and abs(float(np.sum(s.cluster_sizes)) - n) <= 1e-3 * n,
          "streamed fit: non-finite output or cluster sizes off")
    phases = s.timings.as_dict()
    out = {"shape": [n, d], "k": k, "chunk_rows": src.chunk_rows, "chunks": chunks,
           "h2d_pinned_gb_s": rate / 1e9 if rate else None,
           "loop": {"n_iter": it2, "centers_rel_err": c_err, "cost_rel_err": cost_err,
                    "launches": launches, "iters_per_s": it2 / loop_s},
           "chunk_checks": chunk_checks, "ragged_pass": ragged_pass,
           "lloyd_pass": lloyd_pass, "source_walk_ms": walk,
           "fit": {"wall_s": wall, "phases_s": phases, "num_iter": s.num_iter,
                   "training_cost": s.training_cost, "launches": fit_launches,
                   "route": s.route, "iters_per_s": s.num_iter / phases["lloyd_loop"],
                   "init_split": s.timings.subphases("init_centers"),
                   "lloyd_split": s.timings.subphases("lloyd_loop")}}
    emit("stream_kmeans", out)
    return out, host, model


def phase_stream_route(cfg, host, streamed, dev):
    """The route planner: ``KMeans.fit(ndarray)`` with the card budget one
    byte below ``plan_kmeans``'s estimate of the natural route takes the
    streamed route and gives the fit of the source fit (its chunks have
    the same width); for a 2^27 x 256 f32 table (128 GB, beyond the
    card) ``plan_kmeans`` and ``plan_pca`` under the detected budget say
    "streamed" (the planner alone: nothing is allocated)."""
    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    hint = kmeans_ops.auto_row_chunks(n, k)
    plan = membudget.plan_kmeans(n, d, k, row_chunks_hint=hint, device=dev)
    natural = plan.estimate_for(plan.natural).hbm_bytes
    set_config(memory_budget_hbm=str(natural - 1))
    try:
        kmeans_kernel.reset_launches()
        t0 = time.perf_counter()
        model = KMeans(k=k, max_iter=cfg["fit_iter"], tol=1e-4, seed=0,
                       device=str(dev)).fit(host)
        wall = time.perf_counter() - t0
        launches = dict(kmeans_kernel.LAUNCHES)
    finally:
        set_config(memory_budget_hbm="")
    s = model.summary
    check(s.streamed and s.route["route"] == "streamed" and s.route["degraded_scale"],
          f"a budget below the in-memory estimate did not stream: {s.route}")
    width = ChunkSource.from_array(host[:1], chunk_rows=s.route["chunk_rows"]).chunk_rows
    if width != streamed.summary.route["chunk_rows"]:
        # a rehearsal's source fit ran at another width: refit at this one
        streamed = KMeans(k=k, max_iter=cfg["fit_iter"], tol=1e-4, seed=0, device=str(dev)).fit(
            ChunkSource.from_array(host, chunk_rows=width))
    ref = streamed.summary
    c_err = float(np.max(np.abs(model.cluster_centers_ - streamed.cluster_centers_))
                  / max(np.max(np.abs(streamed.cluster_centers_)), 1e-30))
    check(s.num_iter == ref.num_iter and c_err <= 1e-6
          and abs(s.training_cost - ref.training_cost) <= 1e-6 * ref.training_cost,
          f"routed fit vs the source fit: {s.num_iter} / {ref.num_iter} iterations, "
          f"centers {c_err:.3g}")
    big = 1 << 27
    km = membudget.plan_kmeans(big, d, k, row_chunks_hint=kmeans_ops.auto_row_chunks(big, k),
                               device=dev)
    pc = membudget.plan_pca(big, d, device=dev)
    if dev.type == "cuda":
        check(km.route == "streamed" and pc.route == "streamed",
              f"a 128 GB table planned {km.route} / {pc.route}")
    out = {"budget_hbm": natural - 1, "route": s.route, "wall_s": wall,
           "phases_s": s.timings.as_dict(), "launches": launches,
           "centers_rel_err_vs_source_fit": c_err,
           "big_table": {"shape": [big, d], "kmeans": km.as_dict(), "pca": pc.as_dict()}}
    emit("stream_route", out)
    return out


def pca_chunk_checks(src, dev, policy):
    """K2 on a full and a ragged staged chunk (staged at the policy's
    dtype) against its plain version at the policy's tier, both passes:
    column sums and count within PCA_SUM_RTOL, the count equal to the
    chunk's valid rows (the padding carries weight 0), the Gram about
    the table's mean within PCA_GRAM_RTOL."""
    tier = psn.kernel_tier(policy, "highest")
    out = []
    for x, w, n_valid in staged_ends(src, dev, psn.staging_dtype(policy)):
        _, cs, cnt = pca_kernel.pca_moments(x, w, None, tier, need_gram=False)
        _, cs_p, cnt_p = pca_kernel.pca_moments_plain(x, w, None, tier, need_gram=False)
        mean = cs_p / max(float(cnt_p), 1.0)
        g, _, _ = pca_kernel.pca_moments(x, w, mean, tier, need_sums=False)
        g_p, _, _ = pca_kernel.pca_moments_plain(x, w, mean, tier, need_sums=False)
        v = {"policy": policy, "tier": tier, "rows": int(x.shape[0]), "n_valid": n_valid,
             "count": float(cnt), "colsum_rel_err": _rel_err(cs, cs_p),
             "gram_rel_err": _rel_err(g, g_p),
             "max_abs_err": float(torch.max(torch.abs(g - g_p)))}
        check(v["colsum_rel_err"] <= PCA_SUM_RTOL and float(cnt) == n_valid
              and v["gram_rel_err"] <= PCA_GRAM_RTOL[tier],
              f"K2 on a staged chunk of {n_valid} valid rows: {v}")
        out.append(v)
    return out


def phase_stream_pca(cfg, dev, rate):
    """The streamed PCA path: the PCA table as a ``ChunkSource``, K2 on
    every chunk of both passes (2 x chunks launches), components within
    1e-5 sign-insensitively and ratios within 1e-5 of the in-memory fit;
    the same under the bf16 policy against the in-memory bf16 fit, within
    the JAX package's registered bf16 bounds for PCA (the subspace angle
    5e-2 rad, the ratios 1e-2), which the in-memory bf16 fit also meets
    against the f32 one."""
    (n, d), k, rows = cfg["shapes"][0], cfg["k"], cfg["chunk_rows"]
    x = pca_data(n, d, dev, seed=d)
    host = x.cpu().numpy()
    src = ChunkSource.from_array(host, chunk_rows=rows)
    chunks = -(-n // src.chunk_rows)
    nr = n - cfg["cut"]
    ragged = ChunkSource.from_array(host[:nr], chunk_rows=rows)
    out = {"shape": [n, d], "k": k, "chunk_rows": src.chunk_rows, "chunks": chunks}
    for policy in ("f32", "bf16"):
        set_config(compute_precision=policy)
        try:
            resident = PCA(k=k, device=str(dev)).fit(x)
            pca_kernel.reset_launches()
            t0 = time.perf_counter()
            model = PCA(k=k, device=str(dev)).fit(src)
            wall = time.perf_counter() - t0
            launches = dict(pca_kernel.LAUNCHES)
        finally:
            set_config(compute_precision="f32")
        s = model.summary
        check(s["streamed"] and s["route"]["route"] == "streamed" and s["n_rows"] == n,
              f"streamed PCA summary {s.get('route')}")
        expect = 2 * chunks if dev.type == "cuda" else 0
        check(launches[pca_kernel.KERNEL] == expect and s["kernels"] == launches,
              f"streamed PCA: K2 launched {launches[pca_kernel.KERNEL]} times, expected {expect}")
        keep = resident.explained_variance_ > 1e-5
        comp_err = sign_err(model.components_[:, keep], resident.components_[:, keep])
        ratio_err = float(np.max(np.abs(model.explained_variance_
                                        - resident.explained_variance_)))
        sv = np.linalg.svd(model.components_.T @ resident.components_, compute_uv=False)
        angle = float(np.arccos(np.clip(sv.min(), 0.0, 1.0)))
        if policy == "f32":
            check(comp_err <= 1e-5 and ratio_err <= 1e-5,
                  f"streamed PCA vs in-memory: components {comp_err:.3g}, ratios {ratio_err:.3g}")
            f32_resident = resident
        else:
            sv32 = np.linalg.svd(resident.components_.T @ f32_resident.components_,
                                 compute_uv=False)
            angle32 = float(np.arccos(np.clip(sv32.min(), 0.0, 1.0)))
            ratio32 = float(np.max(np.abs(resident.explained_variance_
                                          - f32_resident.explained_variance_)))
            check(angle <= 5e-2 and ratio_err <= 1e-2,
                  f"streamed bf16 PCA vs in-memory bf16: angle {angle:.3g}, ratios {ratio_err:.3g}")
            check(angle32 <= 5e-2 and ratio32 <= 1e-2,
                  f"in-memory bf16 PCA vs f32: angle {angle32:.3g}, ratios {ratio32:.3g}")
        v = {"wall_s": wall, "phases_s": s["timings"].as_dict(), "launches": launches,
             "components_err": comp_err, "ratio_err": ratio_err, "subspace_rad": angle,
             "route": s["route"], "resident_wall_s": sum(resident.summary["timings"]
                                                         .as_dict().values())}
        if policy == "bf16":
            v.update(resident_vs_f32={"subspace_rad": angle32, "ratio_err": ratio32})
        v["chunk_checks"] = pca_chunk_checks(ragged, dev, policy)
        out[policy] = v
    # the ragged table streamed against its in-memory fit, at the f32 gates
    streamed_r = PCA(k=k, device=str(dev)).fit(ragged)
    resident_r = PCA(k=k, device=str(dev)).fit(x[:nr])
    keep = resident_r.explained_variance_ > 1e-5
    out["ragged_fit"] = {
        "rows": nr, "components_err": sign_err(streamed_r.components_[:, keep],
                                               resident_r.components_[:, keep]),
        "ratio_err": float(np.max(np.abs(streamed_r.explained_variance_
                                         - resident_r.explained_variance_)))}
    check(streamed_r.summary["n_rows"] == nr and out["ragged_fit"]["components_err"] <= 1e-5
          and out["ragged_fit"]["ratio_err"] <= 1e-5,
          f"streamed PCA of {nr} rows vs in-memory: {out['ragged_fit']}")
    k_bound = chunks * (pca_bound(src.chunk_rows, d, "highest", False)[0]
                        + pca_bound(src.chunk_rows, d, "highest", True)[0])
    out["passes"] = stream_pass(
        lambda t: stream_ops.covariance_streamed(src, "highest", t, device=dev),
        "covariance_streamed", dev, 2 * chunks * src.chunk_rows * (d + 1) * 4, k_bound, rate)
    emit("stream_pca", out)
    return out


def phase_stream_als(cfg, data, dev, resident, rate):
    """The streamed ALS path: the implicit fit routed streamed by a card
    budget one byte below the in-memory estimate, counts zeroed just
    before: K3 and K4 twice an iteration; held against the in-memory fit
    of ``als_fit`` (the same numpy-seeded init) in prediction space on
    its user sample within 1e-5; iterations/s beside it; one
    iteration's split, idle share and bound.  Then a triples
    ``ChunkSource`` fit on a small table against its array fit."""
    users, items, ratings = data
    n_users, n_items, r, it = cfg["n_users"], cfg["n_items"], cfg["rank"], cfg["max_iter"]
    plan = membudget.plan_als(len(users), n_users, n_items, r, device=dev)
    budget = plan.estimate_for("in-memory").hbm_bytes - 1
    set_config(memory_budget_hbm=str(budget))
    try:
        als_kernel.reset_launches()
        t0 = time.perf_counter()
        model = ALS(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                    alpha=cfg["alpha"], seed=0, device=str(dev)).fit(
            users, items, ratings, n_users, n_items)
        wall = time.perf_counter() - t0
        launches = dict(als_kernel.LAUNCHES)
    finally:
        set_config(memory_budget_hbm="")
    s = model.summary
    check(s.get("streamed") and s["route"]["route"] == "streamed",
          f"streamed ALS route {s.get('route')}")
    expect = 2 * it if dev.type == "cuda" else 0
    check(launches == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect} == s["kernels"],
          f"streamed ALS launches {launches}, expected {expect} of each")
    err = pred_rel_err(model, resident, n_users, dev)
    check(err <= 1e-5, f"streamed ALS vs in-memory: prediction rel err {err:.3g}")
    bit_equal = bool(np.array_equal(model.user_factors_, resident.user_factors_)
                     and np.array_equal(model.item_factors_, resident.item_factors_))
    phases = s["timings"].as_dict()
    rphases = resident.summary["timings"].as_dict()
    by_user = als_ops.build_grouped_edges(users, items, ratings, n_users)
    by_item = als_ops.build_grouped_edges(items, users, ratings, n_items)
    x0, y0 = als_np.init_factors(n_users, r, 0), als_np.init_factors(n_items, r, 1)
    nbytes = sum(a.nbytes for side in (by_user, by_item) for a in side[:3])
    k_bound = (solve_bound(n_users, r, True)[0] + solve_bound(n_items, r, True)[0]
               + gram_bound(n_users, r)[0] + gram_bound(n_items, r)[0])
    iteration = stream_pass(
        lambda t: als_stream.als_run_streamed(by_user, by_item, x0, y0, n_users, n_items, 1,
                                              cfg["reg"], cfg["alpha"], True, t, device=dev),
        "als_iterations", dev, nbytes, k_bound, rate)
    del by_user, by_item

    rng = np.random.default_rng(5)
    su, si = rng.integers(700, size=20_000), rng.zipf(1.3, size=20_000) % 300
    sr = (rng.random(20_000) * 4 + 1).astype(np.float32)
    src = ChunkSource.from_array(np.stack([su, si, sr], 1).astype(np.float64),
                                 chunk_rows=4096)
    kw = dict(rank=r, max_iter=3, reg_param=cfg["reg"], implicit_prefs=True,
              alpha=cfg["alpha"], seed=0, device=str(dev))
    als_kernel.reset_launches()
    sfit = ALS(**kw).fit(src, n_users=700, n_items=300)
    src_launches = dict(als_kernel.LAUNCHES)
    afit = ALS(**kw).fit(su, si, sr, 700, 300)
    src_err = _rel_err(torch.as_tensor(sfit.user_factors_ @ sfit.item_factors_.T),
                       torch.as_tensor(afit.user_factors_ @ afit.item_factors_.T))
    check(sfit.summary.get("streamed") and src_err <= 1e-5,
          f"triples source fit vs array fit: {src_err:.3g}")
    out = {"n_users": n_users, "n_items": n_items, "nnz": len(users), "rank": r,
           "budget_hbm": budget, "wall_s": wall, "phases_s": phases, "launches": launches,
           "iters_per_s": it / phases["als_iterations"],
           "resident_iters_per_s": it / rphases["als_iterations"],
           "pred_rel_err_vs_resident": err, "bit_equal_to_resident": bit_equal,
           "route": s["route"], "iteration": iteration,
           "source_fit": {"pred_rel_err_vs_array_fit": src_err, "launches": src_launches}}
    emit("stream_als", out)
    return out


def block_rows(table, offsets, per, dev):
    """Rows ``[offsets[b], offsets[b + 1])`` of ``table`` as block b, zero
    padded to ``per`` rows (the 2-D layout's factor blocks)."""
    out = []
    for b in range(len(offsets) - 1):
        blk = np.zeros((per, table.shape[1]), np.float32)
        blk[: offsets[b + 1] - offsets[b]] = table[offsets[b]:offsets[b + 1]]
        out.append(torch.from_numpy(blk).to(dev))
    return out


def solve_check(tag, a, b, n_reg, reg, gram):
    """K3 against its plain version on one rank's inputs, as
    :func:`phase_als_kernels` holds it: two launches equal, the rows with
    no ratings 0, bit-equal to the plain version on the rest."""
    valid = n_reg > 0
    w = als_kernel.solve_normal_eq(a, b, n_reg, reg, gram)
    same = torch.equal(w, als_kernel.solve_normal_eq(a, b, n_reg, reg, gram))
    w_p = als_kernel.solve_plain(a, b, n_reg, reg, gram)
    err = _rel_err(w[valid], w_p[valid])
    bit_equal = torch.equal(w[valid], w_p[valid])
    check(same and bool(torch.all(w[~valid] == 0)), f"{tag}: launches differ or empty rows not 0")
    check(bool(torch.all(torch.isfinite(w))) and err <= SOLVE_RTOL and bit_equal,
          f"{tag}: rel err {err:.3g}, bit-equal {bit_equal}")
    return {"systems": int(b.shape[0]), "r": int(b.shape[1]), "rel_err": err,
            "bit_equal": bit_equal, "max_abs_err": float(torch.max(torch.abs(w - w_p)))}


def gram_check(tag, f):
    """K4 against its plain version on one rank's factor block (1e-5),
    deterministic and bit-symmetric."""
    g = als_kernel.factor_gram(f)
    same = torch.equal(g, als_kernel.factor_gram(f))
    g_p = als_kernel.factor_gram_plain(f)
    err = _rel_err(g, g_p)
    check(same and (f.device.type != "cuda" or torch.equal(g, g.T)) and err <= 1e-5,
          f"{tag}: rel err {err:.3g}, deterministic {same}")
    return {"rows": int(f.shape[0]), "r": int(f.shape[1]), "rel_err": err,
            "max_abs_err": float(torch.max(torch.abs(g - g_p)))}


def block_2d_kernel_checks(cfg, data, model, devs):
    """K3 and K4 at the 2-D layout's per-rank shapes: the sides built as
    the fit builds them (the shuffles by user and by item block), the
    fitted factors cut into blocks; rank 0's user and item half-updates
    (its destinations, the other side's gathered blocks, the psum of the
    block Grams) against the plain versions."""
    users, items, ratings = data
    n_users, n_items, r, world = cfg["n_users"], cfg["n_items"], cfg["wide_rank"], len(devs)
    mesh = get_mesh(devices=resolve_devices(",".join(str(v) for v in devs)), model_parallel=1)
    by_user = als_block.prepare_block_inputs(users, items, ratings, world, n_users)
    by_item = als_block.prepare_block_inputs(items, users, ratings, world, n_items)
    grouped, sizes = als_block.block_grouped_guard_2d(users, items, n_users, n_items, world)
    sides = (als_block.prepare_grouped_inputs_2d(by_user, by_item, mesh, r, sizes) if grouped
             else als_block.prepare_coo_inputs_2d(by_user, by_item, mesh, r))
    q0 = als_block.data_ranks(mesh)[0]
    on = mesh.device(q0)
    xb = block_rows(model.user_factors_, by_user.offsets, by_user.upb, on)
    yb = block_rows(model.item_factors_, by_item.offsets, by_item.upb, on)
    out = {"layout": "grouped" if grouped else "coo"}
    for name, side, src in (("users", sides.users[q0], yb), ("items", sides.items[q0], xb)):
        gram = sum(als_kernel.factor_gram_plain(f) for f in src)
        a, b, n_reg = side.partials(torch.cat(src), cfg["alpha"], True, "f32")
        out[name] = {"solve": solve_check(f"2-D rank 0 {name} solve", a, b, n_reg, cfg["reg"],
                                          gram),
                     "gram": gram_check(f"2-D rank 0 {name} source block Gram", src[0])}
        del a, b, n_reg
    del sides
    return out


def phase_als_block_2d(cfg, data, dev):
    """The 2-D ALS item layout: implicit rank 32 at the ML-25M shape on four
    ranks (distinct cards when the machine has four) with the default
    ``als_item_layout="auto"``, which shards the items past the
    crossover; counts zeroed just before: K3 = K4 = 2 x 4 x max_iter.
    Held against the one-device rank-32 fit in prediction space on 4096
    users within 1e-4 (the block phase's gate); iterations/s; the peak
    memory of each card against the replicated layout's."""
    users, items, ratings = data
    n_users, n_items, r, it = cfg["n_users"], cfg["n_items"], cfg["wide_rank"], cfg["max_iter"]
    kw = dict(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
              alpha=cfg["alpha"], seed=0)
    one = ALS(device=str(dev), **kw).fit(users, items, ratings, n_users, n_items)
    devs = mesh_devices(dev, 4)
    layout = ",".join(str(v) for v in devs)
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    runs = {}
    # the 2-D layout as the default "auto" picks it (a rehearsal's table is
    # below the crossover and asks for it), then the replicated layout
    for item_layout in (cfg["layout_2d"], "replicated"):
        set_config(als_item_layout=item_layout)
        try:
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            als_kernel.reset_launches()
            t0 = time.perf_counter()
            m = ALS(device=layout, **kw).fit(users, items, ratings, n_users, n_items)
            runs[m.summary["item_layout"]] = {
                "model": m, "wall_s": time.perf_counter() - t0,
                "launches": dict(als_kernel.LAUNCHES),
                "peak_mem_gb": {f"cuda:{c}": torch.cuda.max_memory_allocated(c) / 1e9
                                for c in cards}}
        finally:
            set_config(als_item_layout="auto")
    check(set(runs) == {"sharded", "replicated"}, f"item layouts {sorted(runs)}")
    model, launches = runs["sharded"]["model"], runs["sharded"]["launches"]
    s = model.summary
    expect = 2 * 4 * it if dev.type == "cuda" else 0
    check(launches == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect} == s["kernels"],
          f"2-D ALS launches {launches}, expected 2 * 4 * {it} = {expect} of each")
    errs = {name: pred_rel_err(runs[name]["model"], one, n_users, dev) for name in runs}
    check(np.all(np.isfinite(model.user_factors_)) and errs["sharded"] <= 1e-4,
          f"2-D ALS vs the one-device fit: prediction rel err {errs['sharded']:.3g}")
    kernel_checks = block_2d_kernel_checks(cfg, data, model, devs)
    check(kernel_checks["layout"] == s["als_kernel"],
          f"the checked layout {kernel_checks['layout']} is not the fit's {s['als_kernel']}")
    phases = s["timings"].as_dict()
    rphases = runs["replicated"]["model"].summary["timings"].as_dict()
    peaks = {name: runs[name]["peak_mem_gb"] for name in runs}
    out = {"devices": layout, "rank": r, "item_layout": s["item_layout"],
           "layout": s["als_kernel"], "wall_s": runs["sharded"]["wall_s"], "phases_s": phases,
           "launches": launches, "iters_per_s": it / phases["als_iterations"],
           "replicated_iters_per_s": it / rphases["als_iterations"],
           "replicated_phases_s": rphases, "pred_rel_err_vs_one_device": errs,
           "peak_mem_gb_by_card": peaks, "kernel_checks": kernel_checks,
           "one_device_iters_per_s": it / one.summary["timings"].as_dict()["als_iterations"]}
    emit("als_block_2d", out)
    return out


def als_source(users, items, ratings):
    """Ratings as a width-3 (user, item, rating) f64 ``ChunkSource``: ids
    and f32 ratings are exact in f64."""
    return ChunkSource.from_array(np.stack([users, items, ratings], 1).astype(np.float64),
                                  chunk_rows=ALS_SOURCE_ROWS)


def factor_rel_err(a, b):
    """max |a - b| / max |b| of two factor tables (0 when bit-equal)."""
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-30))


def phase_block_stream(cfg, data, dev):
    """The streamed block ALS (ops/als_block_stream.py): the ML-25M ratings
    as a width-3 source on four ranks (distinct cards when the machine
    has four), implicit, rank 10 with replicated items and rank 32 in
    the 2-D layout, each held against the resident block fit of the same
    mesh and rank: the factors bit-equal (each rank's chunks are its
    resident blocks of groups; the gate is 1e-5 relative), K3 = K4 = 2 x
    4 x max_iter with the summary's counts equal to the counters, the
    route "streamed-block"; iterations/s, ``table_convert`` seconds, each
    card's peak memory beside the resident route's, and the card's idle
    share of one streamed iteration (torch.profiler)."""
    users, items, ratings = data
    n_users, n_items, it = cfg["n_users"], cfg["n_items"], cfg["max_iter"]
    devs = mesh_devices(dev, 4)
    layout = ",".join(str(v) for v in devs)
    cards = sorted({d.index for d in devs if d.type == "cuda"})
    src = als_source(users, items, ratings)
    out = []
    for r, item_layout in ((cfg["rank"], "replicated"), (cfg["wide_rank"], "sharded")):
        kw = dict(rank=r, max_iter=it, reg_param=cfg["reg"], implicit_prefs=True,
                  alpha=cfg["alpha"], seed=0)
        fits = {}
        set_config(als_item_layout=item_layout)
        try:
            for route, args in (("streamed", (src,)), ("resident", (users, items, ratings))):
                for c in cards:
                    torch.cuda.reset_peak_memory_stats(c)
                als_kernel.reset_launches()
                t0 = time.perf_counter()
                m = ALS(device=layout, **kw).fit(*args, n_users=n_users, n_items=n_items)
                fits[route] = {"model": m, "wall_s": time.perf_counter() - t0,
                               "launches": dict(als_kernel.LAUNCHES),
                               "peak_mem_gb": {f"cuda:{c}": torch.cuda.max_memory_allocated(c)
                                               / 1e9 for c in cards}}
            iteration = streamed_iteration_profile(cfg, data, r, item_layout, devs,
                                                   fits["streamed"]["model"])
        finally:
            set_config(als_item_layout="auto")
        st, rs = fits["streamed"], fits["resident"]
        s = st["model"].summary
        expect = 2 * 4 * it if dev.type == "cuda" else 0
        check(st["launches"] == {als_kernel.SOLVE: expect, als_kernel.GRAM: expect}
              == s["kernels"], f"block_stream rank {r}: launches {st['launches']}, summary "
              f"{s['kernels']}, expected 2 * 4 * {it} = {expect} of each")
        check(s["streamed"] and s["block_parallel"] and s["item_layout"] == item_layout
              and s["route"]["route"] == "streamed-block" and "streamed" not in rs["model"].summary,
              f"block_stream rank {r}: summary {s}")
        um, im = st["model"], rs["model"]
        check(np.all(np.isfinite(um.user_factors_)) and np.all(np.isfinite(um.item_factors_)),
              f"block_stream rank {r}: non-finite factors")
        errs = {"user": factor_rel_err(um.user_factors_, im.user_factors_),
                "item": factor_rel_err(um.item_factors_, im.item_factors_)}
        bit = (np.array_equal(um.user_factors_, im.user_factors_)
               and np.array_equal(um.item_factors_, im.item_factors_))
        check(max(errs.values()) <= 1e-5,
              f"block_stream rank {r}: factors {errs} from the resident block fit")
        phases, rphases = s["timings"].as_dict(), rs["model"].summary["timings"].as_dict()
        v = {"devices": layout, "rank": r, "item_layout": item_layout,
             "launches": st["launches"], "bit_equal_to_resident": bool(bit),
             "factor_rel_err_vs_resident": errs, "wall_s": st["wall_s"], "phases_s": phases,
             "iters_per_s": it / phases["als_iterations"],
             "table_convert_s": phases["table_convert"],
             "resident_iters_per_s": it / rphases["als_iterations"],
             "resident_phases_s": rphases, "peak_mem_gb": st["peak_mem_gb"],
             "resident_peak_mem_gb": rs["peak_mem_gb"], "iteration": iteration,
             "balance": s["balance"]}
        emit("block_stream", v)
        out.append(v)
        del fits, st, rs, um, im
    return out


def streamed_iteration_profile(cfg, data, r, item_layout, devs, model):
    """One iteration of the streamed block loop at the fit's layout, from
    the fitted factors, profiled card by card (the card's idle share of
    the iteration's wall)."""
    users, items, ratings = data
    mesh = get_mesh(devices=list(devs), model_parallel=1)
    lay = als_block_stream.prepare_streamed_block_layouts(
        users, items, ratings, cfg["n_users"], cfg["n_items"], mesh, r,
        item_sharded=item_layout == "sharded")
    ranks = als_block.data_ranks(mesh)

    def blocks(table, offsets, per):
        return {q: blk.to(mesh.device(q))
                for q, blk in zip(ranks, block_rows(table, offsets, per, torch.device("cpu")))}

    x0 = blocks(model.user_factors_, lay.offsets_u, lay.upb)
    y0 = (blocks(model.item_factors_, lay.by_item.offsets, lay.by_item.upb) if lay.item_sharded
          else {q: torch.as_tensor(model.item_factors_, device=mesh.device(q)) for q in ranks})

    def one_iteration():
        return als_block_stream.als_block_run_streamed(lay, x0, y0, 1, cfg["reg"],
                                                       cfg["alpha"], mesh, implicit=True)

    one_iteration()
    out = mesh_breakdown(one_iteration, list(devs))
    return {**(out or {}), "host_split": streamed_iteration_split(one_iteration, lay, devs)}


def streamed_iteration_split(one_iteration, lay, devs):
    """Where the host's wall of one streamed iteration goes, in ms: the
    producer's staging (gathering a chunk into pinned buffers) and its
    pinned copies' issue, the consumer's waits for a staged chunk, and
    the psums across the ranks (each between syncs of every card, so the
    psum's own time: this iteration is not the timed one)."""
    st = lay.stats
    before = (st.stage_s, st.transfer_s, st.wait_s)
    psum_s = [0.0]
    real = collective.psum_group

    def timed_psum(*a, **k):
        sync_all(devs)
        t0 = time.perf_counter()
        got = real(*a, **k)
        sync_all(devs)
        psum_s[0] += time.perf_counter() - t0
        return got

    collective.psum_group = timed_psum
    try:
        sync_all(devs)
        t0 = time.perf_counter()
        one_iteration()
        sync_all(devs)
        wall = time.perf_counter() - t0
    finally:
        collective.psum_group = real
    stage, transfer, wait = (a - b for a, b in zip((st.stage_s, st.transfer_s, st.wait_s),
                                                    before))
    return {"wall_ms": wall * 1e3, "staging_ms": (stage - transfer) * 1e3,
            "pinned_copy_issue_ms": transfer * 1e3, "consumer_wait_ms": wait * 1e3,
            "psum_ms": psum_s[0] * 1e3,
            "consumer_other_ms": (wall - wait - psum_s[0]) * 1e3}


def phase_sparse_input(cfg, dev):
    """SciPy CSR input: ``KMeans.fit`` and ``PCA.fit`` of a CSR table equal
    the fits of its dense copy (the same f32 table reaches the card, the
    kernels are deterministic: equal bits); counts zeroed before each."""
    import scipy.sparse as sp

    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    rng = np.random.default_rng(11)
    dense = rng.normal(size=(n, d)).astype(np.float32)
    dense[rng.random((n, d)) < 0.9] = 0.0
    dense[:, : d // 4] += rng.integers(k, size=(n, 1)).astype(np.float32)
    csr = sp.csr_matrix(dense)
    out = {"shape": [n, d], "density": csr.nnz / (n * d), "k": k}
    kmeans_kernel.reset_launches()
    pca_kernel.reset_launches()
    fits = {}
    for name, x in (("dense", dense), ("csr", csr)):
        fits[name] = (KMeans(k=k, max_iter=10, seed=0, device=str(dev)).fit(x),
                      PCA(k=cfg["pca_k"], device=str(dev)).fit(x))
    launches = {**kmeans_kernel.LAUNCHES, **pca_kernel.LAUNCHES}
    (kd, pd), (ks, ps) = fits["dense"], fits["csr"]
    check(np.array_equal(ks.cluster_centers_, kd.cluster_centers_)
          and ks.summary.training_cost == kd.summary.training_cost,
          "KMeans: the CSR fit differs from the dense fit")
    check(np.array_equal(ps.components_, pd.components_)
          and np.array_equal(ps.explained_variance_, pd.explained_variance_),
          "PCA: the CSR fit differs from the dense fit")
    if dev.type == "cuda":
        check(launches[kmeans_kernel.KERNEL] == 2 * (kd.summary.num_iter + 1)
              and launches[pca_kernel.KERNEL] == 4, f"sparse_input launches {launches}")
    out.update(launches=launches, num_iter=ks.summary.num_iter,
               kmeans_phases_s=ks.summary.timings.as_dict())
    emit("sparse_input", out)
    return out


# -- several processes ------------------------------------------------------------
# Worlds of processes that this script spawns by running itself with
# ``--mp-worker``: world "a", one rank a process (2 processes on the one
# card; 4, one card each, under --mesh), and world "b", two ranks a
# process (2 processes).  Each process makes only its own rows from the
# seed; the parent holds every fit against the one-process fit of the
# same shape afterwards.
MP_FULL = {"n": 1 << 20, "d": 256, "k": 1000, "max_iter": 20, "pca": (1 << 20, 128),
           "pca_k": 16, "chunk_rows": 1 << 16, "stream_iter": 5, "reps": 10,
           "ring_shapes": [(1000, 130), (13, 37), (65536, 256)], "als": ALS_FULL,
           "als_cut": 0.46, "drill_iter": 6, "drill_sleep_s": 0.1}
MP_TINY = {"n": 4096, "d": 29, "k": 11, "max_iter": 5, "pca": (3000, 37), "pca_k": 5,
           "chunk_rows": 256, "stream_iter": 3, "reps": 1,
           "ring_shapes": [(1000, 130), (13, 37), (512, 256)], "als": ALS_TINY,
           "als_cut": 0.46, "drill_iter": 6, "drill_sleep_s": 0.02}
MP_BLOCK = 1 << 16  # rows a seeded generator makes: any process makes its own
MP_TIMEOUT_S = 900


def blob_rows(n, lo, hi, d, k, seed, dev):
    """Rows ``[lo, hi)`` of an n-row table of Gaussian blobs, and centers
    near the blob centers: every block of ``MP_BLOCK`` rows comes from a
    generator of its own, so a process makes its rows alone and the
    whole table is the concatenation of every process's."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    true = torch.randn((k, d), generator=g, device=dev) * 2.0
    c0 = true + 0.5 * torch.randn((k, d), generator=g, device=dev)
    parts = []
    for b in range(lo // MP_BLOCK, -(-hi // MP_BLOCK)):
        b0, b1 = b * MP_BLOCK, min(n, (b + 1) * MP_BLOCK)
        gb = torch.Generator(device=dev)
        gb.manual_seed(seed * 1000003 + b + 1)
        lab = torch.randint(0, k, (b1 - b0,), generator=gb, device=dev)
        rows = true[lab] + torch.randn((b1 - b0, d), generator=gb, device=dev)
        parts.append(rows[max(lo, b0) - b0:min(hi, b1) - b0])
    return torch.cat(parts).contiguous(), c0.contiguous()


def spectrum_rows(n, lo, hi, d, seed, dev):
    """Rows ``[lo, hi)`` of ``pca_data``'s kind of table (a decaying
    spectrum around a mean of 3), block by block as :func:`blob_rows`."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((d, d), generator=g, device=dev))
    scale = 10.0 * 0.85 ** torch.arange(d, device=dev, dtype=torch.float32)
    parts = []
    for b in range(lo // MP_BLOCK, -(-hi // MP_BLOCK)):
        b0, b1 = b * MP_BLOCK, min(n, (b + 1) * MP_BLOCK)
        gb = torch.Generator(device=dev)
        gb.manual_seed(seed * 1000003 + b + 1)
        z = torch.randn((b1 - b0, d), generator=gb, device=dev) * scale
        parts.append((z @ q.T + 3.0)[max(lo, b0) - b0:min(hi, b1) - b0])
    return torch.cat(parts).contiguous()


def mp_local_devices(world, rank, mesh, rehearse):
    """A worker's own devices: world "a" one, world "b" two; the one card
    for every process, or under --mesh cards of its own."""
    per = 1 if world == "a" else 2
    if rehearse:
        return ",".join(["cpu"] * per)
    if mesh:
        return ",".join(f"cuda:{rank * per + j}" for j in range(per))
    return ",".join(["cuda:0"] * per)


def mp_same(tag, value):
    """Fail unless every process holds the same ``value`` (bytes)."""
    from oap_mllib_tpu_torch.parallel import collective

    digest = np.frombuffer(hashlib.sha256(value).digest(), np.uint8)
    (all_d,) = collective.process_allgather([digest])
    check(bool((all_d == all_d[0]).all()), f"{tag}: the processes hold different results")


def mp_timed(fn, n, dev):
    """Milliseconds a call of ``fn`` (a collective: every process times
    it together), after one warm call and a barrier."""
    from oap_mllib_tpu_torch.parallel import collective

    fn()
    sync(dev)
    collective.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / n


def gloo_bare(part):
    """A bare gloo ``all_gather`` of ``part``'s bytes, already on the
    host, into a buffer made beforehand: what the host path's transport
    costs without the port's copies."""
    import torch.distributed as dist

    host = part.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    out = torch.empty((dist.get_world_size(), host.numel()), dtype=torch.uint8)
    views = list(out.unbind(0))
    return lambda: dist.all_gather(views, host)


def mp_ring(cfg, dev, rank, nproc):
    """K5 across the processes: a ring of one member a process (world "a")
    at every shape, the kernel over IPC bit-equal to the plain version
    across processes and to the one-process plain ring of the gathered
    parts, two launches bit-equal, one launch a process a ring; times of
    the kernel call (barriers included), the plain version and the gloo
    host path (process_allgather, then a sum) for the same payload."""
    from oap_mllib_tpu_torch.parallel import collective

    out = []
    groups, owner = [list(range(nproc))], (lambda m: m)
    if dev.type == "cuda":
        # a handle does not open in the process that made it: the hazard
        # the wrapper steps round by using its own pointer
        lib = ring_kernel._library()
        ptr, handle = ctypes.c_void_p(), (ctypes.c_ubyte * 64)()
        check(lib.ring_ws_alloc(dev.index, 1 << 20, ctypes.byref(ptr), handle) == 0,
              "mp_ring: a test workspace")
        mapped = ctypes.c_void_p()
        own_err = lib.ring_ipc_open(dev.index, bytes(handle), ctypes.byref(mapped))
        check(own_err != 0, "mp_ring: a process opened its own IPC handle")
        check(lib.ring_ws_free(dev.index, ptr) == 0, "mp_ring: freeing the test workspace")
    for rows, cols in cfg["ring_shapes"]:
        g = torch.Generator()
        g.manual_seed(rows * cols + 7 * rank)
        part = (torch.randn((rows, cols), generator=g) * 10.0).to(dev)
        mine = {rank: part}
        ring_kernel.reset_launches()
        got = ring_kernel.ring_allreduce_groups(mine, groups, owner)[rank]
        launches = ring_kernel.LAUNCHES[ring_kernel.KERNEL]
        again = ring_kernel.ring_allreduce_groups(mine, groups, owner)[rank]
        plain = ring_kernel.ring_allreduce_groups_plain(mine, groups, owner)[rank]
        (all_parts,) = collective.process_allgather([part])
        one = ring_kernel.ring_allreduce_plain([torch.from_numpy(a) for a in all_parts])[0]
        sync(dev)
        tag = f"mp_ring world={nproc} {rows}x{cols}"
        check(torch.equal(got, again), f"{tag}: two launches differ")
        check(torch.equal(got, plain), f"{tag}: kernel differs from the plain version")
        check(torch.equal(got.cpu(), one), f"{tag}: differs from the one-process plain ring")
        want = 1 if dev.type == "cuda" else 0
        check(launches == want, f"{tag}: {launches} launches in this process, expected {want}")
        mp_same(tag, got.cpu().numpy().tobytes())
        reps = cfg["reps"]
        ring_kernel.reset_ipc_stats()
        ms = mp_timed(lambda: ring_kernel.ring_allreduce_groups(mine, groups, owner), reps, dev)
        stats = dict(ring_kernel.IPC_STATS)
        n_gloo = max(1, reps // 2)
        collective.reset_host_stats()
        gloo_ms = mp_timed(lambda: torch.as_tensor(
            collective.process_allgather([part])[0].sum(axis=0)).to(dev), n_gloo, dev)
        host = dict(collective.HOST_STATS)
        # the same payload's bytes through gloo alone, host to host
        bare_ms = mp_timed(gloo_bare(part), n_gloo, dev)
        plain_ms = mp_timed(lambda: ring_kernel.ring_allreduce_groups_plain(mine, groups, owner),
                            max(1, reps // 4), dev)
        distinct = dev.type == "cuda" and torch.cuda.device_count() >= nproc and nproc > 1 \
            and MP_STATE.get("mesh", False)
        bound_ms, bound_by = ring_bound(rows, cols, nproc, distinct)
        v = {"world": nproc, "shape": [rows, cols], "layout": "distinct cards" if distinct
             else f"all on {dev}", "bit_equal_to_plain": True, "launches_per_process": launches,
             "max_abs_err": float(torch.max(torch.abs(got - plain))), "ms": ms,
             "plain_ms": plain_ms, "gloo_host_ms": gloo_ms, "gloo_bare_ms": bare_ms,
             # the host path's time inside gloo's all_gather and in all of
             # process_allgather (copies included), a call
             "gloo_host_gloo_ms": 1e3 * host["gloo_s"] / max(1, host["calls"]),
             "gloo_host_exchange_ms": 1e3 * host["seconds"] / max(1, host["calls"]),
             "payload_mb": rows * cols * 4 / 1e6, "bound_ms": bound_ms,
             "bound_by": bound_by,
             "barrier_ms_per_call": 1e3 * stats["barrier_s"] / max(1, stats["calls"]),
             "host_ms_per_call": 1e3 * stats["total_s"] / max(1, stats["calls"])}
        emit("mp_ring_variant", v)
        out.append(v)
    return out


def mp_ring_members(dev, rank, nproc):
    """World "b": rings whose processes hold two members each (one ring of
    all the members, and a ring per column as the model-sharded fit
    runs them), bit-equal to the one-process plain rings."""
    from oap_mllib_tpu_torch.parallel import collective

    rows, cols = 1000, 130
    members = 2 * nproc
    mine = {}
    for m in (2 * rank, 2 * rank + 1):
        g = torch.Generator()
        g.manual_seed(31 * m + 5)
        mine[m] = (torch.randn((rows, cols), generator=g) * 10.0).to(dev)
    (gathered,) = collective.process_allgather([torch.stack([mine[2 * rank], mine[2 * rank + 1]])])
    every = [torch.from_numpy(gathered[m // 2, m % 2]) for m in range(members)]
    for groups in ([list(range(members))], [list(range(0, members, 2)),
                                            list(range(1, members, 2))]):
        ring_kernel.reset_launches()
        got = ring_kernel.ring_allreduce_groups(mine, groups, lambda m: m // 2)
        launches = ring_kernel.LAUNCHES[ring_kernel.KERNEL]
        for g in groups:
            one = ring_kernel.ring_allreduce_plain([every[m] for m in g])
            for m, t in zip(g, one):
                if m in got:
                    check(torch.equal(got[m].cpu(), t),
                          f"mp_ring {len(groups)} ring(s) of {len(g)}: member {m} differs "
                          "from the one-process plain ring")
        want = len(groups) if dev.type == "cuda" else 0
        check(launches == want, f"mp_ring: {launches} launches for {len(groups)} rings")
    return {"members_per_process": 2, "bit_equal": True}


def _mp_save(out, rank, name, array):
    np.save(os.path.join(out, f"rank{rank}_{name}.npy"), np.asarray(array))


def mp_kmeans(cfg, dev, rank, nproc, model, out, init):
    """The K-Means fit across the processes: this process's share of the
    headline table, counts zeroed just before: K1 (iterations + 1) a
    local rank, K5 one a process a ring on a model axis; iterations/s and
    the share of the Lloyd loop spent in host collectives."""
    from oap_mllib_tpu_torch.parallel import collective

    n, d, k, it = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"]
    lo, hi = rank * n // nproc, (rank + 1) * n // nproc
    x, _ = blob_rows(n, lo, hi, d, k, 0, dev)
    set_config(model_parallel=model)
    try:
        kmeans_kernel.reset_launches()
        ring_kernel.reset_launches()
        collective.reset_host_stats()
        ring_kernel.reset_ipc_stats()
        t0 = time.perf_counter()
        m = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, init_mode=init).fit(x)
        wall = time.perf_counter() - t0
        launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
        host = dict(collective.HOST_STATS)
        ipc = dict(ring_kernel.IPC_STATS)
    finally:
        set_config(model_parallel=1)
    s = m.summary
    local = len(resolve_devices())
    on_card = dev.type == "cuda"
    check(s.kernels == launches, f"mp_kmeans: summary kernels {s.kernels} != {launches}")
    # K1 runs on the data-parallel route (model 1); the sharded loop is
    # plain torch around the ring, as in one process
    k1_want = (s.num_iter + 1) * local if (on_card and model == 1) else 0
    check(launches[kmeans_kernel.KERNEL] == k1_want,
          f"mp_kmeans ({s.mesh}): K1 launched {launches[kmeans_kernel.KERNEL]} times, "
          f"expected {k1_want}")
    ring_want = (s.num_iter + 1) * model if (on_card and model > 1) else 0
    check(launches[ring_kernel.KERNEL] == ring_want,
          f"mp_kmeans ({s.mesh}): K5 launched {launches[ring_kernel.KERNEL]} times, "
          f"expected {ring_want}")
    check(s.processes == nproc and s.process_id == rank, "mp_kmeans: summary world")
    check(np.all(np.isfinite(m.cluster_centers_)) and np.isfinite(s.training_cost),
          "mp_kmeans: non-finite centers or cost")
    mp_same(f"mp_kmeans {s.mesh}", m.cluster_centers_.tobytes())
    tag = f"kmeans_{s.mesh['data']}x{s.mesh['model']}"
    _mp_save(out, rank, tag, m.cluster_centers_)
    loop = s.timings.as_dict()["lloyd_loop"]
    v = {"mesh": s.mesh, "processes": nproc, "init": init, "shape": [n, d], "k": k,
         "rows_here": hi - lo, "num_iter": s.num_iter, "training_cost": s.training_cost,
         "wall_s": wall, "phases_s": s.timings.as_dict(), "iters_per_s": s.num_iter / loop,
         "launches": launches, "host_collective_s": host["seconds"],
         "host_collective_gloo_s": host["gloo_s"],
         "host_collective_calls": host["calls"], "host_collective_bytes": host["bytes"],
         "host_collective_share_of_fit": host["seconds"] / wall,
         "ring_ipc_s": ipc["total_s"], "ring_barrier_s": ipc["barrier_s"], "tag": tag}
    emit("mp_kmeans", v)
    return v


def mp_pca(cfg, dev, rank, nproc, model, out):
    """PCA across the processes on (processes x local ranks / model,
    model): K2 twice a local rank on a model axis of 1, none above."""
    (n, d), k = cfg["pca"], cfg["pca_k"]
    lo, hi = rank * n // nproc, (rank + 1) * n // nproc
    x = spectrum_rows(n, lo, hi, d, d, dev)
    set_config(model_parallel=model)
    try:
        pca_kernel.reset_launches()
        t0 = time.perf_counter()
        fit = PCA(k=k).fit(x)
        wall = time.perf_counter() - t0
        launches = dict(pca_kernel.LAUNCHES)
    finally:
        set_config(model_parallel=1)
    s = fit.summary
    local = len(resolve_devices())
    want = (2 * local if model == 1 else 0) if dev.type == "cuda" else 0
    check(launches[pca_kernel.KERNEL] == want,
          f"mp_pca ({s['mesh_shape']}): K2 launched {launches[pca_kernel.KERNEL]}, want {want}")
    mp_same(f"mp_pca {s['mesh_shape']}", fit.components_.tobytes())
    tag = f"pca_{s['mesh_shape']['data']}x{s['mesh_shape']['model']}"
    _mp_save(out, rank, tag + "_components", fit.components_)
    _mp_save(out, rank, tag + "_ratios", fit.explained_variance_)
    v = {"mesh": s["mesh_shape"], "processes": s["processes"], "shape": [n, d], "k": k,
         "wall_s": wall, "phases_s": s["timings"].as_dict(), "launches": launches, "tag": tag}
    emit("mp_pca", v)
    return v


def mp_stream(cfg, dev, rank, nproc, out):
    """The streamed fits across the processes: this process's share of
    the headline table as a ChunkSource; the streamed Lloyd loop from
    centers near the blob centers and the streamed covariance, every
    pass's f32 moments through K5 (one launch a process a pass)."""
    n, d, k = cfg["n"], cfg["d"], cfg["k"]
    lo, hi = rank * n // nproc, (rank + 1) * n // nproc
    x, c0 = blob_rows(n, lo, hi, d, k, 0, dev)
    src = ChunkSource.from_array(x.cpu().numpy(), chunk_rows=cfg["chunk_rows"])
    del x
    kmeans_kernel.reset_launches()
    ring_kernel.reset_launches()
    t0 = time.perf_counter()
    with record_sheets() as km_sheets:
        c, n_iter, cost, counts = stream_ops.lloyd_run_streamed(
            src, c0, cfg["stream_iter"], 1e-4, "highest", device=dev)
    wall = time.perf_counter() - t0
    launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    chunks = -(-(hi - lo) // cfg["chunk_rows"])
    on_card = dev.type == "cuda"
    check(launches[kmeans_kernel.KERNEL] == (chunks * (n_iter + 1) if on_card else 0),
          f"mp_stream: K1 {launches[kmeans_kernel.KERNEL]}, expected chunks x (iterations + 1)")
    check(launches[ring_kernel.KERNEL] == (n_iter + 1 if on_card else 0),
          f"mp_stream: K5 {launches[ring_kernel.KERNEL]}, expected one a pass ({n_iter + 1})")
    mp_same("mp_stream kmeans", c.cpu().numpy().tobytes())
    _mp_save(out, rank, "stream_centers", c.cpu().numpy())
    _mp_save(out, rank, "stream_cost", np.asarray([float(cost)]))
    (pn, pd), pk = cfg["pca"], cfg["pca_k"]
    plo, phi = rank * pn // nproc, (rank + 1) * pn // nproc
    psrc = ChunkSource.from_array(spectrum_rows(pn, plo, phi, pd, pd, dev).cpu().numpy(),
                                  chunk_rows=cfg["chunk_rows"])
    pca_kernel.reset_launches()
    ring_kernel.reset_launches()
    t1 = time.perf_counter()
    with record_sheets() as pca_sheets:
        fit = PCA(k=pk).fit(psrc)
    pwall = time.perf_counter() - t1
    plaunch = {**pca_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    check(fit.summary["n_rows"] == pn, f"mp_stream pca: {fit.summary['n_rows']} rows")
    check(plaunch[ring_kernel.KERNEL] == (2 if on_card else 0),
          f"mp_stream pca: K5 {plaunch[ring_kernel.KERNEL]}, expected one a pass (2)")
    mp_same("mp_stream pca", fit.components_.tobytes())
    _mp_save(out, rank, "stream_pca_components", fit.components_)
    _mp_save(out, rank, "stream_pca_ratios", fit.explained_variance_)
    # K5 at the sheets these passes packed, on the parts they passed
    sheets = (stream_sheets("kmeans", km_sheets, cfg, dev, rank, nproc)
              + stream_sheets("pca", pca_sheets, cfg, dev, rank, nproc))
    v = {"processes": nproc, "rows_here": hi - lo, "chunk_rows": cfg["chunk_rows"],
         "num_iter": n_iter, "wall_s": wall, "s_per_pass": wall / (n_iter + 1),
         "launches": launches, "pca_wall_s": pwall, "pca_launches": plaunch,
         "ring_sheets": sheets}
    emit("mp_stream", v)
    return v


class record_sheets:
    """Within the block, every call of ``ring_kernel.ring_allreduce_groups``
    (the streamed passes' ring, stream_ops._ring_reduce_f32) keeps a copy
    of this process's part of the first sheet of each shape; the calls
    run as they would."""

    def __enter__(self):
        self.real = ring_kernel.ring_allreduce_groups
        self.sheets = {}

        def spy(parts, groups, owner, *args, **kwargs):
            for t in parts.values():
                self.sheets.setdefault(tuple(t.shape), t.detach().clone())
            return self.real(parts, groups, owner, *args, **kwargs)

        ring_kernel.ring_allreduce_groups = spy
        return self.sheets

    def __exit__(self, *exc):
        ring_kernel.ring_allreduce_groups = self.real
        return False


def stream_sheets(fit, sheets, cfg, dev, rank, nproc):
    """K5 across the processes on each sheet a streamed fit packed (its
    recorded parts, one ring of the processes): bit-equal to the plain
    version on the same parts, one launch a process; both timed.  These
    launches come after the fit's counts were read."""
    check(bool(sheets), f"mp_stream {fit}: no pass reduced through the ring")
    groups, owner = [list(range(nproc))], (lambda p: p)
    out = []
    for shape in sorted(sheets):
        mine = {rank: sheets[shape]}
        ring_kernel.reset_launches()
        got = ring_kernel.ring_allreduce_groups(mine, groups, owner)[rank]
        launches = ring_kernel.LAUNCHES[ring_kernel.KERNEL]
        plain = ring_kernel.ring_allreduce_groups_plain(mine, groups, owner)[rank]
        sync(dev)
        tag = f"mp_stream {fit} sheet {shape[0]}x{shape[1]}"
        check(torch.equal(got, plain), f"{tag}: the kernel differs from the plain version")
        want = 1 if dev.type == "cuda" else 0
        check(launches == want, f"{tag}: {launches} launches in this process, expected {want}")
        out.append({
            "fit": fit, "shape": list(shape), "bit_equal_to_plain": True,
            "max_abs_err": float(torch.max(torch.abs(got - plain))),
            "launches_per_process": launches,
            "ms": mp_timed(lambda: ring_kernel.ring_allreduce_groups(mine, groups, owner),
                           cfg["reps"], dev),
            "plain_ms": mp_timed(
                lambda: ring_kernel.ring_allreduce_groups_plain(mine, groups, owner),
                max(1, cfg["reps"] // 4), dev)})
        emit("mp_stream_sheet", out[-1])
    return out


def mp_als(cfg, dev, rank, nproc, out):
    """Implicit ALS across the processes: this process's uneven cut of the
    ML-25M-shaped ratings on its two ranks (K3 = K4 = 2 x local ranks x
    iterations), the shuffle across processes; and under --mesh rank 32
    with the 2-D layout."""
    from oap_mllib_tpu_torch.parallel import collective

    a = cfg["als"]
    u, i, r = als_data(a)
    sl = als_part(len(u), cfg["als_cut"], rank, nproc)
    runs = [(a["rank"], "replicated")]
    if MP_STATE.get("mesh") or dev.type == "cpu":
        runs.append((a["wide_rank"], "sharded"))
    res = []
    for rank_, layout in runs:
        set_config(als_item_layout=layout)
        try:
            als_kernel.reset_launches()
            collective.reset_host_stats()
            t0 = time.perf_counter()
            m = ALS(rank=rank_, max_iter=a["max_iter"], reg_param=a["reg"], alpha=a["alpha"],
                    implicit_prefs=True).fit(u[sl], i[sl], r[sl], n_users=a["n_users"],
                                            n_items=a["n_items"])
            wall = time.perf_counter() - t0
            launches = dict(als_kernel.LAUNCHES)
            host = dict(collective.HOST_STATS)
        finally:
            set_config(als_item_layout="auto")
        s = m.summary
        local = len(resolve_devices())
        want = 2 * local * a["max_iter"] if dev.type == "cuda" else 0
        check(launches[als_kernel.SOLVE] == want and launches[als_kernel.GRAM] == want,
              f"mp_als rank {rank_}: K3 {launches[als_kernel.SOLVE]}, K4 "
              f"{launches[als_kernel.GRAM]}, expected {want} each")
        check(s["item_layout"] == layout and s["processes"] == nproc, f"mp_als summary {s}")
        mp_same(f"mp_als rank {rank_}", m.user_factors_.tobytes() + m.item_factors_.tobytes())
        tag = f"als_r{rank_}_{layout}"
        if rank == 0:
            _mp_save(out, rank, tag + "_u", m.user_factors_[:4096])
            _mp_save(out, rank, tag + "_i", m.item_factors_)
        phases = s["timings"].as_dict()
        v = {"rank": rank_, "layout": layout, "mesh": s["mesh"], "processes": nproc,
             "ratings_here": int(sl.stop - sl.start) if sl.stop else len(u) - cut,
             "wall_s": wall, "phases_s": phases,
             "iters_per_s": a["max_iter"] / phases["als_iterations"], "launches": launches,
             "host_collective_s": host["seconds"], "host_collective_gloo_s": host["gloo_s"],
             "host_collective_calls": host["calls"], "host_collective_bytes": host["bytes"],
             "tag": tag}
        emit("mp_als", v)
        res.append(v)
    return res


def mp_block_stream(cfg, dev, rank, nproc, out):
    """The streamed block ALS across the processes: this process's uneven
    cut of the ML-25M ratings as a width-3 source, implicit rank 10 on
    its two ranks (K3 = K4 = 2 x local ranks x iterations), the shuffle
    across processes; the factors saved for the parent's one-process
    streamed block fit."""
    from oap_mllib_tpu_torch.parallel import collective

    a = cfg["als"]
    u, i, r = als_data(a)
    sl = als_part(len(u), cfg["als_cut"], rank, nproc)
    src = als_source(u[sl], i[sl], r[sl])
    del u, i, r
    als_kernel.reset_launches()
    collective.reset_host_stats()
    t0 = time.perf_counter()
    m = ALS(rank=a["rank"], max_iter=a["max_iter"], reg_param=a["reg"], alpha=a["alpha"],
            implicit_prefs=True).fit(src, n_users=a["n_users"], n_items=a["n_items"])
    wall = time.perf_counter() - t0
    launches = dict(als_kernel.LAUNCHES)
    host = dict(collective.HOST_STATS)
    s = m.summary
    want = 2 * len(resolve_devices()) * a["max_iter"] if dev.type == "cuda" else 0
    check(launches == {als_kernel.SOLVE: want, als_kernel.GRAM: want} == s["kernels"],
          f"mp_block_stream: launches {launches}, summary {s['kernels']}, expected {want} each")
    check(s["streamed"] and s["block_parallel"] and s["processes"] == nproc
          and s["route"]["route"] == "streamed-block", f"mp_block_stream summary {s}")
    mp_same("mp_block_stream", m.user_factors_.tobytes() + m.item_factors_.tobytes())
    if rank == 0:
        _mp_save(out, rank, "block_stream_u", m.user_factors_)
        _mp_save(out, rank, "block_stream_i", m.item_factors_)
    phases = s["timings"].as_dict()
    v = {"rank": a["rank"], "mesh": s["mesh"], "processes": nproc,
         "ratings_here": int(src.n_rows), "wall_s": wall, "phases_s": phases,
         "iters_per_s": a["max_iter"] / phases["als_iterations"], "launches": launches,
         "host_collective_s": host["seconds"], "host_collective_gloo_s": host["gloo_s"],
         "host_collective_bytes": host["bytes"], "balance": s["balance"]}
    emit("mp_block_stream", v)
    return v


def als_part(n, cut, rank, nproc):
    """Process ``rank``'s slice of ``n`` ratings: process 0 the first
    ``cut`` of them, the others equal parts of the rest."""
    first = int(n * cut)
    edges = [0] + [first + (n - first) * p // (nproc - 1) for p in range(nproc)]
    return slice(edges[rank], edges[rank + 1])


def pinned_map(nproc):
    """Every even process 1.0, every odd one 0.5: ``rank_capability``'s
    map for the world."""
    return ",".join(f"{p}:{1.0 if p % 2 == 0 else 0.5}" for p in range(nproc))


class SlowRows:
    """The drill's straggler: rows of a table, each slice a balanced view
    takes (one a chunk) paying ``seconds`` of sleep first.  It wraps the
    data this script hands the port; the port has no such setting."""

    def __init__(self, base, seconds):
        self._base = base
        self._seconds = seconds
        self.shape, self.ndim, self.dtype = base.shape, base.ndim, base.dtype

    def __getitem__(self, idx):
        if self._seconds:
            time.sleep(self._seconds)
        return self._base[idx]


def mp_balance(cfg, dev, rank, nproc, out):
    """Capability-weighted shares across the processes (world "a").
    Pinned capabilities (even processes 1.0, odd 0.5): the planned
    extents of the headline table over ``balance.local_sources`` (every
    process holds the whole table), the streamed Lloyd loop from the
    blob-centre start, the streamed PCA, and the block ALS offsets, each
    held against the same fit on equal shares (``capability_sharding``
    "off") within 1e-5, with every process's ``balance`` block equal.
    Then the drill: equal pinned capabilities, process 1's rows slowed
    by a sleep a chunk, the rollups armed, and the controller must
    re-plan within ``rebalance_patience + 1`` passes."""
    n, d, k, chunk = cfg["n"], cfg["d"], cfg["k"], cfg["chunk_rows"]
    xt, c0 = blob_rows(n, 0, n, d, k, 0, dev)
    x = xt.cpu().numpy()
    del xt
    (pn, pd), pk = cfg["pca"], cfg["pca_k"]
    px = spectrum_rows(pn, 0, pn, pd, pd, dev).cpu().numpy()
    a = cfg["als"]
    u, i, r = als_data(a)
    sl = als_part(len(u), cfg["als_cut"], rank, nproc)
    on_card = dev.type == "cuda"
    # the capability probe on this process's device (unused by the plans
    # below, which pin): its value and its cost, gathered
    from oap_mllib_tpu_torch.parallel import collective
    from oap_mllib_tpu_torch.utils import dispatch

    t0 = time.perf_counter()
    cap = dispatch.throughput_probe(0)
    probe = {"ms": (time.perf_counter() - t0) * 1e3}
    (caps,) = collective.process_allgather([np.asarray([cap, probe["ms"]])])
    probe.update(capabilities=caps[:, 0].tolist(), ms_by_process=caps[:, 1].tolist())
    # the default ("auto", nothing pinned): the world's processes run on
    # one model of card, as many a card, so they weigh the same whatever
    # the probes read
    set_config(capability_sharding="auto", rank_capability="")
    balance.reset()
    auto = balance.world_capabilities()
    probe.update(auto_weights=auto.weights.tolist(), auto_origin=auto.origin)
    check(auto.weights.tolist() == [1.0] * nproc,
          f"mp_balance: the default world's weights {auto.weights.tolist()} (probes "
          f"{probe['capabilities']}) on equal hardware")
    runs = {}
    for mode in ("weighted", "equal"):
        weighted = mode == "weighted"
        set_config(capability_sharding="auto" if weighted else "off",
                   rank_capability=pinned_map(nproc) if weighted else "", fleet_stats="off")
        balance.reset()
        src = balance.local_sources(x, chunk_rows=chunk)
        kmeans_kernel.reset_launches()
        ring_kernel.reset_launches()
        km_summary = {}
        t0 = time.perf_counter()
        stream_ops.begin_fit(src)
        c, n_iter, cost, _ = stream_ops.lloyd_run_streamed(src, c0, cfg["stream_iter"], 1e-4,
                                                           "highest", device=dev)
        stream_ops.end_fit(km_summary)
        km_wall = time.perf_counter() - t0
        km_launch = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
        local_chunks = -(-src.n_rows // chunk)
        check(km_launch[kmeans_kernel.KERNEL] == (local_chunks * (n_iter + 1) if on_card else 0)
              and km_launch[ring_kernel.KERNEL] == (n_iter + 1 if on_card else 0),
              f"mp_balance {mode} kmeans: launches {km_launch}, {local_chunks} chunks here")
        pca_kernel.reset_launches()
        ring_kernel.reset_launches()
        psrc = balance.local_sources(px, chunk_rows=chunk)
        pfit = PCA(k=pk).fit(psrc)
        p_launch = {**pca_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
        p_chunks = -(-psrc.n_rows // chunk)
        check(p_launch[pca_kernel.KERNEL] == (2 * p_chunks if on_card else 0)
              and p_launch[ring_kernel.KERNEL] == (2 if on_card else 0),
              f"mp_balance {mode} pca: launches {p_launch}, {p_chunks} chunks here")
        als_kernel.reset_launches()
        am = ALS(rank=a["rank"], max_iter=a["max_iter"], reg_param=a["reg"], alpha=a["alpha"],
                 implicit_prefs=True).fit(u[sl], i[sl], r[sl], n_users=a["n_users"],
                                          n_items=a["n_items"])
        a_launch = dict(als_kernel.LAUNCHES)
        blocks = {"kmeans": km_summary["balance"], "pca": pfit.summary["balance"],
                  "als": am.summary["balance"]}
        mp_same(f"mp_balance {mode} balance blocks",
                json.dumps(blocks, sort_keys=True).encode())
        runs[mode] = {"centers": c.cpu().numpy(), "cost": float(cost), "n_iter": n_iter,
                      "pca": (pfit.components_, pfit.explained_variance_),
                      "als": am, "blocks": blocks,
                      "extents": src.plan.extents(), "km_wall_s": km_wall,
                      "km_launches": km_launch, "pca_launches": p_launch,
                      "als_launches": a_launch,
                      "als_iters_per_s": a["max_iter"]
                      / am.summary["timings"].as_dict()["als_iterations"]}
    set_config(capability_sharding="auto", rank_capability="")
    w, e = runs["weighted"], runs["equal"]
    for mode, tag in (("weighted", "w"), ("equal", "e")):
        _mp_save(out, rank, f"balance_als_{tag}_u", runs[mode]["als"].user_factors_)
        _mp_save(out, rank, f"balance_als_{tag}_i", runs[mode]["als"].item_factors_)
    raw = np.asarray([1.0 if p % 2 == 0 else 0.5 for p in range(nproc)])
    want_ext, _ = balance.plan_extents(n, chunk, raw / raw.mean())
    check(w["extents"] == want_ext and e["extents"] != want_ext,
          f"mp_balance: weighted extents {w['extents']}, planned {want_ext}")
    off = w["blocks"]["als"]["offsets"]
    check(off is not None and off[1] - off[0] > off[2] - off[1]
          and e["blocks"]["als"]["offsets"] is None,
          f"mp_balance: block ALS offsets {off} (equal {e['blocks']['als']['offsets']})")
    errs = {"kmeans_centers": factor_rel_err(w["centers"], e["centers"]),
            "kmeans_cost": abs(w["cost"] - e["cost"]) / abs(e["cost"]),
            "pca_components": sign_err(w["pca"][0], e["pca"][0]),
            "pca_ratios": float(np.max(np.abs(w["pca"][1] - e["pca"][1]))),
            "als_pred": pred_rel_err(w["als"], e["als"], a["n_users"], dev)}
    # the factors' largest elementwise difference, beside
    errs_factor = {"als_user_max": factor_rel_err(w["als"].user_factors_,
                                                  e["als"].user_factors_),
                   "als_item_max": factor_rel_err(w["als"].item_factors_,
                                                  e["als"].item_factors_)}
    check(w["n_iter"] == e["n_iter"] and max(v for k, v in errs.items() if k != "als_pred")
          <= 1e-5, f"mp_balance: weighted against equal shares {errs}, iterations "
          f"{w['n_iter']} / {e['n_iter']}")
    # other user blocks add each item's f32 partials in another grouping,
    # which the implicit solve at alpha 40 magnifies over ten iterations:
    # held to the gate of every block ALS whose blocks differ from its
    # reference's (als_block_fit, als_block_2d, mp_als: 1e-4 in prediction
    # space), the value reported
    check(errs["als_pred"] <= 1e-4,
          f"mp_balance: weighted block ALS {errs['als_pred']:.3g} from equal shares")
    # the drill starts from the table's first k rows, far enough from the
    # blob centres that the loop does not converge before max_iter
    drill = mp_balance_drill(cfg, dev, rank, nproc, x, x[:k].copy())
    v = {"processes": nproc, "pinned": pinned_map(nproc), "table": [n, d], "chunk_rows": chunk,
         "extents": {"weighted": w["extents"], "equal": e["extents"]},
         "als_offsets": {"weighted": off, "equal": e["blocks"]["als"]["offsets"]},
         "weighted_vs_equal": errs, "weighted_vs_equal_factor_max": errs_factor,
         "kmeans_wall_s": {m: runs[m]["km_wall_s"] for m in runs},
         "als_iters_per_s": {m: runs[m]["als_iters_per_s"] for m in runs},
         "launches": {m: {"kmeans": runs[m]["km_launches"], "pca": runs[m]["pca_launches"],
                          "als": runs[m]["als_launches"]} for m in runs},
         "balance_blocks": w["blocks"], "probe": probe, "drill": drill}
    emit("mp_balance", v)
    return v


def mp_balance_drill(cfg, dev, rank, nproc, x, c0):
    """The straggler drill: capabilities pinned equal, process 1's rows
    slowed (a sleep a chunk), the rollups armed, rebalance_threshold 1.3
    and rebalance_patience 2; the streamed Lloyd loop from ``c0``.  The
    controller must re-plan by pass ``patience + 1``; K1's
    launches must equal this process's chunks summed over the passes'
    extents.  Returns each pass's walls, skew ratios and the re-plans."""
    chunk, patience = cfg["chunk_rows"], 2
    set_config(rank_capability="1.0", fleet_stats="on", rebalance_threshold=1.3,
               rebalance_patience=patience)
    balance.reset()
    try:
        src = balance.local_sources(SlowRows(x, cfg["drill_sleep_s"] if rank == 1 else 0.0),
                                    chunk_rows=chunk)
        start = src.plan.extents()
        kmeans_kernel.reset_launches()
        ring_kernel.reset_launches()
        summary = {}
        t0 = time.perf_counter()
        stream_ops.begin_fit(src)
        _, n_iter, _, _ = stream_ops.lloyd_run_streamed(src, c0, cfg["drill_iter"], 0.0,
                                                        "highest", device=dev)
        window = fleet.last_window()
        stream_ops.end_fit(summary)
        wall = time.perf_counter() - t0
        launches = {**kmeans_kernel.LAUNCHES, **ring_kernel.LAUNCHES}
    finally:
        set_config(rank_capability="", fleet_stats="auto", rebalance_threshold=1.5,
                   rebalance_patience=3)
        balance.reset()
    replans = summary["balance"]["replans"]
    check(bool(replans) and replans[0]["pass"] <= patience + 1
          and replans[0]["slowest_rank"] == 1,
          f"mp_balance drill: re-plans {replans}, expected one by pass {patience + 1}")
    rows = [rec["frames"][rank][fleet.FRAME_FIELDS.index("rows")] for rec in window]
    chunks = int(sum(-(-int(r_) // chunk) for r_ in rows))
    check(launches[kmeans_kernel.KERNEL] == (chunks if dev.type == "cuda" else 0),
          f"mp_balance drill: K1 {launches[kmeans_kernel.KERNEL]}, chunks staged {chunks}")
    mp_same("mp_balance drill", json.dumps(summary["balance"], sort_keys=True).encode())
    walls = [[rec["frames"][p][0] for p in range(nproc)] for rec in window]
    return {"sleep_s_a_chunk": cfg["drill_sleep_s"], "patience": patience, "threshold": 1.3,
            "start_extents": start, "final_extents": summary["balance"]["extents"],
            "passes": len(window), "pass_walls_s": walls,
            "pass_wall_max_s": [max(p) for p in walls],
            "skew_ratios": [rec["skew_ratio"] for rec in window], "replans": replans,
            "launches": launches, "wall_s": wall, "num_iter": n_iter,
            "fleet": summary["fleet"]}


MP_STATE = {}


def mp_worker(argv) -> int:
    """One process of a world: join, run the world's phases, print one
    ``MP_RESULT`` line."""
    from oap_mllib_tpu_torch.parallel import bootstrap

    rank, nproc, port, world, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3], argv[4]
    flags = set(argv[5:])
    rehearse, mesh = "--rehearse" in flags, "--mesh" in flags
    MP_STATE["mesh"] = mesh
    cfg = MP_TINY if rehearse else MP_FULL
    set_config(device=mp_local_devices(world, rank, mesh, rehearse), collective_timeout=600.0)
    bootstrap.initialize_distributed(f"127.0.0.1:{port}", nproc, rank, launcher_store=True)
    dev = resolve_devices()[0]
    res = {"rank": rank, "world": world, "layout": bootstrap.world_layout()}
    try:
        if world == "a":
            res["mp_ring"] = mp_ring(cfg, dev, rank, nproc)
            res["mp_kmeans"] = [mp_kmeans(cfg, dev, rank, nproc, 1, out, "k-means||")]
            res["mp_pca"] = [mp_pca(cfg, dev, rank, nproc, 1, out)]
            res["mp_stream"] = mp_stream(cfg, dev, rank, nproc, out)
            res["mp_balance"] = mp_balance(cfg, dev, rank, nproc, out)
        else:
            res["mp_ring_members"] = mp_ring_members(dev, rank, nproc)
            res["mp_kmeans"] = [mp_kmeans(cfg, dev, rank, nproc, 2, out, "random")]
            res["mp_pca"] = [mp_pca(cfg, dev, rank, nproc, 2, out)]
            res["mp_als"] = mp_als(cfg, dev, rank, nproc, out)
            res["mp_block_stream"] = mp_block_stream(cfg, dev, rank, nproc, out)
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        bootstrap.shutdown()
    print("MP_RESULT " + json.dumps(res), flush=True)
    return 0


def run_world(world, nproc, out, flags):
    """Spawn a world of ``nproc`` worker processes and collect their
    results; every process is stopped before this returns.  This process
    hosts the world's store on a port the kernel assigns and holds it
    until the workers end, so two runs on one machine never meet."""
    import datetime

    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, nproc, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-worker",
                               str(r), str(nproc), str(store.port), world, out, *flags],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(nproc)]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            left = max(1.0, MP_TIMEOUT_S - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        raise Failed(f"world {world}: the workers did not end within {MP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    results = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        for line in text.splitlines():
            if not line.startswith("MP_RESULT "):
                print(f"[{world}{r}] {line}", flush=True)
        if p.returncode != 0:
            raise Failed(f"world {world}: worker {r} exited {p.returncode}")
        got = [ln for ln in text.splitlines() if ln.startswith("MP_RESULT ")]
        check(bool(got), f"world {world}: worker {r} printed no result")
        results.append(json.loads(got[-1][len("MP_RESULT "):]))
    return results, time.perf_counter() - t0


def _mp_load(out, name, nproc):
    """A saved array, asserted identical on every process."""
    arrays = [np.load(os.path.join(out, f"rank{r}_{name}.npy")) for r in range(nproc)]
    check(all(np.array_equal(a, arrays[0]) for a in arrays), f"{name}: processes differ")
    return arrays[0]


def als_f64(data, cfg, seed, dev, chunk=1 << 21):
    """The implicit ALS of ``cfg`` in float64 on ``dev``, a plain reference
    independent of the port's routes: als_np's normal equations (A by
    ``alpha |r|`` on every edge, b by ``1 + alpha |r|`` and the ALS-WR
    count on positive ones, plus the other side's Gram) summed by
    ``index_add_`` and solved by ``torch.linalg.cholesky_ex``, rows with
    no positive rating zero; from the fits' own start (the item factors
    ``init_factors(n_items, rank, seed + 1)``).  Returns the (user, item)
    factors, float64 numpy."""
    users, items, ratings = data
    r, alpha, reg = cfg["rank"], cfg["alpha"], cfg["reg"]
    f64 = torch.float64
    u = torch.as_tensor(users, dtype=torch.int64, device=dev)
    i = torch.as_tensor(items, dtype=torch.int64, device=dev)
    c = torch.as_tensor(ratings, dtype=f64, device=dev)
    eye = torch.eye(r, dtype=f64, device=dev)

    def half(dst, src, n_dst, f):
        a = torch.zeros((n_dst, r * r), dtype=f64, device=dev)
        b = torch.zeros((n_dst, r), dtype=f64, device=dev)
        n = torch.zeros((n_dst,), dtype=f64, device=dev)
        for e0 in range(0, len(dst), chunk):
            d, ys, cc = dst[e0:e0 + chunk], f[src[e0:e0 + chunk]], c[e0:e0 + chunk]
            pos = (cc > 0).to(f64)
            a.index_add_(0, d, ((alpha * cc.abs())[:, None, None] * ys[:, :, None]
                                * ys[:, None, :]).reshape(-1, r * r))
            b.index_add_(0, d, ((1.0 + alpha * cc.abs()) * pos)[:, None] * ys)
            n.index_add_(0, d, pos)
        a = a.reshape(n_dst, r, r) + (f.T @ f)[None] + reg * n[:, None, None] * eye[None]
        chol, info = torch.linalg.cholesky_ex(a)
        x = torch.cholesky_solve(b[:, :, None], chol)[:, :, 0]
        return torch.where(((n > 0) & (info == 0))[:, None], x, 0.0)

    y = torch.as_tensor(als_np.init_factors(cfg["n_items"], r, seed + 1), dtype=f64, device=dev)
    for _ in range(cfg["max_iter"]):
        x = half(u, i, cfg["n_users"], y)
        y = half(i, u, cfg["n_items"], x)
    return x.cpu().numpy(), y.cpu().numpy()


def balance_f64_witness(cfg, data, out, nproc, dev):
    """mp_balance's weighted and equal-share block ALS (every process's
    factors equal) each against the float64 fit of the same ratings, in
    prediction space: how far each f32 fit lies from the exact answer
    beside how far the two lie apart.  The equal-share fit must lie
    within 1e-4 of it (the block ALS gate) and the weighted one within
    1e-5, or no farther than twice the equal-share fit."""
    from types import SimpleNamespace

    t0 = time.perf_counter()
    uf, itf = als_f64(data, cfg, 0, dev)
    ref = SimpleNamespace(user_factors_=uf, item_factors_=itf)
    fits = {mode: SimpleNamespace(user_factors_=_mp_load(out, f"balance_als_{tag}_u", nproc),
                                  item_factors_=_mp_load(out, f"balance_als_{tag}_i", nproc))
            for mode, tag in (("weighted", "w"), ("equal", "e"))}
    v = {f"{mode}_vs_f64": pred_rel_err(m, ref, cfg["n_users"], dev)
         for mode, m in fits.items()}
    v["weighted_vs_equal"] = pred_rel_err(fits["weighted"], fits["equal"], cfg["n_users"], dev)
    v["f64_s"] = time.perf_counter() - t0
    emit("balance_f64", v)
    check(v["equal_vs_f64"] <= 1e-4 and v["weighted_vs_f64"] <= max(2.0 * v["equal_vs_f64"],
                                                                     1e-5),
          f"balance_f64: the weighted block ALS {v['weighted_vs_f64']:.3g} from the float64 "
          f"fit, the equal-share one {v['equal_vs_f64']:.3g}")
    return v


def phase_mp(dev, mesh, rehearse):
    """The fits across processes (worlds "a" and "b"), then each against
    the one-process fit of the same shape in this process."""
    cfg = MP_TINY if rehearse else MP_FULL
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oap_mllib_tpu_torch",
                       "build", "mp_smoke")
    os.makedirs(out, exist_ok=True)
    flags = (["--rehearse"] if rehearse else []) + (["--mesh"] if mesh else [])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    n_a = 4 if mesh else 2
    a, wall_a = run_world("a", n_a, out, flags)
    b, wall_b = run_world("b", 2, out, flags)
    n, d, k, it = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"]
    x, c0 = blob_rows(n, 0, n, d, k, 0, dev)
    checks = {}
    # K-Means: the one-process mesh fit of each world's shape
    for v, layout_n, model, init in ((a[0]["mp_kmeans"][0], n_a, 1, "k-means||"),
                                     (b[0]["mp_kmeans"][0], 4, 2, "random")):
        devs = mesh_devices(dev, layout_n) if mesh else [dev] * layout_n
        set_config(model_parallel=model)
        try:
            ref = KMeans(k=k, max_iter=it, tol=1e-4, seed=0, init_mode=init,
                         device=",".join(str(q) for q in devs)).fit(x)
        finally:
            set_config(model_parallel=1)
        got = _mp_load(out, v["tag"], n_a if model == 1 else 2)
        c_err = float(np.max(np.abs(got - ref.cluster_centers_)))
        cost_err = abs(v["training_cost"] - ref.summary.training_cost) / ref.summary.training_cost
        check(v["num_iter"] == ref.summary.num_iter,
              f"mp_kmeans {v['mesh']}: {v['num_iter']} iterations, one process "
              f"{ref.summary.num_iter}")
        check(c_err <= 1e-5 and cost_err <= 1e-5,
              f"mp_kmeans {v['mesh']}: centers {c_err:.3g}, cost {cost_err:.3g} from one process")
        one_loop = ref.summary.timings.as_dict()["lloyd_loop"]
        checks[v["tag"]] = {"centers_abs_err": c_err, "cost_rel_err": cost_err,
                            "bit_equal": bool(np.array_equal(got, ref.cluster_centers_)),
                            "one_process_iters_per_s": ref.summary.num_iter / one_loop}
    # PCA: the one-device fit
    (pn, pd), pk = cfg["pca"], cfg["pca_k"]
    px = spectrum_rows(pn, 0, pn, pd, pd, dev)
    one = PCA(k=pk, device=str(dev)).fit(px)
    keep = one.explained_variance_ > 1e-5
    for v, nproc in ((a[0]["mp_pca"][0], n_a), (b[0]["mp_pca"][0], 2)):
        comps = _mp_load(out, v["tag"] + "_components", nproc)
        ratios = _mp_load(out, v["tag"] + "_ratios", nproc)
        comp_err = sign_err(comps[:, keep], one.components_[:, keep])
        ratio_err = float(np.max(np.abs(ratios - one.explained_variance_)))
        check(comp_err <= 1e-4 and ratio_err <= 1e-5,
              f"mp_pca {v['mesh']}: components {comp_err:.3g}, ratios {ratio_err:.3g}")
        checks[v["tag"]] = {"components_err": comp_err, "ratio_err": ratio_err}
    # streamed: the one-process streamed fits
    src = ChunkSource.from_array(x.cpu().numpy(), chunk_rows=cfg["chunk_rows"])
    c1, it1, cost1, _ = stream_ops.lloyd_run_streamed(src, c0, cfg["stream_iter"], 1e-4,
                                                      "highest", device=dev)
    sv = a[0]["mp_stream"]
    sc = _mp_load(out, "stream_centers", n_a)
    scost = float(_mp_load(out, "stream_cost", n_a)[0])
    sc_err = float(np.max(np.abs(sc - c1.cpu().numpy())) / np.max(np.abs(c1.cpu().numpy())))
    scost_err = abs(scost - float(cost1)) / float(cost1)
    check(sv["num_iter"] == it1 and sc_err <= 1e-4 and scost_err <= 1e-5,
          f"mp_stream kmeans: {sv['num_iter']} vs {it1} iterations, centers {sc_err:.3g}, "
          f"cost {scost_err:.3g}")
    psrc = ChunkSource.from_array(px.cpu().numpy(), chunk_rows=cfg["chunk_rows"])
    pone = PCA(k=pk, device=str(dev)).fit(psrc)
    pc = _mp_load(out, "stream_pca_components", n_a)
    pr = _mp_load(out, "stream_pca_ratios", n_a)
    pc_err = sign_err(pc[:, keep], pone.components_[:, keep])
    pr_err = float(np.max(np.abs(pr - pone.explained_variance_)))
    check(pc_err <= 1e-5 and pr_err <= 1e-5,
          f"mp_stream pca: components {pc_err:.3g}, ratios {pr_err:.3g}")
    checks["stream"] = {"centers_rel_err": sc_err, "cost_rel_err": scost_err,
                        "pca_components_err": pc_err, "pca_ratio_err": pr_err}
    del x, px, src, psrc
    # ALS: the one-process four-rank block fit, in prediction space
    acfg = cfg["als"]
    u, i, r = als_data(acfg)
    for v in b[0]["mp_als"]:
        devs = mesh_devices(dev, 4) if mesh else [dev] * 4
        set_config(als_item_layout=v["layout"])
        try:
            ref = ALS(rank=v["rank"], max_iter=acfg["max_iter"], reg_param=acfg["reg"],
                      alpha=acfg["alpha"], implicit_prefs=True,
                      device=",".join(str(q) for q in devs)).fit(
                u, i, r, n_users=acfg["n_users"], n_items=acfg["n_items"])
        finally:
            set_config(als_item_layout="auto")
        uf = np.load(os.path.join(out, f"rank0_{v['tag']}_u.npy"))
        itf = np.load(os.path.join(out, f"rank0_{v['tag']}_i.npy"))
        got = torch.as_tensor(uf, device=dev) @ torch.as_tensor(itf, device=dev).T
        want = (torch.as_tensor(ref.user_factors_[:len(uf)], device=dev)
                @ torch.as_tensor(ref.item_factors_, device=dev).T)
        err = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        check(err <= 1e-4, f"mp_als rank {v['rank']}: prediction rel err {err:.3g}")
        checks[v["tag"]] = {"pred_rel_err": err, "bit_equal": bool(
            np.array_equal(uf, ref.user_factors_[:len(uf)])
            and np.array_equal(itf, ref.item_factors_)),
            "one_process_iters_per_s": acfg["max_iter"]
            / ref.summary["timings"].as_dict()["als_iterations"]}
    # the streamed block ALS: the one-process four-rank streamed fit
    devs = mesh_devices(dev, 4) if mesh else [dev] * 4
    ref = ALS(rank=acfg["rank"], max_iter=acfg["max_iter"], reg_param=acfg["reg"],
              alpha=acfg["alpha"], implicit_prefs=True,
              device=",".join(str(q) for q in devs)).fit(
        als_source(u, i, r), n_users=acfg["n_users"], n_items=acfg["n_items"])
    uf = np.load(os.path.join(out, "rank0_block_stream_u.npy"))
    itf = np.load(os.path.join(out, "rank0_block_stream_i.npy"))
    errs = {"user": factor_rel_err(uf, ref.user_factors_),
            "item": factor_rel_err(itf, ref.item_factors_)}
    check(ref.summary["streamed"] and max(errs.values()) <= 1e-5,
          f"mp_block_stream: factors {errs} from the one-process streamed block fit")
    checks["block_stream"] = {"factor_rel_err": errs, "bit_equal": bool(
        np.array_equal(uf, ref.user_factors_) and np.array_equal(itf, ref.item_factors_)),
        "one_process_iters_per_s": acfg["max_iter"]
        / ref.summary["timings"].as_dict()["als_iterations"]}
    del ref, uf, itf
    bal = a[0]["mp_balance"]
    checks["balance_f64"] = balance_f64_witness(acfg, (u, i, r), out, n_a, dev)
    checks["balance"] = {"weighted_vs_equal": bal["weighted_vs_equal"],
                         "extents": bal["extents"], "als_offsets": bal["als_offsets"],
                         "drill_replans": len(bal["drill"]["replans"]),
                         "drill_first_replan_pass": bal["drill"]["replans"][0]["pass"]}
    result = {"worlds": {"a": {"processes": n_a, "wall_s": wall_a},
                         "b": {"processes": 2, "wall_s": wall_b}},
              "a": a, "b": b, "checks": checks}
    emit("mp", {"checks": checks, "wall_s": {"a": wall_a, "b": wall_b}})
    return result


# -- the resilience ladder and the randomized PCA solver -----------------------------

class armed:
    """``Config.fault_spec`` armed for a ``with`` block, the registry's
    counts fresh, disarmed on the way out."""

    def __init__(self, spec):
        self.spec = spec

    def __enter__(self):
        set_config(fault_spec=self.spec)
        faults.reset()

    def __exit__(self, *exc):
        set_config(fault_spec="")
        faults.reset()


def counted_fit(fit, *tables):
    """``fit()`` with every launch count set to 0 just before and read
    just after; the summary's ``kernels`` must equal the counts."""
    for t in tables:
        for name in t:
            t[name] = 0
    model = fit()
    launches = {name: n for t in tables for name, n in t.items()}
    s = model.summary
    got = s["kernels"] if isinstance(s, dict) else s.kernels
    check(got == launches, f"summary kernels {got} != counters {launches}")
    return model, launches


def ladder_res(model):
    s = model.summary
    return s["resilience"] if isinstance(s, dict) else s.resilience


def phase_ladder(cfg, dev):
    """The resilience ladder on the card at small sizes: each leg a fit
    under a fault spec, counts zeroed just before and read just after,
    against the same fit without the fault.  Returns each leg's
    launches."""
    n, d, k, it = cfg["n"], cfg["d"], cfg["k"], cfg["max_iter"]
    narrow, wide = cfg["rows"]
    cuda = dev.type == "cuda"
    x, _, _ = blobs(n, d, k, dev, seed=11)
    host = x.cpu().numpy()
    del x
    set_config(retry_backoff=0.001, retry_deadline=30.0)
    km = kmeans_kernel.LAUNCHES
    out = {}

    def kfit(src, **kw):
        return KMeans(k=k, max_iter=kw.pop("max_iter", it), tol=1e-4, seed=0,
                      device=str(dev), **kw).fit(src)

    # (a) transient faults: three retries, the same bits
    base, base_l = counted_fit(lambda: kfit(ChunkSource.from_array(host, narrow)), km)
    with armed("stream.read:fail=2,prefetch.stage:fail=1"):
        m, launches = counted_fit(lambda: kfit(ChunkSource.from_array(host, narrow)), km)
    res = ladder_res(m)
    check(res["retries"] == 3 and res["faults"] == 3 and res["degradations"] == 0,
          f"ladder (a): {res}")
    check(np.array_equal(m.cluster_centers_, base.cluster_centers_),
          "ladder (a): the retried fit's centers differ from the unfaulted fit's")
    check(launches == base_l and (launches[kmeans_kernel.KERNEL] > 0) == cuda,
          f"ladder (a): launches {launches} vs the unfaulted fit's {base_l}")
    out["a_transient"] = {"resilience": res, "launches": launches, "chunk_rows": narrow}
    emit("ladder_a", out["a_transient"])

    # (b) two device OOMs: halvings /2, /4, the cost of a fit at chunk / 4
    quarter, quarter_l = counted_fit(lambda: kfit(ChunkSource.from_array(host, wide // 4)), km)
    with armed("fit.execute:oom=2"):
        m, launches = counted_fit(lambda: kfit(ChunkSource.from_array(host, wide)), km)
    res = ladder_res(m)
    cost_err = abs(m.summary.training_cost - quarter.summary.training_cost) / abs(
        quarter.summary.training_cost)
    check(res["halvings"] == [2, 4] and res["degradations"] == 2, f"ladder (b): {res}")
    check(cost_err <= 1e-5, f"ladder (b): cost {cost_err:.3g} from the fit at chunk / 4")
    check(launches == quarter_l, f"ladder (b): launches {launches} vs {quarter_l}")
    out["b_halving"] = {"resilience": res, "launches": launches, "cost_rel_err": cost_err,
                        "chunk_rows": wide, "real_oom": real_oom(cfg, dev, kfit)}
    emit("ladder_b", out["b_halving"])

    # (c) a host OOM in an in-memory fit: the spill rung, then the
    # streamed fit of the spill, bit-equal to the same source's fit
    spill_dir = tempfile.mkdtemp(prefix="oap-ladder-spill.")
    try:
        set_config(spill_dir=spill_dir)
        with armed("fit.execute:oomhost=1"):
            m, launches = counted_fit(lambda: kfit(host), km)
        res = ladder_res(m)
        rows = m.summary.route["chunk_rows"]
        ref, ref_l = counted_fit(lambda: kfit(ChunkSource.from_array(host, rows)), km)
        check(res["spilled"] and m.summary.route.get("spilled") and m.summary.streamed
              and res["degradations"] == 1, f"ladder (c): {res}, route {m.summary.route}")
        check(np.array_equal(m.cluster_centers_, ref.cluster_centers_),
              "ladder (c): the spilled fit differs from the source fit")
        check(launches == ref_l, f"ladder (c): launches {launches} vs {ref_l}")
        out["c_spill"] = {"resilience": res, "launches": launches,
                          "spill_files": sorted(os.listdir(spill_dir))}
    finally:
        set_config(spill_dir="")
        shutil.rmtree(spill_dir, ignore_errors=True)
    emit("ladder_c", out["c_spill"])

    # (d) a non-finite iterate under bf16: the precision rung, K1 at the
    # bf16 tier in the unfaulted fit and at highest in the retry
    set_config(compute_precision="bf16")
    try:
        kmeans_kernel.reset_launches()  # the tallies by tier too
        bf, bf_l = counted_fit(lambda: kfit(host), km)
        bf_modes = dict(kmeans_kernel.LAUNCHES_BY_MODE)
        with armed("fit.execute:nan=1"):
            kmeans_kernel.reset_launches()
            m, launches = counted_fit(lambda: kfit(host), km)
        modes = dict(kmeans_kernel.LAUNCHES_BY_MODE)
    finally:
        set_config(compute_precision="f32")
    f32, _ = counted_fit(lambda: kfit(host), km)
    res = ladder_res(m)
    iters = m.summary.num_iter
    check(bf.summary.precision == "bf16" and m.summary.precision == "f32"
          and res["degradations"] == 1 and "[nonfinite]" in res["history"][0],
          f"ladder (d): {res}, precision {m.summary.precision}")
    check(not cuda or (bf_modes["default"] == bf.summary.num_iter and bf_modes["highest"] == 1
                       and modes["default"] == 0 and modes["highest"] == iters + 1),
          f"ladder (d): K1 by tier, bf16 fit {bf_modes}, rung {modes}")
    check(np.array_equal(m.cluster_centers_, f32.cluster_centers_),
          "ladder (d): the f32 retry differs from the f32 fit")
    out["d_precision"] = {"resilience": res, "launches": launches, "by_tier": modes,
                          "bf16_fit_by_tier": bf_modes}
    emit("ladder_d", out["d_precision"])

    # (e) C1: non-finite iterates raise, naming what went non-finite
    bad = host.copy()
    bad[7, 2] = np.nan
    names = {}
    for tag, fit, what in (
            ("kmeans", lambda: kfit(ChunkSource.from_array(bad, wide), max_iter=3,
                                    init_mode="random"), "centroids"),
            ("pca", lambda: PCA(k=2, device=str(dev)).fit(ChunkSource.from_array(
                (np.random.default_rng(0).normal(size=(4096, 16)) * 3e19).astype(np.float32),
                wide)), "Gram")):
        try:
            fit()
        except resilience.NonFiniteError as e:
            names[tag] = str(e)
        check(what in names.get(tag, ""), f"ladder (e): {tag} raised {names.get(tag)!r}")
    out["e_nonfinite"] = names
    emit("ladder_e", names)

    # (f) a persistent device OOM: every halving, then ResilienceError
    # with the history; the plain version (the CPU) never runs
    plain_calls = [0]
    real_plain = kmeans_kernel.lloyd_accumulate_plain

    def spy(*a, **kw):
        plain_calls[0] += 1
        return real_plain(*a, **kw)

    kmeans_kernel.lloyd_accumulate_plain = spy
    history = None
    try:
        kmeans_kernel.reset_launches()
        with armed("fit.execute:oom=*"):
            try:
                kfit(ChunkSource.from_array(host, wide))
            except resilience.ResilienceError as e:
                history = e.history
    finally:
        kmeans_kernel.lloyd_accumulate_plain = real_plain
    expect = resilience.halvings_available(ChunkSource.from_array(host, wide).chunk_rows) + 1
    check(history is not None and len(history) == expect,
          f"ladder (f): history {history}, expected {expect} entries")
    check(not cuda or plain_calls[0] == 0, f"ladder (f): the plain version ran {plain_calls}")
    out["f_exhausted"] = {"history": history, "launches": dict(km),
                          "plain_calls": plain_calls[0]}
    emit("ladder_f", out["f_exhausted"])

    # (g) a streamed ALS fit from a triples source, one read fault
    rng = np.random.default_rng(5)
    a = cfg["als"]
    tri = np.stack([rng.integers(a["n_users"], size=a["nnz"]),
                    np.minimum(rng.zipf(1.3, size=a["nnz"]) - 1, a["n_items"] - 1),
                    rng.random(a["nnz"]) * 4 + 1], axis=1)

    def afit():
        return ALS(rank=a["rank"], max_iter=a["max_iter"], implicit_prefs=True, alpha=40.0,
                   reg_param=0.1, seed=0, device=str(dev)).fit(
            ChunkSource.from_array(tri, 1 << 16))

    ab, ab_l = counted_fit(afit, als_kernel.LAUNCHES)
    with armed("stream.read:fail=1"):
        m, launches = counted_fit(afit, als_kernel.LAUNCHES)
    res = ladder_res(m)
    want = 2 * a["max_iter"] if cuda else 0
    check(res["retries"] == 1 and m.summary["streamed"], f"ladder (g): {res}")
    check(launches[als_kernel.SOLVE] == want and launches[als_kernel.GRAM] == want,
          f"ladder (g): launches {launches}, expected {want} of each")
    check(np.array_equal(m.user_factors_, ab.user_factors_)
          and np.array_equal(m.item_factors_, ab.item_factors_),
          "ladder (g): the retried ALS factors differ from the unfaulted fit's")
    out["g_als"] = {"resilience": res, "launches": launches}
    emit("ladder_g", out["g_als"])
    set_config(retry_backoff=0.05, retry_deadline=30.0)
    return out


def real_oom(cfg, dev, kfit):
    """A real ``torch.cuda.OutOfMemoryError`` (an allocation larger than
    the card) must classify as "oom".  Then a streamed fit of a table
    staged as one chunk (``oom_rows`` x d, so its chunks dominate the
    fit's device memory) under a memory cap
    (``torch.cuda.set_per_process_memory_fraction``) halfway between the
    peaks measured at the full chunk width and at half of it: where the
    cap makes the full width fail, the halving rungs must finish, the
    fit bit-equal to the fit at the width they reached.  Whether the cap
    fires is reported, not required."""
    if dev.type != "cuda":
        return None
    x, _, _ = blobs(cfg["oom_rows"], cfg["d"], cfg["k"], dev, seed=12)
    host = x.cpu().numpy()
    del x
    try:
        torch.empty((1 << 40,), dtype=torch.uint8, device=dev)
        kind = "no error"
    except torch.cuda.OutOfMemoryError as e:
        kind = resilience.classify_fault(e)
    check(kind == resilience.OOM, f"a real CUDA OOM classified as {kind!r}")
    rows = host.shape[0]  # the whole table one chunk: the staged chunks dominate
    peaks = {}
    fits = {}
    for width in (rows, rows // 2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        fits[width] = kfit(ChunkSource.from_array(host, width))
        # the cap bounds what the allocator reserves, but it frees its
        # cached blocks and retries before it raises: what a fit needs
        # is its peak of live allocations
        peaks[width] = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = (peaks[rows] + peaks[rows // 2]) // 2
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total, dev)
    try:
        m = kfit(ChunkSource.from_array(host, rows))
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        torch.cuda.empty_cache()
    res = m.summary.resilience
    fired = res["faults"] > 0
    if fired:
        check(all("[oom]" in h and "out of memory" in h.lower() for h in res["history"])
              and res["halvings"] == [2 ** (i + 1) for i in range(len(res["history"]))],
              f"real OOM rung: {res}")
        width = resilience.halved_rows(ChunkSource.from_array(host, rows).chunk_rows,
                                       len(res["halvings"]))
        ref = fits.get(width) or kfit(ChunkSource.from_array(host, width))
        check(np.array_equal(m.cluster_centers_, ref.cluster_centers_),
              f"real OOM rung: the fit differs from the fit at {width} rows")
    return {"classified": kind, "peaks_allocated": {str(w): p for w, p in peaks.items()},
            "cap_bytes": cap, "fired": fired, "resilience": res}


def phase_pca_randomized(cfg, dev, smi):
    """The randomized solver at the full width of the PCA kernel phase
    (2^18 x 1024, k = 16, a decaying spectrum): against eigh on the same
    table, the ratios within 1e-4 relative and every component's
    |cosine| above 1 - 1e-4; two K2 launches a fit, counted just before
    and after; each fit's wall and each solver's own time on the
    covariance (CUDA events)."""
    (n, d), k = cfg["shapes"][-1], cfg["k"]
    x = pca_data(n, d, dev, seed=d + 1)
    fits = {}
    for solver in ("eigh", "randomized"):
        set_config(pca_solver=solver)
        try:
            t0 = time.perf_counter()
            model, launches = counted_fit(lambda: PCA(k=k, device=str(dev)).fit(x),
                                          pca_kernel.LAUNCHES)
            wall = time.perf_counter() - t0
        finally:
            set_config(pca_solver="auto")
        check(model.summary["pca_solver"] == solver, f"pca_randomized: ran {model.summary}")
        check(launches[pca_kernel.KERNEL] == (2 if dev.type == "cuda" else 0),
              f"pca_randomized {solver}: K2 launched {launches}")
        fits[solver] = (model, launches, wall)
    eigh, rand = fits["eigh"][0], fits["randomized"][0]
    ratio_err = float(np.max(np.abs(rand.explained_variance_ - eigh.explained_variance_)
                             / eigh.explained_variance_))
    cos = np.abs(np.einsum("dk,dk->k", rand.components_, eigh.components_))
    check(ratio_err <= 1e-4 and bool(np.all(cos > 1 - 1e-4)),
          f"pca_randomized: ratios {ratio_err:.3g}, cosines {cos.min():.8f}")
    cov, _ = pca_ops.covariance(x, torch.ones(n, device=dev), n)
    reps = 5 if dev.type == "cuda" else 1
    out = {"shape": [n, d], "k": k, "ratio_rel_err": ratio_err,
           "min_abs_cosine": float(cos.min()), "card": smi,
           "eigh_ms": time_ms(lambda: pca_ops.eigh_descending(cov), dev, reps),
           "randomized_ms": time_ms(lambda: pca_ops.topk_eigh_randomized(cov, k), dev, reps)}
    for solver, (model, launches, wall) in fits.items():
        out[solver] = {"wall_s": wall, "phases_s": model.summary["timings"].as_dict(),
                       "launches": launches}
    emit("pca_randomized", out)
    return out


def mp_launches(mp):
    """Each kernel's launches by path in the worlds (process 0's)."""
    a, b = mp["a"][0], mp["b"][0]
    return {
        kmeans_kernel.KERNEL: {f"mp_kmeans {v['tag']} (a process)": v["launches"][
            kmeans_kernel.KERNEL] for v in a["mp_kmeans"] + b["mp_kmeans"]} | {
            "mp_stream kmeans (a process)": a["mp_stream"]["launches"][kmeans_kernel.KERNEL],
            "mp_balance kmeans weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["kmeans"][kmeans_kernel.KERNEL],
            "mp_balance drill (a process)":
                a["mp_balance"]["drill"]["launches"][kmeans_kernel.KERNEL]},
        pca_kernel.KERNEL: {f"mp_pca {v['tag']} (a process)": v["launches"][pca_kernel.KERNEL]
                            for v in a["mp_pca"] + b["mp_pca"]} | {
            "mp_stream pca (a process)": a["mp_stream"]["pca_launches"][pca_kernel.KERNEL],
            "mp_balance pca weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["pca"][pca_kernel.KERNEL]},
        als_kernel.SOLVE: {f"mp_{v['tag']} (a process)": v["launches"][als_kernel.SOLVE]
                           for v in b["mp_als"]} | {
            "mp_block_stream (a process)": b["mp_block_stream"]["launches"][als_kernel.SOLVE],
            "mp_balance als weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["als"][als_kernel.SOLVE]},
        als_kernel.GRAM: {f"mp_{v['tag']} (a process)": v["launches"][als_kernel.GRAM]
                          for v in b["mp_als"]} | {
            "mp_block_stream (a process)": b["mp_block_stream"]["launches"][als_kernel.GRAM],
            "mp_balance als weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["als"][als_kernel.GRAM]},
        ring_kernel.KERNEL: {f"mp_kmeans {v['tag']} (a process)": v["launches"][
            ring_kernel.KERNEL] for v in a["mp_kmeans"] + b["mp_kmeans"]} | {
            "mp_stream kmeans (a process)": a["mp_stream"]["launches"][ring_kernel.KERNEL],
            "mp_stream pca (a process)": a["mp_stream"]["pca_launches"][ring_kernel.KERNEL],
            "mp_balance kmeans weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["kmeans"][ring_kernel.KERNEL],
            "mp_balance pca weighted (a process)":
                a["mp_balance"]["launches"]["weighted"]["pca"][ring_kernel.KERNEL],
            "mp_balance drill (a process)":
                a["mp_balance"]["drill"]["launches"][ring_kernel.KERNEL]},
    }


def phase_build(dev):
    """Every kernel built from the sources; ptxas's registers and spills;
    the HGMMA (tensor-core wgmma) instructions of the libraries that must
    hold them.  Returns the nvidia-smi line."""
    smi = nvidia_smi()
    print(f"device {torch.cuda.get_device_name(dev)} | {smi}", flush=True)
    t0 = time.perf_counter()
    paths = _build.build_all()
    emit("build", {"seconds": time.perf_counter() - t0,
                   "sources_hash": _build.sources_hash(), "cwd": os.getcwd(),
                   "libraries": {k: str(v) for k, v in paths.items()}})
    for name in paths:
        log = (_build.BUILD_DIR / f"{name}.ptxas.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}")
    for name, what in ((pca_kernel.KERNEL, "the bf16 Gram tiers"),
                       (kmeans_kernel.KERNEL, "the Lloyd assignment, every tier")):
        hgmma = count_sass(paths[name], "HGMMA")
        print(f"sass {paths[name].name}: {hgmma} HGMMA instructions "
              f"({what} on the tensor cores)", flush=True)
        check(hgmma > 0, f"the {name} library holds no HGMMA instruction")
    return smi


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--mp-worker"]:
        return mp_worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases on the CPU at a tiny size, plain versions only")
    ap.add_argument("--mesh", action="store_true",
                    help="only the phases whose ranks span cards (K1-K4 on the last card, "
                         "the ring kernels, the sharded, data-parallel, PCA-mesh, block-ALS "
                         "and 2-D ALS fits, the worlds of processes); prints no ok line")
    ap.add_argument("--block-stream", action="store_true",
                    help="only the build and the streamed block ALS phase (on four cards "
                         "when the machine has four); prints no ok line")
    ap.add_argument("--mp", action="store_true",
                    help="only the build and the phases across processes (the worlds of "
                         "--mesh with it); prints no ok line")
    args = ap.parse_args(argv)
    if not args.rehearse and not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        dev = resolve_device("cpu" if args.rehearse else "cuda")
        cfg = TINY if args.rehearse else FULL
        smi = phase_build(dev) if dev.type == "cuda" else None
        if args.block_stream:
            als_cfg = ALS_TINY if args.rehearse else ALS_FULL
            phase_block_stream(als_cfg, als_data(als_cfg), dev)
            print(f"block_stream passed: {smi}", flush=True)
            return 0
        if args.mp:
            mp = phase_mp(dev, args.mesh, args.rehearse)
            emit("mp_launches", mp_launches(mp))
            print(f"mp phases passed: {smi}", flush=True)
            return 0
        if args.mesh:
            phase_last_card(dev)
            phase_ring_kernels(RING_TINY if args.rehearse else RING_FULL, dev,
                               10 if dev.type == "cuda" else 1)
            phase_sharded_fit(SHARDED_TINY if args.rehearse else SHARDED_FULL, dev)
            phase_dp_fit(DP_TINY if args.rehearse else DP_FULL, dev)
            phase_pca_mesh_fit(PCA_TINY if args.rehearse else PCA_FULL, dev)
            als_cfg = ALS_TINY if args.rehearse else ALS_FULL
            als_data_ = als_data(als_cfg)
            phase_als_block_fit(als_cfg, als_data_, dev, None)
            phase_als_block_2d(als_cfg, als_data_, dev)
            phase_block_stream(als_cfg, als_data_, dev)
            del als_data_
            mp = phase_mp(dev, True, args.rehearse)
            emit("mp_launches", mp_launches(mp))
            print(f"mesh phases passed on {torch.cuda.device_count() if dev.type == 'cuda' else 0}"
                  f" cards: {smi}", flush=True)
            return 0
        phase_small(dev)
        phase_small_slices(dev)
        ladder = phase_ladder(LADDER_TINY if args.rehearse else LADDER_FULL, dev)
        x, w, c = blobs(cfg["n"], cfg["d"], cfg["k"], dev, seed=0)
        reps = 10 if dev.type == "cuda" else 1
        variants = phase_kernels(x, w, c, dev, reps)
        breakdown = ({mode: kernel_breakdown(x, w, c, dev, mode) for mode in ("highest", "default")}
                     if dev.type == "cuda" else {})
        del w, c
        last_card = phase_last_card(dev)
        max_iter = 20 if dev.type == "cuda" else 5
        fit = phase_fit(x, dev, cfg, max_iter)
        phase_loop_parity(x, dev, cfg, max_iter)
        del x
        pca_cfg = PCA_TINY if args.rehearse else PCA_FULL
        als_cfg = ALS_TINY if args.rehearse else ALS_FULL
        pca_vars = phase_pca_kernels(pca_cfg, dev, reps)
        pca_fit = phase_pca_fit(pca_cfg, dev)
        pca_rand = phase_pca_randomized(pca_cfg, dev, smi)
        data = als_data(als_cfg)
        solves, grams = phase_als_kernels(als_cfg, data, dev, 2 * reps)
        als_fit, als_model = phase_als_fit(als_cfg, data, dev)
        als_block = phase_als_block_fit(als_cfg, data, dev, als_model)
        rate = pinned_h2d_rate(dev)
        stream_als = phase_stream_als(als_cfg, data, dev, als_model, rate)
        block_2d = phase_als_block_2d(als_cfg, data, dev)
        del als_model
        block_stream = phase_block_stream(als_cfg, data, dev)
        del data
        stream_km, host, streamed_model = phase_stream_kmeans(
            STREAM_TINY if args.rehearse else STREAM_FULL, dev)
        route = phase_stream_route(STREAM_TINY if args.rehearse else STREAM_FULL, host,
                                   streamed_model, dev)
        del host, streamed_model
        stream_pca = phase_stream_pca(STREAM_PCA_TINY if args.rehearse else STREAM_PCA_FULL,
                                      dev, rate)
        sparse = phase_sparse_input(SPARSE_TINY if args.rehearse else SPARSE_FULL, dev)
        ring_cfg = RING_TINY if args.rehearse else RING_FULL
        rings = phase_ring_kernels(ring_cfg, dev, reps)
        sharded = phase_sharded_fit(SHARDED_TINY if args.rehearse else SHARDED_FULL, dev)
        dp = phase_dp_fit(DP_TINY if args.rehearse else DP_FULL, dev)
        pca_mesh = phase_pca_mesh_fit(pca_cfg, dev)
        mp = phase_mp(dev, False, args.rehearse)
    except Failed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    main_v = next(v for v in variants if v["mode"] == "highest" and not v["need_cost"])
    entries = [{
        "name": kmeans_kernel.KERNEL, "route": "cuda",
        "source": "oap_mllib_tpu_torch/csrc/kmeans_accumulate.cu",
        "replaces": REPLACES,
        "launches": fit["launches"][kmeans_kernel.KERNEL],
        "max_abs_err": main_v["max_abs_err"], "ms": main_v["ms"],
        "plain_ms": main_v["plain_ms"], "bound_ms": main_v["bound_ms"],
        "bound_by": main_v["bound_by"], "library_ms": main_v["library_ms"],
        "library_call": "torch.matmul(x, c.T): the cross product only",
        "assign_route": main_v["route"],
        "shape": cfg, "variants": variants, "breakdown_ms": breakdown,
        "last_card": last_card,
    }]
    # each kernel's headline: the variant its path's fit runs most
    headline = [
        (pca_kernel.KERNEL, "pca_moments.cu", PCA_REPLACES, pca_fit["launches"],
         next(v for v in pca_vars if v["pass"] == "gram" and v["mode"] == "highest"),
         pca_vars, {"n": pca_cfg["shapes"][0][0], "d": pca_cfg["shapes"][0][1],
                    "pass": "gram", "mode": "highest"}),
        (als_kernel.SOLVE, "als_solve.cu", SOLVE_REPLACES, als_fit["launches"],
         next(v for v in solves if v["r"] == als_cfg["rank"] and v["gram"]),
         solves, {"n": als_cfg["n_users"], "r": als_cfg["rank"], "gram": True}),
        (als_kernel.GRAM, "als_factor_gram.cu", GRAM_REPLACES, als_fit["launches"],
         next(v for v in grams if v["r"] == als_cfg["rank"]),
         grams, {"n": als_cfg["n_users"], "r": als_cfg["rank"], "mode": "highest"}),
    ]
    for name, src, replaces, launches, v, all_v, shape in headline:
        entries.append({
            "name": name, "route": "cuda", "source": f"oap_mllib_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": v["max_abs_err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": v["library_ms"], "library_call": v["library_call"],
            "shape": shape, "variants": all_v,
        })
    # the ring at the shape, world and layout the sharded fit gives it
    main_ring = next(v for v in rings if v["shape"] == list(ring_cfg["shapes"][0])
                     and v["world"] == SHARDED_FULL["data"] and v["segments"] == 1)
    entries.append({
        "name": ring_kernel.KERNEL, "route": "cuda",
        "source": "oap_mllib_tpu_torch/csrc/ring_reduce.cu", "replaces": RING_REPLACES,
        "launches": sharded["launches"][ring_kernel.KERNEL],
        "max_abs_err": main_ring["max_abs_err"], "ms": main_ring["ms"],
        "plain_ms": main_ring["plain_ms"], "bound_ms": main_ring["bound_ms"],
        "bound_by": main_ring["bound_by"], "library_ms": main_ring["library_ms"],
        "library_call": main_ring["library_call"],
        "shape": {"rows": main_ring["shape"][0], "cols": main_ring["shape"][1],
                  "world": main_ring["world"], "segments": 1,
                  "layout": main_ring["layout"]},
        "variants": rings,
        # across processes (IPC): the main ring of world "a" at the
        # sharded fit's shape, and every shape's
        "cross_process": next(v for v in mp["a"][0]["mp_ring"]
                              if v["shape"] == list(ring_cfg["shapes"][0])),
        "cross_process_variants": mp["a"][0]["mp_ring"],
        # across processes at the sheets the streamed passes packed
        "cross_process_stream_sheets": mp["a"][0]["mp_stream"]["ring_sheets"],
    })
    # every path's launches of each kernel, from the runs above
    by_path = {
        kmeans_kernel.KERNEL: {"fit": fit["launches"][kmeans_kernel.KERNEL],
                               "dp_fit": dp["launches"][kmeans_kernel.KERNEL],
                               "sharded_fit": sharded["launches"][kmeans_kernel.KERNEL],
                               "stream_kmeans loop":
                                   stream_km["loop"]["launches"][kmeans_kernel.KERNEL],
                               "stream_kmeans fit":
                                   stream_km["fit"]["launches"][kmeans_kernel.KERNEL],
                               "stream_route": route["launches"][kmeans_kernel.KERNEL],
                               "sparse_input (two fits)":
                                   sparse["launches"][kmeans_kernel.KERNEL],
                               **{f"ladder {leg}": ladder[leg]["launches"][kmeans_kernel.KERNEL]
                                  for leg in ("a_transient", "b_halving", "c_spill",
                                              "d_precision", "f_exhausted")}},
        pca_kernel.KERNEL: {"pca_fit": pca_fit["launches"][pca_kernel.KERNEL],
                            **{f"pca_mesh_fit {v['mesh']['data']}x{v['mesh']['model']}":
                               v["launches"][pca_kernel.KERNEL] for v in pca_mesh},
                            "stream_pca": stream_pca["f32"]["launches"][pca_kernel.KERNEL],
                            "stream_pca bf16": stream_pca["bf16"]["launches"][pca_kernel.KERNEL],
                            "sparse_input (two fits)": sparse["launches"][pca_kernel.KERNEL],
                            **{f"pca_randomized {v}": pca_rand[v]["launches"][pca_kernel.KERNEL]
                               for v in ("eigh", "randomized")}},
        als_kernel.SOLVE: {"als_fit": als_fit["launches"][als_kernel.SOLVE],
                           "als_block_fit": als_block["launches"][als_kernel.SOLVE],
                           "stream_als": stream_als["launches"][als_kernel.SOLVE],
                           "als_block_2d": block_2d["launches"][als_kernel.SOLVE],
                           **{f"block_stream r{v['rank']} {v['item_layout']}":
                              v["launches"][als_kernel.SOLVE] for v in block_stream},
                           "ladder g_als": ladder["g_als"]["launches"][als_kernel.SOLVE]},
        als_kernel.GRAM: {"als_fit": als_fit["launches"][als_kernel.GRAM],
                          "als_block_fit": als_block["launches"][als_kernel.GRAM],
                          "stream_als": stream_als["launches"][als_kernel.GRAM],
                          "als_block_2d": block_2d["launches"][als_kernel.GRAM],
                          **{f"block_stream r{v['rank']} {v['item_layout']}":
                             v["launches"][als_kernel.GRAM] for v in block_stream},
                          "ladder g_als": ladder["g_als"]["launches"][als_kernel.GRAM]},
        ring_kernel.KERNEL: {"sharded_fit": sharded["launches"][ring_kernel.KERNEL],
                             "dp_fit": dp["launches"][ring_kernel.KERNEL]},
    }
    for name, paths in mp_launches(mp).items():
        by_path[name].update(paths)
    for entry in entries:
        entry["launches_by_path"] = by_path[entry["name"]]
    if args.rehearse:
        # host-clock numbers of the plain versions: no device metric
        print("rehearsal passed (CPU, plain versions; times are host times)")
        return 0
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
