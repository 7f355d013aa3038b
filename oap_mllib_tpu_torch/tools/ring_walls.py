"""Times of K5 across processes (``ring_kernel.ring_allreduce_groups`` on
the card) in any checkout of the port, for A/B runs in one call.

    python oap_mllib_tpu_torch/tools/ring_walls.py --root DIR [--procs N]
        [--layout one-card|cards] [--reps R] [--fit]

starts a ``torch.distributed`` world (gloo on 127.0.0.1, the store held
by this process) of ``--procs`` processes that import the package from
``--root`` (a checkout; unpack the parent with ``git archive`` into a
git-ignored directory), one ring member a process, every process on
card 0 (``one-card``) or process r on card r (``cards``).  At each sheet
(the ring shapes of ``chip_smoke.py``'s ``mp_ring`` and the streamed
passes' ``(P, 128500)``, ``(P, 128501)``, ``(P, 64)``, ``(P, 8192)``) it
checks the kernel's result bit-equal to the plain version across
processes, then times, in ms a call: the kernel (three loops of
``--reps`` calls, each after a barrier and ending in a synchronise), the
plain version, the gloo host path (``process_allgather`` of the parts,
their sum, the copy back to the card) and a bare gloo ``all_gather`` of
the part's bytes; with the checkout's ``ring_kernel.IPC_STATS`` per call
(the host's waits, and the card's where the checkout counts them).
``--fit`` also runs the model-sharded K-Means on (2, 2) across two
processes of two ranks (2^20 x 256, k = 1000, 20 iterations from a
random start) and prints its Lloyd loop, K5's seconds and a digest of
its centers.  Prints ``RING_WALL`` JSON lines (process 0's, with the
slowest process's kernel time) and the card's name and power limit.
Needs the card; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

RING_SHAPES = [(1000, 130), (13, 37), (65536, 256)]
SHEET_COLS = [128500, 128501, 64, 8192]


def _fit(rank: int, nproc: int, layout: str) -> dict:
    """The model-sharded K-Means on (2, 2): two ranks a process."""
    import torch

    from oap_mllib_tpu_torch import KMeans, set_config
    from oap_mllib_tpu_torch.ops.cuda import ring_kernel

    n, d, k = 1 << 20, 256, 1000
    first = torch.device(f"cuda:{2 * rank if layout == 'cards' else 0}")
    true = torch.randn((k, d), generator=torch.Generator(device=first).manual_seed(0),
                       device=first) * 2.0
    g = torch.Generator(device=first).manual_seed(1000 + rank)
    lab = torch.randint(0, k, (n // nproc,), generator=g, device=first)
    x = true[lab] + torch.randn((n // nproc, d), generator=g, device=first)
    set_config(model_parallel=2)
    ring_kernel.reset_launches()
    ring_kernel.reset_ipc_stats()
    t0 = time.perf_counter()
    m = KMeans(k=k, max_iter=20, tol=1e-4, seed=0, init_mode="random").fit(x)
    wall = time.perf_counter() - t0
    return {"kind": "fit_2x2", "wall_s": wall,
            "lloyd_loop_s": m.summary.timings.as_dict()["lloyd_loop"],
            "num_iter": m.summary.num_iter, "k5_launches": dict(ring_kernel.LAUNCHES),
            "ipc_s": dict(ring_kernel.IPC_STATS),
            "centers_sha256": hashlib.sha256(m.cluster_centers_.tobytes()).hexdigest()[:16]}


def _worker(rank: int, nproc: int, port: int, root: str, layout: str, reps: int,
            mode: str) -> int:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.distributed as dist

    from oap_mllib_tpu_torch import set_config
    from oap_mllib_tpu_torch.ops.cuda import ring_kernel
    from oap_mllib_tpu_torch.parallel import bootstrap, collective

    per = 2 if mode == "fit" else 1
    devs = [f"cuda:{per * rank + j if layout == 'cards' else 0}" for j in range(per)]
    set_config(device=",".join(devs), collective_timeout=600.0)
    bootstrap.initialize_distributed(f"127.0.0.1:{port}", nproc, rank, launcher_store=True)
    device = torch.device(devs[0])
    if mode == "fit":
        rec = {"rank": rank, "root": root, "layout": layout, **_fit(rank, nproc, layout)}
        print("RING_WALL " + json.dumps(rec), flush=True)
        bootstrap.shutdown()
        return 0
    groups, owner = [list(range(nproc))], (lambda m: m)

    def timed(fn, n):
        fn()
        torch.cuda.synchronize(device)
        collective.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3 / n

    shapes = [("ring", s) for s in RING_SHAPES] + [("sheet", (nproc, c)) for c in SHEET_COLS]
    for kind, (rows, cols) in shapes:
        g = torch.Generator()
        g.manual_seed(rows * cols + 7 * rank)
        part = (torch.randn((rows, cols), generator=g) * 10.0).to(device)
        mine = {rank: part}
        got = ring_kernel.ring_allreduce_groups(mine, groups, owner)[rank]
        plain = ring_kernel.ring_allreduce_groups_plain(mine, groups, owner)[rank]
        torch.cuda.synchronize(device)
        if not torch.equal(got, plain):
            print(f"FAIL {rows}x{cols}: the kernel differs from the plain version", flush=True)
            return 1
        ring_ms, stats = [], []
        for _ in range(3):
            ring_kernel.reset_ipc_stats()
            ring_ms.append(timed(lambda: ring_kernel.ring_allreduce_groups(mine, groups, owner),
                                 reps))
            st = dict(ring_kernel.IPC_STATS)
            calls = max(1, st["calls"])
            stats.append({k: 1e3 * v / calls for k, v in st.items() if k.endswith("_s")})
        host = part.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        views = list(torch.empty((nproc, host.numel()), dtype=torch.uint8).unbind(0))
        small = max(1, reps // 2)
        rec = {
            "kind": kind, "shape": [rows, cols], "processes": nproc, "layout": layout,
            "rank": rank, "root": root, "ring_ms": ring_ms,
            "ipc_ms_per_call": stats,
            "plain_ms": timed(lambda: ring_kernel.ring_allreduce_groups_plain(
                mine, groups, owner), max(1, reps // 4)),
            "gloo_host_ms": timed(lambda: torch.as_tensor(collective.process_allgather(
                [part])[0].sum(axis=0)).to(device), small),
            "gloo_bare_ms": timed(lambda: dist.all_gather(views, host), small),
            "payload_mb": rows * cols * 4 / 1e6}
        slowest = collective.process_allgather([np.asarray(ring_ms, np.float64)])[0]
        rec["ring_ms_slowest_process"] = slowest.max(axis=0).tolist()
        if rank == 0:
            print("RING_WALL " + json.dumps(rec), flush=True)
    bootstrap.shutdown()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--worker"]:
        r, n, port, root, layout, reps, mode = argv[1:8]
        return _worker(int(r), int(n), int(port), root, layout, int(reps), mode)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--layout", choices=("one-card", "cards"), default="one-card")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--timeout-s", type=float, default=600.0)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"nvidia-smi: {smi[0] if smi else 'not read'}", flush=True)
    root = str(Path(args.root).resolve())
    rc = _world(root, args.procs, args.layout, args.reps, "sheets", args.timeout_s)
    if args.fit and rc == 0:
        rc = _world(root, 2, args.layout, args.reps, "fit", args.timeout_s)
    return rc


def _world(root: str, procs: int, layout: str, reps: int, mode: str, timeout_s: float) -> int:
    """One world of ``procs`` workers of ``root``'s package; their
    RING_WALL lines and the tail of any other output."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, procs, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    env = {**os.environ, "PYTHONPATH": root}
    workers = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r),
                                 str(procs), str(store.port), root, layout, str(reps), mode],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                env=env) for r in range(procs)]
    rc, t0 = 0, time.perf_counter()
    try:
        for r, p in enumerate(workers):
            text = p.communicate(timeout=max(1.0, timeout_s - (time.perf_counter() - t0)))[0]
            for line in text.splitlines():
                print(line if line.startswith("RING_WALL ") else f"[{r}] {line}", flush=True)
            rc = rc or p.returncode
    finally:
        for p in workers:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    print(f"ring_walls {mode}: {root} exit {rc} in {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
