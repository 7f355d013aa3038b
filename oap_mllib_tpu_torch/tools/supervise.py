"""Supervised relaunch of a world of the port's workers: the recovery
loop end to end (the counterpart of the JAX package's ``dev/supervise.py``,
with its flags).

Run as ``python -m oap_mllib_tpu_torch.tools.supervise``.  One module,
two roles:

- **Supervisor** (default): a world of ``--procs`` worker processes
  (each ``--worker RANK WORLD COORD`` of this module) with the recovery
  plane armed (the crash sideband, collective deadlines, ``resume=auto``
  checkpoints), run under the restart budget by
  ``utils/supervisor.Supervisor``: classify, relaunch, shrink.  Prints
  each final worker's ``RESULT`` line and ``SUPERVISOR <json>`` (the
  run's summary); exits 1 when the budget ran out.
- **Worker**: one process of the world.  It joins the rendezvous (world
  > 1), streams its share of a seeded K-Means table with checkpoints
  armed on ``Config.device`` (env ``OAP_MLLIB_TPU_DEVICE``: ``cuda`` by
  default, ``cpu`` for the plain versions) and prints ``RESULT <json>``
  (cost, the centers' bytes, the checkpoint decision, the ladder).
  Drill hooks through the environment: ``SUPERVISE_KILL_RANK`` /
  ``SUPERVISE_KILL_WALK`` (that process SIGKILLs itself while reading the
  given walk of its source; only on attempt 0 under
  ``SUPERVISE_KILL_SCOPE=first``, on every attempt with several
  processes under ``multi``) and ``OAP_MLLIB_TPU_CHAOS``.

Examples::

    # two processes, process 1 killed once mid-fit, resumed
    OAP_MLLIB_TPU_DEVICE=cpu python -m oap_mllib_tpu_torch.tools.supervise \\
        --procs 2 --checkpoint-dir /tmp/ck --crash-dir /tmp/crash --kill-rank 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS, D, K, MAX_ITER, CHUNK = 3000, 8, 4, 6, 500
DATA_SEED = 321


def _worker(rank: int, world: int, coord: str) -> int:
    """One process: a streamed K-Means over its share, checkpoints
    armed, the recovery plane live.  Exit codes: 0 = RESULT printed,
    17 = a recovery abort (its crash record written), 3 = another
    error."""
    import numpy as np

    from oap_mllib_tpu_torch.data.stream import ChunkSource
    from oap_mllib_tpu_torch.models.kmeans import KMeans
    from oap_mllib_tpu_torch.parallel import bootstrap
    from oap_mllib_tpu_torch.utils import recovery

    if world > 1:
        bootstrap.initialize_distributed(coord, world, rank)
    # one table over the world, each process a contiguous share: a
    # shrunken world resumes over the same rows
    rng = np.random.default_rng(int(os.environ.get("SUPERVISE_DATA_SEED", str(DATA_SEED))))
    x = rng.normal(size=(ROWS, D)).astype(np.float32)
    per = ROWS // world
    shard = x[rank * per: ROWS if rank == world - 1 else (rank + 1) * per]

    kill_rank = int(os.environ.get("SUPERVISE_KILL_RANK", "-1"))
    kill_walk = int(os.environ.get("SUPERVISE_KILL_WALK", "4"))
    kill_scope = os.environ.get("SUPERVISE_KILL_SCOPE", "first")
    attempt = int(os.environ.get("SUPERVISE_ATTEMPT", "0"))
    arm_kill = rank == kill_rank and (attempt == 0 if kill_scope == "first" else world > 1)
    walks = {"n": 0}

    def gen():
        # walk 1 is the random init's reservoir pass, Lloyd passes are 2+
        walks["n"] += 1
        if arm_kill and walks["n"] == kill_walk:
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        for lo in range(0, shard.shape[0], CHUNK):
            yield shard[lo: lo + CHUNK]

    src = ChunkSource(gen, D, CHUNK, n_rows=shard.shape[0])
    try:
        m = KMeans(k=K, seed=7, init_mode="random", max_iter=MAX_ITER, tol=0.0).fit(src)
    except recovery.RecoveryError as e:
        print(f"RECOVERY_ABORT rank={rank} {type(e).__name__}: {e}", flush=True)
        recovery.exit_now(17)
    except Exception as e:  # noqa: BLE001 -- the worker's boundary
        print(f"WORKER_ERROR rank={rank} {type(e).__name__}: {e}", flush=True)
        recovery.exit_now(3)
    ck = getattr(m.summary, "checkpoint", None) or {}
    print("RESULT " + json.dumps({
        "rank": rank,
        "world": world,
        "cost": float(m.summary.training_cost),
        "centers_hex": np.ascontiguousarray(m.cluster_centers_).tobytes().hex(),
        "decision": ck.get("decision"),
        "restored_step": ck.get("restored_step"),
        "ladder": m.summary.resilience["ladder"],
    }), flush=True)
    bootstrap.shutdown()
    return 0


def supervise(procs: int, checkpoint_dir: str, crash_dir: str, *, chaos: str = "",
              budget: int = 3, backoff: float = 0.2, shrink_after: int = 2,
              collective_timeout: float = 15.0, kill_rank: int = -1, kill_walk: int = 4,
              kill_scope: str = "first", attempt_timeout: float = 300.0):
    """Supervise one K-Means world to its end; returns ``(summary,
    Supervisor)``."""
    from oap_mllib_tpu_torch.utils.supervisor import Supervisor

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OAP_MLLIB_TPU_CHECKPOINT_DIR"] = checkpoint_dir
    if collective_timeout:
        env["OAP_MLLIB_TPU_COLLECTIVE_TIMEOUT"] = str(collective_timeout)
    if kill_rank >= 0:
        env["SUPERVISE_KILL_RANK"] = str(kill_rank)
        env["SUPERVISE_KILL_WALK"] = str(kill_walk)
        env["SUPERVISE_KILL_SCOPE"] = kill_scope

    def build_argv(rank, world, coord, attempt):
        return [sys.executable, "-m", "oap_mllib_tpu_torch.tools.supervise",
                "--worker", str(rank), str(world), coord]

    sup = Supervisor(build_argv, procs, crash_dir, env=env, chaos=chaos,
                     restart_budget=budget, restart_backoff=backoff,
                     shrink_after=shrink_after, attempt_timeout=attempt_timeout,
                     grace_s=max(10.0, 2 * collective_timeout))
    return sup.run(), sup


def _supervise(args) -> int:
    summary, _ = supervise(
        args.procs, args.checkpoint_dir, args.crash_dir, chaos=args.chaos,
        budget=args.budget, backoff=args.backoff, shrink_after=args.shrink_after,
        collective_timeout=args.collective_timeout, kill_rank=args.kill_rank,
        kill_walk=args.kill_walk, kill_scope=args.kill_scope,
        attempt_timeout=args.attempt_timeout)
    for out in summary["outputs"]:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                print(line, flush=True)
    print("SUPERVISOR " + json.dumps({k: v for k, v in summary.items() if k != "outputs"}),
          flush=True)
    return 0 if summary["ok"] else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        return _worker(int(argv[1]), int(argv[2]), argv[3])
    ap = argparse.ArgumentParser(
        prog="python -m oap_mllib_tpu_torch.tools.supervise",
        description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--crash-dir", required=True)
    ap.add_argument("--chaos", default="", help="base chaos spec (seed re-seeded +attempt)")
    ap.add_argument("--budget", type=int, default=3)
    ap.add_argument("--backoff", type=float, default=0.2)
    ap.add_argument("--shrink-after", type=int, default=2)
    ap.add_argument("--collective-timeout", type=float, default=15.0)
    ap.add_argument("--kill-rank", type=int, default=-1)
    ap.add_argument("--kill-walk", type=int, default=4)
    ap.add_argument("--kill-scope", choices=("first", "multi"), default="first")
    ap.add_argument("--attempt-timeout", type=float, default=300.0)
    return _supervise(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
