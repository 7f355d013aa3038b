"""Supervised relaunch, the restart half of the recovery loop: the port
of the JAX package's ``utils/supervisor.py``.

utils/recovery.py turns a dead peer into a prompt, machine-readable exit
on every process (the watcher, gloo's mapped errors and the crash-record
sideband); utils/checkpoint.py makes the lost work resumable.  A
:class:`Supervisor` launches the world's processes, watches them,
**classifies** the exit (crash records, exit codes, signals), and
relaunches under a restart budget with exponential backoff, shrinking
the world by one when the same process keeps failing
(``Config.shrink_after`` consecutive times).  Relaunched worlds run with
``Config.resume="auto"``: a same-world resume is a bit-equal
continuation, a smaller world redistributes the factor rows through
parallel/shuffle.reshard_factor_rows.

This module imports neither torch nor JAX and never joins the world: it
spawns and reaps plain subprocesses and reads JSON from the sideband,
so it outlives whatever the workers do to themselves, a SIGKILL in a
collective included.

Exit classification, per process:

==================  ========================================================
classification      meaning
==================  ========================================================
``ok``              exit code 0, no crash record
``killed``          died on a signal (negative return code), no record: a
                    preemption
``collective_timeout``  its own deadline expired waiting for a peer (a
                    victim)
``peer_abort``      a peer's record appeared or its connection closed
                    (a victim)
<fault class>       the record's class (transient, oom, nonfinite,
                    unclassified) for a process that faulted itself
``error``           nonzero exit, no record, no signal
==================  ========================================================

The *culprit* of a failed attempt is its first non-victim failure; when
every failure is a victim, the first process killed by a signal, then
the first failure.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.utils import recovery

log = logging.getLogger("oap_mllib_tpu_torch")

_VICTIM_CLASSES = (recovery.FAULT_TIMEOUT, recovery.FAULT_PEER_ABORT)
BALANCE_HINT = "balance.hint.json"
SCALE_HINT = "serve.scale.hint.json"


class SupervisorError(RuntimeError):
    """The restart budget ran out before a world completed."""


@dataclasses.dataclass
class RankExit:
    """One process's exit from one attempt."""

    rank: int
    returncode: Optional[int]
    classification: str
    record: Optional[Dict[str, Any]] = None
    output: str = ""

    @property
    def ok(self) -> bool:
        return self.classification == "ok"

    @property
    def victim(self) -> bool:
        return self.classification in _VICTIM_CLASSES

    def as_dict(self) -> Dict[str, Any]:
        out = {"rank": self.rank, "returncode": self.returncode,
               "classification": self.classification}
        if self.record is not None:
            out["record"] = {k: self.record.get(k)
                             for k in ("fault_class", "site", "op", "last_checkpoint_step")}
        return out


@dataclasses.dataclass
class Attempt:
    """One launched world: its size, each process's exit, the outcome."""

    index: int
    world: int
    exits: List[RankExit] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return bool(self.exits) and all(e.ok for e in self.exits)

    def culprit(self) -> Optional[int]:
        """The process to blame for a failed attempt (None when ok)."""
        if self.ok:
            return None
        bad = [e for e in self.exits if not e.ok]
        for e in bad:  # a failure of its own names itself
            if not e.victim:
                return e.rank
        for e in bad:  # all victims: blame a signal death
            if e.returncode is not None and e.returncode < 0:
                return e.rank
        return bad[0].rank if bad else None

    def as_dict(self) -> Dict[str, Any]:
        return {"index": self.index, "world": self.world, "ok": self.ok,
                "culprit": self.culprit(), "exits": [e.as_dict() for e in self.exits]}


def _read_and_remove(path: str):
    """A JSON hint file's content (None when absent or torn), removed:
    one hint sizes one relaunch."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            hint = json.load(f)
    except (OSError, ValueError):
        hint = None
    try:
        os.remove(path)
    except OSError:
        pass
    return hint


class Supervisor:
    """Launch, watch, classify, relaunch or shrink, under a budget.

    ``build_argv(rank, world, coord, attempt)`` returns one process's
    argv (``coord`` is a fresh ``host:port`` per attempt, the port the
    kernel's: a dead world's port may still hold TIME_WAIT sockets).
    Every worker's environment gets:

    - ``OAP_MLLIB_TPU_CRASH_DIR``: the sideband (stale records are
      cleared between attempts);
    - ``OAP_MLLIB_TPU_RESUME=auto``: a relaunch resumes the last durable
      checkpoint (callers set ``OAP_MLLIB_TPU_CHECKPOINT_DIR`` in
      ``env``);
    - ``OAP_MLLIB_TPU_CHAOS``: a given ``chaos`` spec with its seed moved
      ``+attempt``, so a kill schedule does not kill the resumed world at
      the same point;
    - ``SUPERVISE_ATTEMPT``: the attempt index;
    - ``OAP_MLLIB_TPU_PROBE_EPOCH``: the attempt index as the probe
      generation, so a relaunched process measures its capability again.

    Restart policy: at most ``restart_budget`` relaunches, backoff
    ``restart_backoff * 2^(n-1)`` s before relaunch n; ``shrink_after``
    consecutive failures blamed on one process shrink the world by one
    (never below 1).
    """

    def __init__(self, build_argv: Callable[[int, int, str, int], List[str]], world: int,
                 crash_dir: str, *, env: Optional[Dict[str, str]] = None,
                 restart_budget: Optional[int] = None,
                 restart_backoff: Optional[float] = None, shrink_after: Optional[int] = None,
                 chaos: str = "", attempt_timeout: float = 600.0, grace_s: float = 30.0,
                 poll_s: float = 0.2, coord_host: str = "127.0.0.1"):
        cfg = get_config()
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.build_argv = build_argv
        self.world = world
        self.crash_dir = crash_dir
        self.env = dict(env or os.environ)
        self.restart_budget = int(cfg.restart_budget if restart_budget is None
                                  else restart_budget)
        self.restart_backoff = float(cfg.restart_backoff if restart_backoff is None
                                     else restart_backoff)
        self.shrink_after = int(cfg.shrink_after if shrink_after is None else shrink_after)
        if self.restart_budget < 0 or self.restart_backoff < 0:
            raise ValueError("restart_budget and restart_backoff must be >= 0, got "
                             f"{self.restart_budget}/{self.restart_backoff}")
        if self.shrink_after < 1:
            raise ValueError(f"shrink_after must be >= 1, got {self.shrink_after}")
        self.chaos = chaos
        self.attempt_timeout = attempt_timeout
        self.grace_s = grace_s
        self.poll_s = poll_s
        self.coord_host = coord_host
        self.attempts: List[Attempt] = []
        self.relaunches = 0
        self.shrinks = 0
        self.recovery_s: List[float] = []
        self.balance_hints: List[Dict[str, Any]] = []
        self.scale_hints: List[Dict[str, Any]] = []
        self.drain_reports: List[Dict[str, Any]] = []
        self._blame_rank: Optional[int] = None
        self._blame_count = 0

    # -- the world's life ---------------------------------------------------------

    def _coord(self) -> str:
        """A rendezvous on a port the kernel assigns: supervisors started
        together on one host (and a dead world's TIME_WAIT sockets) never
        meet on it, where the JAX package scans from 4000."""
        with socket.socket() as s:
            s.bind((self.coord_host, 0))
            return f"{self.coord_host}:{s.getsockname()[1]}"

    def _worker_env(self, attempt: int) -> Dict[str, str]:
        env = dict(self.env)
        env["OAP_MLLIB_TPU_CRASH_DIR"] = self.crash_dir
        env["OAP_MLLIB_TPU_RESUME"] = "auto"
        env["SUPERVISE_ATTEMPT"] = str(attempt)
        env["OAP_MLLIB_TPU_PROBE_EPOCH"] = str(attempt)
        if self.chaos:
            from oap_mllib_tpu_torch.utils.faults import parse_chaos

            base = parse_chaos(self.chaos)
            if base is not None:
                parts = self.chaos.split(":")
                parts[0] = str(base.seed + attempt)
                env["OAP_MLLIB_TPU_CHAOS"] = ":".join(parts)
        return env

    def _launch(self, attempt: int, world: int):
        os.makedirs(self.crash_dir, exist_ok=True)
        recovery.clear_crash_records(self.crash_dir)
        coord = self._coord()
        env = self._worker_env(attempt)
        return [subprocess.Popen(self.build_argv(rank, world, coord, attempt),
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                 env=env)
                for rank in range(world)]

    def _reap(self, procs) -> List[str]:
        """Wait out the grace window for the survivors of a failure, then
        SIGKILL stragglers (a process whose watched thread is stuck in
        gloo among them); each process's captured output."""
        deadline = time.monotonic() + self.grace_s
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            time.sleep(self.poll_s)
        outs = []
        for p in procs:
            if p.poll() is None:
                p.kill()
            try:
                out, _ = p.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                out = ""
            outs.append(out or "")
        return outs

    def _watch(self, procs) -> bool:
        """Block until the world completes (True: every process exited 0
        in time) or fails (False: the first nonzero exit, or the attempt
        timeout), leaving survivors to :meth:`_reap`."""
        deadline = time.monotonic() + self.attempt_timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if any(c is not None and c != 0 for c in codes):
                return False
            if all(c == 0 for c in codes):
                return True
            time.sleep(self.poll_s)
        return False

    # -- classification -----------------------------------------------------------

    def _classify(self, attempt: int, world: int, procs, outs: List[str]) -> Attempt:
        att = Attempt(index=attempt, world=world)
        for rank, (p, out) in enumerate(zip(procs, outs)):
            code = p.poll()
            record = None
            path = recovery.crash_record_path(self.crash_dir, rank)
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        record = json.load(f)
                except (OSError, ValueError):  # a torn record
                    record = {"rank": rank}
            if code == 0 and record is None:
                cls = "ok"
            elif record is not None and record.get("fault_class"):
                cls = str(record["fault_class"])
            elif code is not None and code < 0:
                cls = "killed"
            else:
                cls = "error"
            att.exits.append(RankExit(rank=rank, returncode=code, classification=cls,
                                      record=record, output=out))
        return att

    def _read_balance_hint(self) -> Optional[Dict[str, Any]]:
        """The straggler controller's persistent-offender hint
        (parallel/balance.HINT_FILENAME), read and removed."""
        hint = _read_and_remove(os.path.join(self.crash_dir, BALANCE_HINT))
        return hint if isinstance(hint, dict) else None

    def _read_scale_hint(self) -> Optional[Dict[str, Any]]:
        """A serving scale decision ("out" / "in"), read and removed."""
        hint = _read_and_remove(os.path.join(self.crash_dir, SCALE_HINT))
        if not isinstance(hint, dict) or hint.get("action") not in ("out", "in"):
            return None
        return hint

    def _read_drain_reports(self) -> List[Dict[str, Any]]:
        """Graceful-drain reports (``serve.drain.done.rank<r>.json``),
        read and removed."""
        try:
            names = sorted(os.listdir(self.crash_dir))
        except OSError:
            return []
        reports = []
        for name in names:
            if name.startswith("serve.drain.done.rank") and name.endswith(".json"):
                rep = _read_and_remove(os.path.join(self.crash_dir, name))
                if isinstance(rep, dict):
                    reports.append(rep)
        return reports

    # -- the supervision loop -----------------------------------------------------

    def run(self) -> Dict[str, Any]:
        """Supervise until a world completes or the budget runs out; the
        summary (``ok``, ``attempts``, ``relaunches``, ``shrinks``,
        ``final_world``, ``recovery_s`` the detection-to-respawn walls,
        ``outputs`` the last attempt's per-process output).  The relaunch
        counts and walls also land in utils/recovery.stats()."""
        world = self.world
        attempt = 0
        while True:
            log.info("supervisor: attempt %d, world %d", attempt, world)
            procs = self._launch(attempt, world)
            clean = self._watch(procs)
            t_detect = time.monotonic()
            outs = self._reap(procs)
            att = self._classify(attempt, world, procs, outs)
            self.attempts.append(att)
            hint = self._read_balance_hint()
            if hint is not None:
                self.balance_hints.append(hint)
                log.warning("supervisor: balance hint: process %s was a persistent straggler "
                            "(skew %s over %s passes)", hint.get("rank"),
                            hint.get("skew_ratio"), hint.get("streak_passes"))
            scale_hint = self._read_scale_hint()
            if scale_hint is not None:
                self.scale_hints.append(scale_hint)
            self.drain_reports.extend(self._read_drain_reports())
            if att.ok and clean:
                return self._summary(True, world, outs)
            culprit = att.culprit()
            log.warning("supervisor: attempt %d failed (world %d, culprit process %s): %s",
                        attempt, world, culprit,
                        [e.as_dict() for e in att.exits if not e.ok])
            if self.relaunches >= self.restart_budget:
                log.error("supervisor: restart budget (%d) exhausted", self.restart_budget)
                return self._summary(False, world, outs)
            if culprit == self._blame_rank:
                self._blame_count += 1
            else:
                self._blame_rank, self._blame_count = culprit, 1
            # a balance hint naming the culprit is one more vote: the
            # controller saw the process drag the world before it died
            if (hint is not None and culprit is not None
                    and int(hint.get("rank", -1)) == culprit):
                self._blame_count += 1
            if self._blame_count >= self.shrink_after and world > 1 and culprit is not None:
                world -= 1
                self.shrinks += 1
                self._blame_rank, self._blame_count = None, 0
                recovery._bump("world_shrinks")
                log.warning("supervisor: process %s failed %d consecutive times; shrinking "
                            "the world to %d (resume=auto reshards the state)",
                            culprit, self.shrink_after, world)
            if scale_hint is not None:
                # never above the world first provisioned, never below 1
                want = world + (1 if scale_hint["action"] == "out" else -1)
                world = max(1, min(want, self.world))
            self.relaunches += 1
            recovery._bump("relaunches")
            recovery._bump("restart_budget_spent")
            backoff = self.restart_backoff * (2.0 ** (self.relaunches - 1))
            if backoff > 0:
                time.sleep(backoff)
            attempt += 1
            wall = time.monotonic() - t_detect
            self.recovery_s.append(wall)
            recovery.note_recovery(wall)

    def _summary(self, ok: bool, world: int, outs: List[str]) -> Dict[str, Any]:
        return {
            "ok": ok, "final_world": world, "relaunches": self.relaunches,
            "restart_budget": self.restart_budget, "shrinks": self.shrinks,
            "recovery_s": list(self.recovery_s),
            "balance_hints": list(self.balance_hints), "scale_hints": list(self.scale_hints),
            "drain_reports": list(self.drain_reports),
            "attempts": [a.as_dict() for a in self.attempts], "outputs": list(outs),
        }
