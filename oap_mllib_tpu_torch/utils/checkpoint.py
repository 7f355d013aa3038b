"""Checkpoints of a fit's iterate state, and resume onto any world: the
port of the JAX package's ``utils/checkpoint.py``.

Every fit route writes its iterate state (K-Means centers, ALS factor
tables, or their rows block by block, PCA's streamed column sums or
in-memory covariance, with the step and the world's layout) every
``Config.checkpoint_interval`` steps, and restores it at its start, so
a fit whose process or card was lost is relaunched and goes on where it
stopped, in the same world or another: block-sharded factor rows are
redistributed through parallel/shuffle.reshard_factor_rows when the
block layout changed.

On-disk layout (one directory per fit identity), the JAX package's byte
for byte::

    <checkpoint_dir>/<algo>-<sig12>/
        manifest.json                  # step, world, layout, signature
        step00000003.rank0.npz         # process 0's shard at step 3
        step00000003.rank1.npz         # ...

``sig12`` hashes the fit's signature dict, which the estimators build
key for key as the JAX package does (``"x64"`` included, from
``Config.enable_x64``), so both packages name the same directory and a
checkpoint written by either restores in the other, on either lane; an
f64 fit's and an f32 fit's signatures differ, so neither consumes the
other's state.  Replicated arrays keep their dtype on disk (float64 on
the x64 lane) and the routes restore them in the fit's dtype.

Write protocol (the torn-write contract):

1. every process writes its ``step<N>.rank<r>.npz`` shard through
   tmp + ``os.replace`` (data/io.atomic_save_npz);
2. the processes agree that every write landed (one small
   ``process_allgather`` in a world of several);
3. process 0 replaces ``manifest.json``, which NAMES the step, and the
   processes agree again: a kill anywhere in 1-3 leaves the previous
   generation valid;
4. each process drops its shards older than the previous generation
   (two generations are kept).

A restore checks the manifest's version and signature and each shard's
embedded step; any failure is a corrupt checkpoint: a fresh fit with a
warning under ``Config.resume="auto"``, :class:`CheckpointError` under
``"require"``; ``"off"`` writes but never reads.  Replicated state
restores onto any world; block-sharded rows are read round-robin from
the old shards and redistributed.

``ckpt.write`` and ``ckpt.restore`` are fault sites (utils/faults.py):
a failed write warns, counts and the fit goes on; a failed restore
takes the corrupt-checkpoint tiers.  :func:`stats` holds the JAX
package's ``oap_checkpoint_*`` counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.data import io as _io
from oap_mllib_tpu_torch.telemetry import flightrec
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import faults
from oap_mllib_tpu_torch.utils.timing import phase_timer, tick

log = logging.getLogger("oap_mllib_tpu_torch")

MANIFEST = "manifest.json"
_VERSION = 1
_KEEP_GENERATIONS = 2
_SHARD_RE = re.compile(r"step(\d{8})\.rank(\d+)\.npz$")

DECISION_FOUND = "found"
DECISION_FRESH = "fresh"
DECISION_RESHARDED = "resharded"

# the newest step this process committed or restored, across every
# Checkpointer: the crash records' "last durable checkpoint step"
# (utils/recovery.py), so a supervisor knows what a relaunch loses
_lock = threading.Lock()
_LAST_DURABLE = {"step": -1}
_STATS = {"writes": 0, "write_failures": 0, "bytes_written": 0, "shards": 0,
          "write_seconds": 0.0, "restores": {}, "restore_seconds": 0.0}


def _note_durable(step: int) -> None:
    with _lock:
        if step > _LAST_DURABLE["step"]:
            _LAST_DURABLE["step"] = int(step)


def last_durable_step() -> int:
    """The newest checkpoint step this process committed or restored
    (-1 when none), stamped into crash records."""
    with _lock:
        return _LAST_DURABLE["step"]


def _count(key: str, value=1) -> None:
    with _lock:
        _STATS[key] += value


def stats() -> Dict[str, Any]:
    """The process's checkpoint counts (the JAX package's
    ``oap_checkpoint_*`` counters): durable writes, failed writes,
    bytes, shard files, write seconds, restores by decision and restore
    seconds."""
    with _lock:
        return {**_STATS, "restores": dict(_STATS["restores"])}


def reset_stats() -> None:
    with _lock:
        _STATS.update(writes=0, write_failures=0, bytes_written=0, shards=0,
                      write_seconds=0.0, restores={}, restore_seconds=0.0)
        _LAST_DURABLE["step"] = -1


class CheckpointError(RuntimeError):
    """A restore that ``Config.resume="require"`` cannot satisfy (no
    checkpoint, a corrupt manifest or shard, a signature mismatch)."""


def resume_cfg(cfg=None) -> str:
    """Validated ``Config.resume``: a typo raises."""
    policy = (cfg or get_config()).resume
    if policy not in ("auto", "require", "off"):
        raise ValueError(f"resume must be auto|require|off, got {policy!r}")
    return policy


def _world() -> Tuple[int, int]:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.world_size(), bootstrap.process_index()


def _sig_hash(signature: Dict[str, Any]) -> str:
    blob = json.dumps(signature, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def fetch_replicated(value) -> np.ndarray:
    """Host copy of replicated state: a tensor, an array, or a
    ``{rank: tensor}`` dict of copies (the first rank's is taken)."""
    if isinstance(value, dict):
        value = value[min(value)]
    return _to_numpy(value)


def local_factor_rows(blocks: Dict[Any, torch.Tensor], mesh, offsets, per: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """``(ids, vals)`` of THIS process's valid rows of a block-sharded
    factor table: each local data rank's block ``b`` gives its rows below
    the block boundary, ``[offsets[b], offsets[b + 1])``, with their
    global ids: the shard a world of another size re-buckets at restore.
    ``blocks`` maps each local data rank to its (per, r) block."""
    from oap_mllib_tpu_torch.ops.als_block import data_ranks

    offsets = np.asarray(offsets)
    ids: List[np.ndarray] = []
    vals: List[np.ndarray] = []
    for b, q in enumerate(data_ranks(mesh)):
        if not mesh.is_local(q):
            continue
        lo, hi = int(offsets[b]), int(offsets[b + 1])
        ids.append(np.arange(lo, hi, dtype=np.int64))
        vals.append(_to_numpy(blocks[q][: hi - lo]))
    r = next(iter(blocks.values())).shape[-1]
    if not ids:
        return np.zeros((0,), np.int64), np.zeros((0, r), np.float32)
    return np.concatenate(ids), np.concatenate(vals).astype(np.float32)


def factors_from_result(res: "RestoreResult", name: str, n_rows: int) -> np.ndarray:
    """The full ``(n_rows, r)`` host table from either storage form:
    replicated (``arrays``) or block-sharded (``sharded``).  One process
    restoring a block world's checkpoint holds every old shard, so the
    assembly is exact; rows no shard carried stay zero, and a grown axis
    pads its tail with zeros (the caller's grown fill seeds them)."""
    if name in res.arrays:
        arr = np.asarray(res.arrays[name], np.float32)
        if arr.ndim == 2 and arr.shape[0] < n_rows:
            arr = np.concatenate([arr, np.zeros((n_rows - arr.shape[0], arr.shape[1]),
                                                np.float32)])
        return arr
    ids, vals = res.sharded[name]
    r = vals.shape[1] if vals.ndim == 2 else 1
    out = np.zeros((n_rows, r), np.float32)
    keep = ids < n_rows
    out[ids[keep]] = vals[keep]
    return out


def replicated_from_result(res: "RestoreResult", name: str, n_rows: int) -> np.ndarray:
    """The full replicated host table from either storage form, in a
    world of several processes too: a block-sharded checkpoint restored
    into a replicated layout gathers every process's loaded rows first
    (each read only its round-robin share of the old shards)."""
    from oap_mllib_tpu_torch.parallel import collective

    if name in res.arrays or _world()[0] == 1:
        return factors_from_result(res, name, n_rows)
    ids, vals = res.sharded[name]
    r = vals.shape[1] if vals.ndim == 2 else 1
    (counts,) = collective.process_allgather([np.asarray([len(ids)], np.int64)])
    n_max = max(1, int(counts.max()))
    pid = np.full((n_max,), -1, np.int64)
    pid[: len(ids)] = ids
    pval = np.zeros((n_max, r), np.float32)
    pval[: len(ids)] = vals
    gid, gval = collective.process_allgather([pid, pval])
    gid, gval = gid.reshape(-1), gval.reshape(-1, r)
    out = np.zeros((n_rows, r), np.float32)
    keep = (gid >= 0) & (gid < n_rows)
    out[gid[keep]] = gval[keep]
    return out


def sharded_rows_from_result(res: "RestoreResult", name: str, world: int, rank: int):
    """``(ids, vals)`` for the resharding pass from either storage form:
    a replicated checkpoint is strided ``rank::world``, so the live
    processes contribute disjoint rows (reshard_factor_rows needs every
    row on exactly one process)."""
    if name in res.sharded:
        return res.sharded[name]
    arr = np.asarray(res.arrays[name], np.float32)
    ids = np.arange(rank, arr.shape[0], world, dtype=np.int64)
    return ids, arr[ids]


@dataclasses.dataclass
class RestoreResult:
    """One restore attempt's outcome; ``decision`` lands in the fit's
    summary (``checkpoint``)."""

    decision: str = DECISION_FRESH
    step: int = 0
    reason: str = ""
    old_world: int = 0
    new_world: int = 0
    arrays: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    sharded: Dict[str, Tuple[np.ndarray, np.ndarray]] = dataclasses.field(default_factory=dict)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    layout: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # growable axes the manifest recorded SMALLER than this fit:
    # signature key -> (old, new); the caller initializes the tail
    grown: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)

    @property
    def found(self) -> bool:
        return self.decision != DECISION_FRESH


class Checkpointer:
    """One fit's checkpoint channel: periodic sharded writes and the
    restore.  Built by :func:`maybe_open` (None when
    ``Config.checkpoint_dir`` is empty).  ``signature`` is the fit's
    identity (algorithm, shapes, seed, solver parameters; not the world
    size, the chunking or the precision policy, which may change across
    a preemption); it names the directory and rides in the manifest, so a
    restore never takes another problem's state.  ``growable`` names
    signature keys that may grow across restores (ALS ``n_users`` /
    ``n_items``): they are left out of the directory hash and checked as
    a prefix at restore."""

    def __init__(self, algo: str, signature: Dict[str, Any], *, cfg=None, timings=None,
                 growable: Tuple[str, ...] = ()):
        cfg = cfg or get_config()
        self.algo = algo
        self.signature = dict(signature)
        self.signature["algo"] = algo
        self.growable = tuple(growable)
        for key in self.growable:
            if key not in self.signature:
                raise ValueError(f"growable axis {key!r} is not a signature key "
                                 f"(have {sorted(self.signature)})")
        self.resume = resume_cfg(cfg)
        self.interval = max(int(cfg.checkpoint_interval), 1)
        dir_sig = dict(self.signature)
        if self.growable:
            for key in self.growable:
                dir_sig.pop(key, None)
            dir_sig["__growable__"] = sorted(self.growable)
        self.dir = os.path.join(cfg.checkpoint_dir, f"{algo}-{_sig_hash(dir_sig)}")
        self.timings = timings
        self.world, self.rank = _world()
        self.writes = 0
        self.bytes_written = 0
        self.write_s = 0.0
        self.last_step = -1
        self._result: Optional[RestoreResult] = None

    # -- write side ---------------------------------------------------------------

    def due(self, step: int) -> bool:
        """True when ``step`` is a checkpoint boundary: callers whose state
        extraction costs a host copy check this first."""
        return step % self.interval == 0

    def maybe_write(self, step: int, arrays: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None,
                    sharded: Optional[Dict[str, tuple]] = None,
                    layout: Optional[Dict[str, Any]] = None, force: bool = False) -> bool:
        """Checkpoint the state at ``step`` when the interval says so (or
        ``force``).  ``arrays`` is replicated state (every process writes
        its copy); ``sharded`` maps a name to THIS process's ``(ids,
        vals)`` rows (:func:`local_factor_rows`); ``extra`` and ``layout``
        are JSON metadata the same on every process.  Never raises: a
        failed write warns and counts, and the fit goes on."""
        if not force and step % self.interval:
            return False
        with self._phase():
            return self._write_guarded(step, arrays, extra or {}, sharded or {}, layout or {})

    def _phase(self):
        if self.timings is None:
            return contextlib.nullcontext()
        return phase_timer(self.timings, "checkpoint")

    def _write_guarded(self, step, arrays, extra, sharded, layout) -> bool:
        elapsed = tick()
        ok, err, nbytes = True, None, 0
        try:
            faults.maybe_fault("ckpt.write")
            nbytes = self._write_shard(step, arrays, sharded)
        except Exception as e:  # noqa: BLE001 - a checkpoint must not kill the fit
            ok, err = False, e
        # agreed on every process BEFORE the manifest flip, on the failure
        # path too: a one-process fault must not desync the collectives
        if not self._sync_ok(ok):
            _count("write_failures")
            _tm.counter("oap_checkpoint_write_failures_total", {"algo": self.algo},
                        help="Checkpoint writes that failed (the fit continued)").inc()
            log.warning("%s: checkpoint write at step %d failed (%s); fit continues "
                        "without this checkpoint", self.algo, step,
                        err if err is not None else "failure on a peer process")
            return False
        flip_ok = True
        if self.rank == 0:
            try:
                self._write_manifest(step, list(arrays), extra, sharded, layout)
            except Exception as e:  # noqa: BLE001
                flip_ok = False
                log.warning("%s: checkpoint manifest flip at step %d failed (%s); the "
                            "previous generation stays live", self.algo, step, e)
        # the flip is the commit point: a failed flip reads as failed on
        # every process
        if not self._sync_ok(flip_ok):
            _count("write_failures")
            _tm.counter("oap_checkpoint_write_failures_total", {"algo": self.algo},
                        help="Checkpoint writes that failed (the fit continued)").inc()
            if self.rank != 0:
                log.warning("%s: checkpoint manifest flip at step %d failed on process 0; "
                            "the previous generation stays live", self.algo, step)
            return False
        self._gc()
        dt = elapsed()
        self.writes += 1
        self.bytes_written += nbytes
        self.write_s += dt
        self.last_step = step
        _note_durable(step)
        _count("writes")
        _count("bytes_written", nbytes)
        _count("shards")
        _count("write_seconds", dt)
        if flightrec.enabled():
            # the commit (the manifest flip every process agreed on) is the
            # event a post-mortem aligns against
            flightrec.record("ckpt_commit", self.algo, f"step={step}")
        _tm.counter("oap_checkpoint_writes_total", {"algo": self.algo},
                    help="Checkpoint shard writes that landed durably").inc()
        _tm.counter("oap_checkpoint_bytes_written_total",
                    help="Bytes written to checkpoint shards").inc(nbytes)
        _tm.counter("oap_checkpoint_shards_total",
                    help="Checkpoint shard files written").inc()
        _tm.counter("oap_checkpoint_write_seconds_total",
                    help="Wall spent writing checkpoints").inc(dt)
        return True

    def _shard_name(self, step: int, rank: int) -> str:
        return f"step{step:08d}.rank{rank}.npz"

    def _write_shard(self, step, arrays, sharded) -> int:
        os.makedirs(self.dir, exist_ok=True)
        payload = {"__step__": np.asarray(step, np.int64)}
        for name, a in arrays.items():
            payload[f"a.{name}"] = _to_numpy(a)
        for name, (ids, vals) in sharded.items():
            payload[f"s.{name}.ids"] = np.asarray(ids, np.int64)
            payload[f"s.{name}.vals"] = np.asarray(_to_numpy(vals), np.float32)
        path = os.path.join(self.dir, self._shard_name(step, self.rank))
        return _io.atomic_save_npz(path, payload)

    def _write_manifest(self, step, array_names, extra, sharded, layout) -> None:
        from oap_mllib_tpu_torch.parallel.bootstrap import world_layout

        # the value width of each sharded table, so a restoring process
        # that reads no old shard (the world grew) builds its empty (0, r)
        # placeholder at the true width: widths taken from local data
        # would differ across processes and hang the restore collectives
        widths = {}
        if isinstance(sharded, dict):
            for name, (_ids, vals) in sharded.items():
                v = np.asarray(_to_numpy(vals))
                widths[name] = int(v.shape[1]) if v.ndim == 2 else 1
        devices = world_layout()["devices"]
        if devices is None:  # one process: the devices its config names
            devices = len(get_config().device.split(","))
        manifest = {
            "version": _VERSION,
            "algo": self.algo,
            "step": int(step),
            "world": self.world,
            "devices": devices,
            "arrays": sorted(array_names),
            "sharded": sorted(sharded),
            "widths": widths,
            "extra": extra,
            "layout": layout,
            "signature": self.signature,
            "growable": list(self.growable),
            "interval": self.interval,
        }
        _io.atomic_write_json(os.path.join(self.dir, MANIFEST), manifest)

    def _sync_ok(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every process (one small allgather, a
        watched host collective, in a world of several)."""
        if self.world == 1:
            return ok
        from oap_mllib_tpu_torch.parallel import collective

        (flags,) = collective.process_allgather([np.asarray([0 if ok else 1], np.int64)])
        return int(flags.sum()) == 0

    def _gc(self) -> None:
        """Drop THIS process's shards beyond the newest two generations
        (best effort).  Process 0 also drops the shards of processes no
        longer in the world (left by a restore onto a smaller world) once
        their generation leaves the kept set."""
        try:
            entries = []
            for f in os.listdir(self.dir):
                m = _SHARD_RE.match(f)
                if m:
                    entries.append((int(m.group(1)), int(m.group(2)), f))
            mine = sorted(f for _step, rank, f in entries if rank == self.rank)
            for f in mine[:-_KEEP_GENERATIONS]:
                os.unlink(os.path.join(self.dir, f))
            if self.rank == 0:
                kept = set(sorted({step for step, _, _ in entries})[-_KEEP_GENERATIONS:])
                for step, rank, f in entries:
                    if rank >= self.world and step not in kept:
                        os.unlink(os.path.join(self.dir, f))
        except OSError:
            pass

    # -- restore side -------------------------------------------------------------

    def restore(self) -> RestoreResult:
        """One restore attempt; the decision (found / fresh / resharded)
        is kept for :meth:`record`.  Follows ``Config.resume`` (module
        docstring)."""
        elapsed = tick()
        with self._phase():
            res = self._restore_guarded()
        self._result = res
        seconds = elapsed()
        with _lock:
            _STATS["restores"][res.decision] = _STATS["restores"].get(res.decision, 0) + 1
            _STATS["restore_seconds"] += seconds
        _tm.counter("oap_checkpoint_restores_total", {"algo": self.algo, "decision": res.decision},
                    help="Checkpoint restore attempts by outcome").inc()
        _tm.counter("oap_checkpoint_restore_seconds_total",
                    help="Wall spent in checkpoint restore attempts").inc(seconds)
        return res

    def _restore_guarded(self) -> RestoreResult:
        if self.resume == "off":
            return RestoreResult(reason="resume=off", new_world=self.world)
        err: Optional[Exception] = None
        res = RestoreResult(new_world=self.world)
        try:
            faults.maybe_fault("ckpt.restore")
            res = self._load()
        except Exception as e:  # noqa: BLE001 - classified below
            err = e
        # the same outcome on every process: one process starting fresh
        # while its peers resume would desync the collectives
        if not self._sync_ok(err is None):
            err = err or CheckpointError(f"{self.algo}: checkpoint restore failed on a "
                                         "peer process")
            res = RestoreResult(new_world=self.world)
        if err is not None:
            if self.resume == "require":
                raise CheckpointError(f"{self.algo}: resume='require' but no usable "
                                      f"checkpoint under {self.dir}: {err}") from err
            if isinstance(err, FileNotFoundError):
                res.reason = "no checkpoint found"
            else:
                res.reason = f"corrupt checkpoint: {err}"
                log.warning("%s: falling back to a fresh fit (%s)", self.algo, res.reason)
        return res

    def _load(self) -> RestoreResult:
        mpath = os.path.join(self.dir, MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(f"no checkpoint manifest at {mpath}")
        manifest = _io.read_json(mpath)
        if manifest.get("version") != _VERSION:
            raise CheckpointError(f"manifest version {manifest.get('version')!r} != {_VERSION}")
        grown = self._check_signature(manifest)
        step = int(manifest["step"])
        old_world = int(manifest["world"])
        decision = DECISION_FOUND if old_world == self.world else DECISION_RESHARDED
        # replicated arrays: the old process aligned with this one (any
        # shard carries them)
        rep_shard = self._load_shard(step, self.rank % old_world)
        arrays = {name: rep_shard[f"a.{name}"] for name in manifest["arrays"]}
        # sharded state: the old shard files round-robin over the NEW
        # world, so every old row is read once; the caller redistributes
        sharded: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        if manifest["sharded"]:
            widths = {n: int(w) for n, w in dict(manifest.get("widths", {})).items()}
            per_name: Dict[str, Tuple[list, list]] = {n: ([], []) for n in manifest["sharded"]}
            for old_rank in range(old_world):
                if old_rank % self.world != self.rank:
                    continue
                shard = (rep_shard if old_rank == self.rank % old_world
                         else self._load_shard(step, old_rank))
                for name in manifest["sharded"]:
                    per_name[name][0].append(shard[f"s.{name}.ids"])
                    per_name[name][1].append(shard[f"s.{name}.vals"])
            for name, (ids, vals) in per_name.items():
                # a process that read no old shard still joins the restore
                # collectives, at the manifest's width
                sharded[name] = (
                    np.concatenate(ids) if ids else np.zeros((0,), np.int64),
                    np.concatenate(vals) if vals else np.zeros((0, widths.get(name, 1)),
                                                               np.float32))
        self.last_step = step
        _note_durable(step)
        return RestoreResult(decision=decision, step=step, old_world=old_world,
                             new_world=self.world, arrays=arrays, sharded=sharded,
                             extra=dict(manifest.get("extra", {})),
                             layout=dict(manifest.get("layout", {})), grown=grown)

    def _check_signature(self, manifest) -> Dict[str, Tuple[int, int]]:
        """The fit-identity check: every non-growable key matches the
        manifest; a growable key may be LARGER here (the growth is
        returned, (old, new) per axis).  A shrunk axis or a changed
        growable declaration raises."""
        man_sig = manifest.get("signature")
        if not self.growable:
            if man_sig != self.signature:
                raise CheckpointError("checkpoint signature mismatch (different problem): "
                                      f"manifest {man_sig!r} vs fit {self.signature!r}")
            return {}
        man_growable = list(manifest.get("growable", []))
        if man_growable != list(self.growable):
            raise CheckpointError(
                "checkpoint growable-axis declaration mismatch (reordered or changed "
                f"axes): manifest declares {man_growable!r}, fit declares "
                f"{list(self.growable)!r}")
        if not isinstance(man_sig, dict):
            raise CheckpointError("checkpoint signature mismatch (different problem): "
                                  f"manifest {man_sig!r} vs fit {self.signature!r}")
        fixed_man = {k: v for k, v in man_sig.items() if k not in self.growable}
        fixed_fit = {k: v for k, v in self.signature.items() if k not in self.growable}
        if fixed_man != fixed_fit:
            raise CheckpointError("checkpoint signature mismatch (different problem): "
                                  f"manifest {fixed_man!r} vs fit {fixed_fit!r}")
        grown: Dict[str, Tuple[int, int]] = {}
        for key in self.growable:
            old, new = int(man_sig.get(key, -1)), int(self.signature[key])
            if old == new:
                continue
            if old > new:
                raise CheckpointError(
                    f"checkpoint axis {key!r} shrank: manifest has {old}, fit has {new} "
                    "— restored rows beyond the new extent would be silently dropped; "
                    "refit from scratch (or restore into an axis >= the manifest's)")
            grown[key] = (old, new)
        return grown

    def _load_shard(self, step: int, rank: int) -> Dict[str, np.ndarray]:
        path = os.path.join(self.dir, self._shard_name(step, rank))
        shard = _io.load_npz(path)
        got = int(shard.get("__step__", np.asarray(-1)))
        if got != step:
            raise CheckpointError(f"shard {path} records step {got}, manifest says {step}")
        return shard

    def mark_resharded(self) -> None:
        """Upgrade a same-world restore to ``resharded`` when the caller
        redistributed the state anyway (the block layout changed)."""
        if self._result is not None and self._result.found:
            self._result.decision = DECISION_RESHARDED

    # -- summary ------------------------------------------------------------------

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "dir": self.dir, "interval": self.interval, "writes": self.writes,
            "bytes_written": self.bytes_written, "write_seconds": round(self.write_s, 6),
            "last_step": self.last_step,
        }
        res = self._result
        if res is not None:
            out["decision"] = res.decision
            out["restored_step"] = res.step
            if res.found:
                out["old_world"] = res.old_world
                out["new_world"] = res.new_world
                if res.grown:
                    out["grown"] = {k: [int(o), int(n)] for k, (o, n) in sorted(res.grown.items())}
            elif res.reason:
                out["reason"] = res.reason
        return out

    def record(self, summary) -> None:
        """The fit's checkpoint accounting and restore decision on its
        summary (a dict key or an attribute)."""
        if summary is None:
            return
        if isinstance(summary, dict):
            summary["checkpoint"] = self.as_dict()
        else:
            summary.checkpoint = self.as_dict()


def maybe_open(algo: str, signature: Dict[str, Any], *, timings=None,
               growable: Tuple[str, ...] = ()) -> Optional[Checkpointer]:
    """The estimators' one entry: None when ``Config.checkpoint_dir`` is
    empty (one string check), else a :class:`Checkpointer` rooted at the
    fit's signature directory."""
    cfg = get_config()
    if not cfg.checkpoint_dir:
        return None
    return Checkpointer(algo, signature, cfg=cfg, timings=timings, growable=growable)
