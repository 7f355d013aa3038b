"""Runtime sanitizers (``Config.sanitizers``): the JAX package's
``utils/sanitizers.py`` on the port's host collectives, CUDA streams and
lazily built kernels.  Off (the default) every seam pays one cached
string check.

- ``collective``: every host collective across processes
  (parallel/collective.py: ``_all_gather_host``, ``all_to_all``,
  ``barrier``, ``agree``) records an (op, axis, shape, dtype) signature
  and cross-checks it with every process BEFORE it dispatches, over one
  gloo all_gather of a fixed 192-byte frame: a process issuing another
  collective than its peers then raises
  :class:`CollectiveDivergenceError` on every process, naming each one's
  op, instead of hanging.  torch dtypes are written by their numpy
  names, so one signature sequence gives one digest in both packages.
  At a fit's end the sequence's digest is checked once more
  (:func:`finalize_fit_sanitizers`), which catches a tail divergence.
- ``transfer``: the streamed passes' consumer bodies run under
  ``torch.cuda.set_sync_debug_mode("error")`` (data/prefetch.py), the
  counterpart of ``jax.transfer_guard("disallow")``: a synchronising
  call in the body (``.item()``, a copy to the host) raises.  The mode
  is process-wide, not per thread: the prefetch producer's pinned,
  non-blocking copies and its event waits do not synchronise the
  stream and pass; the mode is restored on every exit of the body.  The
  audited host reads (the streamed k-means||'s per-chunk reads,
  ops/stream_ops.py) run under :func:`allow_transfers`.  CUDA only: on
  the CPU there is nothing to synchronise and the scope only counts.
- ``retrace``: in the port a "compile" is a build or load of a kernel
  library by the lazy builders (ops/cuda/_build.py, ops/host_prep.py)
  or a miss of the program cache (utils/progcache.py); a streamed pass
  must make none from its second consumed chunk on
  (:class:`RetraceWatch`), and :func:`steady_state` asserts the same
  over a scope.
- ``locks``: arms the tracked locks (utils/locktrace.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.telemetry import metrics as _tm
from oap_mllib_tpu_torch.utils import locktrace

VALID = ("collective", "transfer", "retrace", "locks")

# every process contributes exactly this many bytes to a cross-check,
# whatever its op: the check itself is shape-uniform
_SIG_BYTES = 192


class SanitizerError(RuntimeError):
    """Base class of sanitizer-witnessed violations."""


class CollectiveDivergenceError(SanitizerError):
    """Processes disagreed on the next collective (op, axis, shape, dtype)."""


class RetraceError(SanitizerError):
    """A steady-state loop built or loaded a kernel, or missed the program
    cache, after warmup."""


class LockOrderError(SanitizerError):
    """Two threads took the same two tracked locks in opposite orders
    (raised by utils/locktrace before blocking)."""


_parse_cache: Dict[str, FrozenSet[str]] = {}
# a plain lock (not the tracked sequence lock): the locks sanitizer's
# own arming check comes through here
_parse_lock = threading.Lock()


def enabled_set(cfg=None) -> FrozenSet[str]:
    """The validated set of ``Config.sanitizers``; an unknown name raises
    naming the valid ones."""
    raw = (cfg or get_config()).sanitizers
    hit = _parse_cache.get(raw)
    if hit is not None:
        return hit
    names = frozenset(n.strip() for n in raw.split(",") if n.strip())
    unknown = sorted(names - set(VALID))
    if unknown:
        raise ValueError(
            f"Config.sanitizers names unknown sanitizer(s) {unknown}; "
            f"valid names: {VALID} (comma-separated)"
        )
    with _parse_lock:
        _parse_cache[raw] = names
    return names


def enabled(name: str) -> bool:
    """Whether one sanitizer is armed: one config read and a dict hit."""
    raw = get_config().sanitizers
    if not raw:
        return False
    return name in enabled_set()


# -- collective fingerprints and the cross-check -------------------------------

_lock = locktrace.TrackedLock("sanitizers.seq", threading.Lock())
_SEQ: List[str] = []  # the process's host-collective signatures
_finalized_idx = 0  # start of the current fit's window into _SEQ


def _world() -> int:
    from oap_mllib_tpu_torch.parallel import bootstrap

    return bootstrap.world_size()


def dtype_name(dtype) -> str:
    """A dtype by its numpy name (``torch.float32`` -> ``float32``)."""
    text = str(dtype)
    return text[len("torch."):] if text.startswith("torch.") else text


def _reduced_tag(dtype) -> str:
    # a reduced payload on one process and f32 on another is a policy
    # divergence: the tag puts it in the signature
    return "reduced" if dtype_name(dtype) in ("bfloat16", "float16") else "full"


def _signature(op: str, axis: str, shape, dtype) -> str:
    return f"{op}|{axis}|{tuple(shape)}|{dtype}"


def _gather_frames(frame: bytes) -> List[bytes]:
    """One fixed-size frame from every process, in process order.  The
    payload has one shape on every process whatever its op, so this
    gather pairs even when the ops diverge."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from oap_mllib_tpu_torch.utils import recovery

    buf = np.zeros((_SIG_BYTES,), np.uint8)
    raw = frame[:_SIG_BYTES]
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    mine = torch.from_numpy(buf)
    out = torch.empty((_world(), _SIG_BYTES), dtype=torch.uint8)
    # the cross-check is a host collective too: a peer that died before
    # its check must not wedge this one
    recovery.guarded_dispatch("sanitizer.crosscheck", "host",
                              lambda: dist.all_gather(list(out.unbind(0)), mine))
    return [bytes(row.numpy()).rstrip(b"\x00") for row in out]


def _raise_divergence(kind: str, mine: str, frames: List[bytes]) -> None:
    from oap_mllib_tpu_torch.parallel import bootstrap
    from oap_mllib_tpu_torch.telemetry import flightrec

    me = bootstrap.process_index()
    peers = []
    first_bad = None
    for r, f in enumerate(frames):
        sig = f.decode("utf-8", "replace")
        peers.append(f"  rank {r}: {sig}")
        if first_bad is None and sig != mine:
            first_bad = (r, sig)
    _tm.counter(
        "oap_sanitizer_violations_total", {"sanitizer": "collective"},
        help="Sanitizer-witnessed invariant violations",
    ).inc()
    assert first_bad is not None
    recorder_note = ""
    if flightrec.enabled():
        recorder_note = (
            f"  Flight recorder: first diverging event on this rank is seq "
            f"{flightrec.last_seq()} (the peers' tails ride their crash records).\n"
        )
    raise CollectiveDivergenceError(
        f"collective sanitizer: rank-divergent {kind} — rank {me} is "
        f"dispatching [{mine}] but rank {first_bad[0]} is dispatching "
        f"[{first_bad[1]}]; every process must issue the same collective "
        "sequence.\n" + recorder_note + "Full world view:\n" + "\n".join(peers)
    )


def note_collective(op: str, axis: str, shape, dtype, crosscheck: bool = True) -> None:
    """Record one host collective's signature and, in a world of several
    processes, cross-check it with every process BEFORE the dispatch.
    A no-op unless ``collective`` is armed."""
    if not enabled("collective"):
        return
    name = dtype_name(dtype)
    sig = _signature(op, axis, shape, f"{name}:{_reduced_tag(name)}")
    with _lock:
        _SEQ.append(sig)
    _tm.counter(
        "oap_sanitizer_collective_ops_total",
        help="Host-level collective dispatches fingerprinted by the "
             "collective sanitizer",
    ).inc()
    if crosscheck and _world() > 1:
        frames = _gather_frames(b"op:" + sig.encode())
        mine = "op:" + sig
        if any(f.decode("utf-8", "replace") != mine for f in frames):
            _raise_divergence("collective", mine, frames)


def fingerprint(since: Optional[int] = None) -> Tuple[int, str]:
    """(op count, hex digest) of the recorded signatures from ``since``
    (default: the current fit's window) to now."""
    with _lock:
        start = _finalized_idx if since is None else since
        window = _SEQ[start:]
    h = hashlib.sha256()
    for sig in window:
        h.update(sig.encode())
        h.update(b"\x00")
    return len(window), h.hexdigest()[:16]


def finalize_fit_sanitizers(summary) -> None:
    """At a fit's end (telemetry/export.finalize_fit): put the armed set
    and the fit's collective fingerprint in ``summary["sanitizers"]`` (an
    attribute on object summaries), cross-check the fingerprint across
    processes, and start the next fit's window."""
    global _finalized_idx
    cfg = get_config()
    if not cfg.sanitizers:
        return
    armed = enabled_set(cfg)
    payload: Dict[str, object] = {"enabled": sorted(armed)}
    if "collective" in armed:
        count, digest = fingerprint()
        with _lock:
            _finalized_idx = len(_SEQ)
        checked = False
        if _world() > 1:
            frame = f"fit:{count}:{digest}".encode()
            frames = _gather_frames(frame)
            mine = frame.decode()
            if any(f.decode("utf-8", "replace") != mine for f in frames):
                _raise_divergence("fit collective fingerprint (op count:digest)", mine, frames)
            checked = True
        payload["collective"] = {"ops": count, "fingerprint": digest, "world_checked": checked}
    if "locks" in armed:
        payload["locks"] = locktrace.summary_block()
    if summary is not None:
        if isinstance(summary, dict):
            summary["sanitizers"] = payload
        else:
            summary.sanitizers = payload


# -- transfer ------------------------------------------------------------------


@contextlib.contextmanager
def transfer_scope(device=None):
    """``torch.cuda.set_sync_debug_mode("error")`` over a streamed
    consumer body on a CUDA ``device``, the previous mode restored on
    every exit; on another device it only counts.  The caller checks
    :func:`enabled`."""
    _tm.counter(
        "oap_sanitizer_transfer_scopes_total",
        help="Per-chunk consumer bodies guarded by the transfer sanitizer",
    ).inc()
    if device is None or getattr(device, "type", str(device)) != "cuda":
        yield
        return
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def allow_transfers():
    """The audited way out inside a guarded body: a designed host read
    runs with the sync debug mode off, restored after.  A no-op when the
    sanitizer is off or no card is present."""
    if not enabled("transfer"):
        yield
        return
    import torch

    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# -- retrace -------------------------------------------------------------------


def _compile_count() -> int:
    from oap_mllib_tpu_torch.utils import progcache

    return progcache.xla_compile_count() + progcache.stats()["misses"]


class RetraceWatch:
    """No build, load or program-cache miss after warmup in a chunk loop:
    armed after the first consumed chunk, checked at every later chunk
    boundary."""

    __slots__ = ("label", "_base")

    def __init__(self, label: str):
        self.label = label
        self._base: Optional[int] = None

    def chunk_done(self, index: int) -> None:
        """Called after the consumer finished chunk ``index`` (0-based)."""
        if index == 0:
            self._base = _compile_count()
            return
        if self._base is None:
            return
        now = _compile_count()
        if now > self._base:
            _tm.counter(
                "oap_sanitizer_violations_total", {"sanitizer": "retrace"},
                help="Sanitizer-witnessed invariant violations",
            ).inc()
            raise RetraceError(
                f"retrace sanitizer: {now - self._base} new kernel build(s), load(s) "
                f"or program-cache miss(es) after warmup in steady-state loop "
                f"'{self.label}' (chunk {index}); steady-state chunks must reuse the "
                "pass's kernels and programs (utils/progcache)"
            )


@contextlib.contextmanager
def steady_state(label: str):
    """Assert a scope builds, loads and misses nothing; a no-op unless
    ``retrace`` is armed (warm the shapes up outside the scope)."""
    if not enabled("retrace"):
        yield
        return
    base = _compile_count()
    yield
    delta = _compile_count() - base
    if delta > 0:
        _tm.counter(
            "oap_sanitizer_violations_total", {"sanitizer": "retrace"},
            help="Sanitizer-witnessed invariant violations",
        ).inc()
        raise RetraceError(
            f"retrace sanitizer: {delta} new kernel build(s), load(s) or program-cache "
            f"miss(es) inside steady-state scope '{label}'; warm up the exact shapes first"
        )


def _reset_for_tests() -> None:
    """Drop the recorded sequence and the fit window (test isolation)."""
    global _finalized_idx
    # the inner lock: a reset must work under a typo'd sanitizer set,
    # whose validation would raise at the tracked seam
    with _lock._inner:
        _SEQ.clear()
        _finalized_idx = 0
    with _parse_lock:
        _parse_cache.clear()
    locktrace._reset_for_tests()
