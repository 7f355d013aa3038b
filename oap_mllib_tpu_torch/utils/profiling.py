"""Profiler traces of the port's fits (the JAX package's
``utils/profiling.py`` on ``torch.profiler``).

``trace(log_dir)`` runs ``torch.profiler.profile`` over the block with
CPU activities and, when a card is present, CUDA activities (the
kernels' device time, through CUPTI), and on exit writes a Chrome trace
``trace-<pid>-<n>.json`` into ``log_dir``.  ``Config.profile_dir``
traces every fit (:func:`maybe_trace`, wrapped round each fit attempt
as the JAX package wraps its fits).  While a trace is live each span of
the fit (telemetry/spans.enter) opens ``torch.profiler.record_function``
of its name, so the phases and the kernels line up in the trace
(``chrome://tracing`` or Perfetto): the hand-written kernels appear
under their CUDA names (``kmeans_accumulate``..., see README).

A profiler that fails to start or to write raises: a trace that was
asked for is never skipped in silence.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading

from oap_mllib_tpu_torch.config import get_config

log = logging.getLogger("oap_mllib_tpu_torch")

# live trace nesting depth: the one bool the span layer checks before
# opening a record_function
_active = 0
_lock = threading.Lock()
_files = itertools.count()
# the Chrome traces written by this process, oldest first
WRITTEN = []


def trace_active() -> bool:
    return _active > 0


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; write its Chrome trace into
    ``log_dir`` on exit.  A trace nested in a live one adds nothing (one
    profiler a process): the outer trace covers it."""
    global _active
    import torch

    if _active:
        with _lock:
            _active += 1
        try:
            yield
        finally:
            with _lock:
                _active -= 1
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_files)}.json")
    log.info("profiler trace -> %s", path)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    with _lock:
        _active += 1
    try:
        yield
    finally:
        with _lock:
            _active -= 1
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        WRITTEN.append(path)


@contextlib.contextmanager
def maybe_trace():
    """Trace the block when ``Config.profile_dir`` is set; else nothing."""
    log_dir = get_config().profile_dir
    if not log_dir:
        yield
        return
    with trace(log_dir):
        yield


def annotate(name: str):
    """A named range inside a live trace (``record_function``)."""
    import torch

    return torch.profiler.record_function(name)
