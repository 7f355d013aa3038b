"""Chunk prefetch for the streamed passes: host staging and the
host-to-device copy of chunk N+1 overlap the kernel of chunk N (the JAX
package's ``data/prefetch.py``, rebuilt on CUDA streams).

A :class:`Prefetcher` walks ``items`` (a source's chunks, group offsets,
...) and hands each to ``stage``, a host function.  With a ``device``,
``stage`` returns ``(host, arrays)``: ``host`` rides along unchanged and
``arrays`` (torch CPU tensors) are copied to the device, so the consumer
receives ``(host, device_tensors)``.  Without one the consumer receives
``stage(item)`` (or the item).

On a card, the upload of one item:

1. takes the next of ``depth + 1`` slots of pinned host buffers, first
   waiting on the slot's event: a pinned buffer is refilled only once
   its previous host-to-device copy has finished;
2. copies the arrays into the slot's pinned buffers (a host ``memcpy``),
   issues ``non_blocking`` copies to fresh device tensors on a side CUDA
   stream and records the slot's event there;
3. hands the item over; the consumer's current stream waits on the
   event (``wait_event``, no host wait) before its kernels read the
   tensors, and ``record_stream`` marks them used on that stream, so the
   caching allocator does not hand their memory out again while a
   kernel still reads it.

On the CPU the upload is the identity (``torch.as_tensor``, no copy).

Depth: at ``Config.prefetch_depth`` >= 2 a background thread stages up
to ``depth`` items ahead of the consumer (a semaphore slot is taken
before each pull from the source and given back when the consumer
moves past the item); depth 1 is the serial loop, no thread.  Order and
values do not depend on the depth.  The producer thread sets the device
and enters the side stream itself (torch's current device and stream
are per thread).  An error in the producer (the source, ``stage``, the
upload) reaches the consumer at its next pull, where it is raised; the
pipeline never drops to the serial loop on its own.  ``close()`` (or
leaving the ``with`` block) cancels the producer, drains what it staged
and joins the thread.  The error raised is the producer's own
exception, its class unchanged, so the resilience ladder classifies it;
the producer has ended by then.  Every stage call is the
``prefetch.stage`` fault site (utils/faults.py).

:class:`PrefetchStats` keeps the stage / transfer / wait split of a pass
and :meth:`PrefetchStats.finalize` writes it into a ``Timings`` under
the JAX package's names: ``<phase>/stage`` (host staging, transfer
excluded), ``<phase>/transfer`` (the pinned copy and the copy issue),
``<phase>/compute`` (pass wall minus the consumer's wait) and
``<phase>/stream_wall``.  Every finalized pass also adds its staged
bytes and rows to :data:`STAGED`, the process totals the route planner
calibrates against (utils/membudget.record_plan).
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from oap_mllib_tpu_torch.utils.faults import maybe_fault

from oap_mllib_tpu_torch.config import get_config
from oap_mllib_tpu_torch.utils.timing import tick

log = logging.getLogger("oap_mllib_tpu_torch")

# process totals of the finalized passes: bytes staged to a device and
# their (padded) rows, read by utils/membudget's calibration
STAGED = {"bytes": 0, "rows": 0}
_staged_lock = threading.Lock()

# seconds the consumer waits for the producer thread to end at close
JOIN_TIMEOUT_S = 5.0


def resolve_depth(depth: Optional[int] = None) -> int:
    """The prefetch depth: ``depth`` if given, else ``Config.prefetch_depth``
    (env ``OAP_MLLIB_TPU_PREFETCH_DEPTH``); it must be >= 1."""
    d = int(get_config().prefetch_depth if depth is None else depth)
    if d < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {d}")
    return d


def staged_totals() -> tuple:
    """``(bytes, rows)`` staged by every finalized pass so far."""
    with _staged_lock:
        return STAGED["bytes"], STAGED["rows"]


class PrefetchStats:
    """The split of one pipeline (or of several, added up):

    - ``stage_s``: host seconds in staging (``stage`` and the upload);
    - ``transfer_s``: the part of it in :meth:`transfer` (the pinned
      copies and the copy issue; the copy itself runs on the side
      stream, overlapped);
    - ``wait_s``: seconds the consumer waited for a staged item (at
      depth 1 all of ``stage_s``);
    - ``chunks``: items that reached the consumer;
    - ``bytes_staged`` / ``rows``: bytes uploaded and the rows of each
      item's first 2-D array;
    - ``leaked_threads``: producers that did not end within
      :data:`JOIN_TIMEOUT_S` of ``close`` (a wedged source).
    """

    __slots__ = ("stage_s", "transfer_s", "wait_s", "chunks", "bytes_staged", "rows",
                 "leaked_threads")

    def __init__(self) -> None:
        self.stage_s = 0.0
        self.transfer_s = 0.0
        self.wait_s = 0.0
        self.chunks = 0
        self.bytes_staged = 0
        self.rows = 0
        self.leaked_threads = 0

    @contextlib.contextmanager
    def transfer(self):
        elapsed = tick()
        try:
            yield
        finally:
            self.transfer_s += elapsed()

    def note_staged(self, arrays) -> None:
        for a in arrays:
            self.bytes_staged += a.numel() * a.element_size()
        first = next((a for a in arrays if a.dim() >= 2), None)
        if first is not None:
            self.rows += int(first.shape[0])

    def finalize(self, timings, prefix: str, wall: float) -> None:
        """Add this pipeline's split to ``timings`` under ``prefix`` (a
        ``Timings``, or None) and its staged bytes to :data:`STAGED`."""
        with _staged_lock:
            STAGED["bytes"] += self.bytes_staged
            STAGED["rows"] += self.rows
        if timings is None:
            return
        timings.add(prefix + "/stage", max(self.stage_s - self.transfer_s, 0.0))
        timings.add(prefix + "/transfer", self.transfer_s)
        timings.add(prefix + "/compute", max(wall - self.wait_s, 0.0))
        timings.add(prefix + "/stream_wall", wall)


def _as_host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


class _Uploader:
    """Copies each item's arrays to ``device`` through ``slots`` rings of
    pinned buffers on a side stream (module docstring).  Used by the
    producer thread only (or inline at depth 1)."""

    def __init__(self, device: torch.device, slots: int, stats: PrefetchStats):
        self.device = device
        self.stats = stats
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._slots: List[Optional[list]] = [None] * slots
        self._events = [None] * slots
        self._next = 0

    def _pinned(self, k: int, arrays) -> list:
        """Slot ``k``'s pinned buffers, made (or remade) for ``arrays``'
        shapes and types."""
        bufs = self._slots[k]
        if bufs is None or [(b.shape, b.dtype) for b in bufs] != [(a.shape, a.dtype) for a in arrays]:
            bufs = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in arrays]
            self._slots[k] = bufs
        return bufs

    def __call__(self, arrays) -> tuple:
        """``(device tensors, ready event or None)``."""
        arrays = [_as_host_tensor(a) for a in arrays]
        self.stats.note_staged(arrays)
        if not self.cuda:
            return tuple(arrays), None
        k = self._next
        self._next = (k + 1) % len(self._slots)
        if self._events[k] is not None:
            # the slot's pinned buffers may be refilled only once their
            # last copy to the device has finished
            self._events[k].synchronize()
        with self.stats.transfer():
            bufs = self._pinned(k, arrays)
            for b, a in zip(bufs, arrays):
                b.copy_(a)
            with torch.cuda.stream(self.stream):
                out = tuple(b.to(self.device, non_blocking=True) for b in bufs)
                ev = torch.cuda.Event()
                ev.record(self.stream)
        self._events[k] = ev
        return out, ev


def _hand_over(staged, device: Optional[torch.device]):
    """The consumer's side of an upload: its stream waits on the copy
    and the tensors are marked used on that stream."""
    host, arrays, ev = staged
    if ev is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ev)
        for t in arrays:
            t.record_stream(stream)
    return host, arrays


class _Sentinel:
    __slots__ = ("err",)

    def __init__(self, err: Optional[BaseException]):
        self.err = err


class _ClosableSource:
    """An iterator the consumer can end from its side: after ``close`` the
    next pull stops, so a producer that wakes late reads nothing more."""

    __slots__ = ("_it", "_closed")

    def __init__(self, it: Iterator):
        self._it = it
        self._closed = False

    def close(self) -> None:
        self._closed = True

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        return next(self._it)


class _Serial:
    """Depth 1: stage inline, on demand, no thread."""

    def __init__(self, items: Iterator, staged: Callable, stats: PrefetchStats):
        self._items = items
        self._staged = staged
        self._stats = stats

    def __next__(self):
        elapsed = tick()
        out = self._staged(next(self._items))  # StopIteration propagates
        dt = elapsed()
        self._stats.stage_s += dt
        self._stats.wait_s += dt
        self._stats.chunks += 1
        return out

    def close(self) -> None:
        pass


class _Threaded:
    """Depth >= 2: a producer thread stages up to ``depth`` items ahead."""

    def __init__(self, items: Iterator, staged: Callable, depth: int, stats: PrefetchStats,
                 device: Optional[torch.device]):
        self._items = _ClosableSource(items)
        self._staged = staged
        self._stats = stats
        self._device = device
        self._slots = threading.Semaphore(depth)
        self._q: queue.Queue = queue.Queue()
        self._cancel = threading.Event()
        self._holding = False
        self._done = False
        self._thread = threading.Thread(target=self._produce, name="oap-mllib-tpu-torch-prefetch",
                                        daemon=True)
        self._thread.start()

    def _acquire_slot(self) -> bool:
        while not self._slots.acquire(timeout=0.05):
            if self._cancel.is_set():
                return False
        return not self._cancel.is_set()

    def _produce(self) -> None:
        try:
            if self._device is not None and self._device.type == "cuda":
                # current device and stream are per thread: this one's own
                torch.cuda.set_device(self._device)
            while True:
                if not self._acquire_slot():
                    return
                try:
                    item = next(self._items)
                except StopIteration:
                    self._q.put(_Sentinel(None))
                    return
                elapsed = tick()
                out = self._staged(item)
                self._stats.stage_s += elapsed()
                self._q.put(out)
        except BaseException as e:  # noqa: BLE001 -- carried to the consumer and raised there
            self._q.put(_Sentinel(e))

    def _join(self, where: str) -> None:
        self._thread.join(timeout=JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            self._stats.leaked_threads += 1
            self._items.close()
            log.warning("prefetch producer did not end within %.1f s at %s; its "
                        "source is closed", JOIN_TIMEOUT_S, where)

    def __next__(self):
        if self._done:
            raise StopIteration
        if self._holding:
            self._holding = False
            self._slots.release()
        elapsed = tick()
        out = self._q.get()
        self._stats.wait_s += elapsed()
        if isinstance(out, _Sentinel):
            self._done = True
            self._join("the end of the stream")
            if out.err is not None:
                raise out.err
            raise StopIteration
        self._stats.chunks += 1
        self._holding = True
        return out

    def close(self) -> None:
        self._cancel.set()
        self._items.close()
        try:  # wake a producer blocked on its semaphore
            while True:
                self._q.get_nowait()
                self._slots.release()
        except queue.Empty:
            pass
        self._join("close()")
        self._done = True


class Prefetcher:
    """Iterate the staged items of ``items`` with up to ``depth`` of them
    staged ahead (module docstring).  Use it as a context manager, so an
    early exit or an error in the consumer ends the producer::

        with Prefetcher(source, stage, device=dev, stats=stats) as pf:
            for host, (x, w) in pf:
                ...launch the kernel on x, w...
    """

    def __init__(self, items: Iterable, stage: Optional[Callable[[Any], Any]] = None,
                 device: Optional[torch.device] = None, depth: Optional[int] = None,
                 stats: Optional[PrefetchStats] = None):
        self.stats = PrefetchStats() if stats is None else stats
        self.depth = resolve_depth(depth)
        self.device = None if device is None else torch.device(device)
        upload = (None if self.device is None
                  else _Uploader(self.device, self.depth + 1, self.stats))

        def staged(item):
            # every stage call, a stageless pipeline's too, is the
            # prefetch.stage fault site (utils/faults.py)
            maybe_fault("prefetch.stage")
            out = item if stage is None else stage(item)
            if upload is None:
                return out
            host, arrays = out
            return (host, *upload(arrays))

        it = iter(items)
        self._impl = (_Serial(it, staged, self.stats) if self.depth == 1
                      else _Threaded(it, staged, self.depth, self.stats, self.device))

    def __iter__(self):
        return self

    def __next__(self):
        out = next(self._impl)
        return out if self.device is None else _hand_over(out, self.device)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self._impl.close()

    def close(self) -> None:
        self._impl.close()
