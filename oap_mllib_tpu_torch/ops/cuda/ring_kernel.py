"""Ring allreduce: the port of the JAX package's
``ops/pallas/ring_reduce.py`` (``_make_ring_kernel`` through
``_ring_pallas``, and the entry ``ring_allreduce``).

- :func:`ring_allreduce_plain` is the schedule in plain PyTorch, written
  as the JAX package's ``_ring_dir_ppermute`` writes it: ppermute steps
  (parallel/collective.ppermute) and one fold per rank per step and
  direction.  The CPU tests hold it to the JAX ring bit for bit, and
  ``chip_smoke.py`` holds the kernel to it on the card.
- :func:`ring_allreduce` is the wrapper of the hand-written Hopper kernel
  ``csrc/ring_reduce.cu``.  CPU tensors take the plain version; CUDA
  tensors launch the kernel, one launch per card per ring, or raise.
  There is no fallback from one to the other.

Contract, as in the JAX package: every rank's buffer is a (rows, cols)
f32 tensor; rows pad to a multiple of ``world * segments`` and columns
to an even multiple of 128, so the clockwise half ``[:half]`` and the
counter-clockwise half ``[half:]`` split where JAX splits them; each of
``segments`` row blocks is its own ring.  A reduce-scatter step computes
``cur + recv``, so every rank ends with the same bits.  A world of one
returns its tensor unchanged, through psum.

On the card the schedule runs no steps.  It fixes, for each element, the
order in which the ranks' values are added (:func:`fold_order`, derived
from :func:`launch_plan`), and the kernel folds every element in that
order and writes the sum to every rank's output: the plain ring's bits,
without its padded copies.  Ranks on one card take one launch; across
cards, each card's launch folds its share of the elements and stores
them on every rank.  Each card's launch waits (CUDA events, in the C
entry) until every card's inputs are ready and outputs allocated, and
after the launches every card's stream waits on every other card's, so
work the caller puts on a rank's stream, including the caching
allocator's reuse of its input, comes after the peers' last reads of
it.  The host never synchronises.

Across processes (:func:`ring_allreduce_groups`, a world of several,
parallel/bootstrap.py) the rings' ranks belong to several processes,
each of which calls with its own ranks' buffers.  Each process owns a
symmetric workspace: one ``cudaMalloc``, grown collectively to the
largest call so far and never carved from torch's caching allocator,
whose ``cudaIpcMemHandle_t`` every peer maps once per size
(``cudaIpcMemLazyEnablePeerAccess``; the process's own ranks use its
own pointer, as a handle does not open in the process that made it).
Its first bytes are a signal area (:func:`signal_area`): a "ready" and
a "folded" word for every process of the world, and a status word.  The
processes order themselves on the card, as the TPU kernel does with its
barrier semaphores, and a call makes no host round trip.  On the
workspace card's current stream, with no synchronisation in between, a
process

1. copies its ranks' buffers into its workspace slots;
2. writes this call's epoch (:func:`signal_word`, with an error bit
   when a copy failed) into its "ready" word in every process's area;
3. waits until every "ready" word of its own area holds the epoch;
4. launches the kernel once per ring it holds a rank of, with a table
   of every rank's mapped input and output, folding its share of the
   elements (one share per process of the ring, in ``fold_order``'s
   order) and storing it into every rank's output; the kernel's blocks
   read the "ready" words first and, when one carries the error bit or
   another epoch, fold nothing and set the status word;
5. writes its "folded" word in every area (the error bit when a launch
   failed) and 6. waits for every peer's;
7. copies its ranks' outputs out, and its signal area to the host.

The writes and waits are stream memory operations (``cuStreamWriteValue32``
after a memory barrier, ``cuStreamWaitValue32``; csrc/stream_memops.cuh):
a waiting stream holds no SM, so two processes that share a card by time
slices make progress (tools/ipc_signal_probe.py: a round trip of 12.5
µs on one H100, where a spinning kernel took 4.5 ms, a time slice).
Every process counts the calls alike (they are collective, in one
order), and the count restarts on a new workspace (:func:`next_epoch`).
The host then waits once for the call's last event: it polls for up to
a millisecond, then waits under the recovery plane's watcher
(utils/recovery.guarded_dispatch, op ``ring_allreduce``), which also
ends the wait when a peer's process has ended (:func:`process_alive`):
a dead or silent peer raises ``PeerAbortError`` or
``CollectiveTimeoutError`` within the deadline, and the process's own
waits are released so its stream drains.  It then reads its signal
area: when any process failed (:func:`failed_processes`), every process
raises ``RuntimeError`` naming them (:func:`call_error`, the rule of
``collective.agree``), and the next call makes the workspace anew.
Only the workspace's growth, renewal and release (:func:`_workspace`,
:func:`close_ipc`) are host collectives.  The mappings stay open until
:func:`close_ipc`
(parallel/bootstrap.shutdown).  The plain version across processes is
``collective.process_allgather`` of the parts, then
:func:`ring_allreduce_plain` of each ring on the gathered list: the bits
of the one-process plain ring.  CPU tensors take it, CUDA tensors the
kernel, or raise.
"""

from __future__ import annotations

import ctypes
import os
import time
from collections import OrderedDict
from functools import lru_cache
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from oap_mllib_tpu_torch.ops.cuda._tiers import LABELS, book_launch
from oap_mllib_tpu_torch.parallel import collective

KERNEL = "ring_reduce"

# launches of the CUDA kernel (one per card per ring); the wrapper adds
# one per launch and nowhere else (the plain version counts none)
LAUNCHES = {KERNEL: 0}

LANE = 128  # the column multiple of the JAX ring (two halves of lanes)

_peers_enabled = set()
_lib = None
# device copies of the kernel's table, by (card, stream, contents): the
# caching allocator hands a ring the same buffers call after call, so the
# table repeats and its copy is made once
_tables: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_MAX_TABLES = 64


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


# the autotuner's ``ring`` knob (ops/cuda/autotune.py): row blocks, each
# its own ring; the bound keeps the padding (rows to a multiple of
# world * segments) small
MAX_SEGMENTS = 64


def check_segments(segments) -> int:
    """``segments`` if the schedule takes it (an int in 1 ..
    :data:`MAX_SEGMENTS`), else ValueError, on every device."""
    if isinstance(segments, bool) or not isinstance(segments, (int, np.integer)) \
            or not 1 <= segments <= MAX_SEGMENTS:
        raise ValueError(f"{KERNEL}: segments must be an int in 1..{MAX_SEGMENTS}, "
                         f"got {segments!r}")
    return int(segments)


def padded_shape(rows: int, cols: int, world: int, segments: int = 1):
    """``(rows_pad, cols_pad)`` of the ring's buffers, as the JAX ring
    pads them."""
    rows_pad = _pad_to(max(rows, world * segments), world * segments)
    return rows_pad, _pad_to(max(cols, 2 * LANE), 2 * LANE)


def _check_parts(parts: Sequence[torch.Tensor]) -> None:
    if len(parts) < 1:
        raise ValueError("ring_allreduce needs one tensor per rank, got none")
    shape = parts[0].shape
    for t in parts:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError("ring_allreduce takes 2-D float32 tensors, one per rank")
        if t.shape != shape:
            raise ValueError(f"ranks hold different shapes: {tuple(t.shape)} vs {tuple(shape)}")
    if len({t.device.type for t in parts}) > 1:
        raise ValueError("ring_allreduce: every rank on the CPU or every rank on a card")


def _padded_copies(parts, rows_pad: int, cols_pad: int) -> List[torch.Tensor]:
    """A fresh zero-padded copy of each rank's buffer on its device (the
    ring works in place)."""
    rows, cols = parts[0].shape
    bufs = []
    for t in parts:
        b = torch.zeros((rows_pad, cols_pad), dtype=torch.float32, device=t.device)
        b[:rows, :cols].copy_(t)
        bufs.append(b)
    return bufs


def launch_plan(world: int, segments: int, rows_pad: int):
    """The kernel's schedule: for each ring step, ``(seg, launches)`` with
    one launch ``(r, left, right, row_cw, row_ccw, add)`` per rank: rank
    ``r`` pulls ``seg`` rows at ``row_cw`` of the clockwise half from
    ``left`` and at ``row_ccw`` of the other half from ``right``, and adds
    them (reduce-scatter) or copies them (all-gather).  Reduce-scatter
    step ``s`` writes segments ``r - (s + 1)`` and ``r + (s + 1)``,
    all-gather step ``s`` segments ``r - s`` and ``r + s`` (mod world):
    the indices of ``_ring_dir_ppermute`` with sign +1 and -1."""
    seg_rows = rows_pad // segments
    seg = seg_rows // world
    steps = [(True, s + 1) for s in range(world - 1)] + [(False, s) for s in range(world - 1)]
    for g in range(segments):
        base = g * seg_rows
        for add, k in steps:
            yield seg, [
                (r, (r - 1) % world, (r + 1) % world,
                 base + (r - k) % world * seg, base + (r + k) % world * seg, add)
                for r in range(world)
            ]


@lru_cache(maxsize=64)
def fold_order(world: int, segments: int, rows_pad: int) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
    """``order[dir][j]``: the ranks whose values an element of segment
    ``j`` adds, in the order :func:`launch_plan`'s reduce-scatter adds
    them (dir 0 the clockwise half, 1 the other).  The first is the rank
    that starts the segment's chain, each next one the rank whose step
    adds its own value to what arrived: ``x[o[-1]] + (... + (x[o[1]] +
    x[o[0]]))``.  Every segment group runs the same chains; a plan that
    did not would raise."""
    chains = {}
    for _, launches in launch_plan(world, segments, rows_pad):
        for r, left, right, row_cw, row_ccw, add in launches:
            if not add:
                continue
            for dirn, row, src in ((0, row_cw, left), (1, row_ccw, right)):
                chain = chains.setdefault((row // (rows_pad // segments), dirn,
                                           row % (rows_pad // segments)), [])
                if not chain:
                    chain.append(src)
                chain.append(r)
    seg = rows_pad // segments // world
    order = tuple(tuple(tuple(chains[(0, dirn, j * seg)]) for j in range(world))
                  for dirn in (0, 1))
    for (g, dirn, row), chain in chains.items():
        if tuple(chain) != order[dirn][row // seg]:
            raise AssertionError(f"segment group {g} folds in another order")
    return order


# -- plain version -------------------------------------------------------------


def _ring_dir_plain(bufs, c0: int, half: int, sign: int, axis) -> None:
    """One direction's ring over the columns ``[c0, c0 + half)`` of the
    row block ``bufs`` (one per rank), in place: ``_ring_dir_ppermute``
    step for step.  ``sign`` +1 sends to the right neighbour."""
    world = len(bufs)
    seg = bufs[0].shape[0] // world
    perm = [(i, (i + sign) % world) for i in range(world)]

    def block(r, idx):
        return bufs[r][idx * seg:(idx + 1) * seg, c0:c0 + half]

    for s in range(world - 1):  # reduce-scatter: rotate + add
        recv = collective.ppermute(
            [block(r, (r - sign * s) % world) for r in range(world)], perm, axis)
        for r in range(world):
            cur = block(r, (r - sign * (s + 1)) % world)
            cur.copy_(cur + recv[r])
    for s in range(world - 1):  # all-gather: rotate the reduced segments
        recv = collective.ppermute(
            [block(r, (r - sign * (s - 1)) % world) for r in range(world)], perm, axis)
        for r in range(world):
            block(r, (r - sign * s) % world).copy_(recv[r])


def _ring_plain(bufs, segments: int, axis) -> None:
    seg_rows = bufs[0].shape[0] // segments
    half = bufs[0].shape[1] // 2
    for g in range(segments):
        rows = [b[g * seg_rows:(g + 1) * seg_rows] for b in bufs]
        _ring_dir_plain(rows, 0, half, 1, axis)
        _ring_dir_plain(rows, half, half, -1, axis)


def ring_allreduce_plain(parts: Sequence[torch.Tensor], segments: int = 1,
                         axis: Optional[str] = None) -> List[torch.Tensor]:
    """The ring schedule in plain PyTorch: the sum of ``parts`` (one 2-D
    f32 tensor per rank, in ring order) on every rank's device."""
    _check_parts(parts)
    world = len(parts)
    segments = check_segments(segments)
    if world < 2:
        return collective.psum_group(list(parts), axis)
    rows, cols = parts[0].shape
    bufs = _padded_copies(parts, *padded_shape(rows, cols, world, segments))
    _ring_plain(bufs, segments, axis)
    return [b[:rows, :cols] for b in bufs]


# -- the kernel ----------------------------------------------------------------


def _library():
    global _lib
    if _lib is None:
        from oap_mllib_tpu_torch.ops.cuda import _build

        lib = _build.load(KERNEL)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ring_enable_peer.argtypes = [i32, i32]
        lib.ring_enable_peer.restype = i32
        u32, i64 = ctypes.c_uint, ctypes.c_longlong
        words = ctypes.POINTER(ctypes.c_ulonglong)
        lib.ring_fold.argtypes = [i32] + [ptr] * 5 + [i32] * 6 + [ptr, i32, u32, ptr]
        lib.ring_ws_alloc.argtypes = [i32, i64, i64, ctypes.POINTER(ptr), ptr]
        lib.ring_ws_free.argtypes = [i32, ptr]
        lib.ring_ipc_open.argtypes = [i32, ptr, ctypes.POINTER(ptr)]
        lib.ring_ipc_close.argtypes = [i32, ptr]
        lib.ring_handshake.argtypes = [i32, ptr, i32, words, u32, i32, words, u32, ptr, ptr,
                                       i64]
        lib.ring_release.argtypes = [i32, i32, words, u32]
        for fn in (lib.ring_fold, lib.ring_ws_alloc, lib.ring_ws_free, lib.ring_ipc_open,
                   lib.ring_ipc_close, lib.ring_handshake, lib.ring_release):
            fn.restype = i32
        _lib = lib
    return _lib


def _enable_peers(lib, cards) -> None:
    """Peer access between every two distinct cards of the ring, once per
    ordered pair; a failure raises."""
    for a in cards:
        for b in cards:
            if a == b or (a, b) in _peers_enabled:
                continue
            err = lib.ring_enable_peer(a, b)
            if err != 0:
                raise RuntimeError(
                    f"{KERNEL}: cudaDeviceEnablePeerAccess(cuda:{a} -> cuda:{b}) "
                    f"failed with error {err}"
                )
            _peers_enabled.add((a, b))


@lru_cache(maxsize=64)
def _geometry(rows: int, cols: int, world: int, segments: int):
    """``(order, half, seg_rows, seg)`` of the kernel's launch: the fold
    order flattened as ``order[(dir * world + segment) * world + t]``,
    the padded buffer's first counter-clockwise column, and the rows of a
    segment group and of a segment."""
    rows_pad, cols_pad = padded_shape(rows, cols, world, segments)
    order = tuple(r for dirn in fold_order(world, segments, rows_pad)
                  for chain in dirn for r in chain)
    seg_rows = rows_pad // segments
    return order, cols_pad // 2, seg_rows, seg_rows // world


def fold_table(ins: Sequence[int], outs: Sequence[int], order: Sequence[int]) -> List[int]:
    """The kernel's table: the ranks' input addresses, their output
    addresses, then the flattened fold order (``csrc/ring_reduce.cu``)."""
    return [*ins, *outs, *order]


def _device_table(card, stream: int, table: List[int]) -> torch.Tensor:
    """The table on ``card``: a cached copy, or one copied now on the
    card's current stream from pinned memory (ordered before the launch;
    the host does not wait).  A table is used only on the stream it was
    copied on, so an evicted one is reused only after its last launch."""
    key = (card, stream, tuple(table))
    t = _tables.get(key)
    if t is None:
        host = torch.tensor(table, dtype=torch.int64).pin_memory()
        t = _tables[key] = host.to(card, non_blocking=True)
        if len(_tables) > _MAX_TABLES:
            _tables.popitem(last=False)
    else:
        _tables.move_to_end(key)
    return t


def _shares(total: int, cards: int):
    """Each card's ``[lo, hi)`` of the flat elements: contiguous, in
    whole 4-element chunks but for the last card's end."""
    chunks = -(-total // 4)
    return [(4 * (c * chunks // cards), min(total, 4 * ((c + 1) * chunks // cards)))
            for c in range(cards)]


def _ring_launch(parts, segments: int) -> List[torch.Tensor]:
    """The ring of CUDA tensors: fresh ``(rows, cols)`` outputs, one
    launch per card."""
    world = len(parts)
    rows, cols = parts[0].shape
    total = rows * cols
    if total >= 2 ** 31 - 2 ** 20:
        raise ValueError(f"{KERNEL}: {rows} x {cols} is past the kernel's 32-bit indices")
    lib = _library()
    parts = [p.contiguous() for p in parts]
    order, half, seg_rows, seg = _geometry(rows, cols, world, segments)
    devs = [p.device for p in parts]
    cards = list(dict.fromkeys(devs))
    outs = [None] * world  # one allocation per card
    for card in cards:
        mine = [r for r, d in enumerate(devs) if d == card]
        for r, t in zip(mine, torch.empty((len(mine), rows, cols), dtype=torch.float32,
                                          device=card).unbind(0)):
            outs[r] = t
    ins, addr_out = [p.data_ptr() for p in parts], [o.data_ptr() for o in outs]
    vec = int(all(a % 16 == 0 for a in ins + addr_out))
    table = fold_table(ins, addr_out, order)
    streams = [torch.cuda.current_stream(c).cuda_stream for c in cards]
    tables = [_device_table(c, st, table) for c, st in zip(cards, streams)]
    n = len(cards)
    if n > 1:
        _enable_peers(lib, [c.index for c in cards])
    los, his = zip(*_shares(total, n))
    ints = ctypes.c_int * n
    t0 = time.perf_counter()
    err = lib.ring_fold(
        n, ints(*(c.index for c in cards)), (ctypes.c_void_p * n)(*streams),
        ints(*los), ints(*his), (ctypes.c_void_p * n)(*(t.data_ptr() for t in tables)),
        world, cols, half, seg_rows, seg, vec, None, 0, 0, None)
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with error {err}")
    LAUNCHES[KERNEL] += n  # one launch per card
    book_launch(LABELS[KERNEL], time.perf_counter() - t0, n)
    return outs


def ring_allreduce(parts: Sequence[torch.Tensor], segments: int = 1,
                   axis: Optional[str] = None) -> List[torch.Tensor]:
    """Sum one 2-D f32 tensor per rank (in ring order) with the ring
    schedule; returns the sum on every rank's device, the same bits on
    every rank.  CPU tensors take the plain version, CUDA tensors the
    Hopper kernel.  ``axis`` names the mesh axis for the census."""
    _check_parts(parts)
    segments = check_segments(segments)
    collective.note("ring_allreduce", axis)
    if len(parts) < 2 or parts[0].device.type == "cpu":
        return ring_allreduce_plain(parts, segments, axis)
    if parts[0].device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {parts[0].device}")
    return _ring_launch(parts, segments)


# -- across processes -------------------------------------------------------------

# this process's workspace and its peers' mapped ones: card index, own
# pointer, bytes (equal on every process), {process: mapped pointer},
# the peers' pids, the last call's epoch, whether the
# next call makes the workspace anew (after a failed call), the pinned
# host copy of this process's signal area, the call's CUDA events and
# tensors over the workspace's slots
_ipc = {"card": None, "ptr": None, "bytes": 0, "peers": {}, "pids": {},
        "epoch": 0, "stale": False, "words": None, "events": None, "views": {}}
_MAX_VIEWS = 256
# the host cost of the cross-process rings: calls, seconds of the whole
# call (copies and launches included), seconds the host waited at the
# end of the call (``barrier_s``), and seconds the card's stream waited
# for the peers' signals (``device_wait_s``, from CUDA events around the
# two waits)
IPC_STATS = {"calls": 0, "barrier_s": 0.0, "device_wait_s": 0.0, "total_s": 0.0}
_SLOT_ALIGN = 256
# a signal word holds (epoch << 1) | failed in 32 bits
EPOCH_LIMIT = 2 ** 31 - 1
# the host's wait at the end of a call: how long it polls before it
# moves under the recovery plane's watcher, how often the watched wait
# looks for peers that ended, and how long it spins before it sleeps
# between polls
_INLINE_S = 0.001
_LIVENESS_S = 0.05
_SPIN_S = 0.002


def reset_ipc_stats() -> None:
    IPC_STATS.update(calls=0, barrier_s=0.0, device_wait_s=0.0, total_s=0.0)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{KERNEL}: {what} failed with CUDA error {err}")


def signal_area(processes: int) -> Dict[str, int]:
    """Byte offsets of the signal area at the start of every workspace of
    a world of ``processes``: a ``ready`` and a ``folded`` 32-bit word for
    each process (process q writes word q of every area), one ``status``
    word (the fold's), ``words`` in all, and the area's ``bytes``, padded
    to the slots' alignment so every slot after it keeps its own."""
    if processes < 1:
        raise ValueError(f"{KERNEL}: a world of {processes} processes")
    words = 2 * processes + 1
    return {"ready": 0, "folded": 4 * processes, "status": 8 * processes, "words": words,
            "bytes": _pad_to(4 * words, _SLOT_ALIGN)}


def workspace_layout(rows: int, cols: int, members: int, processes: int) -> Dict:
    """Where everything lies in one process's workspace for a call of
    (rows, cols) buffers with ``members`` ring members a process:
    ``signal`` (:func:`signal_area`), ``slot`` (the bytes of one buffer,
    aligned), ``inputs`` and ``outputs`` (each member slot's offset: a
    member's input, then its output) and ``bytes`` in all.  Every process
    lays its workspace out alike (each passes the largest member count of
    any process)."""
    area = signal_area(processes)
    slot = _pad_to(4 * rows * cols, _SLOT_ALIGN)
    return {"signal": area, "slot": slot,
            "inputs": [area["bytes"] + 2 * s * slot for s in range(members)],
            "outputs": [area["bytes"] + (2 * s + 1) * slot for s in range(members)],
            "bytes": area["bytes"] + 2 * slot * members}


def next_epoch(epoch: int, limit: int = EPOCH_LIMIT) -> Optional[int]:
    """The epoch of the call after one at ``epoch`` (0: a workspace no
    call has used), or None when it would pass ``limit``: the workspace is
    then made anew (its signal area zeroed) before the call, and the count
    restarts at 1.  Every process counts every call, in one order, so all
    count alike and renew at the same call."""
    return epoch + 1 if epoch < limit else None


def signal_word(epoch: int, failed: bool) -> int:
    """The value a process signals for a call: its epoch, and an error
    bit when its copy in or its launch failed."""
    return (epoch << 1) | int(bool(failed))


def failed_processes(words: Sequence[int], processes: int, epoch: int) -> List[int]:
    """The processes that failed the call at ``epoch``, read from this
    process's signal area at the end of the call (``words``: the ready
    words, the folded words, the status): each whose folded word is not
    this call's clean value, or whose ready word is neither this call's
    clean value nor the next call's (a peer that has seen every folded
    word may already be in the next call, and its ready word then says
    nothing of this one; its folded word cannot move on before this
    process signals the next call).  A failed call stops every process
    from signalling again before all have read it (the next call renews
    the workspace, a host collective), so every process names the same
    processes."""
    want = epoch << 1
    ready, folded = words[:processes], words[processes:2 * processes]
    return [q for q in range(processes)
            if (folded[q] & 0xFFFFFFFF) != want
            or ((ready[q] & 0xFFFFFFFF) != want and (ready[q] & 0xFFFFFFFF) >> 1 != epoch + 1)]


def call_error(failed: Sequence[int], words: Sequence[int], processes: int, epoch: int,
               error: Optional[BaseException]) -> RuntimeError:
    """The error every process raises for a failed call: the processes
    that failed (as ``collective.agree`` names them), whether the fold
    saw it (the status word) and this process's own error."""
    folded = "the fold folded nothing" if (words[2 * processes] & 0xFFFFFFFF) == \
        signal_word(epoch, True) else "the fold ran"
    return RuntimeError(f"{KERNEL}: the cross-process call failed on process(es) "
                        f"{list(failed)} ({folded}; here: {error!r})")


def process_alive(pid: int) -> bool:
    """Whether process ``pid`` of this machine still runs (a zombie, dead
    but not reaped, does not)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return True
    return state not in ("Z", "X")


def _await_call(done, pids: Dict[int, int]) -> None:
    """Wait for ``done`` (the call's last CUDA event); a peer process
    that has ended raises ConnectionError, which the recovery plane maps
    to PeerAbortError.  CUDA IPC maps memory only between processes of one
    machine, so every peer's pid is this machine's."""
    t0 = last = time.monotonic()
    while not done.query():
        now = time.monotonic()
        if now - last >= _LIVENESS_S:
            last = now
            gone = [q for q, pid in pids.items() if not process_alive(pid)]
            if gone:
                raise ConnectionError(f"{KERNEL}: process(es) {gone} ended during the call "
                                      "(connection closed by peer)")
        time.sleep(0 if now - t0 < _SPIN_S else 1e-4)


def close_ipc() -> None:
    """Unmap the peers' workspaces and free this process's (a collective:
    every process calls it; the first barrier keeps a workspace alive
    until no peer maps it, and a failed unmap raises on every process and
    frees nothing)."""
    from oap_mllib_tpu_torch.parallel import collective

    if _ipc["ptr"] is None:
        return
    lib = _library()
    collective.barrier()
    errors = [f"CUDA error {e}" for e in (lib.ring_ipc_close(_ipc["card"], ptr)
                                          for ptr in _ipc["peers"].values()) if e]
    collective.agree(RuntimeError("; ".join(errors)) if errors else None,
                     f"{KERNEL}: cudaIpcCloseMemHandle")
    _check(lib.ring_ws_free(_ipc["card"], _ipc["ptr"]), "cudaFree of the workspace")
    _ipc.update(ptr=None, bytes=0, peers={}, pids={}, epoch=0, stale=False,
                words=None, events=None, views={})


def _workspace(card: int, nbytes: int, processes: int, renew: bool) -> Dict[int, int]:
    """Every process's workspace address in this process (its own and the
    mapped peers'), at least ``nbytes`` each, its signal area zeroed:
    grown (or, with ``renew``, made anew) collectively (every process
    passes the same arguments), the handles and pids exchanged through
    the host and the handles opened here.  A workspace that does not
    allocate, or a handle that does not open, raises on every process.
    A new workspace restarts the epoch."""
    from oap_mllib_tpu_torch.parallel import bootstrap, collective

    me = bootstrap.process_index()
    if _ipc["ptr"] is not None and _ipc["bytes"] >= nbytes and not renew:
        return {me: _ipc["ptr"], **_ipc["peers"]}
    close_ipc()
    lib = _library()
    area = signal_area(processes)
    ptr, handle = ctypes.c_void_p(), (ctypes.c_ubyte * 64)()
    err = lib.ring_ws_alloc(card, nbytes, area["bytes"], ctypes.byref(ptr), handle)
    # the allocation's outcome travels with the handle: a process whose
    # allocation failed does not leave its peers in the exchange
    handles, alloc = collective.process_allgather(
        [np.frombuffer(bytes(handle), np.uint8), np.asarray([err, os.getpid()], np.int64)])
    if alloc[:, 0].any():
        if err == 0:
            lib.ring_ws_free(card, ptr)
        raise RuntimeError(
            f"{KERNEL}: the workspace of {nbytes} bytes did not allocate "
            f"(CUDA errors by process: {alloc[:, 0].tolist()})")
    _ipc.update(card=card, ptr=ptr.value, bytes=nbytes, peers={},
                pids={q: int(pid) for q, pid in enumerate(alloc[:, 1]) if q != me},
                epoch=0, stale=False, views={},
                words=torch.empty((area["words"],), dtype=torch.int32).pin_memory(),
                events=[torch.cuda.Event(enable_timing=True) for _ in range(5)])
    errors = []
    for q, h in enumerate(handles):
        if q == me:
            continue
        mapped = ctypes.c_void_p()
        err = lib.ring_ipc_open(card, h.tobytes(), ctypes.byref(mapped))
        if err != 0:
            errors.append(f"process {q}'s handle: CUDA error {err}")
        else:
            _ipc["peers"][q] = mapped.value
    (failed,) = collective.process_allgather([np.asarray([len(errors)], np.int64)])
    if failed.sum():
        raise RuntimeError(
            f"{KERNEL}: cudaIpcOpenMemHandle failed on {int((failed > 0).sum())} "
            f"process(es) of the world ({'; '.join(errors) or 'on a peer'}); the "
            "cross-process ring needs every process to see every card "
            "(no CUDA_VISIBLE_DEVICES masking)"
        )
    return {me: _ipc["ptr"], **_ipc["peers"]}


class _Raw:
    """A (rows, cols) f32 view of raw device memory, for torch.as_tensor."""

    def __init__(self, ptr: int, shape):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": "<f4", "data": (int(ptr), False),
            "version": 3, "strides": None}


def _layout(groups, owner) -> Dict[Hashable, Tuple[int, int]]:
    """Each member's (process, slot): a process's members in the order
    the rings list them.  Every process derives the same layout."""
    slots: Dict[int, int] = {}
    out = {}
    for g in groups:
        for m in g:
            p = owner(m)
            out[m] = (p, slots.get(p, 0))
            slots[p] = slots.get(p, 0) + 1
    return out


def _check_groups(parts, groups, owner, me):
    members = [m for g in groups for m in g]
    if len(set(members)) != len(members):
        raise ValueError("a member lies in two rings")
    mine = [m for m in members if owner(m) == me]
    if not mine or sorted(map(repr, mine)) != sorted(map(repr, parts)):
        raise ValueError(f"process {me} holds {list(parts)} but its members are {mine}; "
                         "every process holds a member of the rings")
    _check_parts(list(parts.values()))
    return mine


def ring_allreduce_groups_plain(parts: Dict[Hashable, torch.Tensor],
                                groups: Sequence[Sequence[Hashable]],
                                owner: Callable[[Hashable], int], segments: int = 1,
                                axis: Optional[str] = None) -> Dict[Hashable, torch.Tensor]:
    """The plain version of :func:`ring_allreduce_groups`: every
    process's parts through ``collective.process_allgather`` (each
    process holds as many members), then :func:`ring_allreduce_plain` of
    every ring this process holds a member of, on the gathered list; the
    local members' sums on their devices."""
    from oap_mllib_tpu_torch.parallel import bootstrap, collective

    me = bootstrap.process_index()
    mine = _check_groups(parts, groups, owner, me)
    layout = _layout(groups, owner)
    (stacked,) = collective.process_allgather(
        [torch.stack([parts[m].detach().cpu() for m in mine])])
    out = {}
    for g in groups:
        local = [m for m in g if owner(m) == me]
        if not local:
            continue
        dev = parts[local[0]].device
        full = [torch.from_numpy(stacked[layout[m][0], layout[m][1]]).to(dev) for m in g]
        for m, t in zip(g, ring_allreduce_plain(full, segments, axis)):
            if m in parts:
                out[m] = t.to(parts[m].device)
    return out


def ring_allreduce_groups(parts: Dict[Hashable, torch.Tensor],
                          groups: Sequence[Sequence[Hashable]],
                          owner: Callable[[Hashable], int], segments: int = 1,
                          axis: Optional[str] = None) -> Dict[Hashable, torch.Tensor]:
    """Rings whose members may belong to several processes: ``groups``
    lists each ring's members in ring order, ``owner(member)`` the
    process that holds it, and ``parts`` this process's members' 2-D f32
    buffers, all of one shape.  Every process of the world calls it; it
    returns the local members' sums, each ring's the bits of
    :func:`ring_allreduce_plain` of its members.  In one process it is
    :func:`ring_allreduce` ring by ring; CPU tensors take the plain
    version across processes, CUDA tensors the kernel over IPC."""
    from oap_mllib_tpu_torch.parallel import bootstrap

    segments = check_segments(segments)
    if bootstrap.world_size() == 1:
        out = {}
        for g in groups:
            for m, t in zip(g, ring_allreduce([parts[m] for m in g], segments, axis)):
                out[m] = t
        return out
    from oap_mllib_tpu_torch.parallel import collective

    me = bootstrap.process_index()
    _check_groups(parts, groups, owner, me)
    for g in groups:
        if any(owner(m) == me for m in g):
            collective.note("ring_allreduce", axis)
    device = next(iter(parts.values())).device
    if device.type == "cpu":
        return ring_allreduce_groups_plain(parts, groups, owner, segments, axis)
    if device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {device}")
    return _ring_launch_ipc(parts, groups, owner, segments, me, axis)


def _view(ws_dev, addr: int, shape) -> torch.Tensor:
    """A (rows, cols) f32 tensor over the workspace at ``addr``, made once
    per workspace."""
    key = (addr, tuple(shape))
    t = _ipc["views"].get(key)
    if t is None:
        if len(_ipc["views"]) >= _MAX_VIEWS:
            _ipc["views"].clear()
        t = _ipc["views"][key] = torch.as_tensor(_Raw(addr, shape), device=ws_dev)
    return t


def _copy_in(slot: torch.Tensor, t: torch.Tensor) -> None:
    """One member's buffer into its input slot, on the workspace card's
    current stream."""
    slot.copy_(t)


def _ring_launch_ipc(parts, groups, owner, segments: int, me: int, axis: Optional[str]):
    """One cross-process call: stream-ordered work on the workspace card's
    current stream, then one host wait (module docstring)."""
    from oap_mllib_tpu_torch.parallel import bootstrap
    from oap_mllib_tpu_torch.telemetry import flightrec
    from oap_mllib_tpu_torch.utils import recovery

    t_call = time.perf_counter()
    rows, cols = next(iter(parts.values())).shape
    total = rows * cols
    if total >= 2 ** 31 - 2 ** 20:
        raise ValueError(f"{KERNEL}: {rows} x {cols} is past the kernel's 32-bit indices")
    lib = _library()
    layout = _layout(groups, owner)
    per_process: Dict[int, int] = {}
    for p, _ in layout.values():
        per_process[p] = per_process.get(p, 0) + 1
    nproc = bootstrap.world_size()
    plan = workspace_layout(rows, cols, max(per_process.values()), nproc)
    area = plan["signal"]
    card = next(iter(parts.values())).device
    renew = _ipc["stale"] or next_epoch(_ipc["epoch"]) is None
    bases = _workspace(card.index if _ipc["card"] is None else _ipc["card"], plan["bytes"],
                       nproc, renew)
    epoch = _ipc["epoch"] = next_epoch(_ipc["epoch"])
    ws_dev = torch.device("cuda", _ipc["card"])
    if flightrec.enabled():
        flightrec.record("collective", "ring_allreduce", f"{axis}|({rows}, {cols})|float32")

    def addr(m, out):
        p, s = layout[m]
        return bases[p] + (plan["outputs"] if out else plan["inputs"])[s]

    def theirs(kind):  # this process's word ``kind`` in every process's area
        return [bases[p] + area[kind] + 4 * me for p in range(nproc)]

    def mine(kind):  # every process's word ``kind`` in this process's area
        return [bases[me] + area[kind] + 4 * p for p in range(nproc)]

    host_words = _ipc["words"]

    def handshake(kind, failed, read=False):
        """Signal ``kind``, wait for every peer's; with ``read``, then
        copy this process's signal area to ``host_words``."""
        sig, own = theirs(kind), mine(kind)
        n = ctypes.c_ulonglong * nproc
        err = lib.ring_handshake(ws_dev.index, stream.cuda_stream, nproc, n(*sig),
                                 signal_word(epoch, failed), nproc, n(*own), epoch << 1,
                                 host_words.data_ptr(), bases[me], 4 * area["words"] * read)
        if err != 0:
            _ipc["stale"] = True
            _check(err, f"the {kind} signal (stream memory operations)")

    stream = torch.cuda.current_stream(ws_dev)
    events = _ipc["events"]
    # a process whose copy or launch fails still signals, with the error
    # bit, so its peers' waits end and every process raises together
    error = None
    try:
        for m, t in parts.items():
            _copy_in(_view(ws_dev, addr(m, 0), (rows, cols)), t)
    except Exception as e:  # noqa: BLE001 - every process raises at the end of the call
        error = e
    events[0].record(stream)
    handshake("ready", error is not None)
    events[1].record(stream)
    launched, launch_error = 0, None
    t_launch = time.perf_counter()
    ready = ctypes.c_void_p(bases[me] + area["ready"])
    status = ctypes.c_void_p(bases[me] + area["status"])
    for g in groups:
        procs = list(dict.fromkeys(owner(m) for m in g))
        if me not in procs:
            continue
        world = len(g)
        order, half, seg_rows, seg = _geometry(rows, cols, world, segments)
        ins = [addr(m, 0) for m in g]
        outs = [addr(m, 1) for m in g]
        vec = int(all(a % 16 == 0 for a in ins + outs))
        table = _device_table(ws_dev, stream.cuda_stream, fold_table(ins, outs, order))
        lo, hi = _shares(total, len(procs))[procs.index(me)]
        one = ctypes.c_int * 1
        err = lib.ring_fold(
            1, one(ws_dev.index), (ctypes.c_void_p * 1)(stream.cuda_stream), one(lo),
            one(hi), (ctypes.c_void_p * 1)(table.data_ptr()), world, cols, half,
            seg_rows, seg, vec, ready, nproc, epoch << 1, status)
        if err != 0:
            launch_error = launch_error or RuntimeError(
                f"{KERNEL}: the cross-process launch failed with CUDA error {err}")
            continue
        launched += 1
    LAUNCHES[KERNEL] += launched  # one launch per process per ring
    if launched:
        book_launch(LABELS[KERNEL], time.perf_counter() - t_launch, launched)
    error = error or launch_error
    events[2].record(stream)
    handshake("folded", launch_error is not None, read=True)
    events[3].record(stream)
    out = {m: _view(ws_dev, addr(m, 1), (rows, cols)).to(parts[m].device, copy=True)
           for m in parts}
    done = events[4]
    done.record(stream)
    # the call's one host wait: a short poll here (a watched wait starts a
    # thread, which costs more than a small call), then, under the
    # recovery plane's watcher, the rest: a peer that ended or never
    # signals raises PeerAbortError or CollectiveTimeoutError within the
    # deadline
    t0 = time.perf_counter()
    while not done.query() and time.perf_counter() - t0 < _INLINE_S:
        pass
    try:
        if not done.query():
            recovery.guarded_dispatch("ring_allreduce", axis or "host",
                                      lambda: _await_call(done, _ipc["pids"]))
    except recovery.RecoveryError:
        # this process's waits end on its own words (the error bit set),
        # so its stream drains; the next call makes the workspace anew
        _ipc["stale"] = True
        n = ctypes.c_ulonglong * (2 * nproc)
        lib.ring_release(ws_dev.index, 2 * nproc,
                         n(*mine("ready"), *mine("folded")), signal_word(epoch, True))
        raise
    waited = time.perf_counter() - t0
    got = host_words.tolist()
    IPC_STATS["calls"] += 1
    IPC_STATS["barrier_s"] += waited
    IPC_STATS["device_wait_s"] += 1e-3 * (events[0].elapsed_time(events[1])
                                          + events[2].elapsed_time(events[3]))
    IPC_STATS["total_s"] += time.perf_counter() - t_call
    failed = failed_processes(got, nproc, epoch)
    if failed or error is not None:
        _ipc["stale"] = True
        raise call_error(failed, got, nproc, epoch, error) from error
    return out


def ring_allreduce_mesh(parts: Dict, mesh, axis: str, segments: int = 1) -> Dict:
    """One ring per group of the mesh ``axis`` over per-rank buffers
    (this process's ranks'): :func:`ring_allreduce_groups` of the axis'
    groups.  Returns the local ranks' sums."""
    return ring_allreduce_groups(parts, mesh.groups(axis), mesh.process_of, segments, axis)
