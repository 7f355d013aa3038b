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
  tensors launch the kernel, one launch per rank per ring step, or
  raise.  There is no fallback from one to the other.

Contract, as in the JAX package: every rank's buffer is a (rows, cols)
f32 tensor; rows pad to a multiple of ``world * segments`` and columns
to an even multiple of 128, so the clockwise half ``[:half]`` and the
counter-clockwise half ``[half:]`` split where JAX splits them; each of
``segments`` row blocks is its own ring.  A reduce-scatter step computes
``cur + recv``, so every rank ends with the same bits.  A world of one
returns its tensor unchanged, through psum.

On the card, rank ``r``'s step waits (``Stream.wait_event``) on the
events of both neighbours' previous step: the neighbour barrier of the
TPU kernel.  It covers the read of what a neighbour just wrote and, in
a world of two, the write over a segment a neighbour is still reading.
After the last step every rank waits on its neighbours once more, so
work the caller puts on a rank's stream, including the caching
allocator's reuse of that rank's buffer, comes after the neighbours'
last reads of it.  The host never synchronises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from oap_mllib_tpu_torch.parallel import collective

KERNEL = "ring_reduce"

# launches of the CUDA kernel (one per rank per ring step); the wrapper
# adds one per launch and nowhere else (the plain version counts none)
LAUNCHES = {KERNEL: 0}

LANE = 128  # the column multiple of the JAX ring (two halves of lanes)

_peers_enabled = set()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


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
    if world < 2:
        return collective.psum_group(list(parts), axis)
    segments = max(1, int(segments))
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
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ring_enable_peer.argtypes = [i32, i32]
        lib.ring_enable_peer.restype = i32
        lib.ring_step.argtypes = [i32, ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr]
        lib.ring_step.restype = i32
        _lib = lib
    return _lib


def _enable_peers(lib, devices) -> None:
    """Peer access between every two distinct cards of the ring, once per
    ordered pair; a failure raises."""
    cards = sorted({d.index for d in devices})
    for a in cards:
        for b in cards:
            if a == b or (a, b) in _peers_enabled:
                continue
            with torch.cuda.device(a):
                err = lib.ring_enable_peer(a, b)
            if err != 0:
                raise RuntimeError(
                    f"{KERNEL}: cudaDeviceEnablePeerAccess(cuda:{a} -> cuda:{b}) "
                    f"failed with error {err}"
                )
            _peers_enabled.add((a, b))


def _record(stream: torch.cuda.Stream) -> torch.cuda.Event:
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _ring_launch(bufs, segments: int) -> None:
    """The ring on CUDA buffers, in place: one launch per rank per step,
    each after both neighbours' previous step."""
    lib = _library()
    world = len(bufs)
    devs = [b.device for b in bufs]
    _enable_peers(lib, devs)
    rows_pad, cols = bufs[0].shape
    streams = [torch.cuda.current_stream(d) for d in devs]
    events = [_record(s) for s in streams]  # the padded copies are made
    for seg, launches in launch_plan(world, segments, rows_pad):
        done = []
        for r, left, right, row_cw, row_ccw, add in launches:
            with torch.cuda.device(devs[r]):
                streams[r].wait_event(events[left])
                streams[r].wait_event(events[right])
                err = lib.ring_step(
                    devs[r].index, bufs[r].data_ptr(), bufs[left].data_ptr(),
                    bufs[right].data_ptr(), row_cw, row_ccw, seg, cols, int(add),
                    streams[r].cuda_stream,
                )
                if err != 0:
                    raise RuntimeError(f"{KERNEL}: CUDA launch failed with error {err}")
                LAUNCHES[KERNEL] += 1
                done.append(_record(streams[r]))
        events = done
    for r in range(world):  # the neighbours' last reads of this rank's buffer
        with torch.cuda.device(devs[r]):
            streams[r].wait_event(events[(r - 1) % world])
            streams[r].wait_event(events[(r + 1) % world])


def ring_allreduce(parts: Sequence[torch.Tensor], segments: int = 1,
                   axis: Optional[str] = None) -> List[torch.Tensor]:
    """Sum one 2-D f32 tensor per rank (in ring order) with the ring
    schedule; returns the sum on every rank's device, the same bits on
    every rank.  CPU tensors take the plain version, CUDA tensors the
    Hopper kernel.  ``axis`` names the mesh axis for the census."""
    _check_parts(parts)
    collective.note("ring_allreduce", axis)
    if len(parts) < 2 or parts[0].device.type == "cpu":
        return ring_allreduce_plain(parts, segments, axis)
    if parts[0].device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {parts[0].device}")
    segments = max(1, int(segments))
    rows, cols = parts[0].shape
    bufs = _padded_copies(parts, *padded_shape(rows, cols, len(parts), segments))
    _ring_launch(bufs, segments)
    return [b[:rows, :cols] for b in bufs]
