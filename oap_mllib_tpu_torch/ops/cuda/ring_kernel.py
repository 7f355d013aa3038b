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
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import torch

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
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ring_enable_peer.argtypes = [i32, i32]
        lib.ring_enable_peer.restype = i32
        lib.ring_fold.argtypes = [i32] + [ptr] * 5 + [i32] * 6
        lib.ring_fold.restype = i32
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
    err = lib.ring_fold(
        n, ints(*(c.index for c in cards)), (ctypes.c_void_p * n)(*streams),
        ints(*los), ints(*his), (ctypes.c_void_p * n)(*(t.data_ptr() for t in tables)),
        world, cols, half, seg_rows, seg, vec)
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with error {err}")
    LAUNCHES[KERNEL] += n  # one launch per card
    return outs


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
    return _ring_launch(parts, max(1, int(segments)))
