"""Fused Lloyd accumulate: the port of the JAX package's
``ops/pallas/kmeans_kernel.py`` (``_tile_update`` and the loop around it).

- :func:`lloyd_accumulate_plain` is ``_tile_update``'s function in plain
  PyTorch, chunked by ``rows_per_chunk`` so the (rows, k) score buffer
  stays bounded.  The CPU tests run it, and ``chip_smoke.py`` holds the
  kernel against it on the card.
- :func:`lloyd_accumulate` is the wrapper of the hand-written Hopper
  kernel ``csrc/kmeans_accumulate.cu``.  A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises.  There is no
  fallback from one to the other.  The assignment's route is fixed by
  the depth (:func:`assign_route`): up to 256 features it runs on the
  tensor cores at every tier (``csrc/assign_wgmma.cuh``; highest as a
  three-part bf16 split, six products), wider rows on the FP32 pipe.
  :func:`assign_geometry` sizes the launch and its scratch; the wrapper
  checks it against the library's own figures when it loads it.
- :func:`lloyd_run_kernel` is ``_lloyd_loop_padded`` / ``lloyd_run_pallas``:
  the Lloyd loop over the wrapper, then one cost pass at ``highest``.

Contract, as in the JAX package: ``mode`` is a precision tier; loop mode
(``need_cost=False``) ranks on ``argmax(x.c - |c|^2 / 2)`` and computes no
cost; cost mode ranks on ``argmin max(|x|^2 + |c|^2 - 2 x.c, 0)`` and sums
``w * min d2``; ties go to the first index; weights fold into ``w * x``
and the one-hot stays 0/1.  The kernel masks ragged rows and centers
itself, so the JAX package's padding and dummy centers are not needed.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from oap_mllib_tpu_torch.ops.cuda._tiers import MODE_CODE, bf16_round, check_mode, split_bf16
from oap_mllib_tpu_torch.ops.kmeans_ops import _lloyd_loop, rows_per_chunk

KERNEL = "kmeans_accumulate"

# launches of the CUDA kernel, by kernel name; the wrapper adds one per
# launch and nowhere else (the plain version on CPU tensors counts none)
LAUNCHES = {KERNEL: 0}
# the same launches by tier (the precision rung's witness: a bf16 fit
# launches at "default", its f32 retry at "highest")
LAUNCHES_BY_MODE = {"highest": 0, "high": 0, "default": 0}

# the kernel's stable counting sort keeps (k, ranges) integer counts;
# ranges shrink as k grows so the table stays under this many entries
_RANK_TABLE_ELEMS = 1 << 24
_RANGE_ROWS = 2048
# per-cluster parts of the sums pass (load balance for large clusters),
# bounded so the (k, parts, d) partials stay under this many floats
_PARTIAL_ELEMS = 1 << 25
_MAX_PARTS = 8
# the assignment's routes (csrc/kmeans_accumulate.cu, assign_wgmma.cuh):
# wgmma keeps each row's operand parts in registers and shared memory
# for the whole pass, which bounds its depth; wider rows take the SIMT
# tile
ROUTE_CODE = {"simt": 0, "wgmma": 1}
WGMMA_MAX_D = 256
_ROWS = {"simt": 64, "wgmma": 128}
# the wgmma route's prepared centers: tiles of BN centers by 64-deep
# chunks, in PARTS bf16 parts of 128-byte rows (three parts at highest)
_CHUNK = 64
_SCAN_TILE = 4096


def reset_launches() -> None:
    for table in (LAUNCHES, LAUNCHES_BY_MODE):
        for name in table:
            table[name] = 0


def _assign_plain(x, c, mode, need_cost):
    """Labels (and min d2 in cost mode) of one row chunk."""
    c_sq = torch.sum(c * c, dim=1)
    if mode == "highest":
        cross = x @ c.T
    else:
        cross = bf16_round(x) @ bf16_round(c).T
    if need_cost:
        x_sq = torch.sum(x * x, dim=1, keepdim=True)
        d2 = torch.clamp_min(x_sq + c_sq[None, :] - 2.0 * cross, 0.0)
        # argmin returns the first index on ties, as jnp.argmin does
        assign = torch.argmin(d2, dim=1)
        return assign, d2.gather(1, assign[:, None])[:, 0]
    return torch.argmax(cross - 0.5 * c_sq[None, :], dim=1), None


def assign_plain(x, c, mode: str = "highest", need_cost: bool = True):
    """Labels and (cost mode) min d2 of every row, chunked; the kernel's
    assignment in plain PyTorch."""
    mode = check_mode(mode)
    rows = rows_per_chunk(c.shape[0], x.shape[1])
    labels, mins = [], []
    for lo in range(0, x.shape[0], rows):
        a, m = _assign_plain(x[lo:lo + rows], c, mode, need_cost)
        labels.append(a)
        mins.append(m)
    return torch.cat(labels), (torch.cat(mins) if need_cost else None)


def _add_sums(acc, x, w, assign, mode):
    """Fold one chunk's rows into ``acc = [sums_hi, sums_lo, counts_hi,
    counts_lo]`` by label: sums of ``w x`` and counts of ``w`` at the
    tier's rounding (the one-hot is 0/1, so a label-indexed add is the
    one-hot product)."""
    sums_hi, sums_lo, counts_hi, counts_lo = acc
    wx = w[:, None] * x
    if mode == "highest":
        sums_hi.index_add_(0, assign, wx)
        counts_hi.index_add_(0, assign, w)
        return
    if mode == "default":
        sums_hi.index_add_(0, assign, bf16_round(wx))
    else:
        wx_hi, wx_lo = split_bf16(wx)
        sums_hi.index_add_(0, assign, wx_hi)
        sums_lo.index_add_(0, assign, wx_lo)
    w_hi, w_lo = split_bf16(w)
    counts_hi.index_add_(0, assign, w_hi)
    counts_lo.index_add_(0, assign, w_lo)


def _new_acc(k, d, device):
    z = torch.zeros((k, d), dtype=torch.float32, device=device)
    zc = torch.zeros((k,), dtype=torch.float32, device=device)
    return [z, z.clone(), zc, zc.clone()]


def _finish(acc, mode):
    sums_hi, sums_lo, counts_hi, counts_lo = acc
    sums = sums_hi + sums_lo if mode == "high" else sums_hi
    counts = counts_hi if mode == "highest" else counts_hi + counts_lo
    return sums, counts


def sums_for_labels(x, w, labels, k: int, mode: str = "highest"):
    """``(sums, counts)`` of the plain version for given labels: the
    kernel's sums pass alone, held against the kernel on its own labels."""
    mode = check_mode(mode)
    acc = _new_acc(k, x.shape[1], x.device)
    rows = rows_per_chunk(x.shape[1])
    for lo in range(0, x.shape[0], rows):
        _add_sums(acc, x[lo:lo + rows], w[lo:lo + rows],
                  labels[lo:lo + rows].long(), mode)
    return _finish(acc, mode)


def lloyd_accumulate_plain(x, w, c, mode: str = "highest",
                           need_cost: bool = True):
    """``_tile_update`` over all rows: ``(sums (k, d), counts (k,), cost)``
    with ``cost`` a 0-d tensor in cost mode and None in loop mode."""
    mode = check_mode(mode)
    k, d = c.shape
    acc = _new_acc(k, d, x.device)
    cost = torch.zeros((), dtype=torch.float32, device=x.device)
    rows = rows_per_chunk(k, d)
    for lo in range(0, x.shape[0], rows):
        xc, wc = x[lo:lo + rows], w[lo:lo + rows]
        assign, min_d2 = _assign_plain(xc, c, mode, need_cost)
        _add_sums(acc, xc, wc, assign, mode)
        if need_cost:
            cost = cost + torch.sum(min_d2 * wc)
    sums, counts = _finish(acc, mode)
    return sums, counts, (cost if need_cost else None)


def _check_operands(x, w, c):
    for name, t, ndim in (("x", x, 2), ("w", w, 1), ("centers", c, 2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(
                f"{name} is on {t.device}, x on {x.device}: one device only"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, d = x.shape
    if n < 1 or d < 1 or c.shape[0] < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}, centers {tuple(c.shape)}")
    if w.shape[0] != n:
        raise ValueError(f"w has {w.shape[0]} rows, x has {n}")
    if c.shape[1] != d:
        raise ValueError(f"centers have {c.shape[1]} features, x has {d}")
    if n >= 2 ** 31 - 2 ** 16 or c.shape[0] >= 2 ** 31 // _MAX_PARTS:
        raise ValueError("n and k must fit the kernel's 32-bit indices")


def assign_route(d: int) -> str:
    """The assignment's route at depth ``d``: ``wgmma`` (tensor cores,
    every tier) up to :data:`WGMMA_MAX_D`, else ``simt`` (FP32 pipe)."""
    return "wgmma" if d <= WGMMA_MAX_D else "simt"


class AssignGeometry(NamedTuple):
    route: str
    rows: int        # rows per assign block
    blocks: int      # assign blocks: the cost partials
    parts: int       # bf16 parts of each operand (wgmma)
    tile: int        # centers per tile (wgmma)
    prep_bytes: int  # the prepared centers (wgmma), 0 for simt


def assign_geometry(n: int, k: int, d: int, mode: str) -> AssignGeometry:
    """The assignment's launch: route, rows per block, blocks, and the
    wgmma route's operand parts, center tile and prepared-center bytes
    (whole tiles, whole 64-deep chunks, 128 bytes a part's row)."""
    route = assign_route(d)
    rows = _ROWS[route]
    blocks = -(-n // rows)
    if route == "simt":
        return AssignGeometry(route, rows, blocks, 1, 64, 0)
    parts = 3 if check_mode(mode) == "highest" else 1
    tile = 64 if parts == 3 else 128
    dpad = -(-d // _CHUNK) * _CHUNK
    prep = -(-k // tile) * (dpad // _CHUNK) * parts * tile * 128
    return AssignGeometry(route, rows, blocks, parts, tile, prep)


def csq_size(k: int) -> int:
    """Floats of the kernel's |c|^2 buffer: k rounded up to whole tiles of
    the widest wgmma center tile (the padding holds +inf)."""
    return -(-k // 128) * 128


def scan_tiles(m: int) -> int:
    """Tiles of the scan over ``m`` counts (one block each)."""
    return -(-m // _SCAN_TILE)


def _geometry(n: int, k: int, d: int):
    """(range_rows, ranges, parts) for the kernel's sort and sums passes."""
    ranges = -(-n // _RANGE_ROWS)
    range_rows = _RANGE_ROWS
    if ranges * k > _RANK_TABLE_ELEMS:
        ranges = max(1, _RANK_TABLE_ELEMS // k)
        range_rows = -(-n // ranges)
        range_rows = -(-range_rows // 32) * 32
        ranges = -(-n // range_rows)
    parts = max(1, min(_MAX_PARTS, _PARTIAL_ELEMS // max(1, k * d)))
    return range_rows, ranges, parts


def _bind(lib):
    fn = lib.kmeans_accumulate
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr] + [i32] * 9 + [ptr] * 14
    fn.restype = i32
    lib.kmeans_assign_rows.argtypes = [i32]
    lib.kmeans_assign_rows.restype = i32
    lib.kmeans_prep_bytes.argtypes = [i32, i32, i32]
    lib.kmeans_prep_bytes.restype = ctypes.c_longlong
    lib.kmeans_scan_tiles.argtypes = [i32]
    lib.kmeans_scan_tiles.restype = i32
    lib.kmeans_csq_size.argtypes = [i32]
    lib.kmeans_csq_size.restype = i32
    # the wrapper sizes every buffer from its own geometry: it must be the
    # library's
    for route, rows in _ROWS.items():
        if lib.kmeans_assign_rows(ROUTE_CODE[route]) != rows:
            raise RuntimeError(f"{KERNEL}: rows per block of the {route} route disagree")
    for mode in MODE_CODE:
        for d, k in ((1, 1), (29, 13), (256, 1000)):
            if lib.kmeans_prep_bytes(MODE_CODE[mode], d, k) != assign_geometry(1, k, d, mode).prep_bytes:
                raise RuntimeError(f"{KERNEL}: prepared-center bytes disagree at {mode}")
    if lib.kmeans_scan_tiles(512_000) != scan_tiles(512_000):
        raise RuntimeError(f"{KERNEL}: scan tiles disagree")
    if lib.kmeans_csq_size(1000) != csq_size(1000):
        raise RuntimeError(f"{KERNEL}: |c|^2 sizes disagree")
    return lib


_lib = None


def _library():
    global _lib
    if _lib is None:
        from oap_mllib_tpu_torch.ops.cuda import _build

        _lib = _bind(_build.load(KERNEL))
    return _lib


def _launch(x, w, c, mode: str, need_cost: bool):
    """Launch the kernel on CUDA operands (checked by the caller):
    ``(sums, counts, cost or None, labels)``."""
    lib = _library()
    n, d = x.shape
    k = c.shape[0]
    range_rows, ranges, parts = _geometry(n, k, d)
    geo = assign_geometry(n, k, d, mode)
    dev = x.device
    f32, i32 = torch.float32, torch.int32

    def empty(size, dtype=f32):
        return torch.empty(size, dtype=dtype, device=dev)

    csq, labels = empty(csq_size(k)), empty(n, i32)
    prep = empty(max(1, geo.prep_bytes), torch.uint8)
    cost_part = empty(geo.blocks)
    counts_i, scan_part = empty(k * ranges, i32), empty(scan_tiles(k * ranges), i32)
    rank, perm = empty(n, i32), empty(n, i32)
    psums, pcounts = empty(k * parts * d), empty(k * parts)
    sums, counts, cost = empty((k, d)), empty(k), empty(())
    # the library sets its own current device (the .so links cudart
    # statically, so torch's current device is not its own)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.kmeans_accumulate(
        dev.index, x.data_ptr(), w.data_ptr(), c.data_ptr(), n, d, k,
        MODE_CODE[mode], int(need_cost), ROUTE_CODE[geo.route], range_rows, ranges,
        parts, csq.data_ptr(), prep.data_ptr(), labels.data_ptr(), cost_part.data_ptr(),
        counts_i.data_ptr(), scan_part.data_ptr(), rank.data_ptr(), perm.data_ptr(),
        psums.data_ptr(), pcounts.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        cost.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with error {err}")
    LAUNCHES[KERNEL] += 1
    LAUNCHES_BY_MODE[mode] += 1
    return sums, counts, (cost if need_cost else None), labels


def lloyd_accumulate(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                     mode: str = "highest", need_cost: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One fused pass: ``(sums (k, d), counts (k,), cost)`` with ``cost``
    None in loop mode.  f32 contiguous operands on one device: CPU takes
    the plain version, CUDA the Hopper kernel."""
    mode = check_mode(mode)
    _check_operands(x, w, c)
    if x.device.type == "cpu":
        return lloyd_accumulate_plain(x, w, c, mode, need_cost)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {x.device}")
    sums, counts, cost, _ = _launch(x, w, c, mode, need_cost)
    return sums, counts, cost


def lloyd_run_kernel(x, w, init_centers, max_iter: int, tol: float,
                     mode: str = "highest", row_chunks: int = 1):
    """The fused-kernel Lloyd loop: ``(centers, n_iter, cost, counts)``.
    Semantics in :func:`oap_mllib_tpu_torch.ops.kmeans_ops._lloyd_loop`;
    the loop passes run in loop mode at ``mode``, the final pass in cost
    mode at ``highest``.  ``row_chunks`` > 1 (the resilience ladder's
    halving rung) launches the kernel on that many equal row ranges a
    pass, the last one ragged, and adds their moments in range order:
    each launch's scratch shrinks with its rows."""
    mode = check_mode(mode)
    n = x.shape[0]
    step = max(1, -(-n // max(1, int(row_chunks))))
    ranges = [(lo, min(n, lo + step)) for lo in range(0, n, step)]

    def accum(centers, final):
        tier, need_cost = ("highest", True) if final else (mode, False)
        sums = counts = cost = None
        for lo, hi in ranges:
            s, c, t = lloyd_accumulate(x[lo:hi], w[lo:hi], centers, tier, need_cost)
            if sums is None:
                sums, counts, cost = s, c, t
            else:
                sums, counts = sums + s, counts + c
                cost = cost + t if need_cost else None
        return sums, counts, cost

    return _lloyd_loop(accum, lambda m: m, init_centers, max_iter, tol)
