"""Fused Lloyd accumulate: the port of the JAX package's
``ops/pallas/kmeans_kernel.py`` (``_tile_update`` and the loop around it).

- :func:`lloyd_accumulate_plain` is ``_tile_update``'s function in plain
  PyTorch, chunked by ``rows_per_chunk`` so the (rows, k) score buffer
  stays bounded.  The CPU tests run it, and ``chip_smoke.py`` holds the
  kernel against it on the card.
- :func:`lloyd_accumulate` is the wrapper of the hand-written Hopper
  kernel ``csrc/kmeans_accumulate.cu``.  A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises.  There is no
  fallback from one to the other.  The assignment runs on the tensor
  cores at every tier and depth (highest as a three-part bf16 split, six
  products); its route is fixed by the depth (:func:`assign_route`): up
  to 256 features ``csrc/assign_wgmma.cuh``, whose rows' operand parts
  stay in registers and shared memory for the whole pass, wider rows
  ``csrc/assign_wide.cuh``, which streams the depth in 64-deep chunks.
  :func:`assign_geometry` sizes the launch and its scratch; the wrapper
  checks it against the library's own figures when it loads it.
- :func:`lloyd_run_kernel` is ``_lloyd_loop_padded`` / ``lloyd_run_pallas``:
  the Lloyd loop over the wrapper, then one cost pass at ``highest``.

float64 operands (the x64 parity lane, ``Config.enable_x64``) take the
kernel's float64 form, ``kmeans_accumulate_f64``, at ``highest`` only (a
bf16 tier on f64 raises): the assignment's cross term on the FP64 tensor
cores at every depth (``csrc/assign_dmma.cuh``: DMMA ``mma.sync``, 128
rows by 128 centers a block, ``cp.async`` stages; sized by
:func:`f64_assign_geometry`), the sums, counts and cost in f64.  The plain version runs
in its operands' dtype.  Every operand has one dtype: a mixed f32 / f64
call raises.  The f64 form takes :data:`DEFAULT_GEOMETRY`'s knobs like
the f32 one (the autotuner pins it there, ops/cuda/autotune.py).

Launch geometry (the autotuner's ``kmeans`` knobs, ops/cuda/autotune.py):
``range_rows``, the rows a warp of the counting sort ranks (a multiple
of 32; the sort is stable, so it moves no bit), and ``parts``, the most
parts a cluster's sums are cut into (1 .. :data:`_MAX_PARTS`; it changes
the fold).  ``geometry=None`` launches :data:`DEFAULT_GEOMETRY`.

Contract, as in the JAX package: ``mode`` is a precision tier; loop mode
(``need_cost=False``) ranks on ``argmax(x.c - |c|^2 / 2)`` and computes no
cost; cost mode ranks on ``argmin max(|x|^2 + |c|^2 - 2 x.c, 0)`` and sums
``w * min d2``; ties go to the first index; weights fold into ``w * x``
and the one-hot stays 0/1.  The kernel masks ragged rows and centers
itself, so the JAX package's padding and dummy centers are not needed.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional, Tuple

import torch

from oap_mllib_tpu_torch.ops.cuda._tiers import (LABELS, MODE_CODE, bf16_round, book_launch,
                                                 check_mode, split_bf16)
from oap_mllib_tpu_torch.ops.kmeans_ops import _lloyd_loop, rows_per_chunk
from oap_mllib_tpu_torch.utils import progcache

KERNEL = "kmeans_accumulate"

# launches of the CUDA kernel, by kernel name; the wrapper adds one per
# launch and nowhere else (the plain version on CPU tensors counts none)
LAUNCHES = {KERNEL: 0}
# the same launches by tier (the precision rung's witness: a bf16 fit
# launches at "default", its f32 retry at "highest")
LAUNCHES_BY_MODE = {"highest": 0, "high": 0, "default": 0}
# the same launches by operand dtype (the float64 form's witness)
LAUNCHES_BY_DTYPE = {"float32": 0, "float64": 0}

# the kernel's stable counting sort keeps (k, ranges) integer counts;
# ranges shrink as k grows so the table stays under this many entries
_RANK_TABLE_ELEMS = 1 << 24
_RANGE_ROWS = 2048
# per-cluster parts of the sums pass (load balance for large clusters),
# bounded so the (k, parts, d) partials stay under this many floats
_PARTIAL_ELEMS = 1 << 25
_MAX_PARTS = 8
DEFAULT_GEOMETRY = {"range_rows": _RANGE_ROWS, "parts": _MAX_PARTS}
# the assignment's routes (csrc/kmeans_accumulate.cu): wgmma
# (assign_wgmma.cuh) keeps each row's operand parts in registers and
# shared memory for the whole pass, which bounds its depth; wider rows
# take wgmma_wide (assign_wide.cuh), which streams the depth; dmma is the
# float64 form's.  Rows: a cost partial's.
ROUTE_CODE = {"wgmma": 1, "dmma": 2, "wgmma_wide": 3}
WGMMA_MAX_D = 256
_ROWS = {"wgmma": 128, "dmma": 128, "wgmma_wide": 128}
# the wide route (assign_wide.cuh) by parts: centers a tile, and the
# dynamic shared memory of its block (center stages, formed rows, raw
# rows, |x|^2); its center tiles are cut into at most _WIDE_GROUPS groups
_WIDE_TILE = {3: 128, 1: 256}
_WIDE_SMEM = {3: 1024 + 2 * 3 * 128 * 128 + 1 * 3 * 128 * 128 + 1 * 128 * 64 * 4 + 128 * 4,
              1: 1024 + 4 * 256 * 128 + 2 * 128 * 128 + 2 * 128 * 64 * 4 + 128 * 4}
_WIDE_GROUPS = 8
# the float64 form's DMMA tile (csrc/assign_dmma.cuh): centers a tile,
# depth a stage, a staged row's padded slot, stages, and the static
# shared memory beside the stages (|x|^2, the warps' bests, row costs)
_F64_TILE = 128
_F64_BK = 32
_F64_LD = _F64_BK + 4
_F64_STAGES = 3
_F64_STATIC_SMEM = 128 * 8 + 2 * 128 * (8 + 4) + 128 * 8
# a warp's tile of (rows, centers): 4 x 2 warps cover a block's 128 x 128
F64_WARP_TILE = (32, 64)
# the wgmma route's prepared centers: tiles of BN centers by 64-deep
# chunks, in PARTS bf16 parts of 128-byte rows (three parts at highest)
_CHUNK = 64
_SCAN_TILE = 4096


def reset_launches() -> None:
    for table in (LAUNCHES, LAUNCHES_BY_MODE, LAUNCHES_BY_DTYPE):
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


def _new_acc(k, d, device, dtype=torch.float32):
    z = torch.zeros((k, d), dtype=dtype, device=device)
    zc = torch.zeros((k,), dtype=dtype, device=device)
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
    acc = _new_acc(k, x.shape[1], x.device, x.dtype)
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
    acc = _new_acc(k, d, x.device, x.dtype)
    cost = torch.zeros((), dtype=x.dtype, device=x.device)
    rows = rows_per_chunk(k, d)
    for lo in range(0, x.shape[0], rows):
        xc, wc = x[lo:lo + rows], w[lo:lo + rows]
        assign, min_d2 = _assign_plain(xc, c, mode, need_cost)
        _add_sums(acc, xc, wc, assign, mode)
        if need_cost:
            cost = cost + torch.sum(min_d2 * wc)
    sums, counts = _finish(acc, mode)
    return sums, counts, (cost if need_cost else None)


DTYPES = (torch.float32, torch.float64)


def _check_operands(x, w, c):
    for name, t, ndim in (("x", x, 2), ("w", w, 1), ("centers", c, 2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != x.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name} is {t.dtype}, x {x.dtype}: one dtype, float32 or float64")
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
    """The assignment's route at depth ``d``, both on the tensor cores at
    every tier: ``wgmma`` up to :data:`WGMMA_MAX_D`, ``wgmma_wide`` for
    every wider row (no depth limit)."""
    return "wgmma" if d <= WGMMA_MAX_D else "wgmma_wide"


class AssignGeometry(NamedTuple):
    route: str
    rows: int           # rows a cost partial (an assign block, or a merge block)
    blocks: int         # the cost partials
    parts: int          # bf16 parts of each operand
    tile: int           # centers a tile
    prep_bytes: int     # the prepared centers (whole tiles and 64-deep chunks)
    groups: int         # wgmma_wide: groups of center tiles (1 for wgmma)
    per_group: int      # wgmma_wide: center tiles a group (the last may have fewer)
    scratch_bytes: int  # the library's `prep` scratch: the prepared centers and,
    #                     for wgmma_wide, the (groups, n) best scores and indices


def assign_geometry(n: int, k: int, d: int, mode: str) -> AssignGeometry:
    """The assignment's launch: route, rows a cost partial, partials, the
    operand parts, the center tile, the prepared-center bytes (whole
    tiles, whole 64-deep chunks, 128 bytes a part's row) and, for the
    wide route, its groups of center tiles: at most :data:`_WIDE_GROUPS`
    of equal size, each item of the route a block of 128 rows and one
    group, each row's best of a group kept in 8 bytes of scratch."""
    route = assign_route(d)
    rows = _ROWS[route]
    blocks = -(-n // rows)
    parts = 3 if check_mode(mode) == "highest" else 1
    dpad = -(-d // _CHUNK) * _CHUNK
    if route == "wgmma":
        tile = 64 if parts == 3 else 128
        prep = -(-k // tile) * (dpad // _CHUNK) * parts * tile * 128
        return AssignGeometry(route, rows, blocks, parts, tile, prep, 1, -(-k // tile), prep)
    tile = _WIDE_TILE[parts]
    tiles = -(-k // tile)
    per_group = -(-tiles // _WIDE_GROUPS)
    groups = -(-tiles // per_group)
    prep = tiles * (dpad // _CHUNK) * parts * tile * 128
    return AssignGeometry(route, rows, blocks, parts, tile, prep, groups, per_group,
                          prep + groups * n * 8)


class F64AssignGeometry(NamedTuple):
    rows: int        # rows per block
    blocks: int      # blocks: the cost partials
    tile: int        # centers per tile
    tiles: int       # center tiles a block walks
    stages: int      # depth stages per center tile
    smem_bytes: int  # dynamic shared memory a block


def f64_assign_geometry(n: int, k: int, d: int) -> F64AssignGeometry:
    """The float64 form's assignment launch: blocks of 128 rows, each
    walking the k centers in tiles of 128 and the depth in stages of 32,
    its staged rows and centers in dynamic shared memory."""
    rows = _ROWS["dmma"]
    smem = _F64_STAGES * (rows + _F64_TILE) * _F64_LD * 8
    return F64AssignGeometry(rows, -(-n // rows), _F64_TILE, -(-k // _F64_TILE),
                             -(-d // _F64_BK), smem)


def f64_scratch(n: int, k: int, d: int, ranges: int, parts: int) -> dict:
    """Elements of each scratch buffer of the float64 form's launch (the
    library's contract, ``kmeans_accumulate_f64``): ``cost_part`` holds
    one partial per assignment block."""
    return {"csq": csq_size(k), "labels": n, "cost_part": f64_assign_geometry(n, k, d).blocks,
            "counts_i": k * ranges, "scan_part": scan_tiles(k * ranges), "rank": n, "perm": n,
            "psums": k * parts * d, "pcounts": k * parts}


def csq_size(k: int) -> int:
    """Floats of the kernel's |c|^2 buffer: k rounded up to whole tiles of
    the widest center tile (the wide route's 256; the padding holds
    +inf)."""
    return -(-k // 256) * 256


def scan_tiles(m: int) -> int:
    """Tiles of the scan over ``m`` counts (one block each)."""
    return -(-m // _SCAN_TILE)


def check_geometry(geometry) -> Tuple[int, int]:
    """``(range_rows, parts)`` of a ``{"range_rows", "parts"}`` geometry
    (None: :data:`DEFAULT_GEOMETRY`); one the kernel cannot take raises,
    on every device."""
    geo = DEFAULT_GEOMETRY if geometry is None else geometry
    if set(geo) != set(DEFAULT_GEOMETRY):
        raise ValueError(f"{KERNEL} geometry takes the knobs {sorted(DEFAULT_GEOMETRY)}, "
                         f"got {sorted(geo)}")
    range_rows, parts = geo["range_rows"], geo["parts"]
    if not isinstance(range_rows, int) or range_rows < 32 or range_rows % 32:
        raise ValueError(f"{KERNEL}: range_rows must be a positive multiple of 32, "
                         f"got {range_rows!r}")
    if not isinstance(parts, int) or not 1 <= parts <= _MAX_PARTS:
        raise ValueError(f"{KERNEL}: parts must be in 1..{_MAX_PARTS}, got {parts!r}")
    return range_rows, parts


def _geometry(n: int, k: int, d: int, base_rows: int = _RANGE_ROWS,
              max_parts: int = _MAX_PARTS):
    """(range_rows, ranges, parts) for the kernel's sort and sums passes:
    ranges of ``base_rows`` rows unless the (k, ranges) count table would
    pass its bound, and at most ``max_parts`` parts a cluster."""
    ranges = -(-n // base_rows)
    range_rows = base_rows
    if ranges * k > _RANK_TABLE_ELEMS:
        ranges = max(1, _RANK_TABLE_ELEMS // k)
        range_rows = -(-n // ranges)
        range_rows = -(-range_rows // 32) * 32
        ranges = -(-n // range_rows)
    parts = max(1, min(max_parts, _PARTIAL_ELEMS // max(1, k * d)))
    return range_rows, ranges, parts


def _bind(lib):
    fn = lib.kmeans_accumulate
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32, ptr, ptr, ptr] + [i32] * 9 + [ptr] * 14
    fn.restype = i32
    lib.kmeans_assign_rows.argtypes = [i32]
    lib.kmeans_assign_rows.restype = i32
    lib.kmeans_prep_bytes.argtypes = [i32, i32, i32, i32]
    lib.kmeans_prep_bytes.restype = ctypes.c_longlong
    lib.kmeans_wide_figure.argtypes = [i32, i32, i32]
    lib.kmeans_wide_figure.restype = i32
    lib.kmeans_scan_tiles.argtypes = [i32]
    lib.kmeans_scan_tiles.restype = i32
    lib.kmeans_csq_size.argtypes = [i32]
    lib.kmeans_csq_size.restype = i32
    lib.kmeans_accumulate_f64.argtypes = [i32, ptr, ptr, ptr] + [i32] * 7 + [ptr] * 13
    lib.kmeans_accumulate_f64.restype = i32
    for name in ("kmeans_f64_center_tile", "kmeans_f64_smem_bytes"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.kmeans_f64_warp_tile.argtypes = [i32]
    lib.kmeans_f64_warp_tile.restype = i32
    # the wrapper sizes every buffer from its own geometry: it must be the
    # library's
    for route, rows in _ROWS.items():
        if lib.kmeans_assign_rows(ROUTE_CODE[route]) != rows:
            raise RuntimeError(f"{KERNEL}: rows per block of the {route} route disagree")
    for mode in MODE_CODE:
        code, parts = MODE_CODE[mode], 3 if mode == "highest" else 1
        for n, d, k in ((1, 1, 1), (7, 29, 13), (5, 256, 1000), (777, 257, 70),
                        (1 << 20, 960, 1000), (3, 300, 5000)):
            geo = assign_geometry(n, k, d, mode)
            if lib.kmeans_prep_bytes(code, n, d, k) != geo.scratch_bytes:
                raise RuntimeError(f"{KERNEL}: scratch bytes disagree at {mode}, {(n, d, k)}")
            if geo.route == "wgmma_wide" and (
                    lib.kmeans_wide_figure(code, 0, k) != geo.tile
                    or lib.kmeans_wide_figure(code, 1, k) != geo.groups
                    or lib.kmeans_wide_figure(code, 2, k) != _WIDE_SMEM[parts]):
                raise RuntimeError(f"{KERNEL}: the wide route's tile, groups or shared "
                                   f"memory disagree at {mode}, k = {k}")
    f64 = f64_assign_geometry(1, 1, 1)
    if (lib.kmeans_f64_center_tile() != f64.tile
            or lib.kmeans_f64_smem_bytes() != f64.smem_bytes
            or (lib.kmeans_f64_warp_tile(0), lib.kmeans_f64_warp_tile(1)) != F64_WARP_TILE):
        raise RuntimeError(f"{KERNEL}: the float64 tile's centers or shared memory disagree")
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


def _launch(x, w, c, mode: str, need_cost: bool, geometry=None):
    """Launch the kernel on CUDA operands (checked by the caller):
    ``(sums, counts, cost or None, labels)``."""
    lib = _library()
    n, d = x.shape
    k = c.shape[0]
    range_rows, ranges, parts = _geometry(n, k, d, *check_geometry(geometry))
    if x.dtype == torch.float64:
        return _launch_f64(lib, x, w, c, need_cost, range_rows, ranges, parts)
    geo = assign_geometry(n, k, d, mode)
    dev = x.device
    f32, i32 = torch.float32, torch.int32

    def empty(size, dtype=f32):
        return torch.empty(size, dtype=dtype, device=dev)

    csq, labels = empty(csq_size(k)), empty(n, i32)
    prep = empty(max(1, geo.scratch_bytes), torch.uint8)
    cost_part = empty(geo.blocks)
    counts_i, scan_part = empty(k * ranges, i32), empty(scan_tiles(k * ranges), i32)
    rank, perm = empty(n, i32), empty(n, i32)
    psums, pcounts = empty(k * parts * d), empty(k * parts)
    sums, counts, cost = empty((k, d)), empty(k), empty(())
    # the library sets its own current device (the .so links cudart
    # statically, so torch's current device is not its own)
    stream = torch.cuda.current_stream(dev).cuda_stream
    t0 = time.perf_counter()
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
    LAUNCHES_BY_DTYPE["float32"] += 1
    book_launch(LABELS[KERNEL], time.perf_counter() - t0)
    return sums, counts, (cost if need_cost else None), labels


def _launch_f64(lib, x, w, c, need_cost: bool, range_rows: int, ranges: int, parts: int):
    """The float64 form's launch (highest, the DMMA assignment): the
    same outputs as :func:`_launch`, every float buffer a double."""
    n, d = x.shape
    k = c.shape[0]
    dev = x.device
    f64, i32 = torch.float64, torch.int32

    def empty(size, dtype=f64):
        return torch.empty(size, dtype=dtype, device=dev)

    size = f64_scratch(n, k, d, ranges, parts)
    csq, labels = empty(size["csq"]), empty(size["labels"], i32)
    cost_part = empty(size["cost_part"])
    counts_i, scan_part = empty(size["counts_i"], i32), empty(size["scan_part"], i32)
    rank, perm = empty(size["rank"], i32), empty(size["perm"], i32)
    psums, pcounts = empty(size["psums"]), empty(size["pcounts"])
    sums, counts, cost = empty((k, d)), empty(k), empty(())
    stream = torch.cuda.current_stream(dev).cuda_stream
    t0 = time.perf_counter()
    err = lib.kmeans_accumulate_f64(
        dev.index, x.data_ptr(), w.data_ptr(), c.data_ptr(), n, d, k, int(need_cost),
        range_rows, ranges, parts, csq.data_ptr(), labels.data_ptr(), cost_part.data_ptr(),
        counts_i.data_ptr(), scan_part.data_ptr(), rank.data_ptr(), perm.data_ptr(),
        psums.data_ptr(), pcounts.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        cost.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{KERNEL} (float64): CUDA launch failed with error {err}")
    LAUNCHES[KERNEL] += 1
    LAUNCHES_BY_MODE["highest"] += 1
    LAUNCHES_BY_DTYPE["float64"] += 1
    book_launch(LABELS[KERNEL], time.perf_counter() - t0)
    return sums, counts, (cost if need_cost else None), labels


def lloyd_accumulate(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                     mode: str = "highest", need_cost: bool = True, geometry=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One fused pass: ``(sums (k, d), counts (k,), cost)`` with ``cost``
    None in loop mode.  Contiguous operands of one dtype (f32, or f64 at
    ``highest``) on one device: CPU takes the plain version, CUDA the
    Hopper kernel (its float64 form for f64) at ``geometry``."""
    mode = check_mode(mode)
    _check_operands(x, w, c)
    if x.dtype == torch.float64 and mode != "highest":
        raise ValueError(f"float64 operands run at the highest tier only, got {mode!r}")
    check_geometry(geometry)
    if x.device.type == "cpu":
        return lloyd_accumulate_plain(x, w, c, mode, need_cost)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {x.device}")
    sums, counts, cost, _ = _launch(x, w, c, mode, need_cost, geometry)
    return sums, counts, cost


def lloyd_run_kernel(x, w, init_centers, max_iter: int, tol: float,
                     mode: str = "highest", row_chunks: int = 1, geometry=None):
    """The fused-kernel Lloyd loop: ``(centers, n_iter, cost, counts)``.
    Semantics in :func:`oap_mllib_tpu_torch.ops.kmeans_ops._lloyd_loop`;
    the loop passes run in loop mode at ``mode``, the final pass in cost
    mode at ``highest``.  ``row_chunks`` > 1 (the resilience ladder's
    halving rung) launches the kernel on that many equal row ranges a
    pass, the last one ragged, and adds their moments in range order:
    each launch's scratch shrinks with its rows.  Every launch takes
    ``geometry``."""
    mode = check_mode(mode)
    n = x.shape[0]
    step = max(1, -(-n // max(1, int(row_chunks))))
    ranges = [(lo, min(n, lo + step)) for lo in range(0, n, step)]

    def accum(centers, final):
        tier, need_cost = ("highest", True) if final else (mode, False)
        sums = counts = cost = None
        for lo, hi in ranges:
            s, c, t = lloyd_accumulate(x[lo:hi], w[lo:hi], centers, tier, need_cost, geometry)
            if sums is None:
                sums, counts, cost = s, c, t
            else:
                sums, counts = sums + s, counts + c
                cost = cost + t if need_cost else None
        return sums, counts, cost

    return _lloyd_loop(accum, lambda m: m, init_centers, max_iter, tol,
                       ("kmeans.lloyd_kernel", (progcache.array_key(x, w), mode, len(ranges))))
