"""PCA moments: the port of the JAX package's ``ops/pallas/pca_kernel.py``
(``_tile_moments`` and its entries ``pca_moments_pallas`` and
``covariance_pallas``).

- :func:`pca_moments_plain` is ``_tile_moments``'s function over the
  whole table in plain PyTorch.  The CPU tests run it, and
  ``chip_smoke.py`` holds the kernel against it on the card.
- :func:`pca_moments` is the wrapper of the hand-written Hopper kernel
  ``csrc/pca_moments.cu``.  A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel or raises.  There is no fallback from one
  to the other.

Contract, as in the JAX package: ``colsum`` and ``count`` are the raw
masked column sums and the mask total, f32 at every tier; ``gram`` is the
centered masked Gram ``((x - mean) * mask)^T ((x - mean) * mask)`` at a
precision tier, centering in f32 before any rounding.  The kernel masks
ragged rows itself, so the JAX package's 512-row and 128-lane padding
is not needed.  The Gram pass takes one of two hand-written routes,
chosen by ``_gram.pca_gram_route`` from the width: the tensor cores
(``csrc/gram_wgmma.cuh``, sized by ``_gram.wgmma_geometry``) at every
tier for d >= 64 (``highest`` as a three-part bf16 split of each f32
value and six products, the TPU's own ``HIGHEST`` scheme), else SIMT
tiles (``csrc/gram_simt.cuh``, sized by ``_gram.gram_geometry``).

Launch geometry (the autotuner's ``pca`` knobs, ops/cuda/autotune.py):
``target_blocks``, the (tile, slice) blocks the SIMT Gram route (d < 64)
and the float64 form aim for (the tensor-core route fills the SMs by
its own rule), and
``sum_rows``, the least rows of a mean-pass slice.  Both cut the rows
into other slices, so they change the fold.  ``geometry=None`` launches
:data:`DEFAULT_GEOMETRY`.

float64 operands (the x64 parity lane, ``Config.enable_x64``) take the
kernel's float64 form, ``pca_moments_f64``, at ``highest`` only (a bf16
tier on f64 raises): the sums and count Kahan-added in f64, the Gram on
the FP64 tensor cores (``csrc/gram_dmma.cuh``: DMMA ``mma.sync`` in
128-wide tiles fed by ``cp.async`` stages, the whole upper triangle one
block's at d <= 128, sized by :func:`f64_gram_geometry`), no tier.
The plain version runs in its operands' dtype; a mixed f32 / f64 call
raises.  The f64 form takes the same knobs.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional, Tuple

import torch

from oap_mllib_tpu_torch.ops.cuda._gram import (_F64_BK, _F64_TILE, _TARGET_BLOCKS,
                                                F64_DIAG_JOBS, f64_gram_geometry, f64_gram_smem,
                                                gram_geometry, pca_gram_route, wgmma_geometry)
from oap_mllib_tpu_torch.ops.cuda._tiers import (LABELS, MODE_CODE, book_launch, check_mode,
                                                 tiered_dot)

KERNEL = "pca_moments"

# launches of the CUDA kernel, by kernel name; the wrapper adds one per
# launch and nowhere else (the plain version on CPU tensors counts none)
LAUNCHES = {KERNEL: 0}
# the same launches by operand dtype (the float64 form's witness)
LAUNCHES_BY_DTYPE = {"float32": 0, "float64": 0}

# mean pass: rows per slice, and at most this many slices
_SUM_SLICE_ROWS = 1024
_MAX_SUM_SLICES = 4096
DEFAULT_GEOMETRY = {"target_blocks": _TARGET_BLOCKS, "sum_rows": _SUM_SLICE_ROWS}
# the knobs' bounds: a grid of at most this many blocks, slices of at
# most this many rows
_MAX_TARGET_BLOCKS = 1 << 16
_MAX_SUM_ROWS = 1 << 20


def reset_launches() -> None:
    for table in (LAUNCHES, LAUNCHES_BY_DTYPE):
        for name in table:
            table[name] = 0


def check_geometry(geometry) -> Tuple[int, int]:
    """``(target_blocks, sum_rows)`` of a ``{"target_blocks",
    "sum_rows"}`` geometry (None: :data:`DEFAULT_GEOMETRY`); one the
    kernel cannot take raises, on every device."""
    geo = DEFAULT_GEOMETRY if geometry is None else geometry
    if set(geo) != set(DEFAULT_GEOMETRY):
        raise ValueError(f"{KERNEL} geometry takes the knobs {sorted(DEFAULT_GEOMETRY)}, "
                         f"got {sorted(geo)}")
    blocks, rows = geo["target_blocks"], geo["sum_rows"]
    if not isinstance(blocks, int) or not 1 <= blocks <= _MAX_TARGET_BLOCKS:
        raise ValueError(f"{KERNEL}: target_blocks must be in 1..{_MAX_TARGET_BLOCKS}, "
                         f"got {blocks!r}")
    if not isinstance(rows, int) or not 1 <= rows <= _MAX_SUM_ROWS:
        raise ValueError(f"{KERNEL}: sum_rows must be in 1..{_MAX_SUM_ROWS}, got {rows!r}")
    return blocks, rows


def sums_geometry(n: int, sum_rows: int = _SUM_SLICE_ROWS) -> Tuple[int, int]:
    """``(slices, slice_rows)`` of the mean pass: slices of at least
    ``sum_rows`` rows, at most :data:`_MAX_SUM_SLICES` of them."""
    slice_rows = max(sum_rows, -(-n // _MAX_SUM_SLICES))
    return -(-n // slice_rows), slice_rows


def pca_moments_plain(x: torch.Tensor, mask: torch.Tensor,
                      mean: Optional[torch.Tensor] = None,
                      mode: str = "highest", need_gram: bool = True,
                      need_sums: bool = True):
    """``(gram, colsum, count)`` in plain PyTorch; what was not asked for
    is None.  ``mean`` None is zero."""
    mode = check_mode(mode)
    colsum = count = gram = None
    m = mask[:, None]
    if need_sums:
        colsum = torch.sum(x * m, dim=0)
        count = torch.sum(mask)
    if need_gram:
        xc = x if mean is None else x - mean[None, :]
        xc = xc * m
        gram = tiered_dot(xc.T, xc, mode)
    return gram, colsum, count


def _check_operands(x, mask, mean):
    if (not isinstance(x, torch.Tensor) or x.dtype not in (torch.float32, torch.float64)
            or x.dim() != 2):
        raise TypeError("x must be a 2-D float32 or float64 torch.Tensor")
    n, d = x.shape
    if n < 1 or d < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}")
    for name, t, size in (("x", x, None), ("mask", mask, n), ("mean", mean, d)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != x.dtype:
            raise TypeError(f"{name} must be a torch.Tensor of x's dtype {x.dtype}: "
                            "one dtype only")
        if size is not None and tuple(t.shape) != (size,):
            raise ValueError(f"{name} must have shape ({size},), got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}: one device only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n >= 2 ** 31 - 2 ** 16:
        raise ValueError("n must fit the kernel's 32-bit row indices")


def _bind(lib):
    fn = lib.pca_moments
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([i32, ptr, ptr, ptr] + [i32] * 7 + [ptr] * 4 + [i32] * 5
                   + [ptr, ptr, ptr])
    fn.restype = i32
    lib.pca_moments_f64.argtypes = [i32, ptr, ptr, ptr] + [i32] * 6 + [ptr] * 4 + [i32] * 3 \
        + [ptr, ptr, ptr]
    lib.pca_moments_f64.restype = i32
    for name in ("pca_f64_gram_tile", "pca_f64_gram_rows"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    lib.pca_f64_gram_smem.argtypes = [i32]
    lib.pca_f64_gram_smem.restype = i32
    lib.pca_f64_gram_job.argtypes = [i32, i32]
    lib.pca_f64_gram_job.restype = i32
    # the wrapper sizes the float64 Gram's slices and the tests emulate
    # its blocks from the figures in _gram: they must be the library's
    jobs = tuple(tuple(lib.pca_f64_gram_job(w, side) for side in range(3))
                 for w in range(len(F64_DIAG_JOBS)))
    if (lib.pca_f64_gram_tile() != _F64_TILE or lib.pca_f64_gram_rows() != _F64_BK
            or lib.pca_f64_gram_smem(0) != f64_gram_smem(_F64_TILE)
            or lib.pca_f64_gram_smem(1) != f64_gram_smem(_F64_TILE + 1)
            or jobs != F64_DIAG_JOBS):
        raise RuntimeError(f"{KERNEL}: the float64 Gram's tile geometry disagrees")
    return lib


_lib = None


def _library():
    global _lib
    if _lib is None:
        from oap_mllib_tpu_torch.ops.cuda import _build

        _lib = _bind(_build.load(KERNEL))
    return _lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(x, mask, mean, mode, need_gram, need_sums, geometry=None):
    """Launch the kernel on CUDA operands (checked by the caller)."""
    lib = _library()
    n, d = x.shape
    dev = x.device

    def empty(*size):
        return torch.empty(size, dtype=x.dtype, device=dev)

    target_blocks, least_rows = check_geometry(geometry)
    sum_slices, sum_rows = sums_geometry(n, least_rows)
    if x.dtype == torch.float64:
        return _launch_f64(lib, x, mask, mean, need_gram, need_sums, empty, target_blocks,
                           sum_slices, sum_rows)
    route = pca_gram_route(mode, d)
    if route == "wgmma":
        tm = 0
        m, g_slices, g_rows = wgmma_geometry(n, d)
    else:
        tm, m, g_slices, g_rows = gram_geometry(n, d, target_blocks)
    psum = pcount = colsum = count = part = gram = None
    if need_sums:
        psum, pcount, colsum, count = empty(sum_slices, d), empty(sum_slices), empty(d), empty()
    if need_gram:
        part, gram = empty(g_slices, d, d), empty(d, d)
        if mean is None:
            mean = torch.zeros(d, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        t0 = time.perf_counter()
        err = lib.pca_moments(
            dev.index, x.data_ptr(), _ptr(mask), _ptr(mean), n, d, MODE_CODE[mode],
            int(need_sums), int(need_gram), sum_slices, sum_rows,
            _ptr(psum), _ptr(pcount), _ptr(colsum), _ptr(count),
            int(route == "wgmma"), tm, m, g_slices, g_rows, _ptr(part), _ptr(gram), stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with error {err}")
    LAUNCHES[KERNEL] += 1
    LAUNCHES_BY_DTYPE["float32"] += 1
    book_launch(LABELS[KERNEL], time.perf_counter() - t0)
    return gram, colsum, count


def _launch_f64(lib, x, mask, mean, need_gram, need_sums, empty, target_blocks, sum_slices,
                sum_rows):
    """The float64 form's launch: the outputs of :func:`_launch`, every
    float buffer a double, the Gram in 128-wide DMMA tiles."""
    n, d = x.shape
    dev = x.device
    m, g_slices, g_rows = f64_gram_geometry(n, d, target_blocks)
    psum = pcount = colsum = count = part = gram = None
    if need_sums:
        psum, pcount, colsum, count = empty(sum_slices, d), empty(sum_slices), empty(d), empty()
    if need_gram:
        part, gram = empty(g_slices, d, d), empty(d, d)
        if mean is None:
            mean = torch.zeros(d, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        t0 = time.perf_counter()
        err = lib.pca_moments_f64(
            dev.index, x.data_ptr(), _ptr(mask), _ptr(mean), n, d, int(need_sums),
            int(need_gram), sum_slices, sum_rows, _ptr(psum), _ptr(pcount), _ptr(colsum),
            _ptr(count), m, g_slices, g_rows, _ptr(part), _ptr(gram), stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL} (float64): CUDA launch failed with error {err}")
    LAUNCHES[KERNEL] += 1
    LAUNCHES_BY_DTYPE["float64"] += 1
    book_launch(LABELS[KERNEL], time.perf_counter() - t0)
    return gram, colsum, count


def pca_moments(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                mean: Optional[torch.Tensor] = None, mode: str = "highest",
                need_gram: bool = True, need_sums: bool = True, geometry=None):
    """One moments pass: ``(gram (d, d), colsum (d,), count ())``, each
    None when not asked for (``need_gram`` / ``need_sums``).  ``mask``
    None weighs every row 1; ``mean`` None is zero.  Contiguous operands
    of one dtype (f32, or f64 at ``highest``) on one device: CPU takes
    the plain version, CUDA the Hopper kernel (its float64 form for f64)
    at ``geometry``."""
    mode = check_mode(mode)
    _check_operands(x, mask, mean)
    if x.dtype == torch.float64 and mode != "highest":
        raise ValueError(f"float64 operands run at the highest tier only, got {mode!r}")
    check_geometry(geometry)
    if x.device.type == "cpu":
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=x.dtype)
        return pca_moments_plain(x, mask, mean, mode, need_gram, need_sums)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {x.device}")
    return _launch(x, mask, mean, mode, need_gram, need_sums, geometry)
