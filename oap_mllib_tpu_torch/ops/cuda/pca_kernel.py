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
chosen by ``_gram.pca_gram_route`` from the tier and the width: the
tensor cores (``csrc/gram_wgmma.cuh``, sized by ``_gram.wgmma_geometry``)
for the bf16 tiers at d >= 64, else the FP32 pipe
(``csrc/gram_simt.cuh``, sized by ``_gram.gram_geometry``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from oap_mllib_tpu_torch.ops.cuda._gram import gram_geometry, pca_gram_route, wgmma_geometry
from oap_mllib_tpu_torch.ops.cuda._tiers import MODE_CODE, check_mode, tiered_dot

KERNEL = "pca_moments"

# launches of the CUDA kernel, by kernel name; the wrapper adds one per
# launch and nowhere else (the plain version on CPU tensors counts none)
LAUNCHES = {KERNEL: 0}

# mean pass: rows per slice, and at most this many slices
_SUM_SLICE_ROWS = 1024
_MAX_SUM_SLICES = 4096


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sums_geometry(n: int) -> Tuple[int, int]:
    """``(slices, slice_rows)`` of the mean pass."""
    slice_rows = max(_SUM_SLICE_ROWS, -(-n // _MAX_SUM_SLICES))
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
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError("x must be a 2-D float32 torch.Tensor")
    n, d = x.shape
    if n < 1 or d < 1:
        raise ValueError(f"empty operand: x {tuple(x.shape)}")
    for name, t, size in (("x", x, None), ("mask", mask, n), ("mean", mean, d)):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 torch.Tensor")
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


def _launch(x, mask, mean, mode, need_gram, need_sums):
    """Launch the kernel on CUDA operands (checked by the caller)."""
    lib = _library()
    n, d = x.shape
    dev = x.device

    def empty(*size):
        return torch.empty(size, dtype=torch.float32, device=dev)

    sum_slices, sum_rows = sums_geometry(n)
    route = pca_gram_route(mode, d)
    if route == "wgmma":
        tm = 0
        m, g_slices, g_rows = wgmma_geometry(n, d)
    else:
        tm, m, g_slices, g_rows = gram_geometry(n, d)
    psum = pcount = colsum = count = part = gram = None
    if need_sums:
        psum, pcount, colsum, count = empty(sum_slices, d), empty(sum_slices), empty(d), empty()
    if need_gram:
        part, gram = empty(g_slices, d, d), empty(d, d)
        if mean is None:
            mean = torch.zeros(d, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pca_moments(
            dev.index, x.data_ptr(), _ptr(mask), _ptr(mean), n, d, MODE_CODE[mode],
            int(need_sums), int(need_gram), sum_slices, sum_rows,
            _ptr(psum), _ptr(pcount), _ptr(colsum), _ptr(count),
            int(route == "wgmma"), tm, m, g_slices, g_rows, _ptr(part), _ptr(gram), stream,
        )
    if err != 0:
        raise RuntimeError(f"{KERNEL}: CUDA launch failed with error {err}")
    LAUNCHES[KERNEL] += 1
    return gram, colsum, count


def pca_moments(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                mean: Optional[torch.Tensor] = None, mode: str = "highest",
                need_gram: bool = True, need_sums: bool = True):
    """One moments pass: ``(gram (d, d), colsum (d,), count ())``, each
    None when not asked for (``need_gram`` / ``need_sums``).  ``mask``
    None weighs every row 1; ``mean`` None is zero.  f32 contiguous
    operands on one device: CPU takes the plain version, CUDA the Hopper
    kernel."""
    mode = check_mode(mode)
    _check_operands(x, mask, mean)
    if x.device.type == "cpu":
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.float32)
        return pca_moments_plain(x, mask, mean, mode, need_gram, need_sums)
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {x.device}")
    return _launch(x, mask, mean, mode, need_gram, need_sums)
